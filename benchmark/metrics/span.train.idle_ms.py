"""span.train.idle_ms: device idle ms a step inside the program's span
`train.step` (harness/program_spans.idle_ms), the mean over the traced
window."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.idle_ms(ctx, "train.step")
