"""span.serve.idle_ms: device idle ms a batch inside the program's span
`serve.batch` (harness/program_spans.idle_ms: the span's device time less
the busy union of the trace's device operations), the mean over the traced
window; the gaps between batches, in the harness's loop, are left out."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.idle_ms(ctx, "serve.batch")
