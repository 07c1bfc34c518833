"""span.ddp.idle_ms: device idle ms a step inside the program's span
`train.step` on rank 0 (harness/program_spans.idle_ms), the mean over the
traced window. Between steps the harness all-reduces its stop flag (the
only max all-reduce, `ncclDevKernel_AllReduce_Max_*`), whose time is left
out with the gaps between steps."""
from benchmark.harness import program_spans

FLAG = "AllReduce_Max"


def read(ctx):
    return program_spans.idle_ms(ctx, "train.step", outside=(FLAG,))
