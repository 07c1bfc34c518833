"""span.ddp.backward_ms: span.train.backward_ms, read in the data-parallel
cell (rank 0), where the backward also recomputes each conv (remat)."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "train.backward", "train.step")
