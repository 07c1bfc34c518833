"""span.ddp.optimizer_ms: span.train.optimizer_ms, read in the data-parallel
cell (rank 0): the inside counterpart of ddp.optimizer_ms."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "train.optimizer", "train.step")
