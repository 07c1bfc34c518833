"""ddp.optimizer_ms: train.optimizer_ms, read in the data-parallel cell, where it moves
ddp_train_img_per_s (rank 0's trace and spans)."""
from benchmark.harness.spec import load_module


def read(ctx):
    return load_module("metrics", "train.optimizer_ms", ctx.cell.root).read(ctx)
