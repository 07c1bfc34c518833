"""span.ddp.sync_ms: device time of the program's span `train.sync`
(`train/base._sync_train_step`: the all-reduce of the gradients and
BatchNorm statistics and that of the metrics, with the copies around them,
and each one's wait for the slowest rank) in a `train.step` on rank 0, the
mean over the traced window."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "train.sync", "train.step")
