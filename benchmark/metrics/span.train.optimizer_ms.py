"""span.train.optimizer_ms: device time of the program's span
`train.optimizer` (`optimizer.step()`) in a `train.step`, the mean over the
traced window: the inside counterpart of train.optimizer_ms."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "train.optimizer", "train.step")
