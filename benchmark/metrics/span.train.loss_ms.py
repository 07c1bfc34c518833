"""span.train.loss_ms: device time of the program's span `train.loss` (the
f32 softmax cross entropy over 256 classes at every pixel, and its mean) in
a `train.step`, the mean over the traced window."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "train.loss", "train.step")
