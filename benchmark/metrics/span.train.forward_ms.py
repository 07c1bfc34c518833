"""span.train.forward_ms: device time of the program's span `train.forward`
(`train/tracknet_trainer.train_step`: the uint8 frames to NCHW floats and
the train-mode forward) in a `train.step`, the mean over the traced window."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "train.forward", "train.step")
