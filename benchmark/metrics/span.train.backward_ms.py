"""span.train.backward_ms: device time of the program's span `train.backward`
(`zero_grad` and `loss.backward()`) in a `train.step`, the mean over the
traced window."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "train.backward", "train.step")
