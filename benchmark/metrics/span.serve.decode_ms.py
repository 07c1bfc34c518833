"""span.serve.decode_ms: device time of the program's span `serve.decode`
(`infer/tracknet_runner.track_batch`: the centroid decode, the copy of the
tracks to the host and their NaN fill) in a `serve.batch`, the mean over the
traced window."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "serve.decode", "serve.batch")
