"""span.serve.heatmap_ms: device time of the program's span `tracknet.heatmap`
(`heatmap_from_logits`: the 256-way argmax and the antialiased resize to the
original size) in a `serve.batch`, the mean over the traced window. With
span.serve.decode_ms it splits serve.tail_ms."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "tracknet.heatmap", "serve.batch")
