"""span.serve.encoder_ms: device time of the program's span `tracknet.encoder`
(`models/tracknet.TrackNet.forward`: the channel padding of the frame stack
and the encoder) in a `serve.batch`, the mean over the traced window. With
span.serve.decoder_ms it splits serve.forward_ms."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "tracknet.encoder", "serve.batch")
