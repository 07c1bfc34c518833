"""span.serve.decoder_ms: device time of the program's span `tracknet.decoder`
(the decoder: its upsampling, concatenations and convs, to the logits) in a
`serve.batch`, the mean over the traced window."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "tracknet.decoder", "serve.batch")
