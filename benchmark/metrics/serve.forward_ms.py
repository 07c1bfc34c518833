"""serve.forward_ms: device time of the model's forward a batch (the
task's CUDA events at the network's input and output; TrackNet: the
encoder's input and the decoder's output), the mean over the traced
window."""
import statistics


def read(ctx):
    ms = ctx.spans.get("forward")
    return statistics.fmean(ms) if ms else None
