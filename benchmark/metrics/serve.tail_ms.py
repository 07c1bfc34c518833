"""serve.tail_ms: device time from the end of the network to the batch's
results on the host (TrackNet: the argmax heatmap, its resize and the
centroid decode), from the task's CUDA-event spans; the mean over the
traced window."""
import statistics


def read(ctx):
    ms = ctx.spans.get("tail")
    return statistics.fmean(ms) if ms else None
