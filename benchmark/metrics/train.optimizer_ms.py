"""train.optimizer_ms: device time of the optimizer's step (CUDA events
from the optimizer's step pre- and post-hooks), the mean a step."""
import statistics


def read(ctx):
    ms = ctx.spans.get("optimizer")
    return statistics.fmean(ms) if ms else None
