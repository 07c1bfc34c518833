"""A kernel's share of its roofline over a traced window: the sum of each
launch's bound, the larger of its operations over the peak its counts name
(`PEAK` in benchmark/counts/<kernel>.py, a name in harness/peaks.py) and
its bytes over the HBM peak, over the
sum of its launches' device time."""
import re


def share(ctx, counts, pattern: str):
    """Percent, or None where the trace holds no launch of the kernel, or
    not as many as the counts expect (another routing than the counts')."""
    per_step = counts.launches(ctx.records)
    rx = re.compile(pattern)
    durations = [d for name, _, d in ctx.trace.device_ops if rx.search(name)]
    if not durations or not per_step or len(durations) != len(per_step) * ctx.steps:
        return None
    pk = ctx.peaks
    peak = getattr(pk, counts.PEAK)
    bound = sum(max(counts.ops(r) / peak, counts.bytes_moved(r) / pk.HBM_BYTES)
                for r in per_step) * ctx.steps
    return 100.0 * bound / sum(durations)
