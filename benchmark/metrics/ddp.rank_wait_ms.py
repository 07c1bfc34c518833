"""ddp.rank_wait_ms: the wait for the slowest rank in a step's data-parallel
sync. Each rank's span `train.sync` lasts from its own arrival to the end
of the all-reduces; the last rank to arrive waits about nothing, so its
time is the transfer. A step's wait is the mean of the ranks' sync device
times less the least; the metric is the mean over the traced window's
steps. The ranks' records are gathered to every rank while the group is
up (harness/program_spans.rank_records)."""
import statistics

from benchmark.harness import program_spans


def read(ctx):
    ranks = program_spans.rank_records(ctx)
    if not ranks or len(ranks) < 2:
        return None
    syncs = [program_spans.device_ms(recs, "train.sync", "train.step") for recs in ranks]
    if not all(syncs) or len({len(s) for s in syncs}) != 1:
        return None
    return statistics.fmean(statistics.fmean(d) - min(d) for d in zip(*syncs))
