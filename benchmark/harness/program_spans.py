"""The program's own spans, for the metrics that read them.

The port records a span at each of its layer boundaries
(`vision_conglomerate_torch.utils.profiling.span`: `serve.batch`,
`tracknet.encoder`, `train.step`, `train.sync`, ...) while a torch.profiler
session records, so the traced window of a `--trace 1` run collects them
with no switch of the harness's own, and the records stay in the program
until the readers have read them. Beside the benchmark's own spans
(`ctx.spans`, CUDA events from hooks around the port's calls), a reader
gets the program's here:

- `records(ctx)`: this process's records of the traced window, dicts with
  `name`, `parent`, `step` (shared by a root span and the spans inside
  it), `host_ms` and `device_ms` (CUDA events; None on the CPU);
- `rank_records(ctx)`: every rank's records, in rank order, gathered to
  each rank while the process group is up (readers run on every rank, in
  one order, so each rank's call of this meets the others');
- `mean_ms(...)`, `idle_ms(...)`: what the readers compute from them.

A context that carries `program_spans` (and `rank_program_spans`) is read
in place of the program, as the tests' synthetic contexts do. Each
returns None where there is nothing to read: a program without spans (an
older parent), records that do not cover the window's steps, the CPU.
"""
import statistics
from typing import Any, Dict, Iterable, List, Optional

Records = List[Dict[str, Any]]


def records(ctx) -> Optional[Records]:
    recs = getattr(ctx, "program_spans", None)
    if recs is None:
        try:
            from vision_conglomerate_torch.utils import profiling
        except ImportError:
            return None
        read = getattr(profiling, "span_records", None)
        if read is None:
            return None
        recs = read()
    # the window's records: one root step for each step the window ran
    if not recs or len({r["step"] for r in recs}) != ctx.steps:
        return None
    return recs


def rank_records(ctx) -> Optional[List[Records]]:
    ranks = getattr(ctx, "rank_program_spans", None)
    if ranks is not None:
        return ranks
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    mine = records(ctx)
    keep = None if mine is None else [{k: r[k] for k in ("name", "parent", "step", "device_ms")}
                                      for r in mine]
    gathered: List[Optional[Records]] = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, keep)
    return None if any(g is None for g in gathered) else gathered


def _roots(recs: Records) -> Dict[int, str]:
    return {r["step"]: r["name"] for r in recs if r["parent"] is None}


def device_ms(recs: Records, name: str, root: str) -> List[float]:
    """Device ms of each `name` span in a step of root span `root`, in
    order; empty where a span has no device time."""
    roots = _roots(recs)
    out = [r["device_ms"] for r in recs if r["name"] == name and roots.get(r["step"]) == root]
    return out if all(v is not None for v in out) else []


def mean_ms(ctx, name: str, root: str) -> Optional[float]:
    """The mean device ms of span `name` in the window's `root` steps."""
    recs = records(ctx)
    ms = device_ms(recs, name, root) if recs else []
    return statistics.fmean(ms) if ms else None


def _union_s(intervals: Iterable) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def idle_ms(ctx, root: str, outside: Iterable[str] = ()) -> Optional[float]:
    """Device idle ms a step inside the root span `root`: the device time
    from each root span's start event to its end event, less the busy
    union of the trace's device operations that ran inside them, the mean
    over the roots. Every device operation of the window is enqueued
    inside a root span, so runs between its events, except those whose
    names hold a string of `outside` (what the harness enqueues between
    steps), whose union is taken away. Gaps between root spans are not
    counted."""
    recs = records(ctx)
    ops = ctx.trace.device_ops
    if not recs or not ops:
        return None
    ms = [r["device_ms"] for r in recs if r["name"] == root and r["parent"] is None]
    if len(ms) != ctx.steps or any(v is None for v in ms):
        return None
    busy = _union_s((s, s + d) for _, s, d in ops)
    out = _union_s((s, s + d) for n, s, d in ops if any(o in n for o in outside))
    return (sum(ms) - 1e3 * (busy - out)) / len(ms)
