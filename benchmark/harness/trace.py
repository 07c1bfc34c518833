"""Reading the profiler's trace of the traced window.

From `torch.profiler` (CPU and CUDA activities): every device operation
(kernel, copy, fill) with its interval, the device time that each host op
launched itself (`self_device_time_total`), the union of the device
intervals (busy time), and the longest idle gaps, each named by the
innermost host op that was running at its middle.
"""
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from torch.autograd import DeviceType


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float, float]] = field(default_factory=list)  # name, start_s, dur_s
    op_self_device_s: Dict[str, float] = field(default_factory=dict)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, _, dur in self.device_ops:
            out[name] = out.get(name, 0.0) + dur
        return out


def _union(intervals: np.ndarray) -> np.ndarray:
    """Merged [start, end] rows of intervals sorted by start."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return np.asarray(merged, dtype=np.float64).reshape(-1, 2)


def summarize(prof, window_s: float, max_gaps: int = 10) -> TraceSummary:
    events = prof.events()
    dev, host = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            dev.append((e.name, tr.start, tr.end))
        elif e.device_type == DeviceType.CPU:
            host.append((e.name, tr.start, tr.end))
    us = 1e-6
    summary = TraceSummary(window_s=window_s, busy_s=0.0)
    summary.device_ops = [(n, s * us, (e - s) * us) for n, s, e in dev]
    for row in prof.key_averages():
        if row.device_type == DeviceType.CPU and row.self_device_time_total > 0:
            summary.op_self_device_s[row.key] = row.self_device_time_total * us
    if not dev:
        return summary
    iv = np.asarray(sorted((s, e) for _, s, e in dev), dtype=np.float64)
    busy = _union(iv)
    summary.busy_s = float((busy[:, 1] - busy[:, 0]).sum()) * us
    gaps = np.stack([busy[:-1, 1], busy[1:, 0]], axis=1) if len(busy) > 1 else np.zeros((0, 2))
    order = np.argsort(gaps[:, 0] - gaps[:, 1])[:200] if len(gaps) else []
    names = np.asarray([n for n, _, _ in host], dtype=object)
    hs = np.asarray([s for _, s, _ in host], dtype=np.float64)
    he = np.asarray([e for _, _, e in host], dtype=np.float64)
    by_name: Dict[str, float] = {}
    for i in order:
        a, b = gaps[i]
        mid = 0.5 * (a + b)
        cover = np.nonzero((hs <= mid) & (he >= mid))[0]
        name = "host: no op" if not len(cover) else \
            str(names[cover[np.argmin(he[cover] - hs[cover])]])
        by_name[name] = by_name.get(name, 0.0) + (b - a) * us
    summary.idle_gaps = sorted(by_name.items(), key=lambda kv: -kv[1])[:max_gaps]
    return summary


def breakdown(summary: TraceSummary, top: int = 10) -> Dict[str, list]:
    ops = sorted(summary.kernel_seconds().items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in summary.idle_gaps]}
