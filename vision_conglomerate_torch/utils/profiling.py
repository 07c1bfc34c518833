"""Step timing and torch.profiler traces for the trainers.

- `trace(logdir)`: torch.profiler over the enclosed block, written to
  logdir as a Chrome trace (`trace.json`) and a table of device time by op
  (`ops.txt`); a no-op when logdir is empty;
- `StepTimer`: wall-clock and images/s accounting for a loop.
"""
import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    sort = "cuda_time_total" if torch.cuda.is_available() else "cpu_time_total"
    with open(os.path.join(logdir, "ops.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=40))


class StepTimer:
    """Accumulates wall time and sample counts -> images/s."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self._images = 0

    def tick(self, n_images: int):
        self._images += int(n_images)

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def images_per_sec(self) -> float:
        el = self.elapsed
        return self._images / el if el > 0 else 0.0
