"""Spans, step timing and torch.profiler traces for the port.

- `span(name)`: a named range at a layer boundary (`serve.batch`,
  `tracknet.encoder`, `train.step`, ...). Off, it returns one shared no-op
  context: no allocation, no profiler call, no CUDA call. It is on while
  `collect(True)` holds, inside `trace(logdir)`, and while a torch.profiler
  session records, so any profile of the port carries its spans without a
  switch of its own. On, it opens the profiler range `vct.<name>` on the
  host timeline (the trace then puts an idle gap inside it down to it) and
  records the span's name, the name of the span enclosing it on this
  thread, its step (each root span starts the next step; a root opened on
  another thread while a step is open joins that step), its host start
  and end (`time.perf_counter_ns`) and, once CUDA is in use, a pair of
  CUDA events on the current stream.
- `span_records()` and `span_ms()` read the records of the latest
  collection (a new one starts afresh; the records stay until then).
- `trace(logdir)`: torch.profiler over the enclosed block, written to
  logdir as a Chrome trace (`trace.json`) and a table of device time by op
  (`ops.txt`); a no-op when logdir is empty;
- `StepTimer`: wall-clock and images/s accounting for a loop.
"""
import contextlib
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


class _Record:
    __slots__ = ("name", "parent", "step", "host_start_ns", "host_end_ns", "start", "end")

    def __init__(self, name: str):
        self.name = name
        self.parent: Optional[str] = None
        self.step = 0
        self.host_start_ns = self.host_end_ns = None
        self.start = self.end = None  # CUDA events


class _Collector:
    """Process-wide state of the spans: the switch, the records of the
    latest collection and the step counter."""

    def __init__(self):
        self.on = False          # collect(True)
        self.session = False     # a collection is open (reset when a span finds it off)
        self.records: List[_Record] = []
        self.step = 0
        self.open_step: Optional[int] = None  # the step whose root span is open
        self.lock = threading.Lock()
        self.local = threading.local()

    def clear(self, session: bool) -> None:
        """Drop the records; `session`: a new collection starts."""
        with self.lock:
            self.records = []
            self.step = 0
            self.open_step = None
            self.session = session


_STATE = _Collector()


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("rec", "range", "root")

    def __init__(self, name: str):
        self.rec = _Record(name)

    def __enter__(self):
        st = _STATE
        if not st.session:
            st.clear(session=True)
        stack = getattr(st.local, "stack", None)
        if stack is None:
            stack = st.local.stack = []
        rec = self.rec
        self.root = False
        if stack:
            rec.parent, rec.step = stack[-1].name, stack[-1].step
        else:
            with st.lock:
                if st.open_step is None:
                    st.step += 1
                    st.open_step = st.step
                    self.root = True
                rec.step = st.open_step
        st.records.append(rec)
        stack.append(rec)
        # a function-scoped range: a user-scoped one (`record_function`) is
        # mirrored in the CUDA trace by an annotation spanning the range's
        # kernels and the gaps between them, which a trace's busy time counts
        self.range = torch._C._profiler._RecordFunctionFast("vct." + rec.name)
        self.range.__enter__()
        if torch.cuda.is_initialized():
            rec.start = torch.cuda.Event(enable_timing=True)
            rec.start.record()
        rec.host_start_ns = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        rec = self.rec
        if rec.start is not None:
            rec.end = torch.cuda.Event(enable_timing=True)
            rec.end.record()
        rec.host_end_ns = time.perf_counter_ns()
        self.range.__exit__(*exc)
        _STATE.local.stack.pop()
        if self.root:
            with _STATE.lock:
                _STATE.open_step = None
        return False


def span(name: str):
    """The context of span `name` (see the module's docstring)."""
    if _STATE.on or _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    if _STATE.session:
        _STATE.session = False
    return _NULL


def collect(on: bool) -> None:
    """Turn the spans on (a new collection: the records start afresh) or
    off (the records stay until read)."""
    if on and not _STATE.on:
        _STATE.clear(session=True)
    _STATE.on = bool(on)


def span_records() -> List[Dict[str, Any]]:
    """The records of the latest collection, in the order the spans were
    opened: name, parent, step, host start and end (ns) and `host_ms`, and
    `device_ms` (None without CUDA events). Synchronises once."""
    recs = [r for r in _STATE.records if r.host_end_ns is not None]
    if any(r.start is not None for r in recs):
        torch.cuda.synchronize()
    return [{"name": r.name, "parent": r.parent, "step": r.step,
             "host_start_ns": r.host_start_ns, "host_end_ns": r.host_end_ns,
             "host_ms": (r.host_end_ns - r.host_start_ns) / 1e6,
             "device_ms": r.start.elapsed_time(r.end) if r.start is not None else None}
            for r in recs]


def span_ms() -> Dict[str, List[float]]:
    """{span name: [ms of each occurrence]}: device time where the span has
    CUDA events, host time where not (the CPU)."""
    out: Dict[str, List[float]] = {}
    for r in span_records():
        ms = r["device_ms"] if r["device_ms"] is not None else r["host_ms"]
        out.setdefault(r["name"], []).append(ms)
    return out


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    collect(True)
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        collect(False)
        _STATE.clear(session=False)  # the spans are in the trace; no record is kept
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
