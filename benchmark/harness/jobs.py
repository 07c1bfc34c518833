"""What the tasks share: the job protocol, sampling and the optimizer
readings.

A task module (`benchmark/harness/tasks/<task>.py`, named by a
configuration's `task`) gives `calibration(cell)` (harness/tasks/__init__.py)
and `make_job(mode, cell, seed, device, **opts)` for each traffic `mode` it
serves ("serve" or "train"), returning an object with:
- `items_per_step`: images a step completes (on this rank);
- `step(i)`: one call of the timed path; a serve step returns when its
  results are on the host, a train step when it is enqueued;
- optionally `min_steps`: the fewest steps the window runs (a serve job's
  check samples its answers among the first `sample_steps`);
- `records`: the conv records of one step's forward at this rank's batch
  (the reference on the meta device), for the FLOP and byte counts;
- `spans(on)`: put (or take away) the benchmark's span hooks around the
  port's calls; `span_ms()`: {span: [ms per step]} since `spans(True)`;
- `release()`: free the program's state;
- `check()`: the numbers that decide `correct` (harness/compare.py).
"""
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def sample_rows(seed: int, steps: int, batch: int, count: int) -> List[Tuple[int, int]]:
    """`count` (step, row) pairs among the first `steps` steps, drawn from
    the seed: the rows spread over the batch, one from each of `count`
    equal strata (so every part of a batch is judged), each at a step of
    its own draw."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
    edges = [i * batch // count for i in range(count + 1)]
    rows = [int(rng.integers(lo, max(hi, lo + 1))) for lo, hi in zip(edges, edges[1:])]
    return sorted((int(rng.integers(0, steps)), r) for r in rows)


def first_grad_norms(optimizer: torch.optim.Optimizer, names: Dict[int, str]
                     ) -> Dict[str, float]:
    """Each leaf's gradient norm at the first step, from the optimizer's
    state after it: Adadelta's square_avg = (1 - rho) g^2, Adam's exp_avg =
    (1 - beta1) g, SGD's momentum_buffer = g."""
    out = {}
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if "square_avg" in st and "acc_delta" in st:
                g = torch.sqrt(st["square_avg"].double().sum() / (1.0 - group["rho"]))
            elif "exp_avg" in st:
                g = st["exp_avg"].double().norm() / (1.0 - group["betas"][0])
            elif "momentum_buffer" in st and st["momentum_buffer"] is not None:
                g = st["momentum_buffer"].double().norm()
            else:
                continue
            out[names[id(p)]] = float(g)
    return out


class SetupClock:
    """Seconds of each part of a job's set-up (the device synchronised at
    each lap), for PERF.md's account of `setup_s`."""

    def __init__(self, device: torch.device):
        self.device = device
        self.t = time.perf_counter()
        self.parts: Dict[str, float] = {}

    def lap(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.parts[name] = now - self.t
        self.t = now


class CudaSpans:
    """CUDA events recorded at named points of each step; `ms(a, b)` the
    device time between two points, per step."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.on = False
        self.marks: List[Dict[str, torch.cuda.Event]] = []

    def enable(self, on: bool):
        self.on = on and self.cuda
        self.marks = []

    def new_step(self):
        if self.on:
            self.marks.append({})

    def mark(self, name: str):
        if self.on and self.marks:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks[-1][name] = ev

    def ms(self, a: str, b: str) -> List[float]:
        if not self.marks:
            return []
        torch.cuda.synchronize()
        return [m[a].elapsed_time(m[b]) for m in self.marks if a in m and b in m]


def rebatch(records: List[tuple], batch: int) -> List[tuple]:
    """Conv records of a forward at another batch size."""
    return [(r[0], batch) + tuple(r[2:]) for r in records]


def forward_records(model: torch.nn.Module, inputs: Sequence[torch.Tensor]) -> List[tuple]:
    """Conv records of one forward of a reference model built on the meta
    device."""
    from ..reference.layers import conv_records

    with torch.no_grad(), conv_records() as records:
        model(*inputs)
    return list(records)
