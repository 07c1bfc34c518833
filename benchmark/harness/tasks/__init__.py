"""The drivers of the timed path, one module per configuration `task`
(`benchmark/harness/tasks/<task>.py`), found by the task's name. A task
module gives `make_job(mode, cell, seed, device, **opts)` (harness/jobs.py
says what a job is) and `calibration(cell)`, what benchmark/calibrate.py
reads for a cell of the task: its control, witness and faults."""
import importlib
from collections import deque
from types import ModuleType

import torch


def task_module(cell) -> ModuleType:
    return importlib.import_module(f"{__name__}.{cell.config['task']}")


def make_job(cell, seed: int, device, **opts):
    return task_module(cell).make_job(cell.traffic["mode"], cell, seed, device, **opts)


def calibration(cell):
    return task_module(cell).calibration(cell)


def stop_agreement(device):
    """`agree(due) -> stop`: on one process, stop once due; across ranks,
    every rank stops after the same step: each step all-reduces its `due`
    flag (max) and reads the flag of two steps before, so the host never
    waits on the step it has just enqueued."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return lambda due: due
    flags = deque()

    def agree(due: bool) -> bool:
        f = torch.tensor([1.0 if due else 0.0], device=device)
        dist.all_reduce(f, op=dist.ReduceOp.MAX)
        flags.append(f)
        return len(flags) > 2 and bool(flags.popleft().item())

    return agree
