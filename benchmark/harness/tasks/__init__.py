"""The drivers of the timed path, one module per configuration `task`."""
import importlib
from collections import deque

import torch


def make_job(cell, seed: int, device, **opts):
    module = importlib.import_module(f"{__name__}.{cell.config['task']}")
    return module.make_job(cell.traffic["mode"], cell, seed, device, **opts)


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
