"""Data parallelism over processes, the JAX package's parallel/mesh.py in
PyTorch: one process per device, in one process group (NCCL on CUDA, gloo
on the CPU), launched by torchrun or started here as a world of one.

The JAX package shards the global batch over a 1-D 'dp' mesh and keeps
params and optimizer state replicated. Here:
- the global batch (`--batch_size`) is cut on axis 0: rank r of n takes
  rows [r B/n, (r+1) B/n) (`shard_batch`; `data.loader.DataLoader(shard=
  True)` decodes only those rows of each global batch, in the same order
  on every rank);
- `lax.pmean(grads)` is one all-reduce of the flattened gradients, summed
  and divided by n, after the backward and before the optimizer step;
- BatchNorm normalises with each shard's own batch statistics, and the
  updated running statistics are averaged after the step, as
  `pmean(new_bs)` does (not rank 0's copied to the others);
- metrics are averaged, and sum-type metrics summed (the trainers'
  `_combine_metrics`);
- anchors computed once on host process 0 are computed on rank 0 and
  broadcast (`broadcast_object`);
- `process_index() == 0` gating is `process_is_primary()`.

There is no DistributedDataParallel wrapper: its buffer broadcast would
copy rank 0's BatchNorm statistics over the others' at every forward
instead of averaging them, and the detached anchors would be unused
parameters. The trainers call `all_reduce_sum_` themselves. Every
function here works without a process group, as a world of one.
"""
import os
import socket
from typing import Any, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_is_primary() -> bool:
    """Rank 0 writes the artifacts (config copies, checkpoints, CSVs,
    plots); the other ranks write nothing."""
    return rank() == 0


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def maybe_initialize_distributed(device: str = "cuda", seed: int = 42) -> torch.device:
    """Join the process group (once) and return this rank's device.

    Under torchrun the group comes from RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR and MASTER_PORT; without them this process starts a world
    of one on a free local port, so one card runs through the same code.
    The backend is NCCL for `cuda` (device cuda:LOCAL_RANK) and gloo for
    the CPU. Every rank seeds torch's global generators with one `seed`:
    the JAX shards share one key for dropout and flips, so the ranks draw
    one stream too."""
    dev = resolve_device(device)
    env = os.environ
    if not is_distributed():
        if "RANK" in env and "WORLD_SIZE" in env:
            addr, port = env.get("MASTER_ADDR", "localhost"), env.get("MASTER_PORT", "29500")
            r, n = int(env["RANK"]), int(env["WORLD_SIZE"])
        else:
            addr, port, r, n = "localhost", str(_free_port()), 0, 1
        if dev.type == "cuda":
            torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"tcp://{addr}:{port}", rank=r, world_size=n)
        torch.manual_seed(seed)
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def shutdown_distributed():
    if is_distributed():
        dist.destroy_process_group()


def shard_batch(tree: Any) -> Any:
    """This rank's rows [r B/n, (r+1) B/n) of every array or tensor leaf of
    a tuple, list or dict (the global batch on axis 0). ValueError when B is
    not divisible by the world size n."""
    n, r = world_size(), rank()

    def cut(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch axis ({b}) must be divisible by the number of "
                             f"data-parallel processes ({n})")
        return x[r * (b // n):(r + 1) * (b // n)]

    return _map(cut, tree)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    return tree


def _flat_collective(tensors: Sequence[torch.Tensor], collective, scale: float = 1.0):
    """Run `collective` in place on one buffer per dtype and device that
    holds the tensors flattened, times `scale`, then copy the result back
    into them: three kernels and one collective for any number of tensors
    (a kernel a tensor would cost a step more host time than the
    all-reduce)."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        collective(flat)
        if scale != 1.0:
            flat.mul_(scale)
        parts = flat.split([t.numel() for t in ts])
        torch._foreach_copy_(ts, [f.view(t.shape) for f, t in zip(parts, ts)])


def all_reduce_sum_(tensors: Sequence[torch.Tensor], scale: float = 1.0):
    """Sum each tensor over the group, times `scale` (1 / world_size() for
    the mean), in place: one all-reduce per dtype and device, of the
    tensors flattened into one buffer."""
    if is_distributed():
        _flat_collective(tensors, dist.all_reduce, scale)


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` (one shape on all ranks) concatenated on axis 0 in
    rank order: the global batch's rows from the shards."""
    if not is_distributed():
        return t
    x = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()  # gloo has no bool
    parts: List[torch.Tensor] = [torch.empty_like(x) for _ in range(world_size())]
    dist.all_gather(parts, x)
    return torch.cat(parts).to(t.dtype)


def gather_tree(tree: Any) -> Any:
    """`all_gather_rows` of every tensor leaf of a tuple, list, NamedTuple
    or dict."""
    return _map(lambda x: all_gather_rows(x) if isinstance(x, torch.Tensor) else x, tree)


def broadcast_object(obj: Any) -> Any:
    """Rank 0's `obj` (any picklable value) on every rank."""
    if not is_distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def broadcast_module_(module: torch.nn.Module):
    """Rank 0's parameters and buffers copied into every rank's module, as
    DistributedDataParallel does when it wraps one."""
    if is_distributed():
        with torch.no_grad():
            _flat_collective([t.data for t in list(module.parameters()) + list(module.buffers())],
                             lambda flat: dist.broadcast(flat, src=0))


def batchnorm_statistics(module: torch.nn.Module) -> List[torch.Tensor]:
    """The running mean and variance of every BatchNorm in `module`."""
    return [t for m in module.modules()
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm) and m.track_running_stats
            for t in (m.running_mean, m.running_var)]
