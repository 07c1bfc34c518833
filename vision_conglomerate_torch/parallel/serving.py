"""Data-parallel serving, the JAX package's parallel/serving.py in
PyTorch.

Each rank of the process group serves its shard of the request batch
(rows [r B/n, (r+1) B/n)) with its own copy of the net, and the outputs
are gathered back into the whole batch's, in order, on every rank. No
other communication: the images are independent. On one process (or a
world of one) the wrapper calls the serve function on the whole batch.

    serve = make_dp_serve(fn)   # fn: (B, ...) tensor -> tensors (or tuples,
    out = serve(batch)          # NamedTuples, dicts of them) with B rows
"""
from typing import Callable

from .mesh import gather_tree, is_distributed, shard_batch, world_size


def make_dp_serve(fn: Callable) -> Callable:
    """Wrap a one-device serve function into a batch-sharded one. `fn` must
    take any batch size (true of the serve paths here) and return tensors
    whose axis 0 is the batch's."""

    def serve(batch):
        n = world_size()
        if batch.shape[0] % n != 0:
            raise ValueError(
                f"batch axis ({batch.shape[0]}) must be divisible by the number of "
                f"data-parallel processes ({n}) for data-parallel serving")
        if not is_distributed():
            return fn(batch)
        return gather_tree(fn(shard_batch(batch)))

    return serve
