"""Host batching with threaded decode, and the copy of batches to the
device ahead of the step, as in the JAX package's data/loader.py.

`DataLoader` shuffles with np.random.default_rng(seed), so a port run and a
JAX run on one dataset see the same batches. `prefetch_to_device` replaces
the JAX package's device_put lookahead: each batch is copied into pinned
host memory and sent with a non_blocking copy `size` batches ahead of the
step that reads it.
"""
import collections
import concurrent.futures as cf
import itertools
import math
from typing import Any, Callable, Iterator, Optional, Union

import numpy as np
import torch


class DataLoader:
    """Map-style loader: shuffle, batch, collate, threaded item loads.

    pad_last="wrap" fills the final partial batch with samples wrapped from
    the epoch's start, so every batch has one shape; the padding rows are
    always the trailing rows of the final batch. drop_last leaves the final
    partial batch out instead.
    """

    def __init__(self, dataset: Any, batch_size: int, shuffle: bool = False,
                 collate_fn: Optional[Callable] = None, num_workers: int = 8,
                 pad_last: str = "none", seed: int = 0, drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.collate_fn = collate_fn or getattr(dataset, "collate_fn")
        self.num_workers = max(1, num_workers)
        self.pad_last = pad_last
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset) / self.batch_size
        if self.pad_last == "wrap":
            return max(1, math.ceil(n))
        return math.floor(n) if self.drop_last else math.ceil(n)

    def __iter__(self) -> Iterator:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        if self.pad_last == "wrap":
            need = len(self) * self.batch_size
            if need > order.size:
                order = np.concatenate([order, np.resize(order, need - order.size)])
        n_batches = len(self)
        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = collections.deque()

            def submit(batch_idx):
                idxs = order[batch_idx * self.batch_size:(batch_idx + 1) * self.batch_size]
                pending.append([pool.submit(self.dataset.__getitem__, int(i)) for i in idxs])

            ahead = 2  # batches decoded ahead of consumption
            for i in range(min(ahead, n_batches)):
                submit(i)
            for i in range(n_batches):
                if i + ahead < n_batches:
                    submit(i + ahead)
                yield self.collate_fn([f.result() for f in pending.popleft()])


def prefetch_to_device(iterator: Iterator, device: Union[str, torch.device],
                       size: int = 2) -> Iterator:
    """Tuples of numpy arrays -> tuples of tensors on `device`, copied `size`
    batches ahead. On cuda the copies come from pinned memory and do not
    block the host; on the CPU the arrays are wrapped without a copy."""
    dev = torch.device(device)

    def put(batch):
        out = []
        for x in batch:
            t = torch.from_numpy(np.ascontiguousarray(x))
            if dev.type == "cuda":
                t = t.pin_memory().to(dev, non_blocking=True)
            out.append(t)
        return tuple(out)

    it = iter(iterator)
    queue = collections.deque(put(b) for b in itertools.islice(it, size))
    for batch in it:
        queue.append(put(batch))
        yield queue.popleft()
    while queue:
        yield queue.popleft()
