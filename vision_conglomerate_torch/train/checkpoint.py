"""Checkpoint manifests in the JAX package's pickled format.

A manifest is a dict {LAST_EPOCH, NETWORK_PARAMS, NUM_CLASSES, ...} whose
NETWORK_PARAMS is the flax variables tree {"params": ..., "batch_stats":
...} of numpy arrays, pickled. Files written by either package load in the
other; reading needs numpy only. `weights.flax_to_state_dict` and
`weights.state_dict_to_flax` convert NETWORK_PARAMS to and from a port
`state_dict`. The JAX package's orbax format is not read here.

A JAX snapshot pickles its OPTIMIZER_PARAMS as optax named tuples. Loading
never imports optax, jax or flax: their classes come back as plain named
tuples of this module's making (`ForeignState`), which keep the class name
and the fields in order. A port snapshot keeps its torch optimizer state
under TORCH_OPTIMIZER_PARAMS (numpy leaves), a key the JAX package does not
read.
"""
import os
import pickle
from typing import Any, Dict

import numpy as np
import torch

FOREIGN_PACKAGES = ("jax", "jaxlib", "flax", "optax", "chex")


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def to_torch(tree: Any) -> Any:
    """numpy leaves of a nested dict/list/tuple -> CPU tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree))
    return tree


class ForeignState(tuple):
    """An instance of a pickled class of the JAX stack, as a tuple of its
    fields; `module` and the class name say what it was."""

    module = ""

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.split(".")[0] not in FOREIGN_PACKAGES:
            return super().find_class(module, name)
        if name == "FrozenDict":
            return dict
        return type(name, (ForeignState,), {"module": module})


def save_checkpoint(path: str, manifest: Dict[str, Any]):
    """Atomic write: serialize to <path>.tmp then rename."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(_to_numpy(manifest), f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def resolve_checkpoint_path(path: str) -> str:
    """A .ckpt.tar file, or the newest *.ckpt.tar under a directory."""
    if not os.path.isdir(path):
        return path
    cands = []
    for root, _dirs, files in os.walk(path):
        cands += [os.path.join(root, f) for f in files if f.endswith(".ckpt.tar")]
    if not cands:
        raise FileNotFoundError(
            f"Checkpoint path {path} is a directory with no *.ckpt.tar under it")
    return max(cands, key=os.path.getmtime)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a manifest. Unpickling runs code: load only checkpoints that
    this project wrote."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"Checkpoint path {path} does not exist")
    with open(resolve_checkpoint_path(path), "rb") as f:
        return _Unpickler(f).load()
