"""Checkpoint manifests in the JAX package's pickled format.

A manifest is a dict {LAST_EPOCH, NETWORK_PARAMS, NUM_CLASSES, ...} whose
NETWORK_PARAMS is the flax variables tree {"params": ..., "batch_stats":
...} of numpy arrays, pickled. Files written by either package load in the
other; reading needs numpy only. `weights.flax_to_state_dict` and
`weights.state_dict_to_flax` convert NETWORK_PARAMS to and from a port
`state_dict`. The JAX package's orbax format is not read here.
"""
import os
import pickle
from typing import Any, Dict

import numpy as np
import torch


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, np.ndarray):
        return tree
    return tree


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
    path = resolve_checkpoint_path(path)
    with open(path, "rb") as f:
        return pickle.load(f)
