"""Weight bridge between the JAX package's flax variables and a port
`state_dict`.

The port's modules mirror the upstream torch attribute names, which the
flax tree also mirrors, so the mapping is a key rewrite plus layout
transposes (the rules of the JAX package's `tools/torch_port.py`, kept here
as the port's own copy):

- conv weight (O, I, kh, kw)          <-> kernel (kh, kw, I, O)
- `conv_transpose` weight (I, O, kh, kw) <-> kernel (kh, kw, I, O), flipped
  in both spatial dims: flax's ConvTranspose does not flip its kernel and
  torch's conv_transpose2d does (the JAX package's own
  `tools/torch_port.py` maps it without the flip)
- BatchNorm weight / bias             <-> params .../norm/BatchNorm_0/{scale, bias}
- BatchNorm running_mean / running_var <-> batch_stats .../BatchNorm_0/{mean, var}
- sequence index `name.i`             <-> `name_i`
- top-level `{sm,md,lg}_anchors`      <-> the same top-level params
- int8 form (`nn.quantize`): `P.q_kernel` int8 (O, I, kh, kw) <-> params
  .../P/q_kernel int8 (kh, kw, I, O); `P.q_wscale`, `P.q_xscale` (0-d) and
  `P.q_bias` <-> the same leaves at P, in f32

`state_dict_to_flax` feeds the JAX package's loaders (and its
`convert_torch_state_dict` gives the same tree from a port state_dict);
`flax_to_state_dict` is its inverse.
"""
from typing import Any, Dict, Iterable, Tuple

import numpy as np
import torch

# Port containers indexed like a list (nn.Sequential / nn.ModuleList): their
# children are `name.i` in a state_dict and `name_i` in flax. Every other
# `name_i` (e.g. the backbone's `c3_0`) is one attribute name in both.
SEQUENCES = frozenset({
    "head", "bottlenecks", "blocks", "conv_1_3_4",
    "regression_fmap_layer", "classification_fmap_layer", "mask_fmap_layer",
    "keypoints_fmap_layer",
})


def _to_np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _set(tree: Dict[str, Any], path: Iterable[str], value):
    path = list(path)
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def _flax_path(parts):
    """Merge each numeric segment into its parent: `blocks.0` -> `blocks_0`."""
    out = []
    for part in parts:
        if part.isdigit():
            out.append(f"{out.pop()}_{part}")
        else:
            out.append(part)
    return out


def _flip_hw(kernel: np.ndarray) -> np.ndarray:
    """A (kh, kw, ...) kernel flipped in both spatial dims (a copy)."""
    return np.ascontiguousarray(kernel[::-1, ::-1])


def state_dict_to_flax(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """A port state_dict -> {"params": ..., "batch_stats": ...} of numpy
    arrays, the JAX package's variables tree."""
    modules: Dict[Tuple[str, ...], Dict[str, np.ndarray]] = {}
    for key, val in state_dict.items():
        parts = key.split(".")
        if parts[-1] == "num_batches_tracked":
            continue
        modules.setdefault(tuple(_flax_path(parts[:-1])), {})[parts[-1]] = _to_np(val)

    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    for path, leaves in modules.items():
        if "running_mean" in leaves:  # BatchNorm
            base = path + ("BatchNorm_0",)
            _set(params, base + ("scale",), leaves["weight"])
            _set(params, base + ("bias",), leaves["bias"])
            _set(batch_stats, base + ("mean",), leaves["running_mean"])
            _set(batch_stats, base + ("var",), leaves["running_var"])
        elif "q_kernel" in leaves:  # a conv module in its int8 form
            for leaf, val in leaves.items():
                _set(params, path + (leaf,),
                     val.transpose(2, 3, 1, 0) if leaf == "q_kernel" else val)
        elif not path:  # top-level parameters (anchors)
            for leaf, val in leaves.items():
                _set(params, (leaf,), val)
        elif path[-1] == "conv_transpose":  # ConvTranspose2d
            _set(params, path + ("kernel",), _flip_hw(leaves["weight"].transpose(2, 3, 0, 1)))
            if "bias" in leaves:
                _set(params, path + ("bias",), leaves["bias"])
        else:  # Conv2d
            _set(params, path + ("kernel",), leaves["weight"].transpose(2, 3, 1, 0))
            if "bias" in leaves:
                _set(params, path + ("bias",), leaves["bias"])
    variables = {"params": params}
    if batch_stats:
        variables["batch_stats"] = batch_stats
    return variables


def _torch_key(path: Tuple[str, ...]) -> str:
    """Split `name_i` back into `name.i` for the port's sequence containers."""
    out = []
    for seg in path:
        head, sep, tail = seg.rpartition("_")
        if sep and tail.isdigit() and head in SEQUENCES:
            out += [head, tail]
        else:
            out.append(seg)
    return ".".join(out)


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for key, val in tree.items():
        if hasattr(val, "items"):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def flax_to_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """{"params": ..., "batch_stats": ...} of numpy (or array-like) leaves ->
    a port state_dict of f32 CPU tensors (an int8 form's q_kernel stays
    int8). BatchNorm modules get a `num_batches_tracked` of 0."""
    state: Dict[str, torch.Tensor] = {}

    def put(key: str, arr):
        state[key] = torch.from_numpy(np.array(_to_np(arr), dtype=np.float32))

    for path, val in _leaves(variables.get("params", {})):
        mod, leaf = path[:-1], path[-1]
        if mod and mod[-1] == "BatchNorm_0":
            base = _torch_key(mod[:-1])
            put(f"{base}.{'weight' if leaf == 'scale' else 'bias'}", val)
            state[f"{base}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        elif leaf == "kernel" and mod and mod[-1] == "conv_transpose":  # ConvTranspose2d
            put(f"{_torch_key(mod)}.weight", _flip_hw(np.asarray(val)).transpose(2, 3, 0, 1))
        elif leaf == "kernel":  # Conv2d
            put(f"{_torch_key(mod)}.weight", np.asarray(val).transpose(3, 2, 0, 1))
        elif leaf == "q_kernel":  # int8 conv (HWIO -> OIHW)
            state[_torch_key(path)] = torch.from_numpy(
                np.array(_to_np(val), dtype=np.int8).transpose(3, 2, 0, 1).copy())
        else:
            put(_torch_key(path), val)
    for path, val in _leaves(variables.get("batch_stats", {})):
        base = _torch_key(path[:-2])  # .../BatchNorm_0/{mean,var}
        put(f"{base}.running_{path[-1]}", val)
    return state
