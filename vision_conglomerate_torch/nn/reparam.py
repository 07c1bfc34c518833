"""Deploy-form transforms over a port state_dict.

The JAX package's nn/reparam.py, over the port's state (a flat state_dict)
instead of flax (params, batch_stats) trees:

- `fold_conv_bn_params`: every ConvBNorm's (and ConvTransposeBNorm's)
  BatchNorm folds into its conv, w' = w * gamma/std, b' = (b - mean) *
  gamma/std + beta, std = sqrt(var + eps), scaling the weight's output
  channels: dim 0 of a conv's (O, I, kh, kw), dim 1 of a transpose conv's
  (I, O, kh, kw). The result loads into modules built with `folded=True`.
- `reparameterize_params`: every canonical RepVGG block (3x3 conv-BN, 1x1
  conv-BN, optional identity BN) fuses into one 3x3 `conv_reparam`; the 1x1
  kernel and the identity are zero-padded to 3x3. The result loads into
  modules built with `deploy=True`.
- `deploy_transform`: both, in that order.

All arithmetic is f32 on the CPU; the returned tensors are new.
"""
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5

State = Dict[str, torch.Tensor]


def _fold(weight: torch.Tensor, bias, state: State, bn: str,
          out_dim: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold BatchNorm `bn` (a key prefix) into a conv weight whose output
    channels are dim `out_dim` (0 for OIHW, 1 for a transpose conv's IOHW)."""
    gamma = state[f"{bn}.weight"].float()
    beta = state[f"{bn}.bias"].float()
    mean = state[f"{bn}.running_mean"].float()
    scale = gamma / torch.sqrt(state[f"{bn}.running_var"].float() + BN_EPS)
    if bias is None:
        bias = torch.zeros_like(mean)
    shape = [1, 1, 1, 1]
    shape[out_dim] = -1
    return weight.float() * scale.view(shape), (bias.float() - mean) * scale + beta


def _key(prefix: str, rest: str) -> str:
    return f"{prefix}.{rest}" if prefix else rest


def _prefixes(state: State, suffix: str):
    """Module prefixes P with a key `P.suffix` ("" for a bare module)."""
    return sorted(k[:-len(suffix) - 1] if k != suffix else ""
                  for k in state if k == suffix or k.endswith("." + suffix))


def _drop(state: State, prefix: str) -> State:
    return {k: v for k, v in state.items() if not k.startswith(prefix + ".")}


def fold_conv_bn_params(state: State) -> State:
    """Fold each `P.norm` BatchNorm into `P.conv` (every ConvBNorm: all are
    batchnorm-first) or `P.conv_transpose` (ConvTransposeBNorm). Other
    entries pass through."""
    out = dict(state)
    for p in _prefixes(state, "norm.running_mean"):
        for name, out_dim in (("conv", 0), ("conv_transpose", 1)):
            conv = _key(p, name)
            if f"{conv}.weight" in state:
                break
        else:
            continue
        w, b = _fold(state[f"{conv}.weight"], state.get(f"{conv}.bias"), state, _key(p, "norm"),
                     out_dim)
        out = _drop(out, _key(p, "norm"))
        out[f"{conv}.weight"] = w
        out[f"{conv}.bias"] = b
    return out


def _fuse_repvgg(state: State, p: str) -> Tuple[torch.Tensor, torch.Tensor]:
    w3, b3 = _fold(state[_key(p, "conv3x3.conv.weight")], None, state, _key(p, "conv3x3.norm"))
    w1, b1 = _fold(state[_key(p, "conv1x1.conv.weight")], None, state, _key(p, "conv1x1.norm"))
    w = w3 + F.pad(w1, (1, 1, 1, 1))
    b = b3 + b1
    if _key(p, "identity.running_mean") in state:
        cin = w3.shape[1]
        eye = torch.eye(cin, dtype=torch.float32)[:, :, None, None]
        wi, bi = _fold(eye, None, state, _key(p, "identity"))
        w = w + F.pad(wi, (1, 1, 1, 1))
        b = b + bi
    return w, b


def reparameterize_params(state: State) -> State:
    """Fuse each RepVGG block `P` (keys under `P.conv3x3`, `P.conv1x1` and
    `P.identity`) into `P.conv_reparam.{weight,bias}`. Only valid for
    canonical blocks (no branch activation)."""
    out = dict(state)
    for p in _prefixes(state, "conv3x3.conv.weight"):
        if _key(p, "conv1x1.conv.weight") not in state:
            continue
        w, b = _fuse_repvgg(state, p)
        for branch in ("conv3x3", "conv1x1", "identity"):
            out = _drop(out, _key(p, branch))
        out[_key(p, "conv_reparam.weight")] = w
        out[_key(p, "conv_reparam.bias")] = b
    return out


def deploy_transform(state: State, fuse_repvgg: bool = True) -> State:
    """Serving transform: RepVGG fusion (canonical blocks only, for modules
    built with deploy=True), then conv-BN folding of everything else (for
    modules built with folded=True)."""
    if fuse_repvgg:
        state = reparameterize_params(state)
    return fold_conv_bn_params(state)
