"""Zero channels in the serve form, so that every 3x3/s1 conv of a serve
path takes the conv kernels' vector path: Cin, and the producer's Cout, a
multiple of PAD = 16 values (16 bytes of int8, two 16-byte chunks of
bf16). A conv whose Cin is not a multiple of 8 (bf16) or 16 (int8) takes
the kernels' synchronous element path instead (csrc/igemm_sm90.cuh), and
a Cout that is not a multiple of 8 loses the 16-byte stores.

The port's nets have three such places, each padded at its producer:
- TrackNet base's `dec_7` -> `dec_8` (126 channels at width 1): dec_7
  gets zero output rows and zero biases up to 128, so its output carries
  two zero channels, and dec_8 gets zero input columns;
- TrackNet base's `enc_0` (three stacked RGB frames, 9 channels): the
  frame stack is written with 7 zero channels where it is cast to the
  compute dtype on the device (`widen`, in `TrackNet.forward`), and enc_0
  gets zero input columns;
- CSPNet's space-to-depth stem (12 channels): the rearrangement writes
  4 zero channels (`nn.backbones.space_to_depth`), and the stem conv gets
  zero input columns.
In the int8 form the activation quantize pass, which writes a fresh map
anyway, writes the padded channel count (`ops.int8.quantize_activation`),
so the producers of enc_0 and the stem write their own count there.

It is exact. A zero input channel adds exact zeros to every f32 and int32
sum. A zero output row with a zero bias gives act(0) = 0 for ReLU and
SiLU, so its consumer reads zeros there. In int8, the zeros quantize to
0 and leave the per-tensor activation absmax as it is; a padded output
row gets int8 weights 0, weight scale 1 (finite and nonzero) and bias 0.

Where it lives. A model marks each conv to pad at construction (`mark`:
`ConvBNorm.pad_channels`, the serve form's (Cin, Cout)). Only the deploy
form of a marked conv (a folded ConvBNorm, float or int8) pads
(`padding`), on the card and on the CPU alike. Its forward pads the
tensors it holds as it runs (`serve_conv_weights`, `serve_q_params`: a
few small copies), so the padded ones always follow the module's own,
whatever set or loaded them, and no state_dict, checkpoint or flax tree
(weights.py) ever holds a padded tensor.
"""
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

PAD = 16


def padded(c: int) -> int:
    """c rounded up to a multiple of PAD."""
    return -(-c // PAD) * PAD


def mark(module: nn.Module, cin: Optional[int] = None, cout: Optional[int] = None) -> None:
    """Mark a ConvBNorm's 3x3/s1 conv (the conv3x3 kernel's) to serve with
    `cin` input and `cout` output channels (each at least the conv's own;
    None keeps it). A conv whose counts both stay is not marked."""
    conv = module.conv
    if conv.groups != 1 or conv.stride != (1, 1) or conv.kernel_size != (3, 3):
        raise ValueError(f"only a 3x3/s1 conv (the conv3x3 kernel's) pads, not a "
                         f"{conv.kernel_size}/s{conv.stride} one")
    want = (cin or conv.in_channels, cout or conv.out_channels)
    if want[0] < conv.in_channels or want[1] < conv.out_channels:
        raise ValueError(f"pad {tuple(want)} is narrower than the conv's "
                         f"{(conv.in_channels, conv.out_channels)}")
    if want != (conv.in_channels, conv.out_channels):
        module.pad_channels = want


def padding(module: nn.Module) -> Optional[Tuple[int, int]]:
    """The (Cin, Cout) a module serves with: its mark in the deploy form (a
    folded ConvBNorm, float or int8), else None (unmarked, or the train
    form)."""
    return getattr(module, "pad_channels", None) if getattr(module, "folded", False) else None


def in_channels(module: nn.Module, default: int) -> int:
    """The channels a producer writes for `module`'s input: the padded Cin
    of a marked conv's float deploy form, else `default` (the train form
    does not pad, and in int8 the quantize pass writes the padded map)."""
    pad = padding(module)
    return default if pad is None or hasattr(module, "q_kernel") else pad[0]


def widen(x: torch.Tensor, channels: int, dtype: torch.dtype) -> torch.Tensor:
    """x (B, C, H, W) cast to `dtype` with zero channels up to `channels`,
    channels_last: a zero fill, then one copy (with the cast) into the
    first C channels, on an H100 the fastest way to write the padded map
    with torch ops (against a slice fill, F.pad or a concatenation;
    dev/bench_torch_channel_pad.py). With channels == C, x.to(dtype)."""
    b, c, h, w = x.shape
    if channels == c:
        return x.to(dtype)
    out = torch.zeros((b, h, w, channels), dtype=dtype, device=x.device)
    out[..., :c].copy_(x.permute(0, 2, 3, 1))
    return out.permute(0, 3, 1, 2)


def _pad_oihw(w: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    """An OIHW weight with zero rows and columns up to (cout, cin); F.pad
    keeps its memory format (channels_last in the serve form)."""
    return F.pad(w, (0, 0, 0, 0, 0, cin - w.shape[1], 0, cout - w.shape[0]))


def serve_conv_weights(module: nn.Module, conv: nn.Conv2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weight, bias) the float deploy forward of `module` runs: the conv's,
    zero-padded where the module pads."""
    pad = padding(module)
    if pad is None:
        return conv.weight, conv.bias
    cin, cout = pad
    return _pad_oihw(conv.weight, cin, cout), F.pad(conv.bias, (0, cout - conv.out_channels))


def serve_q_params(module: nn.Module) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q_kernel, q_wscale, q_bias) the int8 forward of `module` runs: its
    own, zero-padded where the module pads (a padded row's scale is 1)."""
    q, scale, bias = module.q_kernel, module.q_wscale, module.q_bias
    pad = padding(module)
    if pad is None:
        return q, scale, bias
    cin, cout = pad
    rows = cout - q.shape[0]
    return _pad_oihw(q, cin, cout), F.pad(scale, (0, rows), value=1.0), F.pad(bias, (0, rows))
