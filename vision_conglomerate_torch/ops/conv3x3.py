"""Fused 3x3 conv (stride 1, pad 1) + bias + activation.

Replaces the TPU kernel vision_conglomerate_tpu/ops/conv_pallas.py
:conv3x3_bias_act (Pallas body `_conv3x3_kernel`) with the CUDA kernel in
csrc/conv3x3_bias_act.cu: an implicit GEMM over M = B*H*W, K = 9*Cin,
N = Cout with f32 accumulation and epilogue and one store in x.dtype. The
serve paths call it for every BN-folded stride-1 3x3 conv and every fused
RepVGG `conv_reparam`, TrackNet's 18 convs included. x and y may hold 2^31
elements or more; M = B*H*W may not.

Bound on the H100 at the detector's shapes (H*W 160^2..20^2, Cin 32..768,
Cout 32..512): the tensor cores, from ~144 FLOPs per byte at 32 channels
to ~2800 at 768->512. The kernel is the nine-tap case of the implicit GEMM
in csrc/igemm_sm90.cuh: M = B*H*W output pixels as one flat index, K =
9*Cin. A ring of shared-memory stages takes each tap's shifted pixels
(cp.async gathers, zero outside the image) and the weight tile (TMA) in the
128-byte-swizzled layout that wgmma reads, with two or more K tiles in
flight while wgmma runs; bias and activation run on the accumulators in
registers before 16-byte bf16 stores. The C launcher picks the output tile
per shape.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises. `conv3x3_bias_act.launches` counts launches.
"""
import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _cuda
from .fused_matmul import ACTIVATIONS, apply_activation, check_launch_args

_ARGTYPES = {"conv3x3_bias_act_bf16": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_void_p], "conv3x3_bias_act_tile": _cuda.TILE_ARGTYPES}


def conv3x3_bias_act_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           activation: Optional[str] = "silu") -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 conv, bias and
    activation, cast to x.dtype. x NHWC, w HWIO; returns NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w.permute(3, 2, 0, 1).float(),
                 b.float(), padding=1)
    return apply_activation(y, activation).to(x.dtype).permute(0, 2, 3, 1)


def check_conv_args(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    activation: Optional[str]) -> None:
    """What the kernel takes, checked before a launch: NHWC x, HWIO w,
    (Cout,) b, and the operand rules of `check_launch_args`. Its 32-bit
    indices are the pixel row (M = B*H*W) and W's elements; offsets into x
    and y are 64-bit, so those may hold 2^31 elements or more. The
    launcher rounds M up to whole 128-row tiles in int arithmetic, so M
    may be at most 2^31 - 128."""
    if x.dim() != 4 or w.shape[:3] != (3, 3, x.shape[3]) or b.shape != (w.shape[3],):
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)} "
                         "are not NHWC x, (3, 3, Cin, Cout) w, (Cout,) b")
    n, h, w_dim, cin = x.shape
    check_launch_args(x, w, b, activation, (n * h * w_dim + 127, 9 * cin * w.shape[3]))


def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            activation: Optional[str]) -> torch.Tensor:
    check_conv_args(x, w, b, activation)
    n, h, w_dim, cin = x.shape
    cout = w.shape[3]
    wk = w.permute(3, 0, 1, 2).contiguous()  # (Cout, 3, 3, Cin); free for channels_last OIHW
    bias = b.to(torch.float32).contiguous()
    y = torch.empty((n, h, w_dim, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        lib = _cuda.load("conv3x3_bias_act", _ARGTYPES, x.device.index)
        code = lib.conv3x3_bias_act_bf16(
            x.data_ptr(), wk.data_ptr(), bias.data_ptr(), y.data_ptr(),
            n, h, w_dim, cin, cout, ACTIVATIONS[activation],
            torch.cuda.get_device_properties(x.device).multi_processor_count,
            torch.cuda.current_stream().cuda_stream)
    _cuda.check(lib, "conv3x3_bias_act", code)
    conv3x3_bias_act.launches += 1
    return y


def conv3x3_bias_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     activation: Optional[str] = "silu") -> torch.Tensor:
    """act(conv3x3(x, w; stride 1, pad 1) + b); x (B, H, W, Cin) NHWC,
    w (3, 3, Cin, Cout) HWIO, b (Cout,); returns (B, H, W, Cout)."""
    if x.device.type == "cpu":
        return conv3x3_bias_act_plain(x, w, b, activation)
    if x.device.type == "cuda":
        return _launch(x, w, b, activation)
    raise ValueError(f"no conv3x3_bias_act for device {x.device}")


conv3x3_bias_act.launches = 0
