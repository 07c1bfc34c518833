"""Fused matmul + bias + activation: `act(x @ w + b)`.

Replaces the TPU kernel vision_conglomerate_tpu/ops/fused_matmul.py
:matmul_bias_act (Pallas body `_kernel`) with the CUDA kernel in
csrc/matmul_bias_act.cu. Accumulation and epilogue in f32, one store in
x.dtype. The serve path calls `pointwise_conv_act` for every BN-folded
1x1/stride-1 conv.

Bound on the H100 at the detector's shapes (M = B*H*W up to 4*160^2, K =
Cin 32..1024, N = Cout 32..512): bytes, since K*N/(K+N) FLOPs per byte
stays under the card's ~295. The kernel is the one-tap case of the
implicit GEMM in csrc/igemm_sm90.cuh: TMA copies fill a ring of
shared-memory stages that wgmma reads, and bias and activation run on the
accumulators in registers before 16-byte bf16 stores. x is read once per
N tile and y written once; ragged M, N and K are zero-filled and masked,
not padded. The C launcher picks the output tile per shape.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises. `matmul_bias_act.launches` counts launches.
"""
import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _cuda

ACTIVATIONS = {None: 0, "none": 0, "silu": 1, "relu": 2}
_ARGTYPES = {"matmul_bias_act_bf16": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
             + [ctypes.c_void_p], "matmul_bias_act_tile": _cuda.TILE_ARGTYPES}


def apply_activation(y: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    if activation == "silu":
        return F.silu(y)
    if activation == "relu":
        return F.relu(y)
    if activation in (None, "none"):
        return y
    raise ValueError(f"unsupported activation {activation!r}")


def matmul_bias_act_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          activation: Optional[str] = "silu") -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 matmul, bias and
    activation, cast to x.dtype."""
    y = x.float() @ w.float() + b.float()
    return apply_activation(y, activation).to(x.dtype)


def check_launch_args(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      activation: Optional[str], numels) -> None:
    """What both CUDA kernels need of their operands, checked before a
    launch: a known activation, bf16 x and w, one device, contiguous x,
    and every count in `numels` (what the kernel indexes with 32-bit ints)
    below 2^31."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unsupported activation {activation!r}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16 x and w, got {x.dtype} and {w.dtype}")
    if w.device != x.device or b.device != x.device:
        raise ValueError("x, w and b must be on one device")
    if not x.is_contiguous():
        raise ValueError(f"x must be contiguous, got strides {x.stride()}")
    if max(numels) >= 2 ** 31:
        raise ValueError("the kernel indexes with 32-bit ints; split the call")


def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            activation: Optional[str]) -> torch.Tensor:
    if x.dim() != 2 or w.dim() != 2 or b.shape != (w.shape[1],) or w.shape[0] != x.shape[1]:
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)} "
                         "do not make (M, K) @ (K, N) + (N,)")
    m, k = x.shape
    n = w.shape[1]
    check_launch_args(x, w, b, activation, (m * k, m * n, k * n))
    wt = w.t().contiguous()  # (N, K); free for the transposed view the convs pass
    bias = b.to(torch.float32).contiguous()
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    with torch.cuda.device(x.device):
        lib = _cuda.load("matmul_bias_act", _ARGTYPES, x.device.index)
        code = lib.matmul_bias_act_bf16(
            x.data_ptr(), wt.data_ptr(), bias.data_ptr(), y.data_ptr(), m, n, k,
            ACTIVATIONS[activation], torch.cuda.get_device_properties(x.device).multi_processor_count,
            torch.cuda.current_stream().cuda_stream)
    _cuda.check(lib, "matmul_bias_act", code)
    matmul_bias_act.launches += 1
    return y


def matmul_bias_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    activation: Optional[str] = "silu") -> torch.Tensor:
    """One-pass (x @ w + b) -> activation; x (M, K), w (K, N), b (N,);
    returns (M, N) in x.dtype. activation: silu, relu or None."""
    if x.device.type == "cpu":
        return matmul_bias_act_plain(x, w, b, activation)
    if x.device.type == "cuda":
        return _launch(x, w, b, activation)
    raise ValueError(f"no matmul_bias_act for device {x.device}")


matmul_bias_act.launches = 0


def pointwise_conv_act(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                       activation: Optional[str] = "silu") -> torch.Tensor:
    """Fused 1x1 conv + bias + activation via the matmul kernel.

    x (B, H, W, Cin) NHWC, kernel (1, 1, Cin, Cout) HWIO, bias (Cout,);
    returns (B, H, W, Cout). A channels_last NCHW activation permuted to
    NHWC reshapes to (B*H*W, Cin) with no copy.
    """
    b_, h, w_, cin = x.shape
    cout = kernel.shape[-1]
    y = matmul_bias_act(x.reshape(b_ * h * w_, cin), kernel.reshape(cin, cout),
                        bias, activation)
    return y.reshape(b_, h, w_, cout)
