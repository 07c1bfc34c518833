"""Plain PyTorch building blocks of the benchmark's reference models.

An independent copy of the layer equations of the port's train form, in
float32 with `F.conv2d` and `F.batch_norm`: no kernel, no folding, no
channel padding. Each module keeps the parameter names of the port's
module of the same role, so one seeded state dict loads into both.

In eval mode a ConvBNorm normalises with its running statistics, which is
the function of the port's folded deploy form (w * gamma / std, (b - mean)
* gamma / std + beta) computed without folding.

Inside `conv_records()` every conv call appends one record:
(kind, batch, h_out, w_out, c_in, c_out, kernel, stride, routed), where
`routed` names the port's kernel that takes the conv in its deploy form
("conv3x3" or "matmul") or is None. The FLOP and byte counts of the
benchmark read these records (benchmark/counts).
"""
from contextlib import contextmanager
from typing import Iterator, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5


def act(y: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    if activation == "silu":
        return F.silu(y)
    if activation == "relu":
        return F.relu(y)
    return y


class ConvLog:
    """Where the conv records go; `records` None switches logging off."""
    records: Optional[List[tuple]] = None


@contextmanager
def conv_records() -> Iterator[List[tuple]]:
    """Collect the conv records of the forwards run inside the block."""
    saved, ConvLog.records = ConvLog.records, []
    try:
        yield ConvLog.records
    finally:
        ConvLog.records = saved


def log_conv(conv: nn.Conv2d, y: torch.Tensor, routed: Optional[str]) -> None:
    if ConvLog.records is not None:
        ConvLog.records.append(("conv", y.shape[0], y.shape[2], y.shape[3], conv.in_channels,
                                conv.out_channels, conv.kernel_size[0], conv.stride[0], routed))


def route(kernel: int, stride: int) -> Optional[str]:
    """The port's kernel for a deploy-form conv with a bias and an
    activation (nn/blocks.geometry_route): 1x1/s1 matmul, 3x3/s1 conv3x3."""
    if stride != 1:
        return None
    return {1: "matmul", 3: "conv3x3"}.get(kernel)


def round_fp8(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t rounded to a float8 type with a per-tensor scale (its absmax to
    the type's largest value)."""
    scale = t.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (t / scale).to(dtype).to(t.dtype) * scale


class Fp8(torch.autograd.Function):
    """Float8 training's rounding: e4m3 on the way forward, e5m2 for the
    gradient on the way back."""

    @staticmethod
    def forward(ctx, t):
        return round_fp8(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g, torch.float8_e5m2)


class Fp8Grad(torch.autograd.Function):
    """The identity, with the gradient rounded to e5m2 on the way back."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g, torch.float8_e5m2)


class Numerics:
    """`fp8` True: every conv computes as float8 training does (the control
    of the training cells): its input and weight rounded to e4m3, the
    gradients of its output, input and weight to e5m2. `bf16` True: every
    conv computes in bfloat16 and a ConvBNorm's BatchNorm and activation in
    float32, their output cast back to bfloat16, as the port's bf16
    training does (the witness of what bf16 alone reads)."""
    fp8 = False
    bf16 = False


@contextmanager
def fp8_convs() -> Iterator[None]:
    saved, Numerics.fp8 = Numerics.fp8, True
    try:
        yield
    finally:
        Numerics.fp8 = saved


@contextmanager
def bf16_convs() -> Iterator[None]:
    saved, Numerics.bf16 = Numerics.bf16, True
    try:
        yield
    finally:
        Numerics.bf16 = saved


def plain_conv(conv: nn.Conv2d, x: torch.Tensor, routed: Optional[str] = None) -> torch.Tensor:
    w, b = conv.weight, conv.bias
    if Numerics.fp8:
        x, w = Fp8.apply(x), Fp8.apply(w)
    if Numerics.bf16:
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
        b = None if b is None else b.to(torch.bfloat16)
    y = F.conv2d(x, w, b, conv.stride, conv.padding)
    if Numerics.fp8:
        y = Fp8Grad.apply(y)
    log_conv(conv, y, routed)
    return y


class ConvBNorm(nn.Module):
    """conv (+ bias) -> BatchNorm -> activation; `no_batchnorm`: conv with
    bias -> activation."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: Optional[int] = None, activation: Optional[str] = "silu",
                 use_bias: bool = True, no_batchnorm: bool = False):
        super().__init__()
        self.activation = activation
        self.no_batchnorm = no_batchnorm
        p = k // 2 if padding is None else padding
        self.conv = nn.Conv2d(cin, cout, k, stride, p, bias=use_bias or no_batchnorm)
        if not no_batchnorm:
            self.norm = nn.BatchNorm2d(cout, eps=BN_EPS)
        self.routed = route(k, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = plain_conv(self.conv, x, self.routed)
        if self.no_batchnorm:
            return act(y, self.activation)
        return act(self.norm(y.float()), self.activation).to(y.dtype)


def up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2: every pixel repeated 2x2."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
