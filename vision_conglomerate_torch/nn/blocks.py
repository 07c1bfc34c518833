"""Convolutional blocks of the detection, segmentation and TrackNet nets,
in PyTorch.

The JAX package's nn/blocks.py (flax, NHWC) ported to nn.Modules that keep
NCHW parameters and run on channels_last activations. Attribute names
mirror the upstream torch modules, so the JAX package's
`tools/torch_port.convert_torch_state_dict` maps a port `state_dict` onto
the flax tree (`bottlenecks.0` <-> `bottlenecks_0`, `norm` <-> `norm/BatchNorm_0`).

Deploy form. `folded=True` builds a ConvBNorm whose BatchNorm has been
folded into the conv (`nn.reparam.fold_conv_bn_params`): the conv always
has a bias and there is no `norm`. `deploy=True` builds a RepVGGBlock as a
single fused 3x3 `conv_reparam` (`nn.reparam.reparameterize_params`). In
that form the stride-1 convs run on the port's CUDA kernels when their
input lies on the card: every folded 1x1 conv on `ops.fused_matmul`, every
folded stride-1 3x3 conv and every `conv_reparam` on `ops.conv3x3`. The
6x6/s2 stem, the 3x3/s2 downsamples, transpose convs, pooling, resizes and
the head's plain 1x1 layers stay on PyTorch ops.

int8 form. A BN-folded ConvBNorm (not a `no_batchnorm` one) or a fused
RepVGG block that `nn.quantize.int8_quantize_` quantized holds buffers
`q_kernel` (int8 OIHW, channels_last), `q_wscale` (Cout,), `q_xscale` () and
`q_bias` (Cout,) in place of its conv, the JAX package's int8 parameters;
its forward quantizes its input and runs the int8 conv
(`int8_conv_bias_act`): 1x1/s1 on `ops.int8.matmul_s8_bias_act`, 3x3/s1 on
`ops.int8.conv3x3_s8_bias_act`, every other conv on
`ops.int8.conv_s8_bias_act`.

Channel padding. A ConvBNorm marked with `pad_channels` (nn/channel_pad.py:
TrackNet's enc_0, dec_7 and dec_8, CSPNet's space-to-depth stem) serves
its deploy form, float or int8, with its weights zero-padded in the
forward, so that its conv takes the kernels' vector path.

Numerics follow the JAX package: parameters are f32 and each conv casts its
weight and bias to the activations' dtype at the call, so gradients land in
f32; BatchNorm computes in f32 with flax's running-stat rule (`BatchNorm2d`).
The serve form stores conv weights in the compute dtype instead
(`cast_conv_weights`); the kernels apply bias and activation to their f32
accumulator.

Rematerialization. The backbone and neck call their stages through
`stage`, which with `remat` checkpoints each stage for the backward pass,
the units the JAX package wraps in `nn.blocks.maybe_remat`; TrackNet calls
each of its convs so.
"""
import contextlib
import math
from contextvars import ContextVar
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.conv3x3 import conv3x3_bias_act
from ..ops.fused_matmul import ACTIVATIONS, apply_activation, pointwise_conv_act
from ..ops.int8 import (conv3x3_s8_bias_act, conv_s8_bias_act, int8_scale, matmul_s8_bias_act,
                        quantize_activation)
from ..ops.resize import resize_nchw
from .channel_pad import serve_conv_weights, serve_q_params

IntPair = Union[int, Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    return (int(v[0]), int(v[1]))


def channels8(x: Optional[float], width_multiple: float, divisor: int = 8) -> Optional[int]:
    """Channel width rule ceil(x*wm/8)*8; None passes through."""
    if not x:
        return x
    return int(math.ceil((x * width_multiple) / divisor) * divisor)


def depth_round(x: float, depth_multiple: float) -> int:
    """Depth rule max(round(x*dm), 1)."""
    return max(round(x * depth_multiple), 1)


def conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """`conv` on x in x's dtype. The casts of weight and bias are
    differentiable, so f32 parameters get f32 gradients."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, conv.stride, conv.padding)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) contiguous view of an NCHW tensor; free when x is
    channels_last."""
    return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def geometry_route(kernel_size: Tuple[int, int], stride: Tuple[int, int],
                   padding: Tuple[int, int], activation: Optional[str]) -> Optional[str]:
    """Which kernel computes act(conv(x) + b) of an ungrouped conv of this
    geometry: "matmul" for 1x1/s1/p0, "conv3x3" for 3x3/s1/p1, None for
    every other conv."""
    if activation not in ACTIVATIONS or tuple(stride) != (1, 1):
        return None
    if tuple(kernel_size) == (1, 1) and tuple(padding) == (0, 0):
        return "matmul"
    if tuple(kernel_size) == (3, 3) and tuple(padding) == (1, 1):
        return "conv3x3"
    return None


def kernel_route(conv: nn.Conv2d, activation: Optional[str]) -> Optional[str]:
    """Which CUDA kernel computes act(conv(x) + b) (`geometry_route`)."""
    if conv.groups != 1:
        return None
    return geometry_route(conv.kernel_size, conv.stride, conv.padding, activation)


def conv_bias_act(x: torch.Tensor, conv: nn.Conv2d, activation: Optional[str],
                  weight: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """act(conv(x) + b) for a conv with a bias: on the matmul or conv3x3
    kernel where `kernel_route` names one, else F.conv2d then the
    activation in x's dtype. The weight is cast to x's dtype (a no-op in
    the serve form, whose weights are in the compute dtype already).
    `weight` and `bias`, where given, replace the conv's on the kernel
    route: the serve form's channel-padded ones (nn/channel_pad.py)."""
    route = kernel_route(conv, activation)
    if route is None:
        return apply_activation(conv2d(x, conv), activation)
    weight = conv.weight if weight is None else weight
    bias = conv.bias if bias is None else bias
    w_hwio = weight.to(x.dtype).permute(2, 3, 1, 0)
    fn = pointwise_conv_act if route == "matmul" else conv3x3_bias_act
    return fn(_nhwc(x), w_hwio, bias, activation).permute(0, 3, 1, 2)


def int8_conv_bias_act(x: torch.Tensor, module: nn.Module,
                       activation: Optional[str]) -> torch.Tensor:
    """The JAX package's quantized_conv on a module's int8 buffers:
    x_q = clamp(round(x_f32 / q_xscale)), the int8 conv with exact
    sums, then act(sum * (q_wscale * q_xscale) + q_bias) in f32, cast to
    x's dtype. 1x1/s1 convs run on the s8 matmul kernel, 3x3/s1 ones on
    the s8 conv kernel, the others on `conv_s8_bias_act`. A channel-padded
    module (nn/channel_pad.py) runs its padded q parameters, and the
    quantize pass writes the padded channel count."""
    stride, padding = module.q_geometry
    q_kernel, q_wscale, q_bias = serve_q_params(module)
    w_hwio = q_kernel.permute(2, 3, 1, 0)
    x_q = quantize_activation(_nhwc(x), module.q_xscale, q_kernel.shape[1])
    scale = int8_scale(q_wscale, module.q_xscale)
    route = geometry_route(w_hwio.shape[:2], stride, padding, activation)
    if route == "matmul":
        b, h, w, cin = x_q.shape
        y = matmul_s8_bias_act(x_q.reshape(b * h * w, cin), w_hwio.reshape(cin, -1), scale,
                               q_bias, activation, x.dtype).reshape(b, h, w, -1)
    elif route == "conv3x3":
        y = conv3x3_s8_bias_act(x_q, w_hwio, scale, q_bias, activation, x.dtype)
    else:
        y = conv_s8_bias_act(x_q, w_hwio, scale, q_bias, stride, padding, activation, x.dtype)
    return y.permute(0, 3, 1, 2)


def quantized_conv_name(module: nn.Module) -> Optional[str]:
    """The conv of `module` that the JAX package quantizes in its int8 form,
    or None: the conv of a BN-folded ConvBNorm (not of a `no_batchnorm`
    one, which records no calibration in the JAX package) and the
    `conv_reparam` of a fused RepVGG block. Transpose convs and the head's
    plain 1x1 layers stay in the module dtype."""
    if isinstance(module, ConvBNorm) and module.folded and not module.no_batchnorm:
        return "conv"
    if isinstance(module, RepVGGBlock) and module.deploy:
        return "conv_reparam"
    return None


def set_int8_(module: nn.Module, q_kernel: torch.Tensor, q_wscale: torch.Tensor,
              q_xscale: torch.Tensor, q_bias: torch.Tensor) -> nn.Module:
    """Put a quantizable module (`quantized_conv_name`) in its int8 form:
    its conv goes, buffers q_kernel (int8 OIHW, kept channels_last),
    q_wscale, q_xscale and q_bias (f32) take its place, and its forward
    runs `int8_conv_bias_act` with the conv's stride and padding."""
    name = quantized_conv_name(module)
    conv = getattr(module, name, None) if name else None
    if conv is None:
        raise ValueError(f"{type(module).__name__} has no float conv to quantize")
    if q_kernel.shape != conv.weight.shape or q_kernel.dtype != torch.int8:
        raise ValueError(f"q_kernel {q_kernel.dtype} {tuple(q_kernel.shape)} does not replace "
                         f"a conv weight of {tuple(conv.weight.shape)}")
    module.q_geometry = (conv.stride, conv.padding)
    delattr(module, name)
    module.register_buffer("q_kernel", q_kernel.contiguous(memory_format=torch.channels_last))
    for key, val in (("q_wscale", q_wscale), ("q_xscale", q_xscale), ("q_bias", q_bias)):
        module.register_buffer(key, val.to(torch.float32))
    return module


# True while torch.utils.checkpoint re-runs a stage's forward in the
# backward pass (`stage`); BatchNorm2d then leaves its statistics alone
_RECOMPUTING: ContextVar = ContextVar("vct_recomputing", default=False)


@contextlib.contextmanager
def _recomputing():
    token = _RECOMPUTING.set(True)
    try:
        yield
    finally:
        _RECOMPUTING.reset(token)


def _remat_contexts():
    """(forward context, recompute context) for torch.utils.checkpoint."""
    return contextlib.nullcontext(), _recomputing()


def stage(module: nn.Module, *args: torch.Tensor, remat: bool = False) -> torch.Tensor:
    """module(*args). With `remat`, while autograd records, the stage keeps
    only its inputs for the backward pass and runs its forward again there
    (torch.utils.checkpoint, non-reentrant; the RNG state is restored for
    the recompute). BatchNorm2d updates its running statistics in the
    forward only, not again in the recompute: flax's nn.remat mutates
    batch_stats once per step, too."""
    if remat and torch.is_grad_enabled():
        return checkpoint(module, *args, use_reentrant=False, context_fn=_remat_contexts)
    return module(*args)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's running statistics (momentum 0.1, eps 1e-5).

    Train mode normalises with the biased batch statistics, as
    nn.BatchNorm2d does, and updates `running_mean` and `running_var` as flax
    nn.BatchNorm does: new = 0.9 old + 0.1 batch, where batch is the BIASED
    variance (nn.BatchNorm2d would take the unbiased one). Eval mode
    normalises with the running statistics. The state_dict keys are
    nn.BatchNorm2d's; `num_batches_tracked` is not advanced (nothing reads
    it, and checkpoints drop it).

    The batch statistics come out of F.batch_norm itself, run with momentum
    1 into two scratch buffers, so the train forward stays one fused
    normalisation plus three small updates. The recompute of a
    checkpointed stage (`stage`) normalises alike and skips the updates.
    """

    def __init__(self, num_features: int, device=None):
        super().__init__(num_features, device=device)
        self.register_buffer("_batch_mean", torch.zeros(num_features, device=device),
                             persistent=False)
        self.register_buffer("_batch_var", torch.ones(num_features, device=device),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        if x.device.type == "cpu":
            # torch's CPU kernel reduces a channels_last map (the NHWC images
            # permuted) with float partial sums: its statistics are off by up
            # to 5e-5 relative and move with the thread count; its
            # contiguous kernel is at f32 rounding, as cuDNN's is
            x = x.contiguous()
        # momentum 1: the scratch buffers become the batch mean and the
        # unbiased batch variance
        y = F.batch_norm(x, self._batch_mean, self._batch_var, self.weight, self.bias,
                         True, 1.0, self.eps)
        if _RECOMPUTING.get():
            return y
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.lerp_(self._batch_mean, self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(
                self._batch_var, alpha=self.momentum * (n - 1) / n)
        return y


class ConvBNorm(nn.Module):
    """Conv2d + BatchNorm (f32) + activation; `folded=True` is the deploy
    form, whose conv carries the folded BatchNorm and always has a bias.

    `no_batchnorm=True` is a conv with its bias, then the activation in the
    activations' dtype, with no BatchNorm (TrackNet's `dec_13`); its deploy
    form (`folded=True`) is the same conv on the kernel route.

    `pad_channels`: None, or the (Cin, Cout) its deploy form serves with
    zero channels added (set by the model, `channel_pad.mark`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntPair,
                 stride: IntPair = 1, padding: Optional[IntPair] = None,
                 activation: Optional[str] = "silu", use_bias: bool = True,
                 no_batchnorm: bool = False, folded: bool = False, device=None):
        super().__init__()
        k = _pair(kernel_size)
        p = (k[0] // 2, k[1] // 2) if padding is None else _pair(padding)
        self.activation = activation
        self.folded = folded
        self.no_batchnorm = no_batchnorm
        self.pad_channels = None
        self.conv = nn.Conv2d(in_channels, out_channels, k, _pair(stride), p,
                              bias=use_bias or folded, device=device)
        if not (folded or no_batchnorm):
            self.norm = BatchNorm2d(out_channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "q_kernel"):
            return int8_conv_bias_act(x, self, self.activation)
        if self.folded:
            return conv_bias_act(x, self.conv, self.activation,
                                 *serve_conv_weights(self, self.conv))
        if self.no_batchnorm:
            return apply_activation(conv2d(x, self.conv), self.activation)
        y = apply_activation(self.norm(conv2d(x, self.conv).float()), self.activation)
        return y.to(x.dtype)


class ConvTransposeBNorm(nn.Module):
    """ConvTranspose2d + BatchNorm (f32) + activation, with torch's crop
    padding: output (i - 1) * s - 2p + k. `folded=True` is the deploy form,
    whose transpose conv carries the folded BatchNorm and always has a bias.

    The weight is torch's (I, O, kh, kw). flax's ConvTranspose, which the
    JAX package uses, does not flip its kernel (kh, kw, I, O); this weight
    is that kernel flipped in both spatial dims (`weights.py` bridges it).
    It stays on PyTorch's transpose conv in every form."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntPair,
                 stride: IntPair = 1, padding: Optional[IntPair] = None,
                 activation: Optional[str] = "silu", use_bias: bool = True,
                 no_batchnorm: bool = False, folded: bool = False, device=None):
        super().__init__()
        self.activation = activation
        self.folded = folded
        self.no_batchnorm = no_batchnorm
        self.conv_transpose = nn.ConvTranspose2d(
            in_channels, out_channels, _pair(kernel_size), _pair(stride), _pair(padding or 0),
            bias=use_bias or folded, device=device)
        if not (folded or no_batchnorm):
            self.norm = BatchNorm2d(out_channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ct = self.conv_transpose
        bias = None if ct.bias is None else ct.bias.to(x.dtype)
        y = F.conv_transpose2d(x, ct.weight.to(x.dtype), bias, ct.stride, ct.padding)
        if self.folded or self.no_batchnorm:
            return apply_activation(y, self.activation)
        return apply_activation(self.norm(y.float()), self.activation).to(x.dtype)


class ConvBNormUpsample(nn.Module):
    """A 3x3 ConvBNorm (stride 1, pad 1) followed by a resize by `scale`
    (nearest x2 in every config). With `no_batchnorm` it is a conv with its
    bias and the activation (DeconvCSPNet's `deconv4`). Folded, its conv
    runs on the conv3x3 kernel."""

    def __init__(self, in_channels: int, out_channels: int, scale: float,
                 upsample_mode: str = "nearest", activation: Optional[str] = "silu",
                 no_batchnorm: bool = False, folded: bool = False, device=None):
        super().__init__()
        self.scale = scale
        self.upsample_mode = upsample_mode
        self.conv = ConvBNorm(in_channels, out_channels, 3, 1, 1, activation=activation,
                              no_batchnorm=no_batchnorm, folded=folded, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return resize_nchw(self.conv(x), self.scale, method=self.upsample_mode)


class RepVGGBlock(nn.Module):
    """RepVGG block (stride 1): 3x3 conv-BN + 1x1 conv-BN (+ identity BN
    when in == out), summed, then SiLU.

    `branch_activation="silu"` keeps the upstream branches (conv -> BN ->
    SiLU), which cannot fuse; they deploy by BN folding (`folded=True`).
    `branch_activation=None` is the canonical block, which `deploy=True`
    runs as one fused 3x3 `conv_reparam`.
    """

    activation = "silu"

    def __init__(self, in_channels: int, out_channels: int,
                 branch_activation: Optional[str] = "silu", deploy: bool = False,
                 folded: bool = False, device=None):
        super().__init__()
        self.deploy = deploy
        if deploy:
            if branch_activation is not None:
                raise ValueError(
                    "deploy=True (single fused conv) requires branch_activation=None "
                    "(canonical RepVGG); branch-activated blocks deploy via BN folding")
            self.conv_reparam = nn.Conv2d(in_channels, out_channels, 3, 1, 1, bias=True,
                                          device=device)
            return
        self.conv3x3 = ConvBNorm(in_channels, out_channels, 3, 1, 1, use_bias=False,
                                 activation=branch_activation, folded=folded, device=device)
        self.conv1x1 = ConvBNorm(in_channels, out_channels, 1, 1, 0, use_bias=False,
                                 activation=branch_activation, folded=folded, device=device)
        if in_channels == out_channels:
            self.identity = BatchNorm2d(in_channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "q_kernel"):
            return int8_conv_bias_act(x, self, self.activation)
        if self.deploy:
            return conv_bias_act(x, self.conv_reparam, self.activation)
        out = self.conv3x3(x) + self.conv1x1(x)
        if hasattr(self, "identity"):
            out = out + self.identity(x.float()).to(x.dtype)
        return apply_activation(out, self.activation)


class RepBlock(nn.Module):
    """Stack of n RepVGG blocks with hidden width e*out."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 1, e: float = 0.5,
                 branch_activation: Optional[str] = "silu", deploy: bool = False,
                 folded: bool = False, device=None):
        super().__init__()
        if n < 1:
            raise ValueError(f"n must be >= 1, got n={n}")
        c_h = int(out_channels * e)

        def mk(ci, co):
            return RepVGGBlock(ci, co, branch_activation=branch_activation,
                               deploy=deploy, folded=folded, device=device)

        if n == 1:
            self.conv1 = mk(in_channels, out_channels)
            self.blocks = nn.Sequential()
        else:
            self.conv1 = mk(in_channels, c_h)
            self.blocks = nn.Sequential(*[mk(c_h, c_h) for _ in range(n - 2)],
                                        mk(c_h, out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks(self.conv1(x))


def bic_out_channels(bic_with_conv: bool, c1: int, c0: int, p2: int,
                     out_channels: Optional[int]) -> int:
    if bic_with_conv:
        if out_channels is None:
            raise ValueError("BiCwithConvModule needs out_channels")
        return out_channels
    return out_channels if out_channels else (c1 + c0 + p2)


class BiCwithConvModule(nn.Module):
    """Bi-directional concatenation with 1x1 convs."""

    def __init__(self, c1: int, c0: int, p2: int, out_channels: int, e: float = 0.5,
                 upsample_mode: str = "nearest", folded: bool = False, device=None):
        super().__init__()
        c_h = int(out_channels * e)
        self.upsample_mode = upsample_mode
        self.conv_c1 = ConvBNorm(c1, c_h, 1, folded=folded, device=device)
        self.conv_c0 = ConvBNorm(c0, c_h, 1, folded=folded, device=device)
        self.conv_out = ConvBNorm(2 * c_h + p2, out_channels, 1, folded=folded, device=device)

    def forward(self, c1, c0, p2):
        c1 = self.conv_c1(c1)
        c0 = resize_nchw(self.conv_c0(c0), 0.5, method=self.upsample_mode)
        p2 = resize_nchw(p2, 2.0, method=self.upsample_mode)
        return self.conv_out(torch.cat([c1, c0, p2], dim=1))


class BiCwithNoConvModule(nn.Module):
    """Bi-directional concatenation, optional trailing 1x1 conv
    (out_channels=None: pure concat)."""

    def __init__(self, c1: int, c0: int, p2: int, out_channels: Optional[int] = None,
                 upsample_mode: str = "nearest", folded: bool = False, device=None):
        super().__init__()
        self.upsample_mode = upsample_mode
        if out_channels:
            self.conv = ConvBNorm(c1 + c0 + p2, out_channels, 1, folded=folded, device=device)

    def forward(self, c1, c0, p2):
        c0 = resize_nchw(c0, 0.5, method=self.upsample_mode)
        p2 = resize_nchw(p2, 2.0, method=self.upsample_mode)
        out = torch.cat([c1, c0, p2], dim=1)
        if hasattr(self, "conv"):
            out = self.conv(out)
        return out


class BottleNeckModule(nn.Module):
    """1x1 -> 3x3 bottleneck with optional shortcut."""

    def __init__(self, in_channels: int, out_channels: int, e: float = 0.5,
                 shortcut: bool = True, folded: bool = False, device=None):
        super().__init__()
        c_h = int(out_channels * e)
        self.shortcut = shortcut and in_channels == out_channels
        self.conv1 = ConvBNorm(in_channels, c_h, 1, folded=folded, device=device)
        self.conv2 = ConvBNorm(c_h, out_channels, 3, folded=folded, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        return x + out if self.shortcut else out


class C3Module(nn.Module):
    """CSP C3 block."""

    def __init__(self, in_channels: int, out_channels: int, e: float = 0.5,
                 shortcut: bool = True, num_bottlenecks: int = 1, folded: bool = False,
                 device=None):
        super().__init__()
        c_h = int(out_channels * e)
        self.conv1 = ConvBNorm(in_channels, c_h, 1, folded=folded, device=device)
        self.bottlenecks = nn.Sequential(*[
            BottleNeckModule(c_h, c_h, e=1.0, shortcut=shortcut, folded=folded, device=device)
            for _ in range(num_bottlenecks)])
        self.conv2 = ConvBNorm(in_channels, c_h, 1, folded=folded, device=device)
        self.conv3 = ConvBNorm(2 * c_h, out_channels, 1, folded=folded, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = self.bottlenecks(self.conv1(x))
        out2 = self.conv2(x)
        return self.conv3(torch.cat([out1, out2], dim=1))


def max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k max pool, stride 1, padded with -inf to keep the size."""
    return F.max_pool2d(x, k, stride=1, padding=k // 2)


class SPPFModule(nn.Module):
    """SPPF: a 1x1 conv, three chained k x k max pools (stride 1), a 1x1
    conv over the concat. The concat is the upstream's [y, p2, p2, p3]: p1
    is computed and unused, p2 appears twice (a quirk kept for weight and
    metric parity)."""

    def __init__(self, in_channels: int, out_channels: int, e: float = 0.5,
                 pool_kernel_size: int = 5, folded: bool = False, device=None):
        super().__init__()
        c_h = int(out_channels * e)
        self.pool_kernel_size = pool_kernel_size
        self.conv1 = ConvBNorm(in_channels, c_h, 1, folded=folded, device=device)
        self.conv2 = ConvBNorm(4 * c_h, out_channels, 1, folded=folded, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.pool_kernel_size
        y = self.conv1(x)
        p1 = max_pool_same(y, k)
        p2 = max_pool_same(p1, k)
        p3 = max_pool_same(p2, k)
        return self.conv2(torch.cat([y, p2, p2, p3], dim=1))


class CSPSPPFModule(nn.Module):
    """Cross-stage-partial SPPF."""

    def __init__(self, in_channels: int, out_channels: int, e: float = 0.5,
                 pool_kernel_size: int = 5, folded: bool = False, device=None):
        super().__init__()
        c_h = int(out_channels * e)
        self.pool_kernel_size = pool_kernel_size
        self.conv_1_3_4 = nn.Sequential(
            ConvBNorm(in_channels, c_h, 1, folded=folded, device=device),
            ConvBNorm(c_h, c_h, 3, folded=folded, device=device),
            ConvBNorm(c_h, c_h, 1, folded=folded, device=device))
        self.conv2 = ConvBNorm(in_channels, c_h, 1, folded=folded, device=device)
        self.conv5 = ConvBNorm(4 * c_h, c_h, 1, folded=folded, device=device)
        self.conv6 = ConvBNorm(c_h, c_h, 3, folded=folded, device=device)
        self.conv7 = ConvBNorm(2 * c_h, out_channels, 1, folded=folded, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.pool_kernel_size
        x1 = self.conv_1_3_4(x)
        y1 = self.conv2(x)
        p1 = max_pool_same(x1, k)
        p2 = max_pool_same(p1, k)
        p3 = max_pool_same(p2, k)
        x1 = self.conv6(self.conv5(torch.cat([x1, p1, p2, p3], dim=1)))
        return self.conv7(torch.cat([x1, y1], dim=1))


class ProtoSegModule(nn.Module):
    """YOLACT prototype branch: ConvBNorm 3x3 -> nearest x2 upsample ->
    ConvBNorm 3x3 -> ConvBNorm 1x1 to `out_channels` prototypes, so the
    protos come out at half the input's stride. `c_h` is not scaled by the
    width multiple. Folded, its three convs are stride-1 ConvBNorms and run
    on the kernels."""

    def __init__(self, in_channels: int, out_channels: int = 32, c_h: int = 256,
                 upsample_mode: str = "nearest", folded: bool = False, device=None):
        super().__init__()
        self.upsample_mode = upsample_mode
        self.conv1 = ConvBNorm(in_channels, c_h, 3, folded=folded, device=device)
        self.conv2 = ConvBNorm(c_h, c_h, 3, folded=folded, device=device)
        self.conv3 = ConvBNorm(c_h, out_channels, 1, folded=folded, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = resize_nchw(self.conv1(x), 2.0, method=self.upsample_mode)
        return self.conv3(self.conv2(out))


class EffiDecHead(nn.Module):
    """Efficient decoupled head. Output (N, ny, nx, na, 1 + C + 4 [+ K]
    [+ 5 Kp]) = [conf, cls, bbox, masks, keypoints], the JAX package's
    layout; the mask coefficients come with `num_masks`, the keypoints
    ([x, y, v0, v1, v2] each) with `num_keypoints`.

    The shared regression tower feeds both conf and bbox and is computed
    once. The stem width is round(cin * width_multiple), not channels8.
    The mask branch is `masks_fmap_depth` 3x3 ConvBNorms over the stem and
    a 1x1 `masks_layer`; the keypoint branch likewise
    `keypoints_fmap_depth` of them and a 1x1 `keypoints_layer`.
    `raw_fields=True` returns the 1x1 layers' NCHW maps by field ("conf",
    "cls", "bbox", "masks", "keypoints"; A * D channels each, channel a * D
    + d) for `ops.serve_decode`.
    """

    def __init__(self, in_channels: int, num_classes: int, num_anchors: int = 3,
                 num_masks: Optional[int] = None, num_keypoints: Optional[int] = None,
                 width_multiple: float = 1.0, reg_fmap_depth: int = 1, cls_fmap_depth: int = 1,
                 masks_fmap_depth: Optional[int] = None,
                 keypoints_fmap_depth: Optional[int] = None, folded: bool = False,
                 device=None):
        super().__init__()
        self.num_classes = num_classes
        self.num_anchors = num_anchors
        self.num_masks = num_masks or 0
        self.num_keypoints = num_keypoints or 0
        stem_out = max(round(in_channels * width_multiple), 1)
        reg_depth = max(round(reg_fmap_depth), 1)
        cls_depth = max(round(cls_fmap_depth), 1)

        def conv3(ci):
            return ConvBNorm(ci, stem_out, 3, 1, folded=folded, device=device)

        self.stem_layer = conv3(in_channels)
        self.regression_fmap_layer = nn.Sequential(*[conv3(stem_out) for _ in range(reg_depth + 1)])
        self.classification_fmap_layer = nn.Sequential(*[conv3(stem_out) for _ in range(cls_depth)])
        self.conf_layer = nn.Conv2d(stem_out, num_anchors, 1, device=device)
        self.bbox_layer = nn.Conv2d(stem_out, num_anchors * 4, 1, device=device)
        self.cls_layer = nn.Conv2d(stem_out, num_anchors * num_classes, 1, device=device)
        if self.num_masks:
            m_depth = max(round(masks_fmap_depth or 1), 1)
            self.mask_fmap_layer = nn.Sequential(*[conv3(stem_out) for _ in range(m_depth)])
            self.masks_layer = nn.Conv2d(stem_out, num_anchors * self.num_masks, 1,
                                         device=device)
        if self.num_keypoints:
            kp_depth = max(round(keypoints_fmap_depth or 1), 1)
            self.keypoints_fmap_layer = nn.Sequential(*[conv3(stem_out) for _ in range(kp_depth)])
            self.keypoints_layer = nn.Conv2d(stem_out, num_anchors * 5 * self.num_keypoints, 1,
                                             device=device)

    def forward(self, x: torch.Tensor, raw_fields: bool = False):
        n, _, ny, nx = x.shape
        stem = self.stem_layer(x)
        reg = self.regression_fmap_layer(stem)
        cls_f = self.classification_fmap_layer(stem)
        fields = {"conf": conv2d(reg, self.conf_layer), "cls": conv2d(cls_f, self.cls_layer),
                  "bbox": conv2d(reg, self.bbox_layer)}
        if self.num_masks:
            fields["masks"] = conv2d(self.mask_fmap_layer(stem), self.masks_layer)
        if self.num_keypoints:
            fields["keypoints"] = conv2d(self.keypoints_fmap_layer(stem), self.keypoints_layer)
        if raw_fields:
            return fields
        dims = {"conf": 1, "cls": self.num_classes, "bbox": 4, "masks": self.num_masks,
                "keypoints": 5 * self.num_keypoints}
        return torch.cat([t.permute(0, 2, 3, 1).reshape(n, ny, nx, self.num_anchors, dims[k])
                          for k, t in fields.items()], dim=-1)


class BasicHead(nn.Module):
    """A 3x3 ConvBNorm `stem_layer` of round(cin * width_multiple) channels
    (Python's half-to-even round), then a biased 1x1 `conv` to A * D, D = 5
    + classes + masks + 5 * keypoints. Output (N, ny, nx, A, D): channel
    a * D + d of the conv, the anchor-major [conf | cls | bbox | masks |
    keypoints] packing of EffiDecHead's layout. `raw_fields=True` returns
    {"packed": the conv's NCHW map}. Folded, `stem_layer` runs on the
    conv3x3 kernel; `conv` is a plain conv in every form, as EffiDecHead's
    1x1 layers are."""

    def __init__(self, in_channels: int, num_classes: int, num_anchors: int = 3,
                 num_masks: Optional[int] = None, num_keypoints: Optional[int] = None,
                 width_multiple: float = 1.0, folded: bool = False, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.num_anchors = num_anchors
        self.num_masks = num_masks or 0
        self.num_keypoints = num_keypoints or 0
        stem_out = max(round(in_channels * width_multiple), 1)
        dim = 5 + num_classes + self.num_masks + 5 * self.num_keypoints
        self.stem_layer = ConvBNorm(in_channels, stem_out, 3, 1, folded=folded, device=device)
        self.conv = nn.Conv2d(stem_out, num_anchors * dim, 1, device=device)

    def forward(self, x: torch.Tensor, raw_fields: bool = False):
        n, _, ny, nx = x.shape
        out = conv2d(self.stem_layer(x), self.conv)
        if raw_fields:
            return {"packed": out}
        return out.permute(0, 2, 3, 1).reshape(n, ny, nx, self.num_anchors, -1)


def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """PyTorch's default initialisation drawn from `generator`: conv
    weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)); BatchNorm at
    weight 1, bias 0, mean 0, var 1. Draws on the CPU, then copies."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                for p in (m.weight, m.bias):
                    if p is not None:
                        p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return module


def randomize_batchnorm_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Non-trivial BatchNorm state drawn from `generator`, as a trained net
    has: weight and running_var U(0.5, 1.5), bias and running_mean
    N(0, 0.1^2). Draws on the CPU, then copies."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.BatchNorm2d):
                for t, (lo, hi) in ((m.weight, (0.5, 1.5)), (m.running_var, (0.5, 1.5))):
                    t.copy_(torch.empty(t.shape).uniform_(lo, hi, generator=generator))
                for t in (m.bias, m.running_mean):
                    t.copy_(torch.randn(t.shape, generator=generator) * 0.1)
    return module


def cast_conv_weights(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Serving form of the weights (`infer/runner.py` applies it; training
    keeps f32 parameters): every conv weight in `dtype` and channels_last
    (the layout the kernels read without a copy); biases, BatchNorm and
    other parameters stay f32."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                m.weight = nn.Parameter(
                    m.weight.to(dtype=dtype, memory_format=torch.channels_last),
                    requires_grad=m.weight.requires_grad)
    return module
