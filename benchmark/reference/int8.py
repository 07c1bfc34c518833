"""TrackNet base's int8 serve form in plain PyTorch, written out from the
float32 reference's state (reference/tracknet.py).

The scheme is the port's documented post-training quantization
(vision_conglomerate_torch/nn/quantize.py and ops/int8.py, the JAX
package's nn/quantize.py), restated here from its description:

- the deploy form folds each BatchNorm into its conv in float32:
  w' = w * gamma / sqrt(var + eps), b' = (b - mean) * gamma / sqrt(var + eps) + beta;
- which convs: every conv of a ConvBNorm with a BatchNorm. A conv without
  one (TrackNet's dec_13) stays float in the compute dtype;
- weights: per output channel, from the float32 folded kernel,
  w_s = max(absmax_IHW(w') / 127, 1e-12), w_q = clamp(round(w' / w_s), -127, 127);
- activations: one scale a tensor, x_s = max(absmax / 127, 1e-12), where
  absmax is the largest |x| at the conv's input over the calibration batch
  in the float deploy forward;
- x_q = clamp(round(x / x_s), -127, 127): a true division, and torch.round,
  which rounds half to even;
- the sum over x_q * w_q is exact: a float64 conv of the integer values
  (every sum is below 2**53);
- y = act(float32(sum) * (w_s * x_s) + b') in float32, then stored in the
  compute dtype.

The compute dtype is the one the network runs in: the frame stack is cast
to it first, and every conv's output is stored in it, in the float deploy
forward (which sets the scales) as in the int8 one. The benchmark passes
the configuration's bfloat16 on the card and float32 on the CPU, as the
port runs there.

Departures from the port, none of which changes the scheme:
- a float conv (the calibration forward, dec_13) is an F.conv2d in float32
  of the values in the compute dtype: the products are exact and the sum
  is float32 in cuDNN's order, where the port's bf16 kernel sums in float32
  in its own order. The ties this moves flip an x_q by one here and there;
- the int8 dequantize is two roundings (multiply, then add the bias), as
  the port's plain version; its kernel's epilogue may fuse them;
- dec_13's logits stay float32 (the port stores them in bf16): they judge
  the classes the port served;
- no channel padding: the port's padded channels are zeros and change no
  sum;
- the fold is computed on the device the reference runs on, the port's on
  the CPU.
"""
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import BN_EPS, ConvBNorm, act

QMAX = 127


def quantized(module: torch.nn.Module) -> bool:
    """Whether the int8 form quantizes this module's conv."""
    return isinstance(module, ConvBNorm) and not module.no_batchnorm


def mark_routes(model: torch.nn.Module) -> torch.nn.Module:
    """Name the int8 form's kernels in the conv records of `model`
    (reference/layers.py): a quantized conv's route gains `_s8` ("conv3x3"
    -> "conv3x3_s8"), one with no float kernel is "conv_s8"; the others
    keep theirs."""
    for m in model.modules():
        if quantized(m):
            m.routed = f"{m.routed}_s8" if m.routed else "conv_s8"
    return model


def fold(m: ConvBNorm) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w', b') in float32 of a ConvBNorm, its BatchNorm folded in; a conv
    without a BatchNorm keeps its own."""
    w = m.conv.weight.detach().float()
    b = m.conv.bias
    b = torch.zeros(w.shape[0], device=w.device) if b is None else b.detach().float()
    if m.no_batchnorm:
        return w, b
    n = m.norm
    scale = n.weight.detach().float() / torch.sqrt(n.running_var.float() + BN_EPS)
    return w * scale.view(-1, 1, 1, 1), (b - n.running_mean.float()) * scale + n.bias.float()


def quantize_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w_q as integer-valued float64, w_s (Cout,) float32) of an OIHW kernel."""
    w_s = torch.clamp(w.abs().amax(dim=(1, 2, 3)) / QMAX, min=1e-12)
    w_q = torch.clamp(torch.round(w / w_s.view(-1, 1, 1, 1)), -QMAX, QMAX)
    return w_q.double(), w_s


class Int8Net:
    """The int8 form of `ref` (a reference TrackNetBase in eval mode),
    calibrated on `calib` (B, C, H, W) float32 frames, in blocks of `block`
    rows. `act_scale` multiplies every activation scale (1 is the scheme;
    4 is 6-bit activations on the same sums, a control). Calling it on
    (B, C, H, W) frames gives float32 logits."""

    def __init__(self, ref: torch.nn.Module, calib: torch.Tensor, dtype: torch.dtype,
                 block: int = 8, act_scale: float = 1.0):
        self.ref, self.dtype = ref, dtype
        self.mods = [m for m in ref.modules() if isinstance(m, ConvBNorm)]
        self.folded = {m: fold(m) for m in self.mods}
        self.absmax: Dict[ConvBNorm, torch.Tensor] = {}
        with torch.no_grad(), self._convs(self._float_conv):
            for i in range(0, calib.shape[0], block):
                ref(calib[i:i + block].to(dtype))
        self.q: Dict[ConvBNorm, tuple] = {}
        for m in self.mods:
            if quantized(m):
                w_q, w_s = quantize_weights(self.folded[m][0])
                x_s = torch.clamp(self.absmax[m] / QMAX, min=1e-12) * act_scale
                self.q[m] = (w_q, w_s, x_s)

    @contextmanager
    def _convs(self, conv) -> Iterator[None]:
        """Every ConvBNorm of the reference computes as `conv(m, x)` inside
        the block (an instance attribute over the class's forward)."""
        for m in self.mods:
            m.forward = (lambda mod: lambda x: conv(mod, x))(m)
        try:
            yield
        finally:
            for m in self.mods:
                del m.forward

    def _out(self, m: ConvBNorm, y: torch.Tensor) -> torch.Tensor:
        """The activation, stored in the compute dtype; the last conv's
        logits stay float32."""
        y = act(y, m.activation)
        return y if m.no_batchnorm else y.to(self.dtype)

    def _float_conv(self, m: ConvBNorm, x: torch.Tensor) -> torch.Tensor:
        if quantized(m):
            a = x.detach().float().abs().amax()
            self.absmax[m] = a if m not in self.absmax else torch.maximum(self.absmax[m], a)
        w, b = self.folded[m]
        y = F.conv2d(x.float(), w.to(self.dtype).float(), b, m.conv.stride, m.conv.padding)
        return self._out(m, y)

    def _int8_conv(self, m: ConvBNorm, x: torch.Tensor) -> torch.Tensor:
        if not quantized(m):
            return self._float_conv(m, x)
        w_q, w_s, x_s = self.q[m]
        x_q = torch.clamp(torch.round(x.float() / x_s), -QMAX, QMAX)
        acc = F.conv2d(x_q.double(), w_q, None, m.conv.stride, m.conv.padding)
        scale = (w_s * x_s).view(1, -1, 1, 1)
        y = acc.float() * scale + self.folded[m][1].view(1, -1, 1, 1)
        return self._out(m, y)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with self._convs(self._int8_conv):
            return self.ref(x.to(self.dtype))

    def scales(self) -> List[Optional[float]]:
        """Each ConvBNorm's activation scale, in module order (None where
        it stays float)."""
        return [float(self.q[m][2]) if m in self.q else None for m in self.mods]
