"""Weight initialisation, as in the JAX package's nn/initializers.py:

- "xavier" (detection and segmentation): every conv kernel Xavier-uniform,
  U(+-sqrt(6 / (fan_in + fan_out))) with fan = channels * kh * kw, and
  every conv bias 0.01;
- "uniform" (TrackNet): every conv kernel U(-0.05, 0.05), every conv bias 0.

Both reach every conv and transpose conv. BatchNorm stays at weight 1,
bias 0.

The draws come from an explicit torch.Generator on the CPU. The JAX package
derives its keys from Python's salted `hash()`, so the two agree in
distribution, not in values.
"""
import math

import torch
import torch.nn as nn

_CONVS = (nn.Conv2d, nn.ConvTranspose2d)


def xavier_conv_init(module: nn.Module, generator: torch.Generator,
                     bias_fill: float = 0.01) -> nn.Module:
    """Re-draw every conv of `module` in place (module order)."""
    with torch.no_grad():
        for m in module.modules():
            if not isinstance(m, _CONVS):
                continue
            cout, cin, kh, kw = m.weight.shape  # (I, O, ...) for a transpose conv
            bound = math.sqrt(6.0 / ((cin + cout) * kh * kw))
            m.weight.copy_(torch.empty(m.weight.shape).uniform_(-bound, bound,
                                                                generator=generator))
            if m.bias is not None:
                m.bias.fill_(bias_fill)
    return module


def uniform_conv_init(module: nn.Module, generator: torch.Generator,
                      low: float = -0.05, high: float = 0.05) -> nn.Module:
    """Re-draw every conv of `module` in place (module order): kernels
    U(low, high), biases 0."""
    with torch.no_grad():
        for m in module.modules():
            if not isinstance(m, _CONVS):
                continue
            m.weight.copy_(torch.empty(m.weight.shape).uniform_(low, high, generator=generator))
            if m.bias is not None:
                m.bias.zero_()
    return module


INIT_SCHEMES = {"xavier": xavier_conv_init, "uniform": uniform_conv_init}
