"""Post-training int8 quantization of the deploy form, the JAX package's
nn/quantize.py in PyTorch.

The scheme is the JAX package's:
- which convs: every BN-folded ConvBNorm (not a `no_batchnorm` one) and
  every fused RepVGG `conv_reparam` that ran in the calibration pass
  (`nn.blocks.quantized_conv_name`); transpose convs, `no_batchnorm` convs
  and the EffiDecHead's plain 1x1 layers stay in the module dtype;
- activations: symmetric per-tensor int8 with a static scale from the
  calibration pass (`collect_calibration`: the max of |x| in f32 at each
  such conv's input, over the batches);
- weights: symmetric per-output-channel int8 from the f32 folded kernel,
  w_s = max(absmax_IHW(kernel) / 127, 1e-12), w_q = clamp(round(kernel /
  w_s), -127, 127); x_s = max(absmax / 127, 1e-12) (`int8_quantize_`;
  the JAX package's act_margin, which no caller sets, is its default 1);
- compute: `nn.blocks.int8_conv_bias_act` (the JAX package's
  quantized_conv).

Usage, on a deploy-form net whose quantizable convs still hold their f32
folded weights (the serve loaders' `quantize="int8"`):

    absmax = collect_calibration(model, [x], inference=True)
    int8_quantize_(model, absmax)

A JAX package int8 variable tree loads with `load_int8_state_` after
`weights.flax_to_state_dict`.
"""
from typing import Dict, Iterable

import torch
import torch.nn as nn

from .blocks import quantized_conv_name, set_int8_


def quantizable_modules(model: nn.Module) -> Dict[str, nn.Module]:
    """{module path: module} of every conv module the int8 form may
    quantize, in `named_modules` order (the quantized ones included)."""
    return {name: m for name, m in model.named_modules() if quantized_conv_name(m)}


@torch.no_grad()
def collect_calibration(model: nn.Module, batches: Iterable[torch.Tensor],
                        **forward_kwargs) -> Dict[str, torch.Tensor]:
    """Run `model(batch, **forward_kwargs)` over the calibration batches,
    recording at the input of each float quantizable conv the max of |x|
    in f32, maxed over the batches (the JAX package's `calibrating()`
    sow); returns {path: 0-d f32 tensor on the model's device}."""
    absmax: Dict[str, torch.Tensor] = {}

    def hook(path):
        def record(_module, inputs):
            m = inputs[0].detach().float().abs().max()
            absmax[path] = m if path not in absmax else torch.maximum(absmax[path], m)
        return record

    handles = [module.register_forward_pre_hook(hook(path))
               for path, module in quantizable_modules(model).items()
               if not hasattr(module, "q_kernel")]
    try:
        for batch in batches:
            model(batch, **forward_kwargs)
    finally:
        for h in handles:
            h.remove()
    return absmax


def quantize_weights(kernel: torch.Tensor):
    """(w_q int8, w_s f32 (Cout,)) of an OIHW kernel, from its f32 values:
    per output channel w_s = max(absmax / 127, 1e-12), w_q = clamp(round(
    kernel / w_s), -127, 127)."""
    k = kernel.detach().float()
    w_s = torch.clamp(k.abs().amax(dim=(1, 2, 3)) / 127.0, min=1e-12)
    w_q = torch.clamp(torch.round(k / w_s[:, None, None, None]), -127, 127).to(torch.int8)
    return w_q, w_s


def activation_scale(absmax: torch.Tensor) -> torch.Tensor:
    """x_s = max(absmax / 127, 1e-12), a 0-d f32 tensor."""
    return torch.clamp(absmax.detach().float().reshape(()) / 127.0, min=1e-12)


@torch.no_grad()
def int8_quantize_(model: nn.Module, absmax: Dict[str, torch.Tensor]) -> None:
    """Put every quantizable conv module with a calibrated input absmax in
    its int8 form (`nn.blocks.set_int8_`), from its conv's weight in f32
    (the folded kernel: quantize before the serve form's cast of the
    weights to bf16) and its f32 bias; modules without calibration stay
    float."""
    for path, module in quantizable_modules(model).items():
        if path in absmax and not hasattr(module, "q_kernel"):
            conv = getattr(module, quantized_conv_name(module))
            w_q, w_s = quantize_weights(conv.weight)
            set_int8_(module, w_q, w_s, activation_scale(absmax[path]),
                      conv.bias.detach().float())


def load_int8_state_(model: nn.Module, state: Dict[str, torch.Tensor]) -> nn.Module:
    """Load a state_dict of an int8 form (a JAX package int8 variable tree
    through `weights.flax_to_state_dict`): every quantizable module whose
    `<path>.q_kernel` the state holds is put in its int8 form, then the
    whole state is loaded (strictly)."""
    for path, module in quantizable_modules(model).items():
        key = f"{path}.q_kernel" if path else "q_kernel"
        if key in state and not hasattr(module, "q_kernel"):
            conv = getattr(module, quantized_conv_name(module))
            cout = conv.out_channels
            set_int8_(module, torch.zeros(conv.weight.shape, dtype=torch.int8,
                                          device=conv.weight.device),
                      torch.ones(cout, device=conv.weight.device),
                      torch.ones((), device=conv.weight.device),
                      torch.zeros(cout, device=conv.weight.device))
    model.load_state_dict(state)
    return model
