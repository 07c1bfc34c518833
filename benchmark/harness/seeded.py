"""Weights and inputs made from the run's seed, on the device, in a few
large draws.

Weights: one normal and one uniform draw over every float entry of a
state dict, sliced by key in sorted order, so any two models with the same
keys and shapes (the port's and the reference's) get the same values:
- conv weights He-normal, N(0, 2 / fan_in), so activations keep their
  scale through depth;
- conv biases N(0, 0.02^2);
- BatchNorm like a trained net's: weight and running_var U(0.5, 1.5),
  bias and running_mean N(0, 0.1^2);
- `num_batches_tracked` left alone.
A served net's running statistics then come from data
(`calibrate_batchnorm`), as a trained net's do.
"""
import math
from typing import Dict, List, Tuple

import torch

WEIGHTS, INPUTS, CALIBRATION = 1, 2, 3


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one stream of the run's seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) + (stream << 40)) % (1 << 63))
    return g


def fill_state(state: Dict[str, torch.Tensor], seed: int) -> Dict[str, torch.Tensor]:
    """New tensors for every float entry of `state` (same device)."""
    keys = sorted(k for k, v in state.items() if v.is_floating_point())
    dev = state[keys[0]].device
    total = sum(state[k].numel() for k in keys)
    g = generator(seed, WEIGHTS, dev)
    z = torch.randn(total, generator=g, device=dev)
    u = torch.rand(total, generator=g, device=dev)
    bn = {k.rsplit(".", 1)[0] for k in keys if k.endswith("running_var")}
    out, at = {}, 0
    for k in keys:
        shape = state[k].shape
        n = state[k].numel()
        zk, uk = z[at:at + n].view(shape), u[at:at + n].view(shape)
        at += n
        prefix, leaf = k.rsplit(".", 1)
        if prefix in bn:
            out[k] = (0.5 + uk) if leaf in ("weight", "running_var") else 0.1 * zk
        elif len(shape) == 4:
            out[k] = zk * math.sqrt(2.0 / (n // shape[0]))
        else:
            out[k] = 0.02 * zk
    for k, v in state.items():
        if k not in out:
            out[k] = v.clone()
    return out


def calibrate_batchnorm(model: torch.nn.Module, *inputs
                        ) -> Tuple[Dict[str, torch.Tensor], List[tuple]]:
    """(state, conv records) of `model` (the reference, with the seeded
    weights) after one train-mode forward on `inputs` with cumulative
    running statistics: every BatchNorm's running mean and variance become
    those of the data at its input, so the eval-mode net keeps its
    activations at the scale the weights give them. The conv records of
    that forward (reference/layers.py) give the FLOP and byte counts."""
    from ..reference.layers import conv_records

    norms = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in norms:
        m.reset_running_stats()
        m.momentum = None
    model.train()
    with torch.no_grad(), conv_records() as records:
        model(*inputs)
    for m in norms:
        m.momentum = 0.1
    state = {k: v.detach().clone() for k, v in model.eval().state_dict().items()}
    return state, list(records)


def frames_f32(shape: Tuple[int, ...], seed: int, device, stream: int = INPUTS
               ) -> torch.Tensor:
    """Float32 images in [0, 1), as the serve runners stage them."""
    return torch.rand(shape, generator=generator(seed, stream, device), device=device)


def tracknet_batches(ring: int, batch: int, hw: Tuple[int, int], channels: int, seed: int,
                     device, diameter: float = 5.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ring, batch, H, W, channels) uint8 frame stacks and (ring, batch, H,
    W) uint8 heatmaps: a Gaussian ball of variance `diameter` at a random
    centre, 255 at its peak, and an empty heatmap for one window in ten
    (the ball not visible), as TrackNet's labels are."""
    g = generator(seed, INPUTS, device)
    h, w = hw
    frames = torch.randint(0, 256, (ring, batch, h, w, channels), generator=g, device=device,
                           dtype=torch.uint8)
    cx = torch.rand((ring, batch, 1, 1), generator=g, device=device) * (w - 1)
    cy = torch.rand((ring, batch, 1, 1), generator=g, device=device) * (h - 1)
    seen = torch.rand((ring, batch, 1, 1), generator=g, device=device) >= 0.1
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    d2 = (xs - cx.round()) ** 2 + (ys - cy.round()) ** 2
    heat = (torch.exp(-d2 / (2 * diameter)) * 255).to(torch.uint8) * seen
    return frames, heat
