"""BCE and focal losses, as in the JAX package's losses/focal.py.

The focal form is the reference's `alpha * (1 - exp(-bce))**gamma * bce`,
computed from the BCE value itself (not the p_t formulation).
"""
from typing import Optional

import torch


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE with logits in f32, in the stable form
    max(x, 0) - x*t + log1p(exp(-|x|))."""
    x = logits.float()
    t = targets.float()
    return x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))


def focal_loss_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                           gamma: float = 1.5, alpha: float = 0.25) -> torch.Tensor:
    bce = bce_with_logits(logits, targets)
    return alpha * (1.0 - torch.exp(-bce)) ** gamma * bce


def make_binary_lossfn(alpha: Optional[float], gamma: Optional[float]):
    """Focal when alpha and gamma are both set (and non-zero), else BCE."""
    if alpha and gamma:
        return lambda lg, t: focal_loss_with_logits(lg, t, gamma=gamma, alpha=alpha)
    return bce_with_logits


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-element cross entropy with integer labels, no reduction."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None].long())[..., 0]
