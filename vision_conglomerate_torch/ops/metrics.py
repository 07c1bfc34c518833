"""Classification metrics on the device, as in the JAX package's
ops/metrics.py: a confusion matrix from one-hot products, so the train step
never waits on the host.

Macro averaging follows sklearn: over the classes present in the targets or
the predictions; a class whose precision or recall has a zero denominator
contributes 0.
"""
from typing import Dict

import torch


def macro_classification_metrics(
    pred_labels: torch.Tensor,    # (N,) int
    target_labels: torch.Tensor,  # (N,) int
    valid: torch.Tensor,          # (N,) bool
    num_classes: int,
    e: float = 1e-12,
) -> Dict[str, torch.Tensor]:
    """Accuracy and macro f1/precision/recall over the valid entries; all
    four are NaN when no entry is valid."""
    v = valid.float()
    n_valid = v.sum()
    classes = torch.arange(num_classes, device=pred_labels.device)
    t_oh = (classes[None, :] == target_labels[:, None]).float() * v[:, None]
    p_oh = (classes[None, :] == pred_labels[:, None]).float() * v[:, None]
    conf = t_oh.T @ p_oh  # (C, C) [target, pred]

    tp = torch.diagonal(conf)
    support = conf.sum(dim=1)
    predicted = conf.sum(dim=0)
    present = (support > 0) | (predicted > 0)
    n_present = present.sum().clamp(min=1)

    zero = torch.zeros_like(tp)
    prec_c = torch.where(predicted > 0, tp / (predicted + e), zero)
    rec_c = torch.where(support > 0, tp / (support + e), zero)
    f1_c = torch.where(prec_c + rec_c > 0, 2 * prec_c * rec_c / (prec_c + rec_c + e), zero)

    nan = torch.full_like(n_valid, float("nan"))
    has = n_valid > 0
    out = {
        "accuracy": tp.sum() / n_valid.clamp(min=1),
        "f1": torch.where(present, f1_c, zero).sum() / n_present,
        "precision": torch.where(present, prec_c, zero).sum() / n_present,
        "recall": torch.where(present, rec_c, zero).sum() / n_present,
    }
    return {k: torch.where(has, val, nan) for k, val in out.items()}


def masked_mean(x: torch.Tensor, mask: torch.Tensor, default: float = 0.0) -> torch.Tensor:
    """Mean of x over mask; `default` when mask is empty."""
    m = mask.to(x.dtype)
    denom = m.sum()
    return torch.where(denom > 0, (x * m).sum() / denom.clamp(min=1),
                       torch.full_like(denom, default))
