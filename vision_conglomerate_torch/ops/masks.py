"""Mask ops: the differentiable box crop, dice scores and prototype mask
assembly, the JAX package's ops/masks.py in PyTorch.

Layout: a prototype stack is (K, H, W) here (NCHW protos, one image),
where the JAX package takes (H, W, K); `assemble_masks` contracts over K
either way.
"""
import torch


def crop_section(image: torch.Tensor, bboxes_xywh: torch.Tensor) -> torch.Tensor:
    """Zero each (h, w) plane of `image` (n, h, w) outside its box
    (n, 4) xywh in pixel units: column r in [x1, x2) and row c in [y1, y2)."""
    _, h, w = image.shape
    half = bboxes_xywh[:, 2:4] / 2
    x1y1 = bboxes_xywh[:, :2] - half
    x2y2 = bboxes_xywh[:, :2] + half
    r = torch.arange(w, dtype=image.dtype, device=image.device)[None, None, :]
    c = torch.arange(h, dtype=image.dtype, device=image.device)[None, :, None]
    x1, y1 = x1y1[:, 0, None, None], x1y1[:, 1, None, None]
    x2, y2 = x2y2[:, 0, None, None], x2y2[:, 1, None, None]
    mask = (r >= x1) & (r < x2) & (c >= y1) & (c < y2)
    return image * mask.to(image.dtype)


def compute_dice_score(mask1: torch.Tensor, mask2: torch.Tensor, round_tensor: bool = False,
                       e: float = 1e-5) -> torch.Tensor:
    """Dice coefficient of (n, h, w) or (n, c, h, w) masks, the mean over
    (n, c) as a 0-dim tensor."""
    if mask1.ndim == 3:
        mask1, mask2 = mask1[:, None], mask2[:, None]
    mask1, mask2 = mask1.clamp(0.0, 1.0), mask2.clamp(0.0, 1.0)
    if round_tensor:
        mask1, mask2 = torch.round(mask1), torch.round(mask2)
    inter = (mask1 * mask2).abs().sum(dim=(2, 3))
    denom = mask1.sum(dim=(2, 3)) + mask2.sum(dim=(2, 3))
    return ((2 * inter + e) / (denom + e)).mean(dim=(0, 1))


def masked_dice_score(pred: torch.Tensor, target: torch.Tensor, valid: torch.Tensor,
                      round_tensor: bool = False, e: float = 1e-5) -> torch.Tensor:
    """Dice of (n, h, w) masks averaged over the valid rows only (0 when
    there are none)."""
    pred, target = pred.clamp(0.0, 1.0), target.clamp(0.0, 1.0)
    if round_tensor:
        pred, target = torch.round(pred), torch.round(target)
    inter = (pred * target).abs().sum(dim=(1, 2))
    denom = pred.sum(dim=(1, 2)) + target.sum(dim=(1, 2))
    dice = (2 * inter + e) / (denom + e)
    v = valid.to(dice.dtype)
    n = v.sum()
    return torch.where(n > 0, (dice * v).sum() / n.clamp(min=1), torch.zeros_like(n))


def assemble_masks(protos_khw: torch.Tensor, coefs: torch.Tensor) -> torch.Tensor:
    """Linear combination of prototypes: (K, h, w) and (n, K) -> (n, h, w)
    mask logits."""
    return torch.einsum("khw,nk->nhw", protos_khw, coefs)
