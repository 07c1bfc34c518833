"""Box math, as in the JAX package's ops/boxes.py: xywh <-> xyxy, pairwise
IoU, and the full CIoU of the detection loss with its detached trade-off
term and epsilon placement."""
import math

import torch


def xywh2xyxy(b: torch.Tensor) -> torch.Tensor:
    x1y1 = b[..., :2] - b[..., 2:4] / 2
    x2y2 = x1y1 + b[..., 2:4]
    return torch.cat([x1y1, x2y2], dim=-1)


def box_iou_xyxy(a: torch.Tensor, b: torch.Tensor, e: float = 1e-9) -> torch.Tensor:
    """Pairwise IoU: a (..., N, 4), b (..., M, 4) -> (..., N, M)."""
    a = a[..., :, None, :]
    b = b[..., None, :, :]
    iw = (torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0])).clamp(min=0)
    ih = (torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1])).clamp(min=0)
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)
    return inter / (area_a + area_b - inter + e)


def compute_ciou(preds_xywh: torch.Tensor, targets_xywh: torch.Tensor,
                 e: float = 1e-7) -> torch.Tensor:
    """Complete IoU of xywh boxes (last dim 4); targets may have one dim
    fewer and then broadcast over the preds' second-to-last dim. The
    aspect-ratio term divides by h clamped to 1e-9, so a zero height gives
    a finite value and gradient."""
    if targets_xywh.dim() != preds_xywh.dim():
        targets_xywh = targets_xywh.unsqueeze(-2)
    pw, ph = preds_xywh[..., 2:3], preds_xywh[..., 3:4]
    px1 = preds_xywh[..., 0:1] - pw / 2
    py1 = preds_xywh[..., 1:2] - ph / 2
    px2, py2 = px1 + pw, py1 + ph
    tw, th = targets_xywh[..., 2:3], targets_xywh[..., 3:4]
    tx1 = targets_xywh[..., 0:1] - tw / 2
    ty1 = targets_xywh[..., 1:2] - th / 2
    tx2, ty2 = tx1 + tw, ty1 + th

    iw = (torch.minimum(px2, tx2) - torch.maximum(px1, tx1)).clamp(min=0)
    ih = (torch.minimum(py2, ty2) - torch.maximum(py1, ty1)).clamp(min=0)
    inter = iw * ih
    union = pw * ph + tw * th - inter
    iou = inter / (union + e)

    cw = torch.maximum(px2, tx2) - torch.minimum(px1, tx1)
    ch = torch.maximum(py2, ty2) - torch.minimum(py1, ty1)
    c2 = cw ** 2 + ch ** 2 + e
    v = (4.0 / math.pi ** 2) * torch.square(
        torch.atan(tw / th.clamp(min=1e-9)) - torch.atan(pw / ph.clamp(min=1e-9)))
    rho2 = (torch.square(preds_xywh[..., 0:1] - targets_xywh[..., 0:1])
            + torch.square(preds_xywh[..., 1:2] - targets_xywh[..., 1:2]))
    a = (v / (v - iou + (1 + e))).detach()
    return (iou - (rho2 / c2 + a * v)).squeeze(-1)
