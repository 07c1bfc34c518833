"""Box math, as in the JAX package's ops/boxes.py."""
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
