"""TrackNet heatmap ops, as in the JAX package's ops/heatmap.py: the peak
decode on the device and the ground-truth heatmap on the host.

The reference decodes with cv2.HoughCircles on the host (`hough_decode`,
`decode="hough"`); the default decode here is the JAX package's
thresholded centroid, which stays on the device.
"""
import math
from typing import Tuple

import numpy as np
import torch


def decode_heatmap_peaks(heatmaps: torch.Tensor, threshold: int = 128):
    """(B, H, W) uint8 or float heatmaps -> (cx, cy, r, found), each (B,):
    the pixels at or above `threshold` are the blob; (cx, cy) its centroid,
    r = sqrt(area / pi), found = area > 0 (cx, cy are 0 where not found)."""
    binary = (heatmaps.float() >= threshold).float()
    _, h, w = binary.shape
    ys = torch.arange(h, dtype=torch.float32, device=binary.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=binary.device)[None, None, :]
    area = binary.sum(dim=(1, 2))
    denom = area.clamp(min=1.0)
    cx = (binary * xs).sum(dim=(1, 2)) / denom
    cy = (binary * ys).sum(dim=(1, 2)) / denom
    return cx, cy, torch.sqrt(area / math.pi), area > 0


def make_gt_heatmap_np(x: int, y: int, visibility: int, img_wh: Tuple[int, int],
                       variance: float = 5.0) -> np.ndarray:
    """Gaussian ground-truth heatmap, exp(-(dx^2 + dy^2) / (2 variance)) *
    255 as uint8 (all zeros when the ball is not visible)."""
    w, h = img_wh
    if visibility == 0:
        return np.zeros((h, w), dtype=np.uint8)
    yg, xg = np.mgrid[0 - y:h - y, 0 - x:w - x]
    return (np.exp(-(yg ** 2 + xg ** 2) / (2 * variance)) * 255).astype(np.uint8)


HOUGH_DEFAULTS = dict(method="HOUGH_GRADIENT", dp=1, minDist=1, param1=50, param2=2,
                      minRadius=2, maxRadius=7)


def hough_decode(heatmaps: np.ndarray, threshold: int, hough_grad_config=None) -> np.ndarray:
    """(B, H, W) uint8 heatmaps -> (B, 3) circles [x, y, r], NaN where
    cv2.HoughCircles finds none or more than one on the heatmap binarised
    at `threshold` (the reference's decode)."""
    import cv2

    kwargs = {**HOUGH_DEFAULTS, **(hough_grad_config or {})}
    if isinstance(kwargs["method"], str):
        kwargs["method"] = getattr(cv2, kwargs["method"])
    out = np.full((heatmaps.shape[0], 3), np.nan)
    for i in range(heatmaps.shape[0]):
        hm = np.where(heatmaps[i] >= threshold, 255, 0).astype(np.uint8)
        circles = cv2.HoughCircles(hm, **kwargs)
        if circles is not None and len(circles) == 1:
            out[i] = circles[0][0][:3]
    return out
