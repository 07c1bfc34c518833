"""Host-side label IO and box-format helpers (numpy), as in the JAX
package's utils/labels.py."""
import glob
import os
from typing import Sequence, Tuple

import numpy as np


def load_bbox_labels(annotation_file: str, bbox_only: bool = True) -> np.ndarray:
    """A YOLO txt file -> (n, 5[+3K]) float32 rows [cls, x, y, w, h, ...]."""
    with open(annotation_file, "r") as f:
        rows = [ln.split() for ln in f.read().split("\n")]
    rows = [ln for ln in rows if ln]
    if not rows:
        return np.zeros((0, 5), np.float32)
    boxes = np.asarray(rows, dtype=np.float32)
    return boxes[:, :5] if bbox_only else boxes


def xywh2xyxy_np(b: np.ndarray) -> np.ndarray:
    x1y1 = b[..., :2] - b[..., 2:4] / 2
    return np.concatenate([x1y1, x1y1 + b[..., 2:4]], axis=-1)


def xyxy2xywh_np(b: np.ndarray) -> np.ndarray:
    wh = b[..., 2:4] - b[..., :2]
    return np.concatenate([b[..., :2] + wh / 2, wh], axis=-1)


def get_class_weights(classes: Sequence[int]) -> np.ndarray:
    """Inverse-frequency class weights, total / (n_classes * count)."""
    counts = np.bincount(sorted(int(c) for c in classes))
    return counts.sum() / (counts.shape[0] * counts)


def get_box_sizes_and_class_weights(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(wh of every box, class weights) over the label files under path."""
    files = glob.glob(os.path.join(path, "**", "*.txt"), recursive=True)
    sizes, classes = [], []
    for file in files:
        bbox = load_bbox_labels(file)
        if len(bbox) == 0:
            continue
        classes.append(bbox[:, 0])
        sizes.append(bbox[:, -2:])
    return np.concatenate(sizes, axis=0), get_class_weights(np.concatenate(classes))
