"""Host-side label IO, polygon rasterising and box-format helpers (numpy
and cv2), as in the JAX package's utils/labels.py: the same arrays, bit for
bit."""
import glob
import os
from typing import List, Sequence, Tuple

import cv2
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


def load_polygon_labels(annotation_file: str) -> List[np.ndarray]:
    """A YOLO-seg txt file -> [cls, x1, y1, x2, y2, ...] float32 rows (rows
    of 5 values or fewer are skipped)."""
    with open(annotation_file, "r") as f:
        lines = [ln.split() for ln in f.read().split("\n")]
    return [np.asarray(ln, dtype=np.float32) for ln in lines if len(ln) > 5]


def interpolate_polygons(polygons: List[np.ndarray], n: int = 500) -> List[np.ndarray]:
    """Each polygon (flat [x1, y1, ...] or (p, 2)), closed, resampled to n
    points by linear interpolation -> (n, 2) arrays."""
    out = []
    for polygon in polygons:
        if polygon.ndim == 1:
            if polygon.shape[0] % 2:
                raise ValueError(f"a flat polygon needs an even length, got {polygon.shape[0]}")
            polygon = np.stack([polygon[0::2], polygon[1::2]], axis=1)
        if not np.all(polygon[0] == polygon[-1]):
            polygon = np.concatenate([polygon, polygon[:1]], axis=0)
        x = np.linspace(0, polygon.shape[0] - 1, num=n)
        xp = np.arange(polygon.shape[0])
        out.append(np.stack(
            [np.interp(x, xp, polygon[:, d]) for d in range(polygon.shape[1])], axis=1))
    return out


def polygons_2_xywh(polygons: Sequence[np.ndarray]) -> List[np.ndarray]:
    """The enclosing xywh box of each (n, 2) polygon."""
    bboxes = []
    for polygon in polygons:
        x1, y1 = polygon[:, 0].min(), polygon[:, 1].min()
        x2, y2 = polygon[:, 0].max(), polygon[:, 1].max()
        w, h = x2 - x1, y2 - y1
        bboxes.append(np.asarray([x1 + w / 2, y1 + h / 2, w, h]))
    return bboxes


def polygons_2_masks(polygons: Sequence[np.ndarray], img_width: int, img_height: int,
                     scale_factor: float = 1.0, color: int = 1) -> np.ndarray:
    """Normalised polygons rasterised (cv2.fillPoly) to (n, H*s, W*s) uint8
    masks."""
    masks = []
    h = round(img_height * scale_factor)
    w = round(img_width * scale_factor)
    for polygon in polygons:
        mask = np.zeros((h, w), dtype=np.uint8)
        pts = (polygon * np.asarray([w, h])).astype(int)
        masks.append(cv2.fillPoly(mask, pts=pts[None], color=color))
    return np.stack(masks, axis=0)


def overlap_masks(masks: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(n, H, W) instance masks -> ((1, H, W) indexed mask, area-descending
    order): object order[i] gets id i + 1, so smaller objects get higher ids
    and lie on top."""
    areas = masks.sum((1, 2))
    order = np.argsort(-areas)
    dtype = np.uint8 if masks.shape[0] <= 255 else np.uint32
    final = np.zeros(masks.shape[1:], dtype=dtype)
    for i, idx in enumerate(order):
        final += (masks[idx] * (i + 1)).astype(dtype)
        final = np.clip(final, 0, i + 1)
    return final[None], order


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


def get_box_sizes_and_class_weights_from_polygons(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(wh of every polygon's box, class weights) over the polygon label
    files under path."""
    files = glob.glob(os.path.join(path, "**", "*.txt"), recursive=True)
    sizes, classes = [], []
    for file in files:
        polygons = load_polygon_labels(file)
        if len(polygons) == 0:
            continue
        classes.extend(p[0] for p in polygons)
        interp = interpolate_polygons([p[1:] for p in polygons])
        bboxes = np.asarray(polygons_2_xywh(interp))
        sizes.append(bboxes[:, -2:])
    return np.concatenate(sizes, axis=0), get_class_weights(classes)
