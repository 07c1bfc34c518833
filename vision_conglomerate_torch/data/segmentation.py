"""Segmentation dataset: polygon labels -> boxes and rasterised masks, the
JAX package's data/segmentation.py in PyTorch's host code (numpy and cv2,
the same arrays bit for bit).

With `overlap_masks` (the default) all instances of an image share one
indexed (H, W) mask in which smaller objects get higher ids
(`utils.labels.overlap_masks`); the labels are reordered by descending
area to stay aligned, so label slot m is mask id m + 1, the assigner's
overlap `tmask_idx`. Without it, the masks are a (max_labels, Hm, Wm)
stack aligned with the label slots. `mask_store_wh` nearest-resizes the
masks on the host (index floor(i * in / out)) to bound what goes to the
device; the loss resizes to the protos' size in any case.
"""
from typing import Optional, Tuple

import numpy as np

from ..utils.image import load_rgb_image
from ..utils.labels import (get_class_weights, interpolate_polygons, load_polygon_labels,
                            overlap_masks, polygons_2_masks, polygons_2_xywh)
from .detection import DetectionDataset


class SegmentationDataset(DetectionDataset):
    def __init__(self, *args, overlap_masks: bool = True, mask_scale_factor: float = 1.0,
                 mask_store_wh: Optional[Tuple[int, int]] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.overlap_masks = overlap_masks
        self.mask_scale_factor = mask_scale_factor
        self.mask_store_wh = mask_store_wh

    def __getitem__(self, idx: int):
        """(uint8 HWC image, (n, 5) float32 labels, uint8 masks: (1, Hm, Wm)
        indexed with overlap, else (n, Hm, Wm))."""
        img = load_rgb_image(self.img_files[idx], self.img_wh)
        raw = load_polygon_labels(self.annotation_files[idx])
        h, w = img.shape[0], img.shape[1]
        if len(raw) > 0:
            polygons = interpolate_polygons([p[1:] for p in raw])
            labels = np.zeros((len(polygons), 5), dtype=np.float32)
            labels[:, 0] = np.asarray([p[0] for p in raw])
            labels[:, 1:] = np.asarray(polygons_2_xywh(polygons))
            masks = polygons_2_masks(polygons, w, h, scale_factor=self.mask_scale_factor)
            if self.overlap_masks:
                masks, order = overlap_masks(masks)
                labels = labels[order]
        else:
            labels = np.zeros((0, 5), dtype=np.float32)
            mh, mw = round(h * self.mask_scale_factor), round(w * self.mask_scale_factor)
            masks = np.zeros(((1 if self.overlap_masks else 0), mh, mw), dtype=np.uint8)
        if self.mask_store_wh is not None:
            masks = _nearest_resize_stack(masks, self.mask_store_wh)
        return img, labels, masks

    def get_class_weights(self) -> np.ndarray:
        classes = []
        for f in self.annotation_files:
            classes.extend(p[0] for p in load_polygon_labels(f))
        return get_class_weights(classes).astype(np.float32)

    def collate_fn(self, batch):
        """(B, H, W, 3) uint8 images, (B, M, 5) labels, (B, M) validity and
        uint8 target masks: (B, Hm, Wm) indexed with overlap, else
        (B, M, Hm, Wm) binary and slot-aligned with the labels."""
        imgs, labels, masks = zip(*batch)
        b = len(imgs)
        out = np.zeros((b, self.max_labels, 5), dtype=np.float32)
        valid = np.zeros((b, self.max_labels), dtype=bool)
        for i, lab in enumerate(labels):
            n = min(lab.shape[0], self.max_labels)
            out[i, :n] = lab[:n]
            valid[i, :n] = True
        if self.overlap_masks:
            tgt = np.stack([m[0] for m in masks], axis=0)
        else:
            # an image without labels has a (0, Hm, Wm) stack of the stored
            # size (the JAX package takes the image's size there, which
            # fails with mask_store_wh)
            mh, mw = masks[0].shape[1:]
            tgt = np.zeros((b, self.max_labels, mh, mw), dtype=np.uint8)
            for i, m in enumerate(masks):
                n = min(m.shape[0], self.max_labels)
                tgt[i, :n] = m[:n]
        return np.stack(imgs, axis=0), out, valid, tgt


def _nearest_resize_stack(masks: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
    """Nearest resize of an (n, H, W) stack to (n, h, w), source index
    floor(i * in / out)."""
    if masks.shape[0] == 0:
        return np.zeros((0, wh[1], wh[0]), dtype=masks.dtype)
    w, h = wh
    ys = (np.arange(h) * masks.shape[1] / h).astype(int)
    xs = (np.arange(w) * masks.shape[2] / w).astype(int)
    return masks[:, ys][:, :, xs]
