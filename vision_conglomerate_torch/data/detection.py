"""Detection dataset: YOLO-format images and txt labels -> padded batches,
as in the JAX package's data/detection.py.

Every batch pads its labels to `max_labels` rows per image with a validity
mask, the layout the fixed-capacity assigner takes. Images stay uint8 on the
host (the trainer divides by 255 on the device).

Keypoint columns ((x, y, vis) triples after the box) are kept: their xy go
from image space to bbox-relative, clipped to [0, 1]. The batch pads
ragged keypoint rows with +inf, so the loss's finite filter drops them.
"""
import glob
import logging
import os
from typing import Optional, Tuple, Union

import numpy as np

from ..utils.image import load_rgb_image
from ..utils.labels import load_bbox_labels, xywh2xyxy_np

logger = logging.getLogger(__name__)


class DetectionDataset:
    def __init__(
        self,
        data_dir: str,
        img_ext: str = "png",
        img_wh: Union[int, Tuple[int, int]] = (640, 640),
        max_labels: int = 64,
        decode_backend: str = "pil",
    ):
        if decode_backend == "native":
            raise NotImplementedError(
                "decode_backend 'native' is not in the port yet (ROADMAP §A.8)")
        if decode_backend != "pil":
            raise ValueError(f"unknown decode_backend: {decode_backend!r}")
        if isinstance(img_wh, int):
            img_wh = (img_wh, img_wh)
        self.img_wh = tuple(img_wh)
        self.max_labels = max_labels
        self.img_files = sorted(
            glob.glob(os.path.join(data_dir, "**", f"*.{img_ext}"), recursive=True))
        self.annotation_files = sorted(
            glob.glob(os.path.join(data_dir, "**", "*.txt"), recursive=True))
        if not self.img_files:
            raise FileNotFoundError(
                f"{data_dir} does not contain any .{img_ext} files in its base and sub directories")
        if not self.annotation_files:
            raise FileNotFoundError(
                f"{data_dir} does not contain any .txt files in its base and sub directories")
        if len(self.img_files) != len(self.annotation_files):
            raise ValueError(f"{data_dir}: {len(self.img_files)} images but "
                             f"{len(self.annotation_files)} label files")
        logger.info(f"Number of image samples: {len(self)}")
        self._num_label_cols: Optional[int] = None

    def __len__(self) -> int:
        return len(self.img_files)

    @property
    def num_label_cols(self) -> int:
        """Columns of a label row (5 or 5 + 3K), from the first non-empty
        label file."""
        if self._num_label_cols is None:
            self._num_label_cols = 5
            for f in self.annotation_files:
                raw = load_bbox_labels(f, bbox_only=False)
                if raw.shape[0] > 0:
                    self._num_label_cols = raw.shape[1]
                    break
        return self._num_label_cols

    @property
    def num_keypoints(self) -> int:
        """(columns - 5) // 3 keypoints per box."""
        return max(0, (self.num_label_cols - 5) // 3)

    @staticmethod
    def load_labels(annotation_file: str) -> np.ndarray:
        """(n, 5 + 3K) float32 rows, keypoint xy made bbox-relative and
        clipped to [0, 1]."""
        raw = load_bbox_labels(annotation_file, bbox_only=False)
        if raw.shape[0] > 0 and raw.shape[1] > 5:
            bbox = raw[:, :5]
            kp = raw[:, 5:].reshape(raw.shape[0], -1, 3)
            xyxy = xywh2xyxy_np(bbox[:, 1:])
            span = xyxy[:, None, 2:] - xyxy[:, None, :2]
            kp[..., :2] = np.clip(
                (kp[..., :2] - xyxy[:, None, :2]) / np.maximum(span, 1e-9), 0.0, 1.0)
            raw = np.concatenate([bbox, kp.reshape(kp.shape[0], -1)], axis=1)
        return raw.astype(np.float32)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """(uint8 HWC image resized to img_wh, (n, 5 + 3K) float32 label
        rows)."""
        return (load_rgb_image(self.img_files[idx], self.img_wh),
                self.load_labels(self.annotation_files[idx]))

    def collate_fn(self, batch):
        """Stack images; pad labels to (B, max_labels, C) with a
        (B, max_labels) validity mask. C is the wider of num_label_cols and
        the batch's widest row; box columns pad with 0, keypoint columns
        with +inf."""
        imgs, labels = zip(*batch)
        cols = max(self.num_label_cols, max((lab.shape[1] for lab in labels if lab.size),
                                            default=5))
        out = np.full((len(imgs), self.max_labels, cols), np.inf, dtype=np.float32)
        out[:, :, :5] = 0.0
        mask = np.zeros((len(imgs), self.max_labels), dtype=bool)
        for i, lab in enumerate(labels):
            n = min(lab.shape[0], self.max_labels)
            if lab.shape[0] > self.max_labels:
                logger.warning(
                    f"sample has {lab.shape[0]} labels; truncating to max_labels={self.max_labels}")
            out[i, :n, :lab.shape[1]] = lab[:n]
            mask[i, :n] = True
        return np.stack(imgs, axis=0), out, mask
