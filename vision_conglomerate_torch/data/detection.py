"""Detection dataset: YOLO-format images and txt labels -> padded batches,
as in the JAX package's data/detection.py.

Every batch pads its labels to `max_labels` rows per image with a validity
mask, the layout the fixed-capacity assigner takes. Images stay uint8 on the
host (the trainer divides by 255 on the device). Labels keep their 5 box
columns: keypoint columns are only counted (`num_keypoints`), since the
port's net has no keypoint head yet and raises on them (ROADMAP §A.13).
"""
import glob
import logging
import os
from typing import Tuple, Union

import numpy as np

from ..utils.image import load_rgb_image
from ..utils.labels import load_bbox_labels

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

    def __len__(self) -> int:
        return len(self.img_files)

    @property
    def num_keypoints(self) -> int:
        """(columns - 5) // 3 of the first non-empty label file."""
        for f in self.annotation_files:
            raw = load_bbox_labels(f, bbox_only=False)
            if raw.shape[0] > 0:
                return max(0, (raw.shape[1] - 5) // 3)
        return 0

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """(uint8 HWC image resized to img_wh, (n, 5) float32 label rows)."""
        return (load_rgb_image(self.img_files[idx], self.img_wh),
                load_bbox_labels(self.annotation_files[idx]))

    def collate_fn(self, batch):
        """Stack images; pad labels to (B, max_labels, 5) with a
        (B, max_labels) validity mask."""
        imgs, labels = zip(*batch)
        out = np.zeros((len(imgs), self.max_labels, 5), dtype=np.float32)
        mask = np.zeros((len(imgs), self.max_labels), dtype=bool)
        for i, lab in enumerate(labels):
            n = min(lab.shape[0], self.max_labels)
            if lab.shape[0] > self.max_labels:
                logger.warning(
                    f"sample has {lab.shape[0]} labels; truncating to max_labels={self.max_labels}")
            out[i, :n] = lab[:n]
            mask[i, :n] = True
        return np.stack(imgs, axis=0), out, mask
