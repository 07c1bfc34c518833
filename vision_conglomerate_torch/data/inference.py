"""Inference datasets for images and video, as in the JAX package's
data/inference.py, and TrackNet's frame-stacking variants.

Each item is (resized float image, original uint8 RGB image), both HWC.
The resize is plain bilinear with no letterboxing and no kept aspect ratio.
The image datasets are map-style; the video datasets are iterables over
the decoded frames. A TrackNet item's image is num_stacks frames stacked
newest first, (h, w, 3 * num_stacks), and its original is the newest
frame.
"""
import glob
import os
from collections import deque
from typing import Iterator, Sequence, Tuple

import cv2
import numpy as np

from ..utils.image import load_and_process_img, load_rgb_image


def resize_bilinear(img_f32: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of an HWC float image to (w, h), half-pixel centres
    (torch's align_corners=False)."""
    return cv2.resize(img_f32, tuple(wh), interpolation=cv2.INTER_LINEAR)


class SingleImgSample:
    """One image."""

    def __init__(self, img_path: str, img_wh: Tuple[int, int]):
        self.img_wh = img_wh
        self.og_img = load_rgb_image(img_path)
        self.img = resize_bilinear((self.og_img / 255.0).astype(np.float32), img_wh)

    def __len__(self):
        return 1

    def __getitem__(self, idx: int):
        if idx >= 1:
            raise IndexError(idx)
        return self.img, self.og_img


class InferenceImgDataset:
    """Every image with one of `img_exts` under a directory, recursively,
    in sorted path order."""

    def __init__(self, img_dir: str, img_exts: Sequence[str] = ("png", "jpg", "jpeg"),
                 img_wh: Tuple[int, int] = (640, 640)):
        self.img_wh = img_wh
        files = []
        for ext in img_exts:
            files += glob.glob(os.path.join(img_dir, "**", f"*.{ext}"), recursive=True)
        self.img_files = sorted(set(files))
        if not self.img_files:
            raise FileNotFoundError(f"no {list(img_exts)} files under {img_dir}")

    def __len__(self):
        return len(self.img_files)

    def __getitem__(self, idx: int):
        og = load_rgb_image(self.img_files[idx])
        return resize_bilinear((og / 255.0).astype(np.float32), self.img_wh), og


class InferenceVideoDataset:
    """The frames of a video file (cv2.VideoCapture), keeping frame 0 and
    every (frame_skips + 1)-th frame after it. A file cv2 cannot open
    raises OSError."""

    def __init__(self, video_path: str, img_wh: Tuple[int, int] = (640, 640),
                 frame_skips: int = 0):
        self.video_path = video_path
        self.img_wh = img_wh
        self.frame_skips = max(0, frame_skips)
        self._open().release()  # fail here, before the serve loop writes anything

    def _open(self) -> "cv2.VideoCapture":
        cap = cv2.VideoCapture(self.video_path)
        if not cap.isOpened():
            cap.release()
            raise OSError(f"cv2 cannot open the video {self.video_path}")
        return cap

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        cap = self._open()
        idx = 0
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                if idx % (self.frame_skips + 1) == 0:
                    og = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                    yield resize_bilinear((og / 255.0).astype(np.float32), self.img_wh), og
                idx += 1
        finally:
            cap.release()


class TrackNetInferenceImgDataset:
    """Windows of num_stacks consecutive frames over the sorted `*.img_ext`
    files under a directory (recursively)."""

    def __init__(self, img_dir: str, img_ext: str = "jpg",
                 img_wh: Tuple[int, int] = (640, 352), num_stacks: int = 3):
        self.img_wh = img_wh
        self.num_stacks = num_stacks
        self.img_files = sorted(
            glob.glob(os.path.join(img_dir, "**", f"*.{img_ext}"), recursive=True))
        if len(self.img_files) < num_stacks:
            raise FileNotFoundError(f"need >= {num_stacks} .{img_ext} files under {img_dir}")

    def __len__(self):
        return len(self.img_files) - (self.num_stacks - 1)

    def __getitem__(self, idx: int):
        if idx >= len(self) or idx < 0:
            raise IndexError(idx)
        paths = self.img_files[idx: idx + self.num_stacks][::-1]  # newest first
        frames = [load_and_process_img(p, None, scale=False) for p in paths]
        stacked = np.concatenate([(f / 255.0).astype(np.float32) for f in frames], axis=-1)
        return resize_bilinear(stacked, self.img_wh), frames[0]


class TrackNetInferenceVideoDataset(InferenceVideoDataset):
    """The last num_stacks kept frames of a video (frame 0 and every
    (frame_skips + 1)-th after it), from the num_stacks-th kept frame on."""

    def __init__(self, video_path: str, img_wh: Tuple[int, int] = (640, 352),
                 num_stacks: int = 3, frame_skips: int = 0):
        super().__init__(video_path, img_wh=img_wh, frame_skips=frame_skips)
        self.num_stacks = num_stacks

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        cap = self._open()
        buf = deque(maxlen=self.num_stacks)
        idx = 0
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                if idx % (self.frame_skips + 1) == 0:
                    og = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                    buf.append((og / 255.0).astype(np.float32))
                    if len(buf) == self.num_stacks:
                        stacked = np.concatenate(list(buf)[::-1], axis=-1)  # newest first
                        yield resize_bilinear(stacked, self.img_wh), og
                idx += 1
        finally:
            cap.release()
