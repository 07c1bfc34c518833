"""TrackNet dataset, the JAX package's data/tracknet.py: clip label CSVs
-> sliding windows of stacked frames + Gaussian ground-truth heatmaps.

- `*/Clip*/Label.csv` under data_path are aggregated; each window is
  num_stacks consecutive frames labelled by the last frame's (visibility,
  x, y, status), stacked newest first;
- the ball's (x, y) is rescaled to img_wh, the stacked frames are resized
  with cv2.INTER_LINEAR, and the heatmap is exp(-(dx^2 + dy^2) / (2 var))
  * 255 as uint8 with var = avg_diameter;
- transfer_dtype "float32" divides by 255 before the resize (the
  reference's order); "uint8" resizes the raw bytes and leaves the /255 to
  the trainer on the device (4x fewer bytes to the card);
- the windows are shuffled with `seed` and split at split_percentage; the
  rest is `unused_labels_df`, which the train CLI hands to the eval set.

Items are (frames (H, W, 3 * num_stacks), heatmap (H, W) uint8, others
[visibility, x, y, status] float32); with `cache` each decoded item is kept
(read-only) for later epochs.
"""
import glob
import os
from typing import Optional, Tuple, Union

import cv2
import numpy as np
import pandas as pd

from ..ops.heatmap import make_gt_heatmap_np
from ..utils.image import load_and_process_img


class TrackNetDataset:
    def __init__(
        self,
        data_path: Optional[str] = None,
        labels_df: Optional[pd.DataFrame] = None,
        *,
        num_stacks: int = 3,
        img_wh: Union[int, Tuple[int, int]] = (640, 352),
        avg_diameter: int = 5,
        split_percentage: Optional[float] = None,
        seed: Optional[int] = None,
        cache: bool = False,
        transfer_dtype: str = "float32",
    ):
        if transfer_dtype not in ("float32", "uint8"):
            raise ValueError(f"transfer_dtype must be 'float32' or 'uint8', got {transfer_dtype!r}")
        if (labels_df is None) == (data_path is None):
            raise ValueError(
                "You either pass in labels_df or data_path, not both and both cannot be NoneType")
        self.data_path = data_path
        self.img_wh = (img_wh, img_wh) if isinstance(img_wh, int) else tuple(img_wh)
        self.num_stacks = num_stacks
        self.avg_diameter = avg_diameter
        self.split_percentage = split_percentage or 1.0
        df = self._aggregate_labels_dfs() if data_path is not None else labels_df
        df = df.sample(frac=1, random_state=seed)
        split = int(self.split_percentage * df.shape[0])
        self.labels_df = df.iloc[:split].reset_index(drop=True)
        self.unused_labels_df = df.iloc[split:].reset_index(drop=True)
        self.cache = cache
        self._cache: dict = {}
        self.transfer_dtype = transfer_dtype

    def __len__(self) -> int:
        return self.labels_df.shape[0]

    def __getitem__(self, idx: int):
        if self.cache and idx in self._cache:
            return self._cache[idx]
        item = self._load_item(idx)
        if self.cache:
            for arr in item:
                arr.flags.writeable = False
            self._cache[idx] = item
        return item

    def _load_item(self, idx: int):
        *frame_paths, visibility, x, y, status = self.labels_df.iloc[idx, :]
        ship_u8 = self.transfer_dtype == "uint8"
        frames = [load_and_process_img(p, None, scale=not ship_u8)
                  for p in frame_paths][::-1]  # newest first
        stacked = np.concatenate(frames, axis=-1)
        if visibility == 0:
            x, y = -1, -1
        else:
            x = x * (self.img_wh[0] / stacked.shape[1])
            y = y * (self.img_wh[1] / stacked.shape[0])
        stacked = cv2.resize(stacked, self.img_wh, interpolation=cv2.INTER_LINEAR)
        heatmap = make_gt_heatmap_np(
            int(x), int(y), int(visibility), self.img_wh, variance=self.avg_diameter)
        others = np.asarray([visibility, x, y, status], dtype=np.float32)
        return (stacked if ship_u8 else stacked.astype(np.float32)), heatmap, others

    def collate_fn(self, batch):
        frames, heatmaps, others = zip(*batch)
        return np.stack(frames), np.stack(heatmaps), np.stack(others)

    def _aggregate_labels_dfs(self) -> pd.DataFrame:
        dfs = [self._finalize_label_df(pd.read_csv(os.path.join(d, "Label.csv")), d)
               for d in glob.glob(os.path.join(self.data_path, "*/Clip*"), recursive=True)]
        return pd.concat(dfs, axis=0).reset_index(drop=True)

    def _finalize_label_df(self, label_df: pd.DataFrame, clip_dir: str) -> pd.DataFrame:
        """Windows of num_stacks frame paths and the last frame's labels."""
        paths = os.path.join(clip_dir, "") + label_df["file name"]
        final = pd.DataFrame()
        n = label_df.shape[0]
        for i in range(self.num_stacks):
            final[f"frame{i + 1}"] = paths.iloc[i: n - (self.num_stacks - i) + 1].to_list()
        extra = label_df.iloc[self.num_stacks - 1:][
            ["visibility", "x-coordinate", "y-coordinate", "status"]].reset_index(drop=True)
        return pd.concat([final, extra], axis=1)
