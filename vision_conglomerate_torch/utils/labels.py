"""Host-side box-format helpers (numpy)."""
import numpy as np


def xyxy2xywh_np(b: np.ndarray) -> np.ndarray:
    wh = b[..., 2:4] - b[..., :2]
    return np.concatenate([b[..., :2] + wh / 2, wh], axis=-1)
