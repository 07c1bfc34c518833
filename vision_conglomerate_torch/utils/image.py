"""Host-side image IO (PIL). Layout is HWC, as in the JAX package's
utils/image.py."""
from typing import Optional, Tuple

import numpy as np
from PIL import Image


def load_rgb_image(img_path: str, img_wh: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """An image file as an (H, W, 3) uint8 RGB array, PIL-resized to img_wh
    = (w, h) when given."""
    return load_and_process_img(img_path, img_wh, scale=False)


def load_and_process_img(img_path: str, img_wh: Optional[Tuple[int, int]] = None,
                         scale: bool = True, convert_to: str = "RGB") -> np.ndarray:
    """An image file as an HWC array (a gray one as (H, W, 1)), PIL-resized
    to img_wh = (w, h) when given, divided by 255 into float32 with
    `scale`, else uint8."""
    with Image.open(img_path) as img:
        img = img.convert(convert_to)
        if img_wh is not None:
            img = img.resize(tuple(img_wh))
        arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[..., None]
    if scale:
        arr = (arr / 255.0).astype(np.float32)
    return arr
