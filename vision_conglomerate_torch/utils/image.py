"""Host-side image IO (PIL). Layout is HWC, as in the JAX package."""
from typing import Optional, Tuple

import numpy as np
from PIL import Image


def load_rgb_image(img_path: str, img_wh: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """An image file as an (H, W, 3) uint8 RGB array, PIL-resized to img_wh
    = (w, h) when given (the resize of the JAX package's
    utils/image.load_and_process_img)."""
    with Image.open(img_path) as img:
        img = img.convert("RGB")
        if img_wh is not None:
            img = img.resize(tuple(img_wh))
        return np.asarray(img)
