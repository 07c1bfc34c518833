"""Host-side image IO (PIL). Layout is HWC, as in the JAX package."""
import numpy as np
from PIL import Image


def load_rgb_image(img_path: str) -> np.ndarray:
    """An image file as an (H, W, 3) uint8 RGB array."""
    with Image.open(img_path) as img:
        return np.asarray(img.convert("RGB"))
