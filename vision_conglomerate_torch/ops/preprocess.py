"""Input preprocessing on the device."""
import torch


def normalize_images(imgs_u8: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 images -> [0, 1] floats (the /255 of the JAX package's
    ops/preprocess.normalize_images)."""
    return imgs_u8.to(dtype) / torch.tensor(255.0, dtype=dtype, device=imgs_u8.device)
