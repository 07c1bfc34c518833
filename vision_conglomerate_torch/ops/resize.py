"""Nearest-neighbour resizes of NCHW tensors, as in the JAX package's
ops/resize.py (there NHWC): x2 repeats every pixel, x0.5 takes the even
rows and columns, the index rule of torch's nearest Upsample."""
import torch
import torch.nn.functional as F


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Every pixel repeated 2x2. F.interpolate at an integer scale is that
    repeat, and it keeps a channels_last input channels_last."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def downsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Source index floor(i / 0.5) = 2i: every even row and column."""
    return x[:, :, ::2, ::2]


def resize_nchw(x: torch.Tensor, scale: float, method: str = "nearest") -> torch.Tensor:
    if method == "nearest" and scale == 2.0:
        return upsample_nearest_2x(x)
    if method == "nearest" and scale == 0.5:
        return downsample_nearest_2x(x)
    raise NotImplementedError(
        f"resize {method!r} x{scale}: only nearest x2 and x0.5 are ported "
        "(ROADMAP §A.13)")
