"""Resizes of NCHW tensors, the JAX package's ops/resize.py (there NHWC).

Nearest x2 repeats every pixel and nearest x0.5 takes the even rows and
columns (the index rule of torch's nearest Upsample); every other resize
is `jax.image.resize`'s:

- `nearest` at another scale or a `size`: source index floor((i + 0.5) *
  in / out), computed in f32 (half-pixel centres: torch's
  `nearest-exact`, not its `nearest`);
- `linear` (`bilinear`), `cubic` (`bicubic`: Keys with a = -0.5, where
  torch's bicubic takes -0.75), `lanczos3` and `lanczos5`: separable
  weights per axis as `jax.image.scale_and_translate` builds them, with
  half-pixel centres, the kernel widened by in / out when the axis shrinks
  (antialiasing: a linear x0.5 averages a triangle footprint, it does not
  take every second pixel), each output's weights normalised to sum 1 and
  zeroed where the sample falls outside the input. The weights are
  computed in f32, cast to x's dtype, and applied with one einsum an
  axis. An axis whose size does not change is left as it is.
"""
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Every pixel repeated 2x2. F.interpolate at an integer scale is that
    repeat, and it keeps a channels_last input channels_last."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def downsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Source index floor(i / 0.5) = 2i: every even row and column."""
    return x[:, :, ::2, ::2]


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _lanczos(radius: float) -> Callable[[torch.Tensor], torch.Tensor]:
    def kernel(x: torch.Tensor) -> torch.Tensor:
        y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
        safe = torch.where(x != 0, math.pi ** 2 * x ** 2, torch.ones_like(x))
        out = torch.where(x > 1e-3, y / safe, torch.ones_like(x))
        return torch.where(x > radius, torch.zeros_like(x), out)
    return kernel


KERNELS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "linear": _triangle, "bilinear": _triangle, "trilinear": _triangle, "triangle": _triangle,
    "cubic": _keys_cubic, "bicubic": _keys_cubic, "tricubic": _keys_cubic,
    "lanczos3": _lanczos(3.0), "lanczos5": _lanczos(5.0),
}
METHODS = ("nearest",) + tuple(KERNELS)


def resize_weights(in_size: int, out_size: int, method: str, device=None) -> torch.Tensor:
    """(in_size, out_size) f32 weights of one axis, `jax.image.resize`'s
    `compute_weight_mat` with scale out / in, no translation, antialias."""
    kernel = KERNELS[method]
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    w = kernel((sample[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _nearest_index(in_size: int, out_size: int, device) -> torch.Tensor:
    """floor((i + 0.5) * in / out) in f32, as jax.image.resize's nearest."""
    pos = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * in_size / out_size
    return torch.floor(pos).long()


def resize_nchw(x: torch.Tensor, scale: Optional[float] = None, *,
                size: Optional[Sequence[int]] = None, method: str = "nearest") -> torch.Tensor:
    """Resize an NCHW tensor by `scale` or to the spatial `size` (h, w).
    Nearest x2 and x0.5 by `scale` take their exact fast forms; the rest is
    `jax.image.resize(method)` on H and W (module docstring). A
    channels_last input gives a channels_last output."""
    if method not in METHODS:
        raise ValueError(f"unknown resize method {method!r}; known: {METHODS}")
    if method == "nearest" and scale == 2.0:
        return upsample_nearest_2x(x)
    if method == "nearest" and scale == 0.5:
        return downsample_nearest_2x(x)
    if size is None:
        if scale is None:
            raise ValueError("resize_nchw needs a scale or a size")
        size = (int(round(x.shape[2] * scale)), int(round(x.shape[3] * scale)))
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = x.shape[2], x.shape[3]
    channels_last = x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last) \
        and not x.is_contiguous()
    if method == "nearest":
        if out_h != in_h:
            x = x.index_select(2, _nearest_index(in_h, out_h, x.device))
        if out_w != in_w:
            x = x.index_select(3, _nearest_index(in_w, out_w, x.device))
    else:
        if not x.is_floating_point():
            x = x.float()
        if out_h != in_h:
            x = torch.einsum("nchw,hy->ncyw", x,
                             resize_weights(in_h, out_h, method, x.device).to(x.dtype))
        if out_w != in_w:
            x = torch.einsum("nchw,wx->nchx", x,
                             resize_weights(in_w, out_w, method, x.device).to(x.dtype))
    return x.contiguous(memory_format=torch.channels_last) if channels_last else x


def resize_chw(x: torch.Tensor, size: Sequence[int], method: str = "bilinear") -> torch.Tensor:
    """Resize one CHW image to (h, w) (the JAX package's `resize_hwc`)."""
    return resize_nchw(x[None], size=size, method=method)[0]


def bilinear_resize_chw_like_torch(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """`jax.image.resize(method="linear")` over the last two dims of a
    (..., H, W) tensor: half-pixel centres, as torch's F.interpolate with
    align_corners=False, antialiased where an axis shrinks (torch's
    `antialias=True`); the aspect ratio is not kept."""
    lead: Tuple[int, ...] = tuple(x.shape[:-2])
    flat = x.reshape((-1, 1) + tuple(x.shape[-2:]))
    out = resize_nchw(flat, size=size, method="linear")
    return out.reshape(lead + tuple(out.shape[-2:]))
