"""vision-conglomerate in PyTorch for NVIDIA Hopper.

The port of `vision_conglomerate_tpu` (the JAX package, which stays the
reference). It imports torch and never jax, and nothing of the JAX package.
Modules mirror the JAX package's names. The detection serve path runs its
BN-folded 1x1 and stride-1 3x3 convs on two hand-written CUDA kernels
(`ops/fused_matmul.py`, `ops/conv3x3.py`, sources under `csrc/`).

Entry points run on `cuda` unless the caller passes `device="cpu"`
(`device.resolve_device`).
"""
from .device import resolve_device  # noqa: F401
