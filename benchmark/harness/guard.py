"""What a run must not carry: modules of JAX or of the JAX package, and
TF32 in the reference's float32 arithmetic."""
import sys
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "vision_conglomerate_tpu")


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that are JAX's or the JAX package's,
    each name compared whole (the port's name begins with the JAX
    package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def reference_numerics() -> None:
    """Float32 convs and matmuls in float32, not TF32 (the reference)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
