"""CSPNet / CSPBackBone, the JAX package's nn/backbones.py in PyTorch.

Four feature maps at strides 4/8/16/32. The stem is a 6x6/s2/p2 conv; the
downsamples are 3x3/s2 convs. Both stay on PyTorch's conv in every form.
"""
from typing import Optional, Tuple

import torch
import torch.nn as nn

from .blocks import C3Module, ConvBNorm, channels8, depth_round, stage


def cspnet_channels(width_multiple: float) -> list:
    return [channels8(x, width_multiple) for x in [32, 64, 128, 256, 256, 512, 512, 1024, 1024]]


def cspnet_out_channels(width_multiple: float = 0.5) -> Tuple[int, int, int, int]:
    co = cspnet_channels(width_multiple)
    return (co[2], co[4], co[6], co[8])


class CSPNet(nn.Module):
    """Cross-stage-partial backbone. Input H and W must be divisible by 32.

    `remat` checkpoints every ConvBNorm and C3 stage for the backward pass
    (`blocks.stage`), as the JAX package wraps its Conv and C3 units.
    `space_to_depth_stem` and `early_min_channels` are opt-in variants not
    in the port yet (ROADMAP §A.13).
    """

    def __init__(self, in_channels: int = 3, width_multiple: float = 0.5,
                 depth_multiple: float = 0.3, dropout: float = 0.0,
                 space_to_depth_stem: bool = False, early_min_channels: Optional[int] = None,
                 remat: bool = False, folded: bool = False, device=None):
        super().__init__()
        if space_to_depth_stem or early_min_channels:
            raise NotImplementedError(
                "space_to_depth_stem / early_min_channels are not in the port yet "
                "(ROADMAP §A.13)")
        depths = [depth_round(d, depth_multiple) for d in [3, 6, 9, 3]]
        co = cspnet_channels(width_multiple)
        kw = dict(folded=folded, device=device)
        self.remat = remat
        self.conv0 = ConvBNorm(in_channels, co[0], 6, 2, 2, **kw)
        self.conv1 = ConvBNorm(co[0], co[1], 3, 2, 1, **kw)
        self.c3_0 = C3Module(co[1], co[2], num_bottlenecks=depths[0], **kw)
        self.conv2 = ConvBNorm(co[2], co[3], 3, 2, 1, **kw)
        self.c3_1 = C3Module(co[3], co[4], num_bottlenecks=depths[1], **kw)
        self.conv3 = ConvBNorm(co[4], co[5], 3, 2, 1, **kw)
        self.c3_2 = C3Module(co[5], co[6], num_bottlenecks=depths[2], **kw)
        self.conv4 = ConvBNorm(co[6], co[7], 3, 2, 1, **kw)
        self.c3_3 = C3Module(co[7], co[8], num_bottlenecks=depths[3], **kw)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        if x.shape[2] % 32 != 0 or x.shape[3] % 32 != 0:
            raise ValueError("input must have width and height divisible by 32")
        def run(m, *a):
            return stage(m, *a, remat=self.remat)

        out = self.drop(run(self.conv1, run(self.conv0, x)))
        fmap1 = run(self.c3_0, out)
        fmap2 = run(self.c3_1, self.drop(run(self.conv2, fmap1)))
        fmap3 = run(self.c3_2, self.drop(run(self.conv3, fmap2)))
        fmap4 = run(self.c3_3, run(self.conv4, fmap3))
        return fmap1, fmap2, fmap3, fmap4


class CSPBackBone(CSPNet):
    """Alias of CSPNet."""
