"""CSPNet / CSPBackBone and its decoder mirror DeconvCSPNet, the JAX
package's nn/backbones.py in PyTorch.

CSPNet gives four feature maps at strides 4/8/16/32. The stem is a
6x6/s2/p2 conv; the downsamples are 3x3/s2 convs. Both stay on PyTorch's
conv in every form. DeconvCSPNet takes four maps back up to full
resolution (TrackNet's advanced architecture).
"""
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from .blocks import C3Module, ConvBNorm, ConvBNormUpsample, channels8, depth_round, stage


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


def deconv_cspnet_out_channels(width_multiple: float = 0.5) -> Tuple[int, ...]:
    """The eight widths of DeconvCSPNet's C3 and upsample stages."""
    return tuple(channels8(c, width_multiple) for c in [1024, 1024, 512, 512, 256, 256, 128, 64])


class DeconvCSPNet(nn.Module):
    """CSPNet's mirror, TrackNet's last decoder module: four C3 stages and
    five x2 upsamples from the four maps (deep to shallow, at strides
    32/16/8/4, as DeconvRepBiPAN gives them) to one map at full resolution.

    `in_channels` are the four maps' widths: the port builds its modules
    up front, where the JAX package infers them at init. Each C3 takes the
    concat [upsampled, next map]. The dropout (after the first three
    upsamples) acts only in training; the shipped rate is 0. `deconv4`
    gives the logits: a 3x3 conv with its bias and SiLU, no BatchNorm, at
    half resolution, then nearest x2, so every 2x2 block of the output is
    equal (a reference quirk). `remat` checkpoints each C3 and upsample
    stage but `deconv4`, as the JAX package wraps them.
    """

    def __init__(self, in_channels: Sequence[int], out_channels: int,
                 width_multiple: float = 0.5, depth_multiple: float = 0.3,
                 dropout: float = 0.0, remat: bool = False, folded: bool = False, device=None):
        super().__init__()
        d1, d2, d3, d4 = in_channels
        depths = [depth_round(d, depth_multiple) for d in [3, 9, 6, 3]]
        co = deconv_cspnet_out_channels(width_multiple)
        kw = dict(folded=folded, device=device)
        self.remat = remat
        self.c3_0 = C3Module(d1, co[0], num_bottlenecks=depths[0], **kw)
        self.deconv0 = ConvBNormUpsample(co[0], co[1], 2, **kw)
        self.c3_1 = C3Module(co[1] + d2, co[2], num_bottlenecks=depths[1], **kw)
        self.deconv1 = ConvBNormUpsample(co[2], co[3], 2, **kw)
        self.c3_2 = C3Module(co[3] + d3, co[4], num_bottlenecks=depths[2], **kw)
        self.deconv2 = ConvBNormUpsample(co[4], co[5], 2, **kw)
        self.c3_3 = C3Module(co[5] + d4, co[6], num_bottlenecks=depths[3], **kw)
        self.deconv3 = ConvBNormUpsample(co[6], co[7], 2, **kw)
        self.deconv4 = ConvBNormUpsample(co[7], out_channels, 2, no_batchnorm=True, **kw)
        self.drop = nn.Dropout(dropout)

    def forward(self, fmaps: Sequence[torch.Tensor]) -> torch.Tensor:
        def run(m, *a):
            return stage(m, *a, remat=self.remat)

        fmap1, fmap2, fmap3, fmap4 = fmaps
        out = self.drop(run(self.deconv0, run(self.c3_0, fmap1)))
        out = self.drop(run(self.deconv1, run(self.c3_1, torch.cat([out, fmap2], dim=1))))
        out = self.drop(run(self.deconv2, run(self.c3_2, torch.cat([out, fmap3], dim=1))))
        out = run(self.deconv3, run(self.c3_3, torch.cat([out, fmap4], dim=1)))
        return self.deconv4(out)
