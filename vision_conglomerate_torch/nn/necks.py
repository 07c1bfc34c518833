"""The neck zoo, the JAX package's nn/necks.py in PyTorch: RepBiPAN and
BiPAN, and their inverted decoders DeconvRepBiPAN and DeconvBiPAN (the
TrackNet advanced architecture's decoder heads).

The channel plan (width rounding to multiples of 8 and the None insertions
for conv-less BiC modules) is the JAX package's, so configs and channel
counts carry over. Each `*_out_channels` function gives a module's four
output widths from its input widths and config, without building it.
Every module calls its stages through `blocks.stage`, so `remat`
checkpoints the units the JAX package wraps in `maybe_remat`.
"""
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from .blocks import (
    BiCwithConvModule,
    BiCwithNoConvModule,
    C3Module,
    ConvBNorm,
    ConvBNormUpsample,
    CSPSPPFModule,
    RepBlock,
    SPPFModule,
    bic_out_channels,
    channels8,
    depth_round,
    stage,
)

# (widths with conv-less BiC modules, widths with BiC convs): RepBiPAN and
# BiPAN share the first plan, their inverted decoders the second
_PAN_BASE = ([512, 512, 256, 256, 256, 512, 512, 1024],
             [512, 512, 512, 256, 256, 256, 256, 512, 512, 1024])
_DECONV_PAN_BASE = ([256, 256, 512, 512, 512, 256, 256, 128],
                    [256, 256, 256, 512, 512, 512, 512, 256, 256, 128])


def pan_channel_outs(width_multiple: float, bic_with_conv: bool, base=_PAN_BASE) -> list:
    """The ten widths of a PAN's layers; without BiC convs, None at the two
    BiC slots (1 and 4)."""
    base8, base10 = base
    if bic_with_conv:
        return [channels8(x, width_multiple) for x in base10]
    outs = [channels8(x, width_multiple) for x in base8]
    outs.insert(1, None)
    outs.insert(4, None)
    return outs


def _bic(bic_with_conv: bool, c1: int, c0: int, p2: int, out_channels, upsample_mode: str,
         **kw) -> Tuple[nn.Module, int]:
    """A BiC module over inputs of widths (c1, c0, p2) and its output width."""
    cls = BiCwithConvModule if bic_with_conv else BiCwithNoConvModule
    return (cls(c1, c0, p2, out_channels, upsample_mode=upsample_mode, **kw),
            bic_out_channels(bic_with_conv, c1, c0, p2, out_channels))


def repbipan_out_channels(in_channels: Sequence[int], width_multiple: float = 0.5,
                          bic_with_conv: bool = False, **_) -> Tuple[int, int, int, int]:
    ch = pan_channel_outs(width_multiple, bic_with_conv)
    return (in_channels[0], ch[5], ch[7], ch[9])


class RepBiPAN(nn.Module):
    """YOLOv6-style reparameterisable bi-directional PAN.

    Input (c2, c3, c4, c5) at strides 4/8/16/32, output (c2, n3, n4, n5).
    `repvgg_branch_act=None` is the canonical RepVGG block, which
    `deploy=True` fuses into one 3x3 conv; "silu" keeps the upstream branch
    activations, which deploy by BN folding (`folded=True`). `remat`
    checkpoints every RepBlock, ConvBNorm, CSPSPPF and BiC stage for the
    backward pass (`blocks.stage`), the units the JAX package wraps.
    """

    def __init__(self, in_channels: Sequence[int], width_multiple: float = 0.5,
                 depth_multiple: float = 0.3, cspsppf_poolk: int = 5,
                 upsample_mode: str = "nearest", bic_with_conv: bool = False,
                 repvgg_branch_act: Optional[str] = "silu", deploy: bool = False,
                 remat: bool = False, folded: bool = False, device=None):
        super().__init__()
        c2, c3, c4, c5 = in_channels
        depths = [depth_round(d, depth_multiple) for d in [1, 1, 1, 1]]
        ch = pan_channel_outs(width_multiple, bic_with_conv)
        kw = dict(folded=folded, device=device)
        self.remat = remat

        def rep(ci, co, n):
            return RepBlock(ci, co, n=n, branch_activation=repvgg_branch_act,
                            deploy=deploy, **kw)

        self.cspsppf0 = CSPSPPFModule(c5, c5, pool_kernel_size=cspsppf_poolk, **kw)
        self.conv0 = ConvBNorm(c5, ch[0], 1, **kw)
        self.bic0, b0 = _bic(bic_with_conv, c4, c3, ch[0], ch[1], upsample_mode, **kw)
        self.repblock0 = rep(b0, ch[2], depths[0])
        self.conv1 = ConvBNorm(ch[2], ch[3], 1, **kw)
        self.bic1, b1 = _bic(bic_with_conv, c3, c2, ch[3], ch[4], upsample_mode, **kw)
        self.repblock1 = rep(b1, ch[5], depths[1])
        self.conv2 = ConvBNorm(ch[5], ch[6], 3, 2, **kw)
        self.repblock2 = rep(ch[6] + ch[2], ch[7], depths[2])
        self.conv3 = ConvBNorm(ch[7], ch[8], 3, 2, **kw)
        self.repblock3 = rep(ch[8] + c5, ch[9], depths[3])

    def forward(self, fmaps: Sequence[torch.Tensor]):
        def run(m, *a):
            return stage(m, *a, remat=self.remat)

        c2, c3, c4, c5 = fmaps
        p5 = run(self.cspsppf0, c5)
        y0 = run(self.conv0, p5)
        p4 = run(self.repblock0, run(self.bic0, c4, c3, y0))
        y1 = run(self.conv1, p4)
        n3 = run(self.repblock1, run(self.bic1, c3, c2, y1))
        n4 = run(self.repblock2, torch.cat([run(self.conv2, n3), p4], dim=1))
        n5 = run(self.repblock3, torch.cat([run(self.conv3, n4), p5], dim=1))
        return c2, n3, n4, n5


def deconv_repbipan_out_channels(in_channels: Sequence[int], width_multiple: float = 0.5,
                                 bic_with_conv: bool = False, **_) -> Tuple[int, int, int, int]:
    ch = pan_channel_outs(width_multiple, bic_with_conv, _DECONV_PAN_BASE)
    return (in_channels[3], ch[5], ch[7], ch[9])


class DeconvRepBiPAN(nn.Module):
    """The inverted RepBiPAN, TrackNet's first decoder module.

    Input (c2, n3, n4, n5) at strides 4/8/16/32, output (n5, f4, f3, f2),
    deep to shallow, at strides 32/16/8/4. Its BiCs take (c1 at their
    stride, c0 one stride finer, p2 one stride coarser), as RepBiPAN's:
    bic0(n3, deconv0(c2), n4), bic1(n4, deconv1(q3), n5). Two
    ConvBNormUpsample (`deconv2`, `deconv3`) go back up. `deploy`, `folded`
    and `remat` act as in RepBiPAN.
    """

    def __init__(self, in_channels: Sequence[int], width_multiple: float = 0.5,
                 depth_multiple: float = 0.3, cspsppf_poolk: int = 5,
                 upsample_mode: str = "nearest", bic_with_conv: bool = False,
                 repvgg_branch_act: Optional[str] = "silu", deploy: bool = False,
                 remat: bool = False, folded: bool = False, device=None):
        super().__init__()
        c2, c3, c4, c5 = in_channels
        depths = [depth_round(d, depth_multiple) for d in [1, 1, 1, 1]]
        ch = pan_channel_outs(width_multiple, bic_with_conv, _DECONV_PAN_BASE)
        kw = dict(folded=folded, device=device)
        self.remat = remat

        def rep(ci, co, n):
            return RepBlock(ci, co, n=n, branch_activation=repvgg_branch_act,
                            deploy=deploy, **kw)

        self.deconv0 = ConvBNorm(c2, ch[0], 1, **kw)
        self.bic0, b0 = _bic(bic_with_conv, c3, ch[0], c4, ch[1], upsample_mode, **kw)
        self.repblock0 = rep(b0, ch[2], depths[0])
        self.deconv1 = ConvBNorm(ch[2], ch[3], 1, **kw)
        self.bic1, b1 = _bic(bic_with_conv, c4, ch[3], c5, ch[4], upsample_mode, **kw)
        self.repblock1 = rep(b1, ch[5], depths[1])
        self.cspsppf = CSPSPPFModule(ch[5], ch[5], pool_kernel_size=cspsppf_poolk, **kw)
        self.deconv2 = ConvBNormUpsample(ch[5], ch[6], 2, **kw)
        self.repblock2 = rep(ch[6] + ch[2], ch[7], depths[2])
        self.deconv3 = ConvBNormUpsample(ch[7], ch[8], 2, **kw)
        self.repblock3 = rep(ch[8] + c2, ch[9], depths[3])

    def forward(self, fmaps: Sequence[torch.Tensor]):
        def run(m, *a):
            return stage(m, *a, remat=self.remat)

        c2, n3, n4, n5 = fmaps
        d0 = run(self.deconv0, c2)
        q3 = run(self.repblock0, run(self.bic0, n3, d0, n4))
        d1 = run(self.deconv1, q3)
        q4 = run(self.repblock1, run(self.bic1, n4, d1, n5))
        f4 = run(self.cspsppf, q4)
        f3 = run(self.repblock2, torch.cat([run(self.deconv2, f4), q3], dim=1))
        f2 = run(self.repblock3, torch.cat([run(self.deconv3, f3), c2], dim=1))
        return n5, f4, f3, f2


def bipan_out_channels(in_channels: Sequence[int], width_multiple: float = 0.5,
                       bic_with_conv: bool = False, **_) -> Tuple[int, int, int, int]:
    ch = pan_channel_outs(width_multiple, bic_with_conv)
    return (in_channels[0], ch[5], ch[7], ch[9])


class BiPAN(nn.Module):
    """YOLOv5-flavoured bi-directional PAN: RepBiPAN's plan with C3 stages
    (depths 3, 6, 9, 3 times depth_multiple) and an SPPFModule.

    Input (f1, f2, f3, f4) at strides 4/8/16/32, output (f1, y3, y5, y7).
    """

    def __init__(self, in_channels: Sequence[int], width_multiple: float = 0.5,
                 depth_multiple: float = 0.3, sppf_poolk: int = 5,
                 upsample_mode: str = "nearest", bic_with_conv: bool = False,
                 remat: bool = False, folded: bool = False, device=None):
        super().__init__()
        c1, c2, c3, c4 = in_channels
        depths = [depth_round(d, depth_multiple) for d in [3, 6, 9, 3]]
        ch = pan_channel_outs(width_multiple, bic_with_conv)
        kw = dict(folded=folded, device=device)
        self.remat = remat
        self.sppf0 = SPPFModule(c4, c4, pool_kernel_size=sppf_poolk, **kw)
        self.conv0 = ConvBNorm(c4, ch[0], 1, **kw)
        self.bic0, b0 = _bic(bic_with_conv, c3, c2, ch[0], ch[1], upsample_mode, **kw)
        self.c3_0 = C3Module(b0, ch[2], num_bottlenecks=depths[0], **kw)
        self.conv1 = ConvBNorm(ch[2], ch[3], 1, **kw)
        self.bic1, b1 = _bic(bic_with_conv, c2, c1, ch[3], ch[4], upsample_mode, **kw)
        self.c3_1 = C3Module(b1, ch[5], num_bottlenecks=depths[1], **kw)
        self.conv2 = ConvBNorm(ch[5], ch[6], 3, 2, **kw)
        self.c3_2 = C3Module(ch[6] + ch[3], ch[7], num_bottlenecks=depths[2], **kw)
        self.conv3 = ConvBNorm(ch[7], ch[8], 3, 2, **kw)
        self.c3_3 = C3Module(ch[8] + ch[0], ch[9], num_bottlenecks=depths[3], **kw)

    def forward(self, fmaps: Sequence[torch.Tensor]):
        def run(m, *a):
            return stage(m, *a, remat=self.remat)

        f1, f2, f3, f4 = fmaps
        y0 = run(self.conv0, run(self.sppf0, f4))
        y2 = run(self.conv1, run(self.c3_0, run(self.bic0, f3, f2, y0)))
        y3 = run(self.c3_1, run(self.bic1, f2, f1, y2))
        y5 = run(self.c3_2, torch.cat([run(self.conv2, y3), y2], dim=1))
        y7 = run(self.c3_3, torch.cat([run(self.conv3, y5), y0], dim=1))
        return f1, y3, y5, y7


def deconv_bipan_out_channels(in_channels: Sequence[int], width_multiple: float = 0.5,
                              bic_with_conv: bool = False, **_) -> Tuple[int, int, int, int]:
    ch = pan_channel_outs(width_multiple, bic_with_conv, _DECONV_PAN_BASE)
    return (in_channels[3], ch[5], ch[7], ch[9])


class DeconvBiPAN(nn.Module):
    """The inverted BiPAN: DeconvRepBiPAN's plan with C3 stages and an
    SPPFModule before `deconv2`.

    Input (f1, y3, y5, y7) at strides 4/8/16/32, output (y7, f3, f5, f7).
    """

    def __init__(self, in_channels: Sequence[int], width_multiple: float = 0.5,
                 depth_multiple: float = 0.3, sppf_poolk: int = 5,
                 upsample_mode: str = "nearest", bic_with_conv: bool = False,
                 remat: bool = False, folded: bool = False, device=None):
        super().__init__()
        c1, c3, c5, c7 = in_channels
        depths = [depth_round(d, depth_multiple) for d in [3, 6, 9, 3]]
        ch = pan_channel_outs(width_multiple, bic_with_conv, _DECONV_PAN_BASE)
        kw = dict(folded=folded, device=device)
        self.remat = remat
        self.deconv0 = ConvBNorm(c1, ch[0], 1, **kw)
        self.bic0, b0 = _bic(bic_with_conv, c3, ch[0], c5, ch[1], upsample_mode, **kw)
        self.c3_0 = C3Module(b0, ch[2], num_bottlenecks=depths[0], **kw)
        self.deconv1 = ConvBNorm(ch[2], ch[3], 1, **kw)
        self.bic1, b1 = _bic(bic_with_conv, c5, ch[3], c7, ch[4], upsample_mode, **kw)
        self.c3_1 = C3Module(b1, ch[5], num_bottlenecks=depths[1], **kw)
        self.sppf = SPPFModule(ch[5], ch[5], pool_kernel_size=sppf_poolk, **kw)
        self.deconv2 = ConvBNormUpsample(ch[5], ch[6], 2, **kw)
        self.c3_2 = C3Module(ch[6] + ch[3], ch[7], num_bottlenecks=depths[2], **kw)
        self.deconv3 = ConvBNormUpsample(ch[7], ch[8], 2, **kw)
        self.c3_3 = C3Module(ch[8] + ch[0], ch[9], num_bottlenecks=depths[3], **kw)

    def forward(self, fmaps: Sequence[torch.Tensor]):
        def run(m, *a):
            return stage(m, *a, remat=self.remat)

        fmap1, y3, y5, y7 = fmaps
        f0 = run(self.deconv0, fmap1)
        f2 = run(self.deconv1, run(self.c3_0, run(self.bic0, y3, f0, y5)))
        f3 = run(self.c3_1, run(self.bic1, y5, f2, y7))
        f4 = run(self.deconv2, run(self.sppf, f3))
        f5 = run(self.c3_2, torch.cat([f4, f2], dim=1))
        f7 = run(self.c3_3, torch.cat([run(self.deconv3, f5), f0], dim=1))
        return y7, f3, f5, f7
