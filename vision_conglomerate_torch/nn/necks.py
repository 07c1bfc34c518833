"""RepBiPAN, the JAX package's nn/necks.py in PyTorch.

The channel plan (width rounding to multiples of 8 and the None insertions
for conv-less BiC modules) is the JAX package's, so configs and channel
counts carry over.
"""
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from .blocks import (
    BiCwithConvModule,
    BiCwithNoConvModule,
    ConvBNorm,
    CSPSPPFModule,
    RepBlock,
    bic_out_channels,
    channels8,
    depth_round,
    stage,
)

_REPBIPAN_BASE8 = [512, 512, 256, 256, 256, 512, 512, 1024]
_REPBIPAN_BASE10 = [512, 512, 512, 256, 256, 256, 256, 512, 512, 1024]


def pan_channel_outs(width_multiple: float, bic_with_conv: bool) -> list:
    if bic_with_conv:
        return [channels8(x, width_multiple) for x in _REPBIPAN_BASE10]
    outs = [channels8(x, width_multiple) for x in _REPBIPAN_BASE8]
    outs.insert(1, None)
    outs.insert(4, None)
    return outs


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

        def bic(c1, c0, p2, co):
            if bic_with_conv:
                return BiCwithConvModule(c1, c0, p2, co, upsample_mode=upsample_mode, **kw)
            return BiCwithNoConvModule(c1, c0, p2, co, upsample_mode=upsample_mode, **kw)

        self.cspsppf0 = CSPSPPFModule(c5, c5, pool_kernel_size=cspsppf_poolk, **kw)
        self.conv0 = ConvBNorm(c5, ch[0], 1, **kw)
        self.bic0 = bic(c4, c3, ch[0], ch[1])
        b0 = bic_out_channels(bic_with_conv, c4, c3, ch[0], ch[1])
        self.repblock0 = rep(b0, ch[2], depths[0])
        self.conv1 = ConvBNorm(ch[2], ch[3], 1, **kw)
        self.bic1 = bic(c3, c2, ch[3], ch[4])
        b1 = bic_out_channels(bic_with_conv, c3, c2, ch[3], ch[4])
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
