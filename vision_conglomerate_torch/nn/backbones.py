"""CSPNet / CSPBackBone, its decoder mirror DeconvCSPNet, and
ResNetBackBone: the JAX package's nn/backbones.py in PyTorch.

CSPNet gives four feature maps at strides 4/8/16/32. The stem is a
6x6/s2/p2 conv, or with `space_to_depth_stem` a space-to-depth then a
3x3/s1/p1 conv over 4x the channels; the downsamples are 3x3/s2 convs.
The 6x6 stem and the downsamples stay on PyTorch's conv in every form; the
s2d stem, folded, runs on the conv3x3 kernel. DeconvCSPNet takes four maps
back up to full resolution (TrackNet's advanced architecture).
ResNetBackBone is the upstream's ResNet with two 7x7/s2 stems.
"""
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import (BatchNorm2d, C3Module, ConvBNorm, ConvBNormUpsample, channels8, conv2d,
                     depth_round, stage)


def cspnet_channels(width_multiple: float, early_min_channels: Optional[int] = None) -> list:
    """The nine layer widths. `early_min_channels` raises the first three
    (the stem, the stride-2 conv and the first C3) to at least that many."""
    co = [channels8(x, width_multiple) for x in [32, 64, 128, 256, 256, 512, 512, 1024, 1024]]
    if early_min_channels:
        for i in range(3):
            co[i] = max(co[i], int(early_min_channels))
    return co


def cspnet_out_channels(width_multiple: float = 0.5,
                        early_min_channels: Optional[int] = None) -> Tuple[int, int, int, int]:
    co = cspnet_channels(width_multiple, early_min_channels)
    return (co[2], co[4], co[6], co[8])


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2), channel (dy * 2 + dx) * C + c
    holding x[:, c, 2i + dy, 2j + dx] (the JAX package's NHWC order)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, 4 * c, h // 2, w // 2)


class CSPNet(nn.Module):
    """Cross-stage-partial backbone. Input H and W must be divisible by 32.

    `remat` checkpoints every ConvBNorm and C3 stage for the backward pass
    (`blocks.stage`), as the JAX package wraps its Conv and C3 units.
    `space_to_depth_stem` makes `conv0` a 3x3/s1/p1 ConvBNorm over the
    space-to-depth input (4 in_channels): the same function as the 6x6/s2
    stem with its kernel rearranged (`nn.reparam.s2d_stem_kernel`), other
    parameter shapes. `early_min_channels` widens the first three layers
    (`cspnet_channels`).
    """

    def __init__(self, in_channels: int = 3, width_multiple: float = 0.5,
                 depth_multiple: float = 0.3, dropout: float = 0.0,
                 space_to_depth_stem: bool = False, early_min_channels: Optional[int] = None,
                 remat: bool = False, folded: bool = False, device=None):
        super().__init__()
        depths = [depth_round(d, depth_multiple) for d in [3, 6, 9, 3]]
        co = cspnet_channels(width_multiple, early_min_channels)
        kw = dict(folded=folded, device=device)
        self.remat = remat
        self.space_to_depth_stem = space_to_depth_stem
        if space_to_depth_stem:
            self.conv0 = ConvBNorm(4 * in_channels, co[0], 3, 1, 1, **kw)
        else:
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

        if self.space_to_depth_stem:
            x = space_to_depth(x)
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


def _bn(x: torch.Tensor, bn: BatchNorm2d) -> torch.Tensor:
    """BatchNorm in f32, back to x's dtype (the JAX package's
    `.astype(dtype)` after each BatchNorm)."""
    return bn(x.float()).to(x.dtype)


def _conv_bn(c_in: int, c_out: int, k: int, stride: int, device) -> Tuple[nn.Conv2d, BatchNorm2d]:
    return (nn.Conv2d(c_in, c_out, k, stride, k // 2, bias=False, device=device),
            BatchNorm2d(c_out, device=device))


class _ResNetBasicBlock(nn.Module):
    """3x3 conv (stride s) -> BN -> ReLU -> 3x3 conv -> BN, plus the
    identity or a 1x1/s `downsample_conv` -> `downsample_bn`, then ReLU.
    No conv has a bias."""

    expansion = 1

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 downsample: bool = False, device=None):
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(in_channels, planes, 3, stride, device)
        self.conv2, self.bn2 = _conv_bn(planes, planes, 3, 1, device)
        if downsample:
            self.downsample_conv, self.downsample_bn = _conv_bn(in_channels, planes, 1, stride,
                                                                device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(_bn(conv2d(x, self.conv1), self.bn1))
        out = _bn(conv2d(out, self.conv2), self.bn2)
        identity = x
        if hasattr(self, "downsample_conv"):
            identity = _bn(conv2d(x, self.downsample_conv), self.downsample_bn)
        return F.relu(out + identity)


class _ResNetBottleneck(nn.Module):
    """1x1 -> BN -> ReLU -> 3x3 (stride s) -> BN -> ReLU -> 1x1 to 4x the
    planes -> BN, plus the identity or the downsample, then ReLU."""

    expansion = 4

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 downsample: bool = False, device=None):
        super().__init__()
        out = planes * self.expansion
        self.conv1, self.bn1 = _conv_bn(in_channels, planes, 1, 1, device)
        self.conv2, self.bn2 = _conv_bn(planes, planes, 3, stride, device)
        self.conv3, self.bn3 = _conv_bn(planes, out, 1, 1, device)
        if downsample:
            self.downsample_conv, self.downsample_bn = _conv_bn(in_channels, out, 1, stride,
                                                                device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(_bn(conv2d(x, self.conv1), self.bn1))
        out = F.relu(_bn(conv2d(out, self.conv2), self.bn2))
        out = _bn(conv2d(out, self.conv3), self.bn3)
        identity = x
        if hasattr(self, "downsample_conv"):
            identity = _bn(conv2d(x, self.downsample_conv), self.downsample_bn)
        return F.relu(out + identity)


def resnet_out_channels(block: str = "BasicBlock") -> Tuple[int, int, int, int]:
    if block == "BasicBlock":
        return (64, 128, 256, 512)
    return (256, 512, 1024, 2048)


class ResNetBackBone(nn.Module):
    """The upstream's ResNet: conv1 (7x7/s2) -> conv2 (7x7/s2), with no
    BatchNorm between them, -> bn1 -> ReLU -> dropout -> layer1..4 of
    `block_layers` blocks (BasicBlock or Bottleneck; default 3, 4, 6, 3),
    the first block of a layer at stride (1, 2, 2, 2) with a downsample
    where the stride is not 1 or the width changes. Returns the four
    layers' maps, at strides 4/8/16/32. Modules are `layer{L}_{B}`, as in
    the JAX package.

    The convs have no bias and their BatchNorms are `bnN` siblings, not a
    ConvBNorm's `norm`: neither package's deploy transform folds them, so
    the deploy form keeps eval-mode BatchNorm on PyTorch's convs, and the
    int8 form leaves them in the compute dtype. It has no `remat`
    (`registry.takes`: `model_config.remat` skips it, as in the JAX
    package).
    """

    def __init__(self, in_channels: int = 3, dropout: float = 0.0, block: str = "BasicBlock",
                 block_layers: Optional[Sequence[int]] = None, device=None):
        super().__init__()
        layers = tuple(block_layers or (3, 4, 6, 3))
        cls = _ResNetBasicBlock if block == "BasicBlock" else _ResNetBottleneck
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False, device=device)
        self.conv2 = nn.Conv2d(64, 64, 7, 2, 3, bias=False, device=device)
        self.bn1 = BatchNorm2d(64, device=device)
        self.drop = nn.Dropout(dropout)
        self.stages = []
        in_ch = 64
        for li, (n_blocks, planes, s) in enumerate(zip(layers, (64, 128, 256, 512), (1, 2, 2, 2))):
            names = []
            for bi in range(n_blocks):
                stride = s if bi == 0 else 1
                need_ds = stride != 1 or in_ch != planes * cls.expansion
                name = f"layer{li + 1}_{bi}"
                setattr(self, name, cls(in_ch, planes, stride, need_ds, device=device))
                names.append(name)
                in_ch = planes * cls.expansion
            self.stages.append(names)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        if x.shape[2] % 32 != 0 or x.shape[3] % 32 != 0:
            raise ValueError("input must have width and height divisible by 32")
        x = conv2d(conv2d(x, self.conv1), self.conv2)
        x = self.drop(F.relu(_bn(x, self.bn1)))
        fmaps = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            fmaps.append(x)
        return tuple(fmaps)
