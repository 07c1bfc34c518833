"""TrackNet's base architecture in plain float32 PyTorch.

The encoder-decoder of TrackNet (Huang et al., arXiv:1907.03698) as the
reference repository ches-001/vision-conglomerate builds it, quirks
included: the skip taps after enc_1, enc_3 and enc_6; decoder widths
[256, 256, 256, 126, 128, 64, 64]; each decoder stage concatenates
[upsampled, skip]; dec_13 is a conv with bias and ReLU and no BatchNorm.
Every conv is 3x3/s1 with ReLU. The output is (B, 256, H, W) logits of a
per-pixel 256-way intensity classification.

The serve tail: argmax over the classes as uint8, an antialiased
bilinear resize to the original size, rounded and clipped, then the
thresholded centroid decode.
"""
import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import ConvBNorm, up2

ENCODER = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512)
DECODER = (256, 256, 256, 126, 128, 64, 64)
ENC_NAMES = ("enc_0", "enc_1", "enc_3", "enc_4", "enc_6", "enc_7", "enc_8", "enc_10",
             "enc_11", "enc_12")
NUM_CLASSES = 256


def _widths(widths, wm: float) -> List[int]:
    return [max(round(c * wm), 1) for c in widths]


def _conv(cin: int, cout: int, no_batchnorm: bool = False) -> ConvBNorm:
    return ConvBNorm(cin, cout, 3, 1, 1, activation="relu", no_batchnorm=no_batchnorm)


class Encoder(nn.Module):
    def __init__(self, cin: int, wm: float):
        super().__init__()
        co = _widths(ENCODER, wm)
        for name, c in zip(ENC_NAMES, co):
            setattr(self, name, _conv(cin, c))
            cin = c
        self.out_channels = (co[1], co[2], co[4], co[9])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.enc_1(self.enc_0(x))
        taps = [x]
        x = self.enc_3(F.max_pool2d(x, 2, 2))
        taps.append(x)
        x = self.enc_6(F.max_pool2d(self.enc_4(x), 2, 2))
        taps.append(x)
        x = F.max_pool2d(self.enc_8(self.enc_7(x)), 2, 2)
        taps.append(self.enc_12(self.enc_11(self.enc_10(x))))
        return taps


class Decoder(nn.Module):
    def __init__(self, fmap_channels, wm: float):
        super().__init__()
        f0, f1, f2, f3 = fmap_channels
        co = _widths(DECODER, wm)
        plan = (("dec_2", f3 + f2, co[0]), ("dec_3", co[0], co[1]), ("dec_4", co[1], co[2]),
                ("dec_7", co[2] + f1, co[3]), ("dec_8", co[3], co[4]),
                ("dec_11", co[4] + f0, co[5]), ("dec_12", co[5], co[6]))
        for name, cin, cout in plan:
            setattr(self, name, _conv(cin, cout))
        self.dec_13 = _conv(co[6], NUM_CLASSES, no_batchnorm=True)

    def forward(self, taps: List[torch.Tensor]) -> torch.Tensor:
        x = torch.cat([up2(taps[3]), taps[2]], dim=1)
        x = self.dec_4(self.dec_3(self.dec_2(x)))
        x = self.dec_8(self.dec_7(torch.cat([up2(x), taps[1]], dim=1)))
        x = self.dec_12(self.dec_11(torch.cat([up2(x), taps[0]], dim=1)))
        return self.dec_13(x)


class TrackNetBase(nn.Module):
    """`model_config` is the configuration's model_config block (base
    architecture); `in_channels` is 3 * num_stacks."""

    def __init__(self, model_config: Dict[str, Any], in_channels: int = 9):
        super().__init__()
        cfg = model_config["base_arch_config"]
        self.encoder = Encoder(in_channels, float(cfg["encoder_config"]["width_multiple"]))
        self.decoder = Decoder(self.encoder.out_channels,
                               float(cfg["decoder_config"]["width_multiple"]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(x))


def heatmap(classes: torch.Tensor, og_hw: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W) argmax classes -> (B, h, w) uint8 heatmap at the original
    size: antialiased bilinear resize (half-pixel centres), rounded,
    clipped."""
    hm = classes.to(torch.uint8)
    if tuple(og_hw) == tuple(hm.shape[1:]):
        return hm
    out = F.interpolate(hm[:, None].float(), size=tuple(int(v) for v in og_hw),
                        mode="bilinear", align_corners=False, antialias=True)
    return out[:, 0].round().clamp(0, 255).to(torch.uint8)


def centroid_tracks(hm: torch.Tensor, threshold: int) -> torch.Tensor:
    """(B, h, w) heatmaps -> (B, 3) [x, y, r] of the blob of pixels at or
    above `threshold`: its centroid and sqrt(area / pi); NaN rows where the
    blob is empty."""
    out = torch.full((hm.shape[0], 3), float("nan"), dtype=torch.float64)
    for i in range(hm.shape[0]):
        ys, xs = torch.nonzero(hm[i] >= threshold, as_tuple=True)
        if ys.numel():
            area = float(ys.numel())
            out[i, 0] = xs.double().mean()
            out[i, 1] = ys.double().mean()
            out[i, 2] = math.sqrt(area / math.pi)
    return out
