"""TrackNet, the JAX package's models/tracknet.py in PyTorch.

Input: 3 * num_stacks stacked RGB frames, newest first, NCHW (a batch of
NHWC frames permuted to NCHW is already channels_last). Output: (B, 256,
H, W) logits of a per-pixel 256-way classification over heatmap
intensity, or with `inference=True` the (B, H, W) uint8 heatmap: argmax
over the 256 classes, then, where `og_size` differs from (H, W), a linear
antialiased resize to og_size, rounded and clipped.

Base: a VGG-style encoder (10 3x3 convs, three 2x2/s2 max-pools) and a
skip-concat decoder back to full resolution. Quirks kept from the JAX
package:
- the skip taps are after `enc_1`, `enc_3` and `enc_6`, the FIRST conv of
  stages 2 and 3, not the last;
- the decoder widths are [256, 256, 256, 126, 128, 64, 64] (the 126);
- each decoder stage concatenates [upsampled, skip] in that order;
- `dec_13` is a conv with bias and ReLU and no BatchNorm.

Every conv is a stride-1 3x3 with ReLU, so in the deploy form (`folded`:
BatchNorm folded by `nn.reparam.deploy_transform`) all 18 run on the
conv3x3 kernel when their input lies on the card, `dec_13` included.
`config["remat"]` checkpoints each encoder and decoder conv but `dec_13`
for the backward pass (`nn.blocks.stage`), as the JAX package wraps them
in `maybe_remat`.

Advanced: two registered encoder modules and two decoder modules, chained
by name through `registry.TRACKNET_MODULES` (the shipped
config_advanced.yaml: CSPNet + RepBiPAN, DeconvRepBiPAN + DeconvCSPNet;
BiPAN and DeconvBiPAN also fit). Each module's config is its
`<name.lower()>_config` block; `deploy` (fused canonical RepVGG blocks) and
`remat` reach only the modules that take them, `folded` every one. CSPNet
takes the 3 * num_stacks frame channels through its 6x6/s2 stem, so H and
W must be multiples of 32. In the deploy form every folded 1x1 conv runs
on the matmul kernel and every stride-1 3x3 conv (the fused RepBlocks, the
C3 and CSPSPPF 3x3s, each ConvBNormUpsample's conv, `deconv4` included) on
the conv3x3 kernel; the stem, the 3x3/s2 downsamples, pools and resizes
stay on PyTorch ops.
"""
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import registry
from ..nn.blocks import ConvBNorm, stage
from ..ops.resize import resize_nchw

ENCODER_WIDTHS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512)
DECODER_WIDTHS = (256, 256, 256, 126, 128, 64, 64)
NUM_CLASSES = 256


def _widths(widths: Sequence[int], width_multiple: float) -> List[int]:
    return [max(round(c * width_multiple), 1) for c in widths]


def _conv(cin: int, cout: int, folded: bool, device, no_batchnorm: bool = False) -> ConvBNorm:
    return ConvBNorm(cin, cout, 3, 1, 1, activation="relu", no_batchnorm=no_batchnorm,
                     folded=folded, device=device)


class BaseTrackNetEncoder(nn.Module):
    """Feature maps at strides 1, 2, 4 and 8: the taps after enc_1, enc_3
    and enc_6, and the last conv's output."""

    STAGES = (("enc_0", "enc_1"), ("enc_3", "enc_4"), ("enc_6", "enc_7", "enc_8"),
              ("enc_10", "enc_11", "enc_12"))

    def __init__(self, in_channels: int, width_multiple: float = 1.0, remat: bool = False,
                 folded: bool = False, device=None):
        super().__init__()
        self.remat = remat
        co = _widths(ENCODER_WIDTHS, width_multiple)
        cin = in_channels
        for name, c in zip((n for s in self.STAGES for n in s), co):
            setattr(self, name, _conv(cin, c, folded, device))
            cin = c
        self.out_channels = (co[1], co[2], co[4], co[9])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        def conv(name, t):
            return stage(getattr(self, name), t, remat=self.remat)

        x = conv("enc_1", conv("enc_0", x))
        fmaps = [x]                             # tap after enc_1
        x = conv("enc_3", F.max_pool2d(x, 2, 2))
        fmaps.append(x)                         # tap after enc_3 (quirk)
        x = conv("enc_4", x)
        x = conv("enc_6", F.max_pool2d(x, 2, 2))
        fmaps.append(x)                         # tap after enc_6 (quirk)
        x = conv("enc_8", conv("enc_7", x))
        x = F.max_pool2d(x, 2, 2)
        x = conv("enc_12", conv("enc_11", conv("enc_10", x)))
        fmaps.append(x)
        return fmaps


class BaseTrackNetDecoder(nn.Module):
    """Skip-concat decoder back to full resolution; `fmap_channels` are the
    encoder's four outputs' widths."""

    def __init__(self, fmap_channels: Sequence[int], out_channels: int = NUM_CLASSES,
                 width_multiple: float = 1.0, remat: bool = False, folded: bool = False,
                 device=None):
        super().__init__()
        self.remat = remat
        f0, f1, f2, f3 = fmap_channels
        co = _widths(DECODER_WIDTHS, width_multiple)
        plan = (("dec_2", f3 + f2, co[0]), ("dec_3", co[0], co[1]), ("dec_4", co[1], co[2]),
                ("dec_7", co[2] + f1, co[3]), ("dec_8", co[3], co[4]),
                ("dec_11", co[4] + f0, co[5]), ("dec_12", co[5], co[6]))
        for name, cin, cout in plan:
            setattr(self, name, _conv(cin, cout, folded, device))
        self.dec_13 = _conv(co[6], out_channels, folded, device, no_batchnorm=True)

    def forward(self, fmaps: Sequence[torch.Tensor]) -> torch.Tensor:
        def conv(name, t):
            return stage(getattr(self, name), t, remat=self.remat)

        def up_cat(t, skip):
            return torch.cat([resize_nchw(t, 2.0, method="nearest"), skip], dim=1)

        x = up_cat(fmaps[3], fmaps[2])
        x = conv("dec_4", conv("dec_3", conv("dec_2", x)))
        x = up_cat(x, fmaps[1])
        x = conv("dec_8", conv("dec_7", x))
        x = up_cat(x, fmaps[0])
        x = conv("dec_12", conv("dec_11", x))
        return self.dec_13(x)


def _tracknet_module(name: str, in_channels, config: Dict[str, Any], deploy: bool,
                     remat: bool, folded: bool, device, **extra):
    """(module, its output widths) of a TRACKNET_MODULES entry, built on
    `in_channels` from the `<name.lower()>_config` block of `config`."""
    spec = registry.resolve(registry.TRACKNET_MODULES, name)
    cfg = registry.component_config(config, name)
    if registry.takes(spec.cls, "deploy"):
        cfg["deploy"] = deploy
    if remat and registry.takes(spec.cls, "remat"):
        cfg.setdefault("remat", True)
    module = spec.cls(in_channels, **extra, **cfg, folded=folded, device=device)
    return module, spec.out_channels(in_channels, **cfg)


class AdvTrackNetEncoder(nn.Module):
    """Two registered modules in a chain (CSPNet then RepBiPAN in the
    shipped config): frames -> four maps at strides 4/8/16/32."""

    def __init__(self, in_channels: int, encoder_modules: Sequence[str], config: Dict[str, Any],
                 deploy: bool = False, remat: bool = False, folded: bool = False, device=None):
        super().__init__()
        if len(encoder_modules) != 2:
            raise ValueError(f"the encoder chains two modules, got {list(encoder_modules)}")
        ch = in_channels
        for i, name in enumerate(encoder_modules):
            module, ch = _tracknet_module(name, ch, config, deploy, remat, folded, device)
            setattr(self, f"enc_module_p{i + 1}", module)
        self.out_channels = tuple(ch)

    def forward(self, x: torch.Tensor) -> Sequence[torch.Tensor]:
        return self.enc_module_p2(self.enc_module_p1(x))


class AdvTrackNetDecoder(nn.Module):
    """Two registered modules in a chain (DeconvRepBiPAN then DeconvCSPNet
    in the shipped config): four maps -> `out_channels` logits at full
    resolution."""

    def __init__(self, fmap_channels: Sequence[int], out_channels: int,
                 decoder_modules: Sequence[str], config: Dict[str, Any], deploy: bool = False,
                 remat: bool = False, folded: bool = False, device=None):
        super().__init__()
        if len(decoder_modules) != 2:
            raise ValueError(f"the decoder chains two modules, got {list(decoder_modules)}")
        self.dec_module_p1, ch = _tracknet_module(decoder_modules[0], fmap_channels, config,
                                                  deploy, remat, folded, device)
        self.dec_module_p2, _ = _tracknet_module(decoder_modules[1], ch, config, deploy, remat,
                                                 folded, device, out_channels=out_channels)

    def forward(self, fmaps: Sequence[torch.Tensor]) -> torch.Tensor:
        return self.dec_module_p2(self.dec_module_p1(fmaps))


def heatmap_from_logits(logits: torch.Tensor,
                        og_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """(B, 256, H, W) logits -> (B, H, W) uint8: argmax over the classes;
    where og_size (h, w) differs from (H, W), a linear antialiased resize
    to it (jax.image.resize's "linear" with antialias), rounded, clipped."""
    hm = torch.argmax(logits, dim=1).to(torch.uint8)
    if og_size is not None and tuple(og_size) != tuple(hm.shape[1:]):
        out = F.interpolate(hm[:, None].float(), size=(int(og_size[0]), int(og_size[1])),
                            mode="bilinear", align_corners=False, antialias=True)
        hm = out[:, 0].round().clamp(0, 255).to(torch.uint8)
    return hm


class TrackNet(nn.Module):
    """Heatmap tracker. `config` is the `model_config` dict (architecture
    "base" or "advanced"); `in_channels` is 3 * num_stacks. `folded=True`
    builds BN-folded convs and `deploy=True` fused canonical RepVGG blocks
    (advanced only; the weights from `nn.reparam.deploy_transform`).
    Parameters are f32 and the network computes in `dtype`; the serve form
    casts its conv weights to `dtype` (`nn.blocks.cast_conv_weights`,
    applied by `infer/tracknet_runner.py`)."""

    def __init__(self, config: Dict[str, Any], in_channels: int = 9, folded: bool = False,
                 deploy: bool = False, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        arch = config["architecture"]
        if arch not in ("base", "advanced"):
            raise ValueError(f"Only base and advanced architectures are supported, got {arch}")
        self.dtype = dtype
        remat = bool(config.get("remat", False))
        if arch == "advanced":
            cfg = config["advanced_arch_config"]
            self.encoder = AdvTrackNetEncoder(
                in_channels, cfg["encoder_modules"], cfg.get("encoder_config", {}) or {},
                deploy=deploy, remat=remat, folded=folded, device=device)
            self.decoder = AdvTrackNetDecoder(
                self.encoder.out_channels, NUM_CLASSES, cfg["decoder_modules"],
                cfg.get("decoder_config", {}) or {}, deploy=deploy, remat=remat, folded=folded,
                device=device)
            return
        cfg = config["base_arch_config"]
        enc_cfg = dict(cfg.get("encoder_config", {}) or {})
        dec_cfg = dict(cfg.get("decoder_config", {}) or {})
        if remat:
            enc_cfg.setdefault("remat", True)
            dec_cfg.setdefault("remat", True)
        self.encoder = BaseTrackNetEncoder(in_channels, **enc_cfg, folded=folded, device=device)
        self.decoder = BaseTrackNetDecoder(self.encoder.out_channels, NUM_CLASSES, **dec_cfg,
                                           folded=folded, device=device)

    def forward(self, x: torch.Tensor, inference: bool = False,
                og_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        y = self.decoder(self.encoder(x.to(self.dtype)))
        if inference:
            return heatmap_from_logits(y, og_size)
        return y
