"""DetectionNet and its per-scale decode, the JAX package's
models/detection.py in PyTorch.

The input is an NCHW image batch (an NHWC batch permuted to NCHW is
already channels_last). The outputs keep the JAX layout: per scale
(N, ny, nx, na, 1 + C + 4 [+ K] [+ 5 Kp]) when `inference=False`, and the
flattened, decoded (N, M, 5 + C [+ K] [+ 5 Kp]) when `inference=True`,
where K mask coefficients (tanh'd in both decodes) come with the proto
branch (`with_proto_seg`, models/segmentation.py) and Kp keypoints
[x, y, v0, v1, v2] with `num_keypoints`: xy sigmoid'd (bbox-relative in
training, input pixels at inference), the visibility logits raw.

Quirks kept from the JAX package:
- the stride vector is [h/ny, w/nx] and multiplies (x, y) in that order;
- the og-size rescale fires only when BOTH dims differ;
- decode runs in f32 even when the network runs in bf16.
Anchors are parameters (`{sm,md,lg}_anchors`), so they ride in checkpoints.
"""
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from .. import registry
from ..nn.blocks import ProtoSegModule

ZERO_ANCHORS = {
    "sm": ((0.0, 0.0), (0.0, 0.0), (0.0, 0.0)),
    "md": ((0.0, 0.0), (0.0, 0.0), (0.0, 0.0)),
    "lg": ((0.0, 0.0), (0.0, 0.0), (0.0, 0.0)),
}


def make_2dgrid(nx: int, ny: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(1, ny, nx, 1, 2) grid of (x, y) cell indices."""
    yg, xg = torch.meshgrid(torch.arange(ny, device=device), torch.arange(nx, device=device),
                            indexing="ij")
    return torch.stack([xg, yg], dim=2).reshape(1, ny, nx, 1, 2).to(dtype)


def decode_scale(scale_pred: torch.Tensor, anchors: torch.Tensor, input_shape: Tuple[int, int],
                 num_classes: int, num_masks: int = 0, num_keypoints: int = 0,
                 inference: bool = False) -> torch.Tensor:
    """Per-scale decode of (B, ny, nx, na, 1 + C + 4 + K + 5 Kp); anchors
    (na, 2) in 0-1.

    Train: xy = sig*2 - 0.5 (cell units), wh = (sig*2)^2 (anchor-relative).
    Inference: xy and wh in input pixels. The K mask coefficients are
    tanh'd in both. Each keypoint's xy is sigmoid'd (bbox-relative); at
    inference it maps into the decoded box, kp * wh + (xy - wh / 2), in
    input pixels. Its three visibility logits pass through.
    """
    _, ny, nx, _, _ = scale_pred.shape
    if inference:
        scale_pred = scale_pred.float()
    bbox_i = num_classes + 1
    kp_i = bbox_i + 4 + num_masks
    xy = torch.sigmoid(scale_pred[..., bbox_i:bbox_i + 2]) * 2.0 - 0.5
    wh = torch.square(torch.sigmoid(scale_pred[..., bbox_i + 2:bbox_i + 4]) * 2.0)
    if num_keypoints:
        kp = scale_pred[..., kp_i:kp_i + 5 * num_keypoints].unflatten(-1, (num_keypoints, 5))
        kp_xy = torch.sigmoid(kp[..., :2])
    if inference:
        dtype, dev = scale_pred.dtype, scale_pred.device
        stride = torch.tensor([input_shape[0] / ny, input_shape[1] / nx], dtype=dtype, device=dev)
        xy = (xy + make_2dgrid(nx, ny, dtype, dev)) * stride
        wh = wh * anchors.to(dtype) * torch.tensor([nx, ny], dtype=dtype, device=dev) * stride
        if num_keypoints:
            kp_xy = kp_xy * wh[..., None, :] + (xy - wh / 2.0)[..., None, :]
    parts = [scale_pred[..., :bbox_i], xy, wh]
    if num_masks:
        parts.append(torch.tanh(scale_pred[..., bbox_i + 4:kp_i]))
    if num_keypoints:
        parts.append(torch.cat([kp_xy, kp[..., 2:]], dim=-1).flatten(-2))
    return torch.cat(parts, dim=-1)


def rescale_preds_to_size(pred: torch.Tensor, from_wh: Tuple[int, int], to_wh: Tuple[int, int],
                          num_classes: int, num_keypoints: int = 0) -> torch.Tensor:
    """Rescale decoded xywh boxes, and the xy of the `num_keypoints`
    keypoints that end each row, from one image size to another; the
    columns between (mask coefficients) and the visibility logits pass
    through (the logits are divided and multiplied by 1, as in the JAX
    package)."""
    box_i = 1 + num_classes
    kp_i = pred.shape[-1] - 5 * num_keypoints
    _from = torch.tensor([from_wh[0], from_wh[1]] * 2, dtype=pred.dtype, device=pred.device)
    _to = torch.tensor([to_wh[0], to_wh[1]] * 2, dtype=pred.dtype, device=pred.device)
    boxes = pred[..., box_i:box_i + 4] / _from * _to
    parts = [pred[..., :box_i], boxes, pred[..., box_i + 4:kp_i]]
    if num_keypoints:
        ones = torch.ones(3, dtype=pred.dtype, device=pred.device)
        kp = pred[..., kp_i:].unflatten(-1, (-1, 5))
        kp = kp / torch.cat([_from[:2], ones]) * torch.cat([_to[:2], ones])
        parts.append(kp.flatten(-2))
    return torch.cat(parts, dim=-1)


class DetectionNet(nn.Module):
    """Backbone + neck + 3 decoupled heads + per-scale decode.

    `config` is the `model_config` dict; its backbone, neck and head names
    resolve through `registry`. `deploy=True` builds fused RepVGG blocks and
    `folded=True` BN-folded convs (the serve form; weights from
    `nn.reparam.deploy_transform`). `config["remat"]` checkpoints the
    backbone and neck stages in training (`nn.blocks.stage`); it changes
    neither the parameters nor the outputs. Parameters are f32 and the network
    computes in `dtype`; the serve form casts its conv weights to `dtype`
    (`nn.blocks.cast_conv_weights`, applied by `infer/runner.py`).

    With `with_proto_seg` (SegmentationNet) the head also emits
    `config["num_masks"]` mask coefficients per anchor, a ProtoSegModule
    (`config["protos_config"]`) runs on n3, and forward returns
    (preds, protos), the protos NCHW (N, K, H/4, W/4). `num_keypoints`
    adds the heads' keypoint branch.
    """

    with_proto_seg = False

    def __init__(self, num_classes: int, config: Dict[str, Any],
                 anchors: Optional[Dict[str, Any]] = None, num_keypoints: Optional[int] = None,
                 deploy: bool = False, folded: bool = False, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.num_classes = num_classes
        self.num_keypoints = num_keypoints
        self.num_masks = int(config.get("num_masks") or 0) if self.with_proto_seg else 0
        self.dtype = dtype
        anchors = anchors or ZERO_ANCHORS
        self.num_anchors = len(anchors["sm"])
        for k in ("sm", "md", "lg"):
            setattr(self, f"{k}_anchors", nn.Parameter(
                torch.tensor(anchors[k], dtype=torch.float32, device=device), requires_grad=False))

        bb_spec = registry.resolve(registry.BACKBONES, config["backbone"])
        bb_cfg = registry.component_config(config, config["backbone"])
        neck_spec = registry.resolve(registry.NECKS, config["neck"])
        neck_cfg = registry.component_config(config, config["neck"])
        head_spec = registry.resolve(registry.HEADS, config["head"])
        head_cfg = registry.component_config(config, config["head"])
        # model_config.remat reaches the backbone and neck unless their own
        # config sets it, as in the JAX package
        if config.get("remat"):
            bb_cfg.setdefault("remat", True)
            neck_cfg.setdefault("remat", True)
        kw = dict(folded=folded, device=device)
        self.backbone = bb_spec.cls(3, **bb_cfg, **kw)
        bb_out = bb_spec.out_channels(**bb_cfg)
        if registry.takes(neck_spec.cls, "deploy"):
            neck_cfg["deploy"] = deploy
        self.neck = neck_spec.cls(bb_out, **neck_cfg, **kw)
        neck_out = neck_spec.out_channels(bb_out, **neck_cfg)
        self.head = nn.ModuleList([
            head_spec.cls(c, num_classes, num_anchors=self.num_anchors,
                          num_masks=self.num_masks or None, num_keypoints=num_keypoints,
                          **head_cfg, **kw)
            for c in neck_out[1:]])
        if self.with_proto_seg:
            self.proto_seg_module = ProtoSegModule(
                neck_out[1], self.num_masks, **dict(config.get("protos_config") or {}), **kw)

    def forward(self, x: torch.Tensor, inference: bool = False,
                og_size: Optional[Tuple[int, int]] = None):
        x = x.to(self.dtype)
        _, n3, n4, n5 = self.neck(self.backbone(x))
        heads_out = [head(fm) for head, fm in zip(self.head, (n3, n4, n5))]
        input_shape = (x.shape[2], x.shape[3])
        anchors = (self.sm_anchors, self.md_anchors, self.lg_anchors)
        preds = [decode_scale(p, a, input_shape, self.num_classes, self.num_masks,
                              self.num_keypoints or 0, inference)
                 for p, a in zip(heads_out, anchors)]
        if not inference:
            preds = tuple(preds)
        else:
            if og_size is not None and og_size[0] != x.shape[2] and og_size[1] != x.shape[3]:
                from_wh, to_wh = (x.shape[3], x.shape[2]), (og_size[1], og_size[0])
                preds = [rescale_preds_to_size(p, from_wh, to_wh, self.num_classes,
                                               self.num_keypoints or 0) for p in preds]
            final_dim = self.num_classes + 5 + self.num_masks + 5 * (self.num_keypoints or 0)
            preds = torch.cat([p.reshape(x.shape[0], -1, final_dim) for p in preds], dim=1)
        if self.with_proto_seg:
            return preds, self.proto_seg_module(n3)
        return preds
