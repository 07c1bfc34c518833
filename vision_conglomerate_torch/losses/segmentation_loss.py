"""Segmentation (YOLACT prototype) loss, the JAX package's
losses/segmentation_loss.py in PyTorch.

The matched candidates of each image are compacted into a fixed number of
slots (`seg_candidates_per_image`), and the mask loss is one batched einsum
protos (B, K, H, W) x coefs (B, S, K) -> (B, S, H, W) plus masked
reductions. When an image has more candidates than the cap, `cap_policy`
picks the ones that keep mask supervision:
- "first": assignment order;
- "area": larger target boxes first (ties in assignment order);
- "random": a fresh uniform draw each step from the caller's
  torch.Generator (the trainer's own), in place of the JAX package's
  fold_in of the step key; without a generator a fixed seed-0 draw.
The selection is a stable descending sort with invalid rows at -inf, so
ties keep the lower index, as lax.top_k does.

Semantics kept from the JAX package (and its reference quirks):
- overlap masks rebuild each instance's binary mask by id comparison;
  without overlap the per-slot mask stack is indexed;
- target masks are resized to the protos' size with half-pixel nearest
  sampling (jax.image.resize "nearest" = F.interpolate "nearest-exact");
- the element loss is BCE with logits (or the focal form), cropped to the
  target box and normalised by the box's area, then combined as
  `(1 - crop_mean/area) * dice_loss`;
- under crop_mode="reference" the crop boxes are the assigner's t_xywh
  (xy relative to the grid cell, wh in grid units) applied to the
  proto-resolution plane; crop_mode="corrected" crops with the true box in
  proto pixels;
- per-image results are averaged over the batch size.
Padded label rows are replaced before any nonlinear math, so their inf or
zero boxes put no NaN into the gradients.
"""
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.masks import crop_section
from .assigner import assign_targets_to_scale
from .detection_loss import DetectionLossConfig, _nan_to_zero, scale_loss
from .focal import make_binary_lossfn

CAP_POLICIES = ("first", "area", "random")
SAFE_BOX = (0.5, 0.5, 1.0, 1.0)


@dataclass(frozen=True)
class SegmentationLossConfig(DetectionLossConfig):
    seg_w: float = 1.0
    overlap_masks: bool = True
    seg_candidates_per_image: int = 32
    crop_mode: str = "reference"  # "reference" | "corrected"
    cap_policy: str = "random"    # "first" | "area" | "random"


def _select_top_candidates(values: Sequence[torch.Tensor], valid: torch.Tensor,
                           priority: torch.Tensor, cap: int
                           ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The `cap` highest-priority valid rows of (B, N, ...) tensors, in
    (B, cap, ...) slots. Invalid rows sort last (-inf); equal priorities
    keep the lower index. A cap above N keeps every row."""
    keyed = torch.where(valid, priority, torch.full_like(priority, -float("inf")))
    cap = min(cap, keyed.shape[-1])
    idx = torch.sort(keyed, dim=-1, descending=True, stable=True).indices[:, :cap]
    out = []
    for v in values:
        ix = idx.reshape(idx.shape + (1,) * (v.ndim - 2)).expand(*idx.shape, *v.shape[2:])
        out.append(torch.gather(v, 1, ix))
    return out, torch.gather(valid, 1, idx)


def _candidate_priority(cfg: SegmentationLossConfig, valid: torch.Tensor, t_xywh: torch.Tensor,
                        generator: Optional[torch.Generator]) -> torch.Tensor:
    if cfg.cap_policy == "first":
        n = valid.shape[1]
        return -torch.arange(n, dtype=torch.float32, device=valid.device)[None].expand(valid.shape)
    if cfg.cap_policy == "area":
        return t_xywh[..., 2] * t_xywh[..., 3]
    if cfg.cap_policy == "random":
        if generator is None:
            generator = torch.Generator(device=valid.device).manual_seed(0)
        return torch.rand(valid.shape, generator=generator, device=valid.device)
    raise ValueError(f"Unknown cap_policy {cfg.cap_policy!r}; supported: {', '.join(CAP_POLICIES)}")


def _nearest_to(masks: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(B, [M,] H, W) masks as f32, resized to hw with half-pixel nearest
    sampling where their size differs."""
    masks = masks.float()
    if tuple(masks.shape[-2:]) == tuple(hw):
        return masks
    if masks.ndim == 3:
        return F.interpolate(masks[:, None], size=hw, mode="nearest-exact")[:, 0]
    return F.interpolate(masks, size=hw, mode="nearest-exact")


def seg_scale_loss(
    preds: torch.Tensor,         # (B, ny, nx, A, D) train-decoded (tanh'd coefficients)
    labels: torch.Tensor,        # (B, M, 5)
    label_mask: torch.Tensor,    # (B, M)
    protos: torch.Tensor,        # (B, K, Hp, Wp) NCHW
    target_masks: torch.Tensor,  # overlap: (B, Hm, Wm); else (B, M, Hm, Wm)
    anchors: torch.Tensor,       # (A, 2), 0-1
    cfg: SegmentationLossConfig,
    generator: Optional[torch.Generator] = None,
    image_mask: Optional[torch.Tensor] = None,  # (B,) row validity; None = all
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One scale's detection and mask losses and metrics."""
    b, ny, nx, na, _ = preds.shape
    c = cfg.num_classes
    k = protos.shape[1]
    hp, wp = protos.shape[2], protos.shape[3]
    dev = preds.device
    if image_mask is not None:
        # masked rows get no candidates and leave the batch-size denominators
        label_mask = label_mask.bool() & (image_mask[:, None] > 0)
    target_masks = _nearest_to(target_masks, (hp, wp))

    asn = assign_targets_to_scale(labels, label_mask, (ny, nx), anchors,
                                  anchor_threshold=cfg.anchor_t, edge_threshold=cfg.edge_t,
                                  overlap_masks=cfg.overlap_masks)
    match = preds[asn.batch_idx, asn.grid_j, asn.grid_i, asn.anchor_idx].float()
    coefs = match[:, 5 + c:5 + c + k]

    n_per_img = asn.valid.shape[0] // b
    cap = min(cfg.seg_candidates_per_image, n_per_img)

    def per_img(t):
        return t.reshape((b, n_per_img) + t.shape[1:])

    valid_img, txywh_img = per_img(asn.valid), per_img(asn.t_xywh)
    priority = _candidate_priority(cfg, valid_img, txywh_img, generator)
    (c_coefs, c_tmask_idx, c_txywh, c_slot), c_valid = _select_top_candidates(
        [per_img(coefs), per_img(asn.tmask_idx), txywh_img, per_img(asn.label_slot)],
        valid_img, priority, cap)
    safe = torch.tensor(SAFE_BOX, device=dev)
    c_txywh = torch.where(c_valid[..., None], c_txywh, safe)
    # candidates lost to the cap, as a metric
    dropped = (valid_img.sum(dim=1).float() - cap).clamp(min=0.0).sum()

    pred_mask = torch.einsum("bkhw,bsk->bshw", protos.float(), c_coefs)
    sig_pred = torch.sigmoid(pred_mask)
    if cfg.overlap_masks:
        tmask = (target_masks[:, None] == c_tmask_idx[:, :, None, None].float()).float()
    else:
        ix = c_tmask_idx[:, :, None, None].expand(-1, -1, hp, wp)
        tmask = torch.gather(target_masks, 1, ix)

    elem = make_binary_lossfn(cfg.alpha, cfg.gamma)(pred_mask, tmask)
    if cfg.crop_mode == "reference":
        crop_boxes = c_txywh
    else:
        lab = torch.gather(labels.float(), 1, c_slot[:, :, None].expand(-1, -1, labels.shape[-1]))
        scale = torch.tensor([wp, hp, wp, hp], dtype=torch.float32, device=dev)
        crop_boxes = torch.where(c_valid[..., None], lab[..., 1:5] * scale, safe)
    cropped = crop_section(elem.reshape(b * cap, hp, wp),
                           crop_boxes.reshape(b * cap, 4)).reshape(elem.shape)
    mask_area = (crop_boxes[..., 2] * crop_boxes[..., 3]).clamp(min=1e-9)
    crop_mean = cropped.mean(dim=(2, 3)) / mask_area  # (B, S)

    e = 1e-5
    inter = (sig_pred * tmask).sum(dim=(2, 3))
    denom = sig_pred.sum(dim=(2, 3)) + tmask.sum(dim=(2, 3))
    dice_n = (2 * inter + e) / (denom + e)
    rp, rt = torch.round(sig_pred.detach()), torch.round(tmask)
    dice_rnd_n = (2 * (rp * rt).sum(dim=(2, 3)) + e) / (rp.sum(dim=(2, 3)) + rt.sum(dim=(2, 3)) + e)

    vimg = c_valid.float()
    n_img = vimg.sum(dim=1)
    has_img = n_img > 0
    zero = torch.zeros((), device=dev)

    def mean_img(t):
        return torch.where(has_img, (t * vimg).sum(dim=1) / n_img.clamp(min=1), zero)

    dice_loss_img = torch.where(has_img, 1.0 - mean_img(dice_n), zero)
    sl_img = mean_img((1.0 - crop_mean) * dice_loss_img[:, None])
    ds_img = mean_img(dice_rnd_n)
    n_rows = (torch.tensor(float(b), device=dev) if image_mask is None
              else image_mask.float().sum().clamp(min=1.0))
    seg = sl_img.sum() / n_rows
    dice_score = ds_img.sum() / n_rows

    det_losses, det_metrics = scale_loss(preds, labels, label_mask, anchors, cfg,
                                         image_mask=image_mask)
    det_losses = dict(det_losses, seg=_nan_to_zero(seg))
    det_metrics = dict(det_metrics, seg_loss=seg, dice_score=dice_score,
                       seg_dropped_candidates=dropped)
    return det_losses, det_metrics


def segmentation_loss(
    preds: Sequence[torch.Tensor],
    labels: torch.Tensor,
    label_mask: torch.Tensor,
    protos: torch.Tensor,
    target_masks: torch.Tensor,
    anchors: Sequence[torch.Tensor],
    cfg: SegmentationLossConfig,
    generator: Optional[torch.Generator] = None,
    image_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The three-scale loss (box, conf, class and mask terms) and its
    metrics, each a nanmean over the scales; `aggregate_loss` is the loss.
    Under cap_policy "random" each scale draws from `generator` in turn."""
    per_scale = [seg_scale_loss(p, labels, label_mask, protos, target_masks, a.detach(), cfg,
                                generator=generator, image_mask=image_mask)
                 for p, a in zip(preds, anchors)]
    sw = cfg.scale_w

    def agg(key):
        return sum(sw[i] * per_scale[i][0][key] for i in range(3))

    loss = (cfg.box_w * agg("box") + cfg.conf_w * agg("conf") + cfg.class_w * agg("class")
            + cfg.seg_w * agg("seg"))
    if cfg.batch_scale_loss:
        loss = loss * (preds[-1].shape[0] if image_mask is None else image_mask.float().sum())
    metrics = {"aggregate_loss": loss}
    for key in per_scale[0][1]:
        metrics[key] = torch.nanmean(torch.stack([m[1][key] for m in per_scale]))
    return loss, metrics
