"""Detection loss, as in the JAX package's losses/detection_loss.py, on the
fixed-capacity assigner:

- matched predictions gathered at (b, gj, gi, a); predicted wh times the
  matched anchor (grid units) before CIoU;
- conf target = the detached CIoU at positive cells, BCE over the full grid;
  a cell that several candidates hit takes the value of the last one in the
  reference's write order (a scatter-max of `priority` picks the winner,
  then only winners write), which is deterministic on the card too;
- class BCE with label smoothing cn = 0.5*ls, cp = 1 - cn;
- the focal form for conf and class when alpha and gamma are set;
- keypoints: a 3-class softmax CE of the visibility logits against
  clip(v, 0, 2) and an MSE of the bbox-relative xy, each a mean over the
  matched keypoints whose label is finite (ragged rows are +inf padded),
  kp = (1 + kpv) * kpc;
- per-scale weights `scale_w`, then box/conf/class/keypoints weights,
  optional batch_scale_loss; NaN losses count as 0;
- metrics on the device: mean CIoU, conf/class losses, mean positive and
  negative confidence, macro accuracy/f1/precision/recall (and kpv_loss,
  kpc_loss, kp_loss), each a nanmean over the three scales.

`class_weights` is accepted by the config and unused, as in the reference.
"""
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..ops.boxes import compute_ciou
from ..ops.metrics import macro_classification_metrics, masked_mean
from .assigner import AssignResult, assign_targets_to_scale
from .focal import make_binary_lossfn, softmax_cross_entropy


@dataclass(frozen=True)
class DetectionLossConfig:
    num_classes: int = 1
    num_keypoints: int = 0
    anchor_t: float = 4.0
    edge_t: float = 0.5
    box_w: float = 1.0
    conf_w: float = 1.0
    class_w: float = 1.0
    keypoints_w: float = 1.0
    label_smoothing: float = 0.0
    batch_scale_loss: bool = False
    alpha: Optional[float] = None
    gamma: Optional[float] = None
    scale_w: Tuple[float, float, float] = (4.0, 2.0, 1.0)


def _nan_to_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(x), torch.zeros_like(x), x)


def conf_targets(asn: AssignResult, values: torch.Tensor,
                 grid: Tuple[int, int, int, int]) -> torch.Tensor:
    """(B, ny, nx, na) grid of zeros with `values` written at the valid
    candidates' cells. Where several candidates share a cell, the one with
    the highest `priority` (the reference's last write) wins: a scatter-max
    of the priorities picks it, then only winners write, so no two writes
    meet in a kept cell. Cells are flat indices into a (B+1, ny, nx, na)
    grid whose row B takes the other candidates and is dropped."""
    b, ny, nx, na = grid
    n_cells = ny * nx * na
    dev = values.device
    cell = (asn.grid_j * nx + asn.grid_i) * na + asn.anchor_idx
    flat = torch.where(asn.valid, asn.batch_idx, b) * n_cells + cell
    pr_grid = torch.full(((b + 1) * n_cells,), -1, dtype=torch.int64, device=dev)
    pr_grid = pr_grid.scatter_reduce(0, flat, asn.priority, "amax")
    is_winner = asn.valid & (pr_grid[flat] == asn.priority)
    win = torch.where(is_winner, asn.batch_idx, b) * n_cells + cell
    t = torch.zeros((b + 1) * n_cells, dtype=values.dtype, device=dev).scatter(0, win, values)
    return t[:b * n_cells].view(b, ny, nx, na)


def scale_loss(
    preds: torch.Tensor,       # (B, ny, nx, A, D) train-decoded
    labels: torch.Tensor,      # (B, M, 5+E)
    label_mask: torch.Tensor,  # (B, M)
    anchors: torch.Tensor,     # (A, 2), 0-1
    cfg: DetectionLossConfig,
    image_mask: Optional[torch.Tensor] = None,  # (B,) row validity; None = all
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One scale's losses and metrics.

    `image_mask` marks the valid rows of a wrap-padded eval batch: masked
    rows get no candidates (their label_mask is zeroed) and leave the
    full-grid conf BCE, so each sample scores once. None keeps the plain
    train-path computation.
    """
    b, ny, nx, na, _ = preds.shape
    c = cfg.num_classes
    binfn = make_binary_lossfn(cfg.alpha, cfg.gamma)
    if image_mask is not None:
        imw = image_mask.float()
        label_mask = label_mask.bool() & (imw[:, None] > 0)

    asn = assign_targets_to_scale(labels, label_mask, (ny, nx), anchors,
                                  anchor_threshold=cfg.anchor_t, edge_threshold=cfg.edge_t)
    valid = asn.valid

    match = preds[asn.batch_idx, asn.grid_j, asn.grid_i, asn.anchor_idx].float()  # (N, D)
    p_cls = match[:, 1:1 + c]
    # Padded label slots have wh = 0, which is NaN in CIoU's atan(w/h) and
    # would leak NaN into the gradients through the masked rows: give invalid
    # rows a harmless target and anchor before any nonlinear math.
    safe_t = torch.where(valid[:, None], asn.t_xywh,
                         torch.tensor([0.5, 0.5, 1.0, 1.0], device=preds.device))
    safe_anchors = torch.where(valid[:, None], asn.anchors, torch.ones_like(asn.anchors))
    p_xywh = torch.cat([match[:, 1 + c:3 + c], match[:, 3 + c:5 + c] * safe_anchors], dim=-1)

    # ---- box loss (CIoU)
    ciou = compute_ciou(p_xywh, safe_t)
    ciou_loss = masked_mean(1.0 - ciou, valid)

    # ---- conf loss: target grid = detached CIoU at positives
    ciou_d = ciou.detach()
    t_conf = conf_targets(asn, ciou_d, (b, ny, nx, na))
    n_cells = ny * nx * na
    p_conf = preds[..., 0].float()
    conf_elem = binfn(p_conf, t_conf)
    if image_mask is None:
        conf_loss = conf_elem.mean()
        neg_mask = t_conf == 0
    else:
        row_w = imw[:, None, None, None]
        conf_loss = (conf_elem * row_w).sum() / (imw.sum() * n_cells).clamp(min=1.0)
        neg_mask = (t_conf == 0) & (row_w > 0)
    nan = float("nan")
    avg_pos_conf = masked_mean(torch.sigmoid(match[:, 0]), valid, default=nan)
    avg_neg_conf = masked_mean(torch.sigmoid(p_conf), neg_mask, default=nan)

    # ---- class loss with label smoothing over the matched rows
    cn = 0.5 * cfg.label_smoothing
    t_cls = torch.full_like(p_cls, cn).scatter(1, asn.classes.clamp(0, c - 1)[:, None], 1.0 - cn)
    class_loss = masked_mean(binfn(p_cls, t_cls).mean(dim=-1), valid)

    losses = {"box": _nan_to_zero(ciou_loss), "conf": conf_loss,
              "class": _nan_to_zero(class_loss)}
    kp_metrics = {}
    if cfg.num_keypoints and labels.shape[-1] > 5:
        nkp = cfg.num_keypoints
        p_kp = match[:, 5 + c:].reshape(-1, nkp, 5)
        t_kp = asn.keypoints.reshape(-1, nkp, 3)
        kp_valid = torch.isfinite(t_kp).all(dim=-1) & valid[:, None]  # (N, nkp)
        # clip before the cast: padded slots hold +inf
        kpv_elem = softmax_cross_entropy(p_kp[..., 2:], t_kp[..., 2].clamp(0, 2).long())
        kpv_loss = masked_mean(kpv_elem, kp_valid)
        # the padded +inf leaves the target before the square, so no NaN
        # reaches the gradient through the masked rows
        t_xy = torch.where(kp_valid[..., None], t_kp[..., :2], torch.zeros_like(t_kp[..., :2]))
        kpc_loss = masked_mean(torch.square(p_kp[..., :2] - t_xy).mean(dim=-1), kp_valid)
        kp_loss = (1.0 + kpv_loss) * kpc_loss
        losses["keypoints"] = _nan_to_zero(kp_loss)
        kp_metrics = {"kpv_loss": kpv_loss, "kpc_loss": kpc_loss, "kp_loss": kp_loss}

    pred_labels = p_cls.detach().argmax(dim=-1)
    mean_ciou = masked_mean(ciou_d, valid)
    metrics = {
        "mean_ciou": torch.where(valid.any(), mean_ciou, torch.full_like(mean_ciou, nan)),
        "conf_loss": conf_loss,
        "avg_pos_conf": avg_pos_conf,
        "avg_neg_conf": avg_neg_conf,
        "class_loss": class_loss,
        **macro_classification_metrics(pred_labels, asn.classes, valid, c),
        **kp_metrics,
    }
    return losses, metrics


def detection_loss(
    preds: Sequence[torch.Tensor],    # (sm, md, lg) train-decoded per-scale preds
    labels: torch.Tensor,
    label_mask: torch.Tensor,
    anchors: Sequence[torch.Tensor],  # (sm, md, lg) each (A, 2), 0-1
    cfg: DetectionLossConfig,
    image_mask: Optional[torch.Tensor] = None,  # (B,), see scale_loss
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The three-scale loss and its metrics (all 0-dim tensors on the
    preds' device; `aggregate_loss` is the loss)."""
    per_scale = [scale_loss(p, labels, label_mask, a.detach(), cfg, image_mask=image_mask)
                 for p, a in zip(preds, anchors)]
    sw = cfg.scale_w

    def agg(key):
        return sum(sw[i] * per_scale[i][0][key] for i in range(3))

    loss = cfg.box_w * agg("box") + cfg.conf_w * agg("conf") + cfg.class_w * agg("class")
    if "keypoints" in per_scale[0][0]:
        loss = loss + cfg.keypoints_w * agg("keypoints")
    if cfg.batch_scale_loss:
        loss = loss * (preds[-1].shape[0] if image_mask is None else image_mask.float().sum())
    metrics = {"aggregate_loss": loss}
    for key in per_scale[0][1]:
        metrics[key] = torch.nanmean(torch.stack([m[1][key] for m in per_scale]))
    return loss, metrics
