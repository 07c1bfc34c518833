"""YOLOv5-style target assignment on a fixed-capacity candidate lattice, as
in the JAX package's losses/assigner.py.

Every (image, label slot, anchor, offset) combination is a candidate row
with a validity flag: B*M*A*5 rows, no boolean indexing, so the shapes do
not depend on the data and the train step never waits on the host. The
losses gather and scatter with the row indices and mask by validity.

Semantics kept from the JAX package:
- anchor ratio filter max(r, 1/r).max < anchor_threshold;
- 5-way edge expansion, offsets [[0,0],[1,0],[0,1],[-1,0],[0,-1]] *
  edge_threshold, gated by (coord % 1 < t) & (coord > 1) and the mirrored
  test on gain - coord; `%` is floor modulo (torch.remainder);
- cell = int(xy - offset), truncated toward zero, then clamped to the map;
  the target xy is relative to the CLAMPED cell;
- `priority` orders candidates offset-major, then anchor, batch, slot: the
  reference's write order, which decides duplicate cells (last write wins).

Inputs are the padded batch layout of the data pipeline: labels
(B, M, 5+E) = [cls, x, y, w, h, extras] normalised to 0-1, label_mask (B, M).
"""
from typing import NamedTuple, Tuple

import torch

OFFSETS = ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (-1.0, 0.0), (0.0, -1.0))
NUM_OFFSETS = 5


class AssignResult(NamedTuple):
    batch_idx: torch.Tensor   # (N,) int64
    grid_j: torch.Tensor      # (N,) int64 (y cell)
    grid_i: torch.Tensor      # (N,) int64 (x cell)
    anchor_idx: torch.Tensor  # (N,) int64
    classes: torch.Tensor     # (N,) int64
    anchors: torch.Tensor     # (N, 2) matched anchor wh in grid units
    t_xywh: torch.Tensor      # (N, 4) xy relative to the cell, wh in grid units
    tmask_idx: torch.Tensor   # (N,) int64: slot (+1 with overlap masks)
    keypoints: torch.Tensor   # (N, E) pass-through extras
    valid: torch.Tensor       # (N,) bool
    label_slot: torch.Tensor  # (N,) int64: source row m in the padded labels
    priority: torch.Tensor    # (N,) int64: reference write order


def assign_targets_to_scale(
    labels: torch.Tensor,
    label_mask: torch.Tensor,
    fmap_hw: Tuple[int, int],
    anchors: torch.Tensor,
    anchor_threshold: float = 4.0,
    edge_threshold: float = 0.5,
    overlap_masks: bool = False,
) -> AssignResult:
    b, m, cols = labels.shape
    e = cols - 5
    ny, nx = int(fmap_hw[0]), int(fmap_hw[1])
    a = anchors.shape[0]
    dev = labels.device
    gain_wh = torch.tensor([nx, ny], dtype=torch.float32, device=dev)
    shape = (b, m, a, NUM_OFFSETS)

    cls = labels[..., 0].to(torch.int64)
    xy_g = labels[..., 1:3].float() * gain_wh
    wh_g = labels[..., 3:5].float() * gain_wh
    extras = labels[..., 5:].float()
    anchors_g = anchors.float() * gain_wh

    # anchor ratio filter -> (B, M, A)
    r = wh_g[:, :, None, :] / anchors_g[None, None].clamp(min=1e-9)
    ratio_ok = torch.maximum(r, 1.0 / r.clamp(min=1e-9)).amax(dim=-1) < anchor_threshold

    # edge-expansion offset validity -> (B, M, 5)
    gx, gy = xy_g[..., 0], xy_g[..., 1]
    gxi, gyi = gain_wh[0] - gx, gain_wh[1] - gy
    t = edge_threshold
    offset_ok = torch.stack([
        torch.ones_like(gx, dtype=torch.bool),
        (torch.remainder(gx, 1.0) < t) & (gx > 1.0),
        (torch.remainder(gy, 1.0) < t) & (gy > 1.0),
        (torch.remainder(gxi, 1.0) < t) & (gxi > 1.0),
        (torch.remainder(gyi, 1.0) < t) & (gyi > 1.0),
    ], dim=-1)

    valid = label_mask.bool()[:, :, None, None] & ratio_ok[:, :, :, None] & offset_ok[:, :, None, :]

    offs = torch.tensor(OFFSETS, dtype=torch.float32, device=dev) * t  # (5, 2)
    shifted = xy_g[:, :, None, :] - offs[None, None]                   # (B, M, 5, 2)
    grid_ij = shifted.to(torch.int64)  # truncates toward zero
    gi = grid_ij[..., 0].clamp(0, nx - 1)
    gj = grid_ij[..., 1].clamp(0, ny - 1)
    t_xy = xy_g[:, :, None, :] - torch.stack([gi, gj], dim=-1).float()
    t_xywh = torch.cat([t_xy, wh_g[:, :, None, :].expand(b, m, NUM_OFFSETS, 2)], dim=-1)

    def ar(n, view):
        return torch.arange(n, device=dev).view(view).expand(shape)

    batch_idx = ar(b, (b, 1, 1, 1))
    label_slot = ar(m, (1, m, 1, 1))
    anchor_idx = ar(a, (1, 1, a, 1))
    offset_idx = ar(NUM_OFFSETS, (1, 1, 1, NUM_OFFSETS))
    priority = offset_idx * (a * b * m) + anchor_idx * (b * m) + batch_idx * m + label_slot

    n = b * m * a * NUM_OFFSETS
    return AssignResult(
        batch_idx=batch_idx.reshape(n),
        grid_j=gj[:, :, None, :].expand(shape).reshape(n),
        grid_i=gi[:, :, None, :].expand(shape).reshape(n),
        anchor_idx=anchor_idx.reshape(n),
        classes=cls[:, :, None, None].expand(shape).reshape(n),
        anchors=anchors_g[None, None, :, None, :].expand(b, m, a, NUM_OFFSETS, 2).reshape(n, 2),
        t_xywh=t_xywh[:, :, None].expand(b, m, a, NUM_OFFSETS, 4).reshape(n, 4),
        tmask_idx=(label_slot + 1 if overlap_masks else label_slot).reshape(n),
        keypoints=extras[:, :, None, None, :].expand(b, m, a, NUM_OFFSETS, e).reshape(n, e),
        valid=valid.reshape(n),
        label_slot=label_slot.reshape(n),
        priority=priority.reshape(n),
    )
