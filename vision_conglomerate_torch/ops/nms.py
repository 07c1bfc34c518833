"""Batched NMS on the device, the JAX package's ops/nms.py in PyTorch.

1. top-P prefilter by score (P = pre_nms_topk);
2. class-aware suppression by the coordinate-offset trick;
3. exact greedy keep as a fixed point: with candidates sorted by score,
   keep[i] = valid[i] and no kept j < i has iou(i, j) > t. Iterating this
   as a batched matvec converges to the greedy answer in at most
   longest-suppression-chain steps; the loop stops when the keep mask
   stops changing (one host sync per step);
4. compaction of the kept set into max_detections slots.

`topk_method="approx"` names a TPU-only partial reduce in the JAX package;
here both methods take the exact `torch.topk`. Ties in score may order
differently from `lax.top_k`.
"""
from typing import NamedTuple

import torch

from .boxes import box_iou_xyxy


class NMSResult(NamedTuple):
    boxes: torch.Tensor    # (B, K, 4) xyxy
    scores: torch.Tensor   # (B, K)
    classes: torch.Tensor  # (B, K) int32
    valid: torch.Tensor    # (B, K) bool
    indices: torch.Tensor  # (B, K) int64 index into the input N axis


def greedy_keep(iou: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Exact greedy keep mask (B, P) for score-sorted candidates."""
    p = iou.shape[-1]
    earlier = torch.ones((p, p), dtype=torch.bool, device=iou.device).tril(-1)  # [i, j]: j < i
    sup = (iou > iou_threshold) & earlier & valid[:, None, :] & valid[:, :, None]
    sup_f = sup.float()
    keep = valid
    for _ in range(p):
        suppressed = torch.bmm(sup_f, keep.float()[:, :, None])[:, :, 0] > 0
        new_keep = valid & ~suppressed
        if torch.equal(new_keep, keep):
            break
        keep = new_keep
    return keep


def _compact(top_boxes, top_scores, top_classes, top_idx, keep, max_detections: int):
    b = keep.shape[0]
    k = max_detections
    rank = torch.cumsum(keep.long(), dim=1) - 1
    dest = torch.where(keep & (rank < k), rank, torch.full_like(rank, k))  # k = dropped
    dev = keep.device

    def scatter(src, fill, shape_tail=()):
        out = torch.full((b, k + 1) + shape_tail, fill, dtype=src.dtype, device=dev)
        idx = dest.view(b, -1, *([1] * len(shape_tail))).expand(-1, -1, *shape_tail)
        return out.scatter_(1, idx, src)[:, :k]

    out_boxes = scatter(top_boxes, 0, (4,))
    out_scores = scatter(top_scores, 0)
    out_classes = scatter(top_classes.to(torch.int32), 0)
    out_indices = scatter(top_idx, 0)
    n_kept = keep.sum(dim=1, keepdim=True).clamp(max=k)
    out_valid = torch.arange(k, device=dev)[None, :] < n_kept
    return out_boxes, out_scores, out_classes, out_valid, out_indices


def batched_nms(
    boxes: torch.Tensor,    # (B, N, 4) xyxy
    scores: torch.Tensor,   # (B, N)
    classes: torch.Tensor,  # (B, N)
    iou_threshold: float = 0.5,
    score_threshold: float = 0.0,
    max_detections: int = 300,
    pre_nms_topk: int = 2048,
    class_agnostic: bool = False,
    class_offset: float = 8192.0,
    topk_method: str = "exact",
) -> NMSResult:
    if topk_method not in ("exact", "approx"):
        raise ValueError(f"unknown topk_method {topk_method!r}")
    p = min(pre_nms_topk, boxes.shape[1])
    top_scores, top_idx = torch.topk(scores, p, dim=1, sorted=True)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_classes = torch.gather(classes, 1, top_idx)
    valid = top_scores > score_threshold
    nms_boxes = top_boxes
    if not class_agnostic:
        nms_boxes = top_boxes + (top_classes.to(top_boxes.dtype) * class_offset)[..., None]
    nms_boxes = nms_boxes.float()
    keep = greedy_keep(box_iou_xyxy(nms_boxes, nms_boxes), valid, iou_threshold)
    return NMSResult(*_compact(top_boxes, top_scores, top_classes, top_idx, keep,
                               max_detections))
