"""Serve-fast decode and postprocess from the heads' raw fields, the JAX
package's ops/serve_decode.py in PyTorch.

The input is `DetectionNet(x, raw_fields=True)`: the anchors and, per
scale, the heads' 1x1 maps (NCHW, channel a * D + d) by field, or
BasicHead's one packed map. The fields are packed per anchor, decoded by
`models.detection.decode_scale` and flattened in the order (scale,
anchor, cell), as the JAX package orders its candidates, then go through
`ops.postprocess.postprocess_detections`: the same kept set as the net's
own decode, up to the order of equal scores. As there:

- the og-size rescale fires only when both dims differ;
- `box_allowance` adds to wh before xywh -> xyxy;
- NMS is class-agnostic greedy, into `max_detections` slots; the kept
  rows' mask coefficients are tanh'd and zeroed in the empty slots.

A keypoint head raises NotImplementedError, as in the JAX package; serve
keypoint nets through the decode and `postprocess_detections`.
"""
from typing import Any, Dict, Optional, Tuple

import torch

from ..models.detection import decode_scale, rescale_preds_to_size
from .postprocess import PostProcessResult, postprocess_detections


def _packed(fields: Dict[str, torch.Tensor], num_anchors: int, num_classes: int,
            num_masks: int) -> torch.Tensor:
    """One scale's fields -> (B, ny, nx, A, 5 + C + Km), the heads' packed
    layout [conf | cls | bbox | masks]."""
    a = num_anchors
    if "packed" in fields:  # BasicHead: anchor-major [conf | cls | bbox | masks | kp]
        p = fields["packed"]
        if p.shape[1] != a * (5 + num_classes + num_masks):
            raise NotImplementedError(
                f"packed head width {p.shape[1]} != A * (5 + C + Km) = "
                f"{a * (5 + num_classes + num_masks)}: keypoint heads are not served by the "
                "serve-fast decode")
        parts = [p]
    else:
        names = ("conf", "cls", "bbox") + (("masks",) if num_masks and "masks" in fields else ())
        parts = [fields[k] for k in names]
    b, _, ny, nx = parts[0].shape
    return torch.cat([t.permute(0, 2, 3, 1).reshape(b, ny, nx, a, -1) for t in parts], dim=-1)


@torch.no_grad()
def decode_and_postprocess(raw: Any, input_shape: Tuple[int, int], num_classes: int,
                           num_masks: int = 0, og_size: Optional[Tuple[int, int]] = None,
                           iou_threshold: float = 0.5, score_threshold: float = 0.1,
                           box_allowance: float = 0.0, max_detections: int = 300,
                           pre_nms_topk: int = 2048, topk_method: str = "exact"
                           ) -> PostProcessResult:
    """Decode, score, top-`pre_nms_topk`, class-agnostic greedy NMS and
    compaction of `DetectionNet(..., raw_fields=True)`'s output (the
    anchors and the per-scale fields; a SegmentationNet's without its
    protos). `input_shape` is the net's (H, W), `og_size` the (h, w) to
    rescale the boxes to.

    `topk_method="approx"` names `jax.lax.approx_max_k` in the JAX package,
    which is approximate only on a TPU (elsewhere it is the exact top-k);
    here both methods take the exact `torch.topk`.
    """
    if topk_method not in ("exact", "approx"):
        raise ValueError(f"unknown topk_method {topk_method!r}")
    anchors, per_scale = raw
    if any("keypoints" in fields for fields in per_scale):
        raise NotImplementedError(
            "the serve-fast decode does not carry keypoint fields; serve keypoint nets through "
            "models.detection.decode_scale and ops.postprocess.postprocess_detections")
    preds = []
    for key, fields in zip(("sm", "md", "lg"), per_scale):
        a = anchors[key].shape[0]
        pred = decode_scale(_packed(fields, a, num_classes, num_masks), anchors[key],
                            input_shape, num_classes, num_masks, inference=True)
        preds.append(pred.permute(0, 3, 1, 2, 4).flatten(1, 3))  # (B, A * HW, D), (a, hw)
    preds = torch.cat(preds, dim=1)
    h, w = input_shape
    if og_size is not None and og_size[0] != h and og_size[1] != w:
        preds = rescale_preds_to_size(preds, (w, h), (og_size[1], og_size[0]), num_classes)
    res = postprocess_detections(preds, num_classes, num_masks, iou_threshold=iou_threshold,
                                 score_threshold=score_threshold, box_allowance=box_allowance,
                                 max_detections=max_detections, pre_nms_topk=pre_nms_topk)
    return res._replace(mask_coefs=torch.where(res.valid[..., None], res.mask_coefs,
                                               torch.zeros((), device=preds.device)))
