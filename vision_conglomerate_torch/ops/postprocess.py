"""Detection postprocessing on the device, the JAX package's
ops/postprocess.postprocess_detections in PyTorch.

- scores = sigmoid(conf) * max(sigmoid(cls));
- box_allowance adds to wh before the xywh -> xyxy conversion;
- NMS is per image and class-agnostic.
Keypoints (ROADMAP §A.13) and mask coefficients (§A.11) are not in the
port yet.
"""
from typing import NamedTuple

import torch

from .boxes import xywh2xyxy
from .nms import batched_nms


class PostProcessResult(NamedTuple):
    boxes_xyxy: torch.Tensor   # (B, K, 4)
    scores: torch.Tensor       # (B, K)
    classes: torch.Tensor      # (B, K) int32 argmax class
    valid: torch.Tensor        # (B, K) bool


def postprocess_detections(
    preds: torch.Tensor,  # (B, M, 5 + C) flattened inference-decoded preds
    num_classes: int,
    iou_threshold: float = 0.5,
    score_threshold: float = 0.1,
    box_allowance: float = 0.0,
    max_detections: int = 300,
    pre_nms_topk: int = 2048,
    topk_method: str = "exact",
) -> PostProcessResult:
    preds = preds.float()
    c = num_classes
    conf = torch.sigmoid(preds[..., 0])
    cls_probs = torch.sigmoid(preds[..., 1:1 + c])
    cls_max, classes = cls_probs.max(dim=-1)
    scores = cls_max * conf
    classes = classes.to(torch.int32)
    xywh = preds[..., 1 + c:5 + c]
    if box_allowance:
        xywh = torch.cat([xywh[..., :2], xywh[..., 2:4] + box_allowance], dim=-1)
    xyxy = xywh2xyxy(xywh)
    nms = batched_nms(
        xyxy, scores, classes,
        iou_threshold=iou_threshold,
        score_threshold=score_threshold,
        max_detections=max_detections,
        pre_nms_topk=pre_nms_topk,
        class_agnostic=True,
        topk_method=topk_method,
    )
    return PostProcessResult(nms.boxes, nms.scores, nms.classes, nms.valid)
