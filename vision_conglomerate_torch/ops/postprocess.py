"""Detection and segmentation postprocessing on the device, the JAX
package's ops/postprocess.py in PyTorch.

- scores = sigmoid(conf) * max(sigmoid(cls));
- box_allowance adds to wh before the xywh -> xyxy conversion;
- NMS is per image and class-agnostic;
- keypoints of the kept rows are gathered like the boxes, as (x, y,
  argmax of the visibility logits);
- mask coefficients of the kept rows are gathered like the boxes, and
  `assemble_instance_masks` turns them into binary masks:
  sigmoid(protos . coefs), bilinear to the og size, > 0.5, optionally
  cropped to the box.
"""
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .boxes import xywh2xyxy
from .nms import batched_nms


class PostProcessResult(NamedTuple):
    boxes_xyxy: torch.Tensor   # (B, K, 4)
    scores: torch.Tensor       # (B, K)
    classes: torch.Tensor      # (B, K) int32 argmax class
    valid: torch.Tensor        # (B, K) bool
    keypoints: torch.Tensor    # (B, K, Kp, 3) [x, y, vis] or (B, K, 0, 3)
    mask_coefs: torch.Tensor   # (B, K, Km) or (B, K, 0)


def postprocess_detections(
    preds: torch.Tensor,  # (B, M, 5 + C + Km + 5 Kp) flattened inference-decoded preds
    num_classes: int,
    num_masks: int = 0,
    num_keypoints: int = 0,
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
    def take(t):
        return torch.gather(t, 1, nms.indices[..., None].expand(-1, -1, t.shape[-1]))

    kp_i = 5 + c + num_masks
    kp = take(preds[..., kp_i:kp_i + 5 * num_keypoints]).unflatten(-1, (num_keypoints, 5))
    kp = torch.cat([kp[..., :2], kp[..., 2:].argmax(dim=-1, keepdim=True).to(kp.dtype)], dim=-1)
    coefs = take(preds[..., 5 + c:kp_i])
    return PostProcessResult(nms.boxes, nms.scores, nms.classes, nms.valid, kp, coefs)


def assemble_instance_masks(
    protos: torch.Tensor,      # (B, Km, Hp, Wp) NCHW
    mask_coefs: torch.Tensor,  # (B, K, Km)
    og_size: Optional[Tuple[int, int]] = None,
    threshold: float = 0.5,
    boxes_xyxy: Optional[torch.Tensor] = None,  # (B, K, 4), same coords as output
) -> torch.Tensor:
    """(B, K, H, W) bool instance masks: sigmoid(protos . coefs) in f32,
    bilinear to og_size (half-pixel centres, antialiased when it shrinks,
    as jax.image.resize "linear"), then > threshold. `boxes_xyxy` zeroes
    each mask outside its box (inclusive edges), in the coordinates of the
    output. Only the rows passed are assembled, so a caller that passes the
    kept rows of one image pays for those alone."""
    logits = torch.einsum("bkhw,bnk->bnhw", protos.float(), mask_coefs.float())
    masks = torch.sigmoid(logits)
    if og_size is not None and tuple(og_size) != tuple(masks.shape[2:]):
        masks = F.interpolate(masks, size=(int(og_size[0]), int(og_size[1])), mode="bilinear",
                              align_corners=False, antialias=True)
    out = masks > threshold
    if boxes_xyxy is not None:
        out = out & in_box_grid(out.shape[2:], boxes_xyxy)
    return out


def in_box_grid(shape_hw, boxes_xyxy: torch.Tensor) -> torch.Tensor:
    """(B, N, H, W) bool grid, True inside each box with inclusive edges:
    the crop of serve mask assembly and of the seg eval harness."""
    h, w = int(shape_hw[0]), int(shape_hw[1])
    bx = boxes_xyxy.float()
    ys = torch.arange(h, dtype=torch.float32, device=bx.device)[None, None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=bx.device)[None, None, None, :]
    return ((xs >= bx[..., 0, None, None]) & (xs <= bx[..., 2, None, None])
            & (ys >= bx[..., 1, None, None]) & (ys <= bx[..., 3, None, None]))
