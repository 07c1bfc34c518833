"""mAP harness: a checkpoint (or a live train pipeline) and a YOLO-format
directory -> mAP@IoU, the JAX package's tools/eval_harness.py in PyTorch.

- `evaluate_checkpoint_map` rebuilds the net from a checkpoint manifest in
  the deploy form (`infer.runner.load_detection_model`: bf16 and both CUDA
  kernels on `cuda`, f32 and their plain versions on the CPU);
- `evaluate_pipeline_map` scores the live train-form net of a
  TrainDetectionPipeline (the train CLI's `--map_eval` hook) in eval mode,
  and puts it back in the mode it found it in;
- `evaluate_checkpoint_seg` scores a SegmentationNet checkpoint's masks
  (mask mAP, dataset dice) and boxes over a polygon-label directory.

A keypoint net (`num_keypoints`) is also scored by PCK@0.1
(`map_eval.compute_pck`): the ground-truth keypoints go from
bbox-relative back to input pixels.

Both checkpoint harnesses take `quantize="int8"` (deploy form only): the
first `batch_size` images of the directory, as uint8 / 255, calibrate the
int8 form (`infer.runner.quantize_model_int8`), as in the JAX package.

Per batch the uint8 images go to the device, are normalised there, and the
forward, decode and NMS run there; only the kept (<= max_detections) boxes
come back to the host, where `tools.map_eval` scores them. The JAX package
pads the last batch to one compiled shape and drops the padded rows; the
port needs no pad and scores the same images. Postprocess keeps
box_allowance 0 (the serve pad would shift IoU against tight ground-truth
boxes) and a low score threshold (mAP integrates the whole PR curve).
"""
import logging
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.postprocess import PostProcessResult, in_box_grid, postprocess_detections
from ..ops.preprocess import normalize_images
from ..utils.labels import xywh2xyxy_np
from .map_eval import _iou_matrix, compute_map, compute_pck

logger = logging.getLogger(__name__)

Forward = Callable[[np.ndarray], PostProcessResult]


def _collect_and_score(forward: Forward, dataset, batch_size: int, num_classes: int,
                       img_wh: Tuple[int, int], iou_threshold: float = 0.5,
                       num_keypoints: int = 0, pck_radius: float = 0.1) -> Dict[str, Any]:
    """Run `forward` over the dataset in order, pair each image's kept
    boxes with its ground truth (YOLO xywh scaled to img_wh pixels), and
    compute mAP, and PCK@pck_radius when num_keypoints > 0. forward:
    (B, H, W, 3) uint8 batch -> PostProcessResult."""
    w, h = img_wh
    scale = np.asarray([w, h, w, h], np.float32)
    predictions, ground_truths, pck_rows = [], [], []
    n = len(dataset)
    for lo in range(0, n, batch_size):
        imgs, labels, mask = dataset.collate_fn(
            [dataset[i] for i in range(lo, min(lo + batch_size, n))])
        post = forward(imgs)
        boxes = post.boxes_xyxy.float().cpu().numpy()
        scores = post.scores.float().cpu().numpy()
        classes = post.classes.cpu().numpy()
        valid = post.valid.cpu().numpy()
        kps = post.keypoints.float().cpu().numpy()
        for k in range(imgs.shape[0]):
            v = valid[k]
            predictions.append((boxes[k][v], scores[k][v], classes[k][v]))
            lab = labels[k][mask[k]]
            gt_xyxy = xywh2xyxy_np(lab[:, 1:5]) * scale
            gt_cls = lab[:, 0].astype(np.int64)
            ground_truths.append((gt_xyxy, gt_cls))
            if num_keypoints:
                gkp = lab[:, 5:].reshape(-1, num_keypoints, 3).copy()
                span = gt_xyxy[:, None, 2:] - gt_xyxy[:, None, :2]
                gkp[..., :2] = gt_xyxy[:, None, :2] + gkp[..., :2] * span
                gt_wh = np.stack([gt_xyxy[:, 2] - gt_xyxy[:, 0],
                                  gt_xyxy[:, 3] - gt_xyxy[:, 1]], axis=1)
                pck_rows.append((_iou_matrix(boxes[k][v], gt_xyxy), scores[k][v],
                                 classes[k][v], gt_cls, kps[k][v], gkp, gt_wh))
    result = compute_map(predictions, ground_truths, num_classes, iou_threshold=iou_threshold)
    result["num_images"] = n
    if num_keypoints:
        result.update(compute_pck(pck_rows, r=pck_radius, iou_threshold=iou_threshold))
        result["pck_radius"] = pck_radius
    return result


def _calibrate_int8(model: torch.nn.Module, dataset, batch_size: int) -> None:
    """int8 PTQ on the dataset's first `batch_size` images (uint8 / 255)."""
    from ..infer.runner import quantize_model_int8

    batch = dataset.collate_fn([dataset[i] for i in range(min(batch_size, len(dataset)))])
    x = normalize_images(torch.from_numpy(batch[0]).to(model.sm_anchors.device))
    quantize_model_int8(model, x.permute(0, 3, 1, 2), inference=True)


def _make_postprocess_forward(model: torch.nn.Module, num_classes: int,
                              iou_threshold_nms: float = 0.35, score_threshold: float = 0.001,
                              max_detections: int = 300, num_keypoints: int = 0) -> Forward:
    """uint8 NHWC numpy batch -> on the model's device: /255, forward,
    decode, NMS with box_allowance 0. The model's mode is the caller's."""
    dev = model.sm_anchors.device

    @torch.no_grad()
    def forward(imgs: np.ndarray) -> PostProcessResult:
        x = normalize_images(torch.from_numpy(imgs).to(dev))
        preds = model(x.permute(0, 3, 1, 2), inference=True)
        return postprocess_detections(
            preds, num_classes=num_classes, num_keypoints=num_keypoints,
            iou_threshold=iou_threshold_nms, score_threshold=score_threshold, box_allowance=0.0,
            max_detections=max_detections)

    return forward


def evaluate_checkpoint_map(
    weights_path: str,
    config: Dict[str, Any],
    data_dir: str,
    batch_size: int = 16,
    iou_threshold: float = 0.5,
    nms_iou_threshold: float = 0.35,
    score_threshold: float = 0.001,
    max_detections: int = 300,
    use_reparam: bool = True,
    max_labels: int = 64,
    quantize: Optional[str] = None,
    device=None,
) -> Dict[str, Any]:
    """Checkpoint + YOLO-format directory -> {"map", "ap_per_class",
    "num_gt_per_class", "num_images"}, and for a keypoint net {"pck",
    "pck_matched", "num_visible_keypoints", "num_matched_keypoints",
    "pck_radius"}. `device` None means cuda."""
    from ..data.detection import DetectionDataset
    from ..infer.runner import check_quantize, load_detection_model

    int8 = check_quantize(quantize, use_reparam)
    model_config = config["model_config"]
    tc = config["train_config"]
    img_wh = tuple(tc["img_config"]["img_wh"])
    dataset = DetectionDataset(data_dir, img_ext=tc["img_config"]["img_ext"], img_wh=img_wh,
                               max_labels=max_labels)
    num_keypoints = model_config.get("num_keypoints") or 0
    model, num_classes = load_detection_model(
        weights_path, model_config, num_keypoints=num_keypoints or None,
        use_reparam=use_reparam, device=device, quantize=quantize)
    if int8:
        _calibrate_int8(model, dataset, batch_size)
    forward = _make_postprocess_forward(
        model, num_classes, iou_threshold_nms=nms_iou_threshold,
        score_threshold=score_threshold, max_detections=max_detections,
        num_keypoints=num_keypoints)
    return _collect_and_score(forward, dataset, batch_size, num_classes, img_wh, iou_threshold,
                              num_keypoints=num_keypoints)


def evaluate_checkpoint_seg(
    weights_path: str,
    config: Dict[str, Any],
    data_dir: str,
    batch_size: int = 8,
    iou_threshold: float = 0.5,
    nms_iou_threshold: float = 0.35,
    score_threshold: float = 0.001,
    max_detections: int = 100,
    use_reparam: bool = True,
    max_labels: int = 64,
    quantize: Optional[str] = None,
    crop_masks: bool = False,
    device=None,
) -> Dict[str, Any]:
    """Segmentation checkpoint + polygon-label directory -> mask metrics:
    {"mask_map", "mask_ap_per_class", "num_gt_per_class", "box_map",
    "num_images", "dice", "dice_matched", "recall", "num_gt",
    "num_matched"}. `device` None means cuda.

    Per batch, on the device: the forward (deploy form unless
    `use_reparam=False`), decode, NMS (box_allowance 0), the kept rows'
    masks at the protos' size (sigmoid(protos . coefs) > 0.5, optionally
    zeroed outside the box scaled by 1/4 with `crop_masks`), the ground
    truth instance masks from the overlap-indexed target (slot m is id
    m + 1, stored at img_wh // 4 and nearest-resized, half-pixel, if the
    protos differ), and the pairwise intersections and areas. Only the
    (K, M) matrices come to the host, where mask mAP (the box-mAP
    machinery on mask IoU), `greedy_dice` and box mAP over the same run
    are computed."""
    from ..data.segmentation import SegmentationDataset
    from ..device import resolve_device
    from ..infer.runner import check_quantize, load_detection_model
    from .map_eval import compute_map_from_iou, greedy_dice

    device = resolve_device(device)
    int8 = check_quantize(quantize, use_reparam)
    model_config = config["model_config"]
    tc = config["train_config"]
    img_wh = tuple(tc["img_config"]["img_wh"])
    dataset = SegmentationDataset(data_dir, img_ext=tc["img_config"]["img_ext"], img_wh=img_wh,
                                  max_labels=max_labels, overlap_masks=True,
                                  mask_store_wh=(img_wh[0] // 4, img_wh[1] // 4))
    model, num_classes = load_detection_model(weights_path, model_config, task="segmentation",
                                              use_reparam=use_reparam, device=device,
                                              quantize=quantize)
    if int8:
        _calibrate_int8(model, dataset, batch_size)
    dev = model.sm_anchors.device

    @torch.no_grad()
    def forward(imgs: np.ndarray, gt_overlap: np.ndarray):
        x = normalize_images(torch.from_numpy(imgs).to(dev))
        preds, protos = model(x.permute(0, 3, 1, 2), inference=True)
        post = postprocess_detections(
            preds, num_classes=num_classes, num_masks=model.num_masks,
            iou_threshold=nms_iou_threshold, score_threshold=score_threshold,
            box_allowance=0.0, max_detections=max_detections)
        logits = torch.einsum("bkhw,bnk->bnhw", protos.float(), post.mask_coefs)
        pm = (torch.sigmoid(logits) > 0.5).float()
        if crop_masks:
            pm = pm * in_box_grid(pm.shape[2:], post.boxes_xyxy / 4.0).float()
        gt = torch.from_numpy(gt_overlap).to(dev).float()
        if tuple(gt.shape[1:]) != tuple(protos.shape[2:]):
            gt = F.interpolate(gt[:, None], size=protos.shape[2:], mode="nearest-exact")[:, 0]
        ids = torch.arange(1, max_labels + 1, dtype=torch.float32, device=dev)
        gm = (gt[:, None] == ids[None, :, None, None]).float()
        inter = torch.einsum("bnhw,bmhw->bnm", pm, gm)
        return post, inter, pm.sum(dim=(2, 3)), gm.sum(dim=(2, 3))

    w, h = img_wh
    scale = np.asarray([w, h, w, h], np.float32)
    per_image_mask, per_image_dice, box_pred, box_gt = [], [], [], []
    n = len(dataset)
    for lo in range(0, n, batch_size):
        imgs, labels, vmask, tmasks = dataset.collate_fn(
            [dataset[i] for i in range(lo, min(lo + batch_size, n))])
        post, inter, parea, garea = forward(imgs, tmasks)
        boxes = post.boxes_xyxy.float().cpu().numpy()
        scores = post.scores.float().cpu().numpy()
        classes = post.classes.cpu().numpy()
        valid = post.valid.cpu().numpy()
        inter, parea, garea = (t.cpu().numpy() for t in (inter, parea, garea))
        for k in range(imgs.shape[0]):
            v = valid[k]
            gv = vmask[k] & (garea[k] > 0)
            gt_classes = labels[k][gv][:, 0].astype(np.int64)
            it = inter[k][v][:, gv]
            pa, ga = parea[k][v], garea[k][gv]
            iou = it / np.maximum(pa[:, None] + ga[None, :] - it, 1e-9)
            dice = 2.0 * it / np.maximum(pa[:, None] + ga[None, :], 1e-9)
            per_image_mask.append((iou, scores[k][v], classes[k][v], gt_classes))
            per_image_dice.append((iou, dice, scores[k][v], classes[k][v], gt_classes))
            lab = labels[k][vmask[k]]
            box_pred.append((boxes[k][v], scores[k][v], classes[k][v]))
            box_gt.append((xywh2xyxy_np(lab[:, 1:5]) * scale, lab[:, 0].astype(np.int64)))
    mask_map = compute_map_from_iou(per_image_mask, num_classes, iou_threshold)
    box_map = compute_map(box_pred, box_gt, num_classes, iou_threshold=iou_threshold)
    return {
        "mask_map": mask_map["map"],
        "mask_ap_per_class": mask_map["ap_per_class"],
        "num_gt_per_class": mask_map["num_gt_per_class"],
        "box_map": box_map["map"],
        "num_images": n,
        **greedy_dice(per_image_dice, iou_threshold=0.5),
    }


def evaluate_pipeline_map(
    pipeline,
    dataset,
    batch_size: int = 16,
    iou_threshold: float = 0.5,
    nms_iou_threshold: float = 0.35,
    score_threshold: float = 0.001,
    max_detections: int = 300,
) -> Dict[str, Any]:
    """mAP of a live TrainDetectionPipeline's current (train-form) net. The
    net runs in eval mode (BatchNorm normalises with its running statistics
    and leaves them as they are) and returns to its former mode after."""
    model = pipeline.model
    was_training = model.training
    model.eval()
    try:
        num_keypoints = model.num_keypoints or 0
        forward = _make_postprocess_forward(
            model, model.num_classes, iou_threshold_nms=nms_iou_threshold,
            score_threshold=score_threshold, max_detections=max_detections,
            num_keypoints=num_keypoints)
        return _collect_and_score(forward, dataset, batch_size, model.num_classes,
                                  tuple(dataset.img_wh), iou_threshold,
                                  num_keypoints=num_keypoints)
    finally:
        model.train(was_training)
