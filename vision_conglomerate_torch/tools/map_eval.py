"""mAP at one IoU threshold (host-side numpy), the JAX package's
tools/map_eval.py kept as the port's own copy.

Standard all-point-interpolated average precision per class (PASCAL VOC
2010 / COCO style at a single IoU threshold), macro-averaged over the
classes that have ground truth. Inputs are per-image detections (the
postprocess_detections outputs, on the host) and ground truths.

`greedy_dice` is the segmentation harness's dataset dice, `compute_pck`
the keypoint harness's PCK@r.
"""
from typing import Dict, Sequence, Tuple

import numpy as np


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    inter = np.prod(np.clip(br - tl, 0, None), axis=2)
    area_a = np.prod(np.clip(a[:, 2:4] - a[:, :2], 0, None), axis=1)
    area_b = np.prod(np.clip(b[:, 2:4] - b[:, :2], 0, None), axis=1)
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-9)


def average_precision(recall: np.ndarray, precision: np.ndarray) -> float:
    """All-point interpolated AP: area under the monotone precision envelope."""
    r = np.concatenate([[0.0], recall, [1.0]])
    p = np.concatenate([[0.0], precision, [0.0]])
    # monotone non-increasing envelope
    for i in range(len(p) - 2, -1, -1):
        p[i] = max(p[i], p[i + 1])
    idx = np.where(r[1:] != r[:-1])[0]
    return float(np.sum((r[idx + 1] - r[idx]) * p[idx + 1]))


def compute_map_from_iou(
    per_image: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]],
    num_classes: int,
    iou_threshold: float = 0.5,
) -> Dict[str, object]:
    """mAP at one IoU threshold from precomputed pred-vs-GT IoU matrices.

    per_image: (iou (n,m), scores (n,), pred_classes (n,), gt_classes (m,))
    tuples. Per class, detections of all images are taken in descending
    score order; each is a true positive when its best-IoU ground truth of
    that class reaches the threshold and is not matched yet.
    Returns {"map": float, "ap_per_class": (C,), "num_gt_per_class": (C,)};
    classes without ground truth have AP NaN and stay out of the mean.
    """
    aps = np.full(num_classes, np.nan)
    n_gt_per_class = np.zeros(num_classes, int)

    for c in range(num_classes):
        rows = []  # (score, img_idx, det_idx_within_image_class)
        gt_count = 0
        iou_by_img = []
        score_by_img = []
        for iou, ps, pc, gc in per_image:
            sel_p = np.asarray(pc) == c
            sel_g = np.asarray(gc) == c
            iou_by_img.append(np.asarray(iou)[sel_p][:, sel_g])
            score_by_img.append(np.asarray(ps)[sel_p])
            gt_count += int(sel_g.sum())
        n_gt_per_class[c] = gt_count
        if gt_count == 0:
            continue

        for i, scores in enumerate(score_by_img):
            for j in range(len(scores)):
                rows.append((float(scores[j]), i, j))
        rows.sort(key=lambda r: -r[0])

        matched = [np.zeros(m.shape[1], bool) for m in iou_by_img]
        tp = np.zeros(len(rows))
        fp = np.zeros(len(rows))
        for k, (_, i, j) in enumerate(rows):
            ious = iou_by_img[i][j]
            if ious.size == 0:
                fp[k] = 1
                continue
            best = int(np.argmax(ious))
            if ious[best] >= iou_threshold and not matched[i][best]:
                matched[i][best] = True
                tp[k] = 1
            else:
                fp[k] = 1
        ctp = np.cumsum(tp)
        cfp = np.cumsum(fp)
        recall = ctp / gt_count
        precision = ctp / np.maximum(ctp + cfp, 1e-9)
        aps[c] = average_precision(recall, precision)

    present = ~np.isnan(aps)
    return {
        "map": float(np.nanmean(aps)) if present.any() else 0.0,
        "ap_per_class": aps,
        "num_gt_per_class": n_gt_per_class,
    }


def compute_map(
    predictions: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    ground_truths: Sequence[Tuple[np.ndarray, np.ndarray]],
    num_classes: int,
    iou_threshold: float = 0.5,
) -> Dict[str, object]:
    """mAP at one IoU threshold (box IoU).

    predictions: per image (boxes_xyxy (n,4), scores (n,), classes (n,))
    ground_truths: per image (boxes_xyxy (m,4), classes (m,))
    Returns {"map": float, "ap_per_class": (C,), "num_gt_per_class": (C,)}.
    """
    if len(predictions) != len(ground_truths):
        raise ValueError(f"{len(predictions)} predictions for {len(ground_truths)} "
                         "ground truths")
    per_image = [
        (_iou_matrix(np.asarray(pb), np.asarray(gb)), ps, pc, gc)
        for (pb, ps, pc), (gb, gc) in zip(predictions, ground_truths)]
    return compute_map_from_iou(per_image, num_classes, iou_threshold)


def greedy_dice(
    per_image: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]],
    iou_threshold: float = 0.5,
) -> Dict[str, float]:
    """Dataset-level instance dice of the seg harness.

    per_image: (iou (n, m), dice (n, m), scores (n,), pred_classes (n,),
    gt_classes (m,)). Per image, predictions in descending score order take
    the same-class ground-truth instance of highest mask IoU not yet taken,
    when that IoU is >= iou_threshold. Returns `dice` (mean over ALL ground
    truth, an unmatched one counting 0), `dice_matched` (mean over matched
    pairs), `recall` (matched fraction), `num_gt` and `num_matched`.
    """
    total_gt = 0
    matched_dice_sum = 0.0
    n_matched = 0
    for iou, dice, scores, pc, gc in per_image:
        m = len(gc)
        total_gt += m
        if m == 0 or len(scores) == 0:
            continue
        order = np.argsort(-np.asarray(scores))
        taken = np.zeros(m, bool)
        for j in order:
            cand = np.where((np.asarray(gc) == pc[j]) & ~taken)[0]
            if cand.size == 0:
                continue
            best = cand[np.argmax(iou[j, cand])]
            if iou[j, best] >= iou_threshold:
                taken[best] = True
                matched_dice_sum += float(dice[j, best])
                n_matched += 1
    return {
        "dice": matched_dice_sum / max(total_gt, 1),
        "dice_matched": matched_dice_sum / max(n_matched, 1),
        "recall": n_matched / max(total_gt, 1),
        "num_gt": total_gt,
        "num_matched": n_matched,
    }


def compute_map50(predictions, ground_truths, num_classes: int):
    return compute_map(predictions, ground_truths, num_classes, iou_threshold=0.5)


def compute_pck(
    per_image: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray, np.ndarray, np.ndarray]],
    r: float = 0.1,
    iou_threshold: float = 0.5,
) -> Dict[str, float]:
    """PCK@r keypoint accuracy.

    per_image: (box_iou (n, m), scores (n,), pred_classes (n,),
    gt_classes (m,), pred_kp (n, Kp, 3) [x, y, vis] pixels,
    gt_kp (m, Kp, 3) [x, y, vis] pixels, gt_wh (m, 2) pixels).

    Predictions are greedily matched to same-class ground-truth boxes by
    score at box IoU >= iou_threshold (each ground truth once). A visible
    ground-truth keypoint (vis > 0 and finite: padded slots are +inf) of a
    matched instance is correct when the predicted one lies within
    r * max(gt box w, h) of it.
      pck          - correct / all visible ground-truth keypoints (a missed
                     instance counts all its keypoints as wrong);
      pck_matched  - correct / visible keypoints of matched instances.
    """
    total_vis = 0
    matched_vis = 0
    correct = 0

    def _visible(kp):
        kp = np.asarray(kp)
        return (kp[..., 2] > 0) & np.isfinite(kp).all(axis=-1)

    for iou, scores, pc, gc, pkp, gkp, gwh in per_image:
        m = len(gc)
        total_vis += int(_visible(gkp).sum()) if m else 0
        if m == 0 or len(scores) == 0:
            continue
        order = np.argsort(-np.asarray(scores))
        taken = np.zeros(m, bool)
        for j in order:
            cand = np.where((np.asarray(gc) == pc[j]) & ~taken)[0]
            if cand.size == 0:
                continue
            best = cand[np.argmax(iou[j, cand])]
            if iou[j, best] < iou_threshold:
                continue
            taken[best] = True
            vis = _visible(gkp[best])
            matched_vis += int(vis.sum())
            if not vis.any():
                continue
            thresh = r * float(max(gwh[best][0], gwh[best][1]))
            d = np.hypot(pkp[j][:, 0] - gkp[best][:, 0], pkp[j][:, 1] - gkp[best][:, 1])
            correct += int((d[vis] <= thresh).sum())
    return {
        "pck": correct / max(total_vis, 1),
        "pck_matched": correct / max(matched_vis, 1),
        "num_visible_keypoints": total_vis,
        "num_matched_keypoints": matched_vis,
    }
