"""Segmentation mask-metric CLI of the port, with the flags of the JAX
package's eval_seg.py plus `--device` (default `cuda`).

    python -m vision_conglomerate_torch.eval_seg \\
        --weights_path saved_model/segmentation/best_model/SegmentationNet.ckpt.tar \\
        --data_dir data/segmentation/valid [--config_path .../config.yaml] [--crop_masks]

It serves the checkpoint in the deploy form over a polygon-label directory
(`tools.eval_harness.evaluate_checkpoint_seg`) and prints the JAX CLI's one
JSON line, with the same keys and rounding: mask mAP at --iou, dataset
dice, matched dice, mask recall and box mAP from the same run.
`--quantize int8` scores the int8 serving form, calibrated on the first
batch of the directory.
"""
import argparse
import json
import logging
import os
from pathlib import Path

import numpy as np

from .eval_det import LOG_DATE_FORMAT, LOG_FORMAT


def run(args) -> dict:
    from .tools.eval_harness import evaluate_checkpoint_seg
    from .utils import load_yaml

    config_path = args.config_path or os.path.join(
        Path(args.weights_path).parent.resolve(), "config", "config.yaml")
    result = evaluate_checkpoint_seg(
        args.weights_path,
        load_yaml(config_path),
        args.data_dir,
        batch_size=args.batch_size,
        iou_threshold=args.iou,
        nms_iou_threshold=args.nms_iou_threshold,
        score_threshold=args.score_threshold,
        max_detections=args.max_detections,
        use_reparam=not args.no_reparam,
        max_labels=args.max_labels,
        quantize=args.quantize if args.quantize != "none" else None,
        crop_masks=args.crop_masks,
        device=args.device,
    )
    iou = int(round(args.iou * 100))
    out = {
        f"mask_map{iou}": round(result["mask_map"], 5),
        "dice": round(result["dice"], 5),
        "dice_matched": round(result["dice_matched"], 5),
        "mask_recall50": round(result["recall"], 5),
        f"box_map{iou}": round(result["box_map"], 5),
        "iou_threshold": args.iou,
        "mask_ap_per_class": [None if np.isnan(v) else round(float(v), 5)
                              for v in result["mask_ap_per_class"]],
        "num_gt_per_class": [int(v) for v in result["num_gt_per_class"]],
        "num_images": result["num_images"],
        "weights": args.weights_path,
        "data_dir": args.data_dir,
        "quantize": args.quantize,
        "crop_masks": args.crop_masks,
    }
    print(json.dumps(out))
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Segmentation mask mAP + dice evaluation")
    parser.add_argument("--weights_path", type=str,
                        default="saved_model/segmentation/best_model/SegmentationNet.ckpt.tar",
                        metavar="", help="checkpoint manifest path")
    parser.add_argument("--data_dir", type=str, default="data/segmentation/valid",
                        metavar="", help="directory with images + polygon-label txts")
    parser.add_argument("--config_path", type=str, default="", metavar="",
                        help="config YAML (default: <weights dir>/config/config.yaml)")
    parser.add_argument("--batch_size", type=int, default=8, metavar="")
    parser.add_argument("--iou", type=float, default=0.5, metavar="",
                        help="mAP matching IoU threshold (mask IoU)")
    parser.add_argument("--nms_iou_threshold", type=float, default=0.35, metavar="")
    parser.add_argument("--score_threshold", type=float, default=0.001, metavar="",
                        help="low by design: mAP integrates the full PR curve")
    parser.add_argument("--max_detections", type=int, default=100, metavar="",
                        help="capped lower than eval_det: each kept det assembles a mask")
    parser.add_argument("--max_labels", type=int, default=64, metavar="")
    parser.add_argument("--no_reparam", action="store_true",
                        help="Evaluate the train-form (multi-branch) network")
    parser.add_argument("--quantize", type=str, default="none", choices=["none", "int8"], metavar="",
                        help="Evaluate the int8 serving form (calibrated on the first batch)")
    parser.add_argument("--crop_masks", action="store_true",
                        help="Crop assembled masks to their predicted boxes before scoring")
    parser.add_argument("--device", type=str, default="cuda", metavar="",
                        help="device to evaluate on (cuda or cpu)")
    return parser


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO, format=LOG_FORMAT, datefmt=LOG_DATE_FORMAT)
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
