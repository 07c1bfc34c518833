"""Detection mAP CLI of the port, with the flags of the JAX package's
eval_det.py plus `--device` (default `cuda`).

    python -m vision_conglomerate_torch.eval_det \\
        --weights_path saved_model/detection/best_model/DetectionNet.ckpt.tar \\
        --data_dir data/detection/valid [--config_path .../config.yaml] [--iou 0.5]

It serves the checkpoint in the deploy form over a YOLO-format directory
(`tools.eval_harness.evaluate_checkpoint_map`) and prints the JAX CLI's one
JSON line, with the same keys and rounding:
{"map50": ..., "iou_threshold": ..., "ap_per_class": [...], ...}; a
keypoint checkpoint adds "pck10", "pck_matched" and "num_visible_keypoints"
after "iou_threshold". `--quantize int8` scores the int8 serving form, calibrated on the first
batch of the directory.
"""
import argparse
import json
import logging
import os
from pathlib import Path

import numpy as np

LOG_FORMAT = "%(asctime)s %(levelname)s %(filename)s: %(message)s"
LOG_DATE_FORMAT = "%Y-%m-%d %H:%M:%S"


def run(args) -> dict:
    from .tools.eval_harness import evaluate_checkpoint_map
    from .utils import load_yaml

    config_path = args.config_path or os.path.join(
        Path(args.weights_path).parent.resolve(), "config", "config.yaml")
    result = evaluate_checkpoint_map(
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
        device=args.device,
    )
    out = {
        f"map{int(round(args.iou * 100))}": round(result["map"], 5),
        "iou_threshold": args.iou,
        **({f"pck{int(round(result['pck_radius'] * 100))}": round(result["pck"], 5),
            "pck_matched": round(result["pck_matched"], 5),
            "num_visible_keypoints": result["num_visible_keypoints"]}
           if "pck" in result else {}),
        "ap_per_class": [None if np.isnan(v) else round(float(v), 5)
                         for v in result["ap_per_class"]],
        "num_gt_per_class": [int(v) for v in result["num_gt_per_class"]],
        "num_images": result["num_images"],
        "weights": args.weights_path,
        "data_dir": args.data_dir,
        "quantize": args.quantize,
    }
    print(json.dumps(out))
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Detection mAP evaluation")
    parser.add_argument("--weights_path", type=str,
                        default="saved_model/detection/best_model/DetectionNet.ckpt.tar",
                        metavar="", help="checkpoint manifest path")
    parser.add_argument("--data_dir", type=str, default="data/detection/valid",
                        metavar="", help="YOLO-format directory (images + txt labels)")
    parser.add_argument("--config_path", type=str, default="", metavar="",
                        help="config YAML (default: <weights dir>/config/config.yaml)")
    parser.add_argument("--batch_size", type=int, default=16, metavar="")
    parser.add_argument("--iou", type=float, default=0.5, metavar="",
                        help="mAP matching IoU threshold")
    parser.add_argument("--nms_iou_threshold", type=float, default=0.35, metavar="")
    parser.add_argument("--score_threshold", type=float, default=0.001, metavar="",
                        help="low by design: mAP integrates the full PR curve")
    parser.add_argument("--max_detections", type=int, default=300, metavar="")
    parser.add_argument("--max_labels", type=int, default=64, metavar="")
    parser.add_argument("--no_reparam", action="store_true",
                        help="Evaluate the train-form (multi-branch) network")
    parser.add_argument("--quantize", type=str, default="none", choices=["none", "int8"], metavar="",
                        help="Evaluate the int8 serving form (calibrated on the first batch)")
    parser.add_argument("--device", type=str, default="cuda", metavar="",
                        help="device to evaluate on (cuda or cpu)")
    return parser


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO, format=LOG_FORMAT, datefmt=LOG_DATE_FORMAT)
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
