"""Detection inference CLI of the port, with the flags of the JAX package's
inference_det.py; `--device` defaults to `cuda`.

    python -m vision_conglomerate_torch.inference_det --path imgs/ --with_summary
    python -m vision_conglomerate_torch.inference_det --path clip.mp4 --with_summary \
        --fps 30 --frame_skips 1 --tracked_classes 0,2

As in the JAX package's CLI, the config is
saved_model/detection/best_model/config/config.yaml and the weights default
to DetectionNet.ckpt.tar in saved_model/detection/best_model/. A video
(.mp4/.avi/.mkv) is tracked with ByteTrack and written as video.mp4 at
`--fps`, keeping every (frame_skips + 1)-th frame. `--quantize int8` serves
the int8 post-training-quantized deploy form, calibrated on the first batch
of the input (on the card its int8 convs run on the s8 kernels).
"""
import argparse
import logging
import os
from pathlib import Path

LOG_FORMAT = "%(asctime)s %(levelname)s %(filename)s: %(message)s"
LOG_DATE_FORMAT = "%Y-%m-%d %H:%M:%S"
BEST_MODEL_PATH = "saved_model/detection/best_model/DetectionNet.ckpt.tar"


def build_parser(default_weights: str = BEST_MODEL_PATH) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Detection Inference")
    parser.add_argument("--path", type=str, metavar="", help="input path (image, folder of images or video)")
    parser.add_argument("--batch_size", type=int, default=32, metavar="", help="Inference batch size")
    parser.add_argument("--weights_path", type=str, default=default_weights, metavar="", help="saved model path")
    parser.add_argument("--dl_workers", type=int, default=0, metavar="", help="Number of dataloader workers")
    parser.add_argument("--device", type=str, default="cuda", metavar="", help="device to run inference on (cuda or cpu)")
    parser.add_argument("--fps", type=int, default=30, metavar="", help="Number of frames per second for video")
    parser.add_argument("--iou_threshold", type=float, default=0.35, metavar="", help="IOU threshold for NMS")
    parser.add_argument("--score_threshold", type=float, default=0.3, metavar="", help="Confidence score threshold")
    parser.add_argument("--with_summary", action="store_true", help="Store output with csv summary of detection")
    parser.add_argument("--tracked_classes", type=str, default="", metavar="", help="class indexes to track")
    parser.add_argument("--frame_skips", type=int, default=0, metavar="", help="Number of frames to skip (only applicable to video stream)")
    parser.add_argument("--box_allowance", type=int, default=4, metavar="", help="Bounding box width and height allowance")
    parser.add_argument("--save_og_size", dest="save_og_size", action="store_true",
                        help="Render outputs at original image size (default)")
    parser.add_argument("--no_save_og_size", dest="save_og_size", action="store_false",
                        help="Render outputs at network resolution instead of original size")
    parser.set_defaults(save_og_size=True)
    parser.add_argument("--no_reparam", action="store_true", help="Serve the train-form (multi-branch RepVGG) network")
    parser.add_argument("--quantize", type=str, default="none", choices=["none", "int8"], metavar="",
                        help="Post-training quantization of the deploy-form convs, calibrated on the first batch")
    parser.add_argument("--out_ext", type=str, default="png", choices=["png", "jpg", "jpeg"], metavar="",
                        help="Annotated-image output format")
    return parser


def run(args, config_path: str, task: str = "detection") -> str:
    from .infer.runner import run_detection_inference
    from .utils import load_yaml

    tracked = [int(i) for i in args.tracked_classes.split(",") if i != ""] or None
    return run_detection_inference(
        path=args.path,
        weights_path=args.weights_path,
        config=load_yaml(config_path),
        task=task,
        batch_size=args.batch_size,
        iou_threshold=args.iou_threshold,
        score_threshold=args.score_threshold,
        fps=args.fps,
        with_summary=args.with_summary,
        tracked_classes=tracked,
        frame_skips=args.frame_skips,
        box_allowance=args.box_allowance,
        save_og_size=args.save_og_size,
        use_reparam=not args.no_reparam,
        quantize=None if args.quantize == "none" else args.quantize,
        crop_masks=getattr(args, "crop_masks", False),
        out_ext=args.out_ext,
        device=args.device,
    )


def main(argv=None) -> str:
    logging.basicConfig(level=logging.INFO, format=LOG_FORMAT, datefmt=LOG_DATE_FORMAT)
    args = build_parser().parse_args(argv)
    config_path = os.path.join(Path(BEST_MODEL_PATH).parent.resolve(), "config", "config.yaml")
    return run(args, config_path)


if __name__ == "__main__":
    main()
