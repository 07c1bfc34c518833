"""TrackNet inference CLI of the port, with the flags of the JAX package's
inference_tracknet.py; `--device` defaults to `cuda`.

    python -m vision_conglomerate_torch.inference_tracknet --path clip.mp4 --with_summary
    python -m vision_conglomerate_torch.inference_tracknet --path frames/ --img_ext jpg

As in the JAX package's CLI, the config is
saved_model/tracknet/best_model/config/config.yaml and the weights default
to TrackNet.ckpt.tar beside it. It writes outputs/tracknet/<datetime>/
video.mp4 with the ball's fading trace and, with --with_summary,
output.csv [frame, x, y, r]. `--dl_workers` is accepted and unused, as in
the JAX CLI. `--quantize int8` serves the int8 post-training-quantized
deploy form, calibrated on the first batch of stacked frames.
"""
import argparse
import logging
import os
from pathlib import Path

from .train_det import LOG_DATE_FORMAT, LOG_FORMAT

BEST_MODEL_PATH = "saved_model/tracknet/best_model/TrackNet.ckpt.tar"


def run(args, config_path: str) -> str:
    from .infer.tracknet_runner import run_tracknet_inference
    from .utils import load_yaml

    return run_tracknet_inference(
        path=args.path,
        weights_path=args.weights_path,
        config=load_yaml(config_path),
        batch_size=args.batch_size,
        fps=args.fps,
        img_ext=args.img_ext,
        frame_skips=args.frame_skips,
        with_summary=args.with_summary,
        max_num_trace=args.max_num_trace,
        max_circle_thickness=args.max_circle_thickness,
        use_reparam=not args.no_reparam,
        quantize=args.quantize if args.quantize != "none" else None,
        device=args.device,
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="TrackNet Inference")
    parser.add_argument("--path", type=str, metavar="", help="input path (folder of frames or single video)")
    parser.add_argument("--batch_size", type=int, default=32, metavar="", help="Inference batch size")
    parser.add_argument("--weights_path", type=str, default=BEST_MODEL_PATH, metavar="", help="saved model path")
    parser.add_argument("--dl_workers", type=int, default=0, metavar="", help="Number of dataloader workers")
    parser.add_argument("--device", type=str, default="cuda", metavar="", help="device to run inference on (cuda or cpu)")
    parser.add_argument("--fps", type=int, default=30, metavar="", help="Number of frames per second for video")
    parser.add_argument("--img_ext", type=str, default="jpg", metavar="", help="Image extension for frame folders")
    parser.add_argument("--frame_skips", type=int, default=0, metavar="", help="Number of frames to skip (video only)")
    parser.add_argument("--with_summary", action="store_true", help="Store output with csv summary [frame, x, y, r]")
    parser.add_argument("--max_num_trace", type=int, default=5, metavar="", help="Number of past positions in the fading trace")
    parser.add_argument("--max_circle_thickness", type=int, default=10, metavar="", help="Max thickness of trace circles")
    parser.add_argument("--no_reparam", action="store_true", help="Serve the train-form network")
    parser.add_argument("--quantize", type=str, default="none", choices=["none", "int8"], metavar="",
                        help="int8 PTQ serving, calibrated on the first batch")
    return parser


def main(argv=None) -> str:
    logging.basicConfig(level=logging.INFO, format=LOG_FORMAT, datefmt=LOG_DATE_FORMAT)
    args = build_parser().parse_args(argv)
    config_path = os.path.join(Path(BEST_MODEL_PATH).parent.resolve(), "config", "config.yaml")
    return run(args, config_path)


if __name__ == "__main__":
    main()
