"""TrackNet accuracy CLI of the port, with the flags of the JAX package's
eval_tracknet.py plus `--device` (default `cuda`).

    python -m vision_conglomerate_torch.eval_tracknet \\
        --weights_path saved_model/tracknet/best_model/TrackNet.ckpt.tar \\
        [--config_path .../config.yaml] [--decode centroid|hough] [--deploy]

It scores the reference's protocol over the 30% eval split of the clips
under train_config.data_path (or --data_path): the trainer's own seed-42
70/30 split, so the numbers match the per-epoch eval CSV. Each window's
argmax heatmap is decoded to one circle (the on-device centroid, or
cv2.HoughCircles with --decode hough) and counted as tp, fp, tn or fn per
visibility class within tp_dist_tol pixels (the config's wins over
--tp_dist_tol). It prints the JAX CLI's one JSON line, with the same keys
and rounding.

Forms: by default the train form (parameters and running BatchNorm
statistics, bf16 on the card); --deploy the serve form (BatchNorm folded,
every stride-1 conv on the kernels on the card), what inference_tracknet
runs; `--quantize int8` (implies --deploy) the int8 serve form, calibrated
on the first eval batch as the JAX package does, whose int8 convs run on
the s8 kernels on the card. The JSON's "form" is "train", "deploy" or
"int8".
"""
import argparse
import json
import logging
import os
from pathlib import Path

from .train_det import LOG_DATE_FORMAT, LOG_FORMAT


def run(args) -> dict:
    import torch

    from .data.loader import DataLoader
    from .device import resolve_device
    from .infer.runner import quantize_model_int8
    from .infer.tracknet_runner import load_tracknet_model
    from .models import TrackNet
    from .train.optim import make_optimizer
    from .train.tracknet_trainer import TrainTrackNetPipeline
    from .train_tracknet import make_datasets
    from .utils import load_yaml

    if args.quantize not in ("none", "int8"):
        raise ValueError(f"unknown quantize mode: {args.quantize!r}")
    int8 = args.quantize == "int8"
    deploy = args.deploy or int8
    dev = resolve_device(args.device)
    config_path = args.config_path or os.path.join(
        Path(args.weights_path).parent.resolve(), "config", "config.yaml")
    cfg = load_yaml(config_path)
    tc = cfg["train_config"]
    num_stacks = int(tc["img_config"].get("num_stacks", 3))
    _, eval_ds = make_datasets(cfg, args.data_path or None,
                               split_percentage=float(tc.get("split_percentage", 0.7)))
    eval_dl = DataLoader(eval_ds, args.batch_size, shuffle=False, num_workers=2,
                         pad_last="wrap")

    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model = TrackNet(cfg["model_config"], in_channels=3 * num_stacks, dtype=dtype, device=dev)
    optimizer, _ = make_optimizer(dict(tc["optimizer_config"]), model)
    pipe = TrainTrackNetPipeline(
        model, optimizer, checkpoint_path=args.weights_path, init_scheme=None,
        tp_dist_tol=float(tc.get("tp_dist_tol", args.tp_dist_tol)),
        heatmap_threshold=int(tc.get("heatmap_threshold", 128)),
        decode=args.decode, hough_grad_config=tc.get("hough_grad_config"))
    serve_net = None
    if deploy:
        serve_net = load_tracknet_model(args.weights_path, cfg["model_config"], num_stacks,
                                        device=dev, quantize=args.quantize)
    if int8:  # PTQ on the first eval batch
        frames = torch.from_numpy(next(iter(eval_dl))[0]).to(dev)
        quantize_model_int8(serve_net, pipe._inputs(frames))
    metrics = pipe.evaluate(eval_dl, verbose=args.verbose, model=serve_net)
    out = {
        "f1": round(float(metrics["f1"]), 5),
        "precision": round(float(metrics["precision"]), 5),
        "recall": round(float(metrics["recall"]), 5),
        "tp": int(metrics["tp"]), "tn": int(metrics["tn"]),
        "fp": int(metrics["fp"]), "fn": int(metrics["fn"]),
        "eval_loss": round(float(metrics["loss"]), 6),
        "num_windows": len(eval_ds),
        "decode": args.decode,
        "form": "int8" if int8 else "deploy" if deploy else "train",
        "weights": args.weights_path,
    }
    print(json.dumps(out))
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="TrackNet eval (official protocol)")
    parser.add_argument("--weights_path", type=str,
                        default="saved_model/tracknet/best_model/TrackNet.ckpt.tar",
                        metavar="", help="checkpoint manifest path")
    parser.add_argument("--config_path", type=str, default="", metavar="",
                        help="config YAML (default: <weights dir>/config/config.yaml)")
    parser.add_argument("--data_path", type=str, default="", metavar="",
                        help="clips root (default: train_config.data_path)")
    parser.add_argument("--batch_size", type=int, default=8, metavar="")
    parser.add_argument("--decode", type=str, default="centroid",
                        choices=["centroid", "hough"], metavar="",
                        help="centroid (on-device) | hough (cv2 parity)")
    parser.add_argument("--deploy", action="store_true",
                        help="score the serve form (BN folded)")
    parser.add_argument("--quantize", type=str, default="none",
                        choices=["none", "int8"], metavar="",
                        help="int8 PTQ on the first eval batch (implies --deploy)")
    parser.add_argument("--tp_dist_tol", type=float, default=4.0, metavar="",
                        help="tp tolerance in px (config tp_dist_tol wins)")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--device", type=str, default="cuda", metavar="",
                        help="device to evaluate on (cuda or cpu)")
    return parser


def main(argv=None) -> dict:
    logging.basicConfig(format=LOG_FORMAT, datefmt=LOG_DATE_FORMAT, level=logging.INFO)
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
