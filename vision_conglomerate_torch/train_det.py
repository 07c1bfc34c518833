"""Detection training CLI of the port, with the flags of the JAX package's
train_det.py plus `--device` (default `cuda`, as the port's inference_det).

    python -m vision_conglomerate_torch.train_det --config_path configs/detection/config.yaml \
        --anchors_path configs/detection/anchors.yaml --batch_size 16 --epochs 100 --lr_schedule

It writes what the JAX CLI writes: metrics/detection/*.csv and plots,
saved_model/detection/best_model/DetectionNet.ckpt.tar with its
config/config.yaml, and snapshots under saved_model/detection/checkpoints/.
Auto-anchors may rewrite the file given as --anchors_path, and no other.
The lr is scaled by the device count (1). `--map_eval` adds the val set's
mAP@50 to each eval record (a `map50` column in eval_metrics.csv), and for
keypoint data its PCK@0.1 (a `pck` column). Keypoint data ((cols - 5) // 3
keypoints per label row, as `configs/detection/config_kp.yaml` expects)
gives the heads a keypoint branch, and the saved config/config.yaml
carries `num_keypoints`.
`model_config.remat`, which the CLI turns on by default at batch >= 32,
recomputes each backbone and neck stage in the backward pass
(`nn.blocks.stage`). `--use_ddp` is not in the port yet and raises (ROADMAP
§A.8).
"""
import argparse
import logging
import os

import numpy as np

LOG_FORMAT = "%(asctime)s %(levelname)s %(filename)s: %(message)s"
LOG_DATE_FORMAT = "%Y-%m-%d %H:%M:%S"
logger = logging.getLogger(__name__)


def make_dataset(config, subdir: str):
    from .data.detection import DetectionDataset

    tc = config["train_config"]
    dl_cfg = tc.get("dataloader_config", {}) or {}
    return DetectionDataset(
        os.path.join(tc["data_path"], subdir),
        img_ext=tc["img_config"]["img_ext"],
        img_wh=tuple(tc["img_config"]["img_wh"]),
        max_labels=int(dl_cfg.get("max_labels", 64) or 64),
        decode_backend=dl_cfg.get("decode_backend", "pil"),
    )


def make_dataloader(dataset, batch_size, config, shuffle=None, seed=42):
    from .data.loader import DataLoader

    dl_cfg = dict(config["train_config"].get("dataloader_config", {}) or {})
    if shuffle is None:
        shuffle = bool(dl_cfg.get("shuffle", True))
    return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                      num_workers=int(dl_cfg.get("num_workers", 8) or 8),
                      pad_last="wrap", seed=seed)


def make_loss_config(config, num_classes: int, num_keypoints: int = 0):
    """DetectionLossConfig from train_config.loss_config (its unused
    class_weights dropped)."""
    from .losses import DetectionLossConfig

    kwargs = dict(config["train_config"].get("loss_config", {}) or {})
    kwargs.pop("class_weights", None)
    if kwargs.get("scale_w") is not None:
        kwargs["scale_w"] = tuple(kwargs["scale_w"])
    return DetectionLossConfig(num_classes=num_classes, num_keypoints=num_keypoints, **kwargs)


def build(args, config, config_path, anchors_path):
    """(pipeline, train loader, eval loader) as `run` uses them."""
    import torch

    from .device import resolve_device
    from .models import DetectionNet
    from .tools.make_anchors import generate_anchors_and_class_weights
    from .train.base import resolve_remat_default
    from .train.detection_trainer import TrainDetectionPipeline
    from .train.lr_schedule import make_lr_scheduler
    from .train.optim import make_optimizer
    from .utils import load_yaml

    if args.use_ddp:
        raise NotImplementedError("--use_ddp is not in the port yet (ROADMAP §A.8)")
    resolve_remat_default(config["model_config"], args.batch_size)
    dev = resolve_device(args.device)

    tc = config["train_config"]
    train_ds = make_dataset(config, "train")
    eval_ds = make_dataset(config, "valid")
    train_dl = make_dataloader(train_ds, args.batch_size, config)
    eval_dl = make_dataloader(eval_ds, args.batch_size, config, shuffle=False)

    auto_cfg = dict(config.get("auto_anchors_config", {}) or {})
    update_cfg = auto_cfg.pop("update_anchors_cfg", True)
    anchors_arr, class_weights = generate_anchors_and_class_weights(
        os.path.join(tc["data_path"], "train"), load_yaml(anchors_path)["anchors"],
        anchors_path=anchors_path, verbose=not args.no_verbose,
        update_anchors_cfg=update_cfg, **auto_cfg)
    anchors = {k: anchors_arr[i].tolist() for i, k in enumerate(("sm", "md", "lg"))}
    num_classes = int(class_weights.shape[0])
    num_keypoints = train_ds.num_keypoints or None

    dtype = torch.bfloat16 if config["model_config"].get("dtype") == "bfloat16" else torch.float32
    model = DetectionNet(num_classes, config["model_config"], anchors=anchors,
                         num_keypoints=num_keypoints, dtype=dtype, device=dev)

    loss_cfg = make_loss_config(config, num_classes, num_keypoints or 0)

    opt_cfg = dict(tc["optimizer_config"])
    if getattr(args, "lr", None):
        opt_cfg["lr"] = float(args.lr)
    n_devices = 1  # the lr scales by the device count, as in the JAX CLI
    opt_cfg["lr"] = float(opt_cfg.get("lr", 1e-3)) * n_devices
    optimizer, base_lr = make_optimizer(
        opt_cfg, model, train_anchors=bool(config["model_config"].get("train_anchors", True)))
    scheduler = (make_lr_scheduler(tc.get("lr_scheduler_config"), base_lr)
                 if args.lr_schedule else None)
    aug_cfg = tc.get("augment_config", {}) or {}
    pipeline = TrainDetectionPipeline(
        model, loss_cfg, optimizer,
        lr_scheduler=scheduler,
        lr_schedule_interval=args.lr_schedule_interval,
        checkpoint_path=args.checkpoint_path or None,
        config_path=config_path,
        hflip_prob=float(aug_cfg.get("hflip_prob", 0.0) or 0.0),
    )
    return pipeline, train_dl, eval_dl


def run(args, config, config_path, anchors_path):
    """Train for args.epochs (resuming at the checkpoint's LAST_EPOCH);
    returns the pipeline."""
    return fit(args, *build(args, config, config_path, anchors_path))


def fit(args, pipeline, train_dl, eval_dl):
    """The epoch loop of the train CLIs: train (at most
    --steps_per_epoch steps, where the CLI has it), evaluate every
    eval_interval epochs (with --map_eval, where the CLI has it), keep the
    best model by the pipeline's eval loss, snapshot every
    checkpoint_interval epochs, write the metrics CSVs and plots. Returns
    the pipeline."""
    from .utils.profiling import trace

    # seeded from restored history, so a resumed run keeps its best model
    best_loss = pipeline.best_eval_loss()
    verbose = not args.no_verbose
    profile_dir = getattr(args, "profile_dir", "")
    steps = getattr(args, "steps_per_epoch", None)
    train_kw = {"steps_per_epoch": steps} if steps else {}
    for epoch in range(pipeline.last_epoch, args.epochs):
        logger.info(f"epoch {epoch + 1}/{args.epochs}")
        # profile only the first trained epoch (traces are large)
        with trace(profile_dir if epoch == pipeline.last_epoch else None):
            pipeline.train(train_dl, verbose=verbose, **train_kw)
        if ((epoch + 1) % args.eval_interval == 0) or (epoch + 1 == args.epochs):
            metrics = pipeline.evaluate(eval_dl, verbose=verbose)
            if getattr(args, "map_eval", False):
                from .tools.eval_harness import evaluate_pipeline_map

                map_res = evaluate_pipeline_map(pipeline, eval_dl.dataset,
                                                batch_size=args.batch_size)
                extra = {"map50": float(map_res["map"])}
                if "pck" in map_res:
                    extra["pck"] = float(map_res["pck"])
                pipeline.annotate_last("eval", extra)
                if verbose:
                    logger.info(f"mAP@50: {map_res['map']:.4f}" + (
                        f"  PCK@0.1: {map_res['pck']:.4f}" if "pck" in map_res else ""))
            if metrics[pipeline.eval_loss_key] < best_loss:
                best_loss = metrics[pipeline.eval_loss_key]
                pipeline.save_best_model()
            pipeline.metrics_to_csv()
        if ((epoch + 1) % args.checkpoint_interval == 0) or (epoch + 1 == args.epochs):
            pipeline.save_checkpoint()
    pipeline.metrics_to_csv()
    pipeline.save_metrics_plots()
    return pipeline


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Detection Training")
    parser.add_argument("--batch_size", type=int, default=16, metavar="", help="Training batch size")
    parser.add_argument("--epochs", type=int, default=100, metavar="", help="Number of training epochs")
    parser.add_argument("--checkpoint_interval", type=int, default=10, metavar="", help="Number of epochs before persisting checkpoint to disk")
    parser.add_argument("--eval_interval", type=int, default=1, metavar="", help="Number of epochs before each evaluation")
    parser.add_argument("--no_verbose", action="store_true", help="Reduce training output verbosity")
    parser.add_argument("--lr_schedule", action="store_true", help="Use learning rate scheduler")
    parser.add_argument("--lr_schedule_interval", type=int, default=1, metavar="", help="Number of epochs before lr scheduling")
    parser.add_argument("--use_ddp", action="store_true", help="Data-parallel training over all visible devices (not in the port yet)")
    parser.add_argument("--checkpoint_path", type=str, default="", metavar="", help="Resume from this checkpoint")
    parser.add_argument("--config_path", type=str, default="configs/detection/config.yaml", metavar="", help="Config YAML path")
    parser.add_argument("--anchors_path", type=str, default="configs/detection/anchors.yaml", metavar="", help="Anchors YAML path")
    parser.add_argument("--profile_dir", type=str, default="", metavar="", help="Write a torch.profiler trace of the first epoch here")
    parser.add_argument("--map_eval", action="store_true", help="Compute mAP@50 on the val set at each eval interval (recorded in eval metrics)")
    parser.add_argument("--lr", type=float, default=0.0, metavar="", help="Override optimizer_config.lr (still scaled by device count); 0 = use config")
    parser.add_argument("--device", type=str, default="cuda", metavar="", help="device to train on (cuda or cpu)")
    return parser


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format=LOG_FORMAT, datefmt=LOG_DATE_FORMAT)
    args = build_parser().parse_args(argv)
    np.random.seed(42)
    from .utils import load_yaml

    return run(args, load_yaml(args.config_path), args.config_path, args.anchors_path)


if __name__ == "__main__":
    main()
