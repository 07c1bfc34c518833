"""Segmentation training CLI of the port, with the flags of the JAX
package's train_seg.py plus `--device` (default `cuda`).

    python -m vision_conglomerate_torch.train_seg --config_path configs/segmentation/config.yaml \
        --anchors_path configs/segmentation/anchors.yaml --batch_size 16 --epochs 100 --lr_schedule

It writes what the JAX CLI writes: metrics/segmentation/*.csv (with
seg_loss, dice_score and seg_dropped_candidates) and plots,
saved_model/segmentation/best_model/SegmentationNet.ckpt.tar with its
config/config.yaml, and snapshots under saved_model/segmentation/checkpoints/.
The data are YOLO-seg polygon labels under train_config.data_path/{train,valid}.
Auto-anchors read the polygons' boxes and may rewrite the file given as
--anchors_path, and no other. `overlap_masks` is read from train_config,
else from loss_config (default true). Without img_config.mask_scale_factor
the masks are stored at the protos' size (img_wh // 4). `model_config.remat`
is on by default at batch >= 32. `--use_ddp` trains data-parallel under
torchrun, as `train_det` does (the global batch, the lr scaled by the
number of ranks, anchors from rank 0, writes on rank 0).
"""
import argparse
import logging
import os

import numpy as np

from .train_det import (LOG_DATE_FORMAT, LOG_FORMAT, fit, make_dataloader, on_primary,
                        setup_device)

logger = logging.getLogger(__name__)


def make_dataset(config, subdir: str):
    from .data.segmentation import SegmentationDataset

    tc = config["train_config"]
    img_wh = tuple(tc["img_config"]["img_wh"])
    # train_config's overlap_masks (the reference's place for it) wins over
    # loss_config's
    overlap = bool(tc.get("overlap_masks",
                          (tc.get("loss_config", {}) or {}).get("overlap_masks", True)))
    msf = (tc.get("img_config", {}) or {}).get("mask_scale_factor")
    mask_kwargs = ({"mask_scale_factor": float(msf)} if msf is not None
                   else {"mask_store_wh": (img_wh[0] // 4, img_wh[1] // 4)})
    dl_cfg = tc.get("dataloader_config", {}) or {}
    return SegmentationDataset(
        os.path.join(tc["data_path"], subdir),
        img_ext=tc["img_config"]["img_ext"],
        img_wh=img_wh,
        max_labels=int(dl_cfg.get("max_labels", 64) or 64),
        overlap_masks=overlap,
        decode_backend=dl_cfg.get("decode_backend", "pil"),
        **mask_kwargs,
    )


def make_loss_config(config, num_classes: int):
    """SegmentationLossConfig from train_config.loss_config (its unused
    class_weights dropped; train_config.overlap_masks wins)."""
    from .losses import SegmentationLossConfig

    tc = config["train_config"]
    kwargs = dict(tc.get("loss_config", {}) or {})
    kwargs.pop("class_weights", None)
    if "overlap_masks" in tc:
        kwargs["overlap_masks"] = bool(tc["overlap_masks"])
    if kwargs.get("scale_w") is not None:
        kwargs["scale_w"] = tuple(kwargs["scale_w"])
    return SegmentationLossConfig(num_classes=num_classes, **kwargs)


def build(args, config, config_path, anchors_path):
    """(pipeline, train loader, eval loader) as `run` uses them."""
    import torch

    from .models import SegmentationNet
    from .tools.make_anchors import generate_anchors_and_class_weights
    from .train.base import resolve_remat_default
    from .train.lr_schedule import make_lr_scheduler
    from .train.optim import make_optimizer
    from .train.segmentation_trainer import TrainSegmentationPipeline
    from .parallel.mesh import world_size
    from .utils import load_yaml

    resolve_remat_default(config["model_config"], args.batch_size)  # the global batch
    dev = setup_device(args)

    tc = config["train_config"]
    train_ds = make_dataset(config, "train")
    eval_ds = make_dataset(config, "valid")
    train_dl = make_dataloader(train_ds, args.batch_size, config, shard=args.use_ddp)
    eval_dl = make_dataloader(eval_ds, args.batch_size, config, shuffle=False,
                              shard=args.use_ddp)

    auto_cfg = dict(config.get("auto_anchors_config", {}) or {})
    update_cfg = auto_cfg.pop("update_anchors_cfg", True)
    anchors_arr, class_weights = on_primary(
        generate_anchors_and_class_weights,
        os.path.join(tc["data_path"], "train"), load_yaml(anchors_path)["anchors"],
        anchors_path=anchors_path, verbose=not args.no_verbose,
        update_anchors_cfg=update_cfg, from_polygons=True, **auto_cfg)
    anchors = {k: anchors_arr[i].tolist() for i, k in enumerate(("sm", "md", "lg"))}
    num_classes = int(class_weights.shape[0])

    dtype = torch.bfloat16 if config["model_config"].get("dtype") == "bfloat16" else torch.float32
    model = SegmentationNet(num_classes, config["model_config"], anchors=anchors, dtype=dtype,
                            device=dev)
    opt_cfg = dict(tc["optimizer_config"])
    if getattr(args, "lr", None):
        opt_cfg["lr"] = float(args.lr)
    # the lr scales by the device count, as in the JAX CLI
    opt_cfg["lr"] = float(opt_cfg.get("lr", 1e-3)) * world_size()
    optimizer, base_lr = make_optimizer(
        opt_cfg, model, train_anchors=bool(config["model_config"].get("train_anchors", True)))
    scheduler = (make_lr_scheduler(tc.get("lr_scheduler_config"), base_lr)
                 if args.lr_schedule else None)
    pipeline = TrainSegmentationPipeline(
        model, make_loss_config(config, num_classes), optimizer,
        lr_scheduler=scheduler,
        lr_schedule_interval=args.lr_schedule_interval,
        checkpoint_path=args.checkpoint_path or None,
        config_path=config_path,
    )
    return pipeline, train_dl, eval_dl


def run(args, config, config_path, anchors_path):
    """Train for args.epochs (resuming at the checkpoint's LAST_EPOCH);
    returns the pipeline."""
    return fit(args, *build(args, config, config_path, anchors_path))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Segmentation Training")
    parser.add_argument("--batch_size", type=int, default=16, metavar="", help="Training batch size")
    parser.add_argument("--epochs", type=int, default=100, metavar="", help="Number of training epochs")
    parser.add_argument("--checkpoint_interval", type=int, default=10, metavar="", help="Number of epochs before persisting checkpoint to disk")
    parser.add_argument("--eval_interval", type=int, default=1, metavar="", help="Number of epochs before each evaluation")
    parser.add_argument("--no_verbose", action="store_true", help="Reduce training output verbosity")
    parser.add_argument("--lr_schedule", action="store_true", help="Use learning rate scheduler")
    parser.add_argument("--lr_schedule_interval", type=int, default=1, metavar="", help="Number of epochs before lr scheduling")
    parser.add_argument("--use_ddp", action="store_true", help="Data-parallel training, one process per device (launch with torchrun)")
    parser.add_argument("--checkpoint_path", type=str, default="", metavar="", help="Resume from this checkpoint")
    parser.add_argument("--config_path", type=str, default="configs/segmentation/config.yaml", metavar="", help="Config YAML path")
    parser.add_argument("--anchors_path", type=str, default="configs/segmentation/anchors.yaml", metavar="", help="Anchors YAML path")
    parser.add_argument("--lr", type=float, default=0.0, metavar="", help="Override optimizer_config.lr (still scaled by device count); 0 = use config")
    parser.add_argument("--device", type=str, default="cuda", metavar="", help="device to train on (cuda or cpu)")
    return parser


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format=LOG_FORMAT, datefmt=LOG_DATE_FORMAT)
    args = build_parser().parse_args(argv)
    np.random.seed(42)
    from .parallel.mesh import shutdown_distributed
    from .utils import load_yaml

    try:
        return run(args, load_yaml(args.config_path), args.config_path, args.anchors_path)
    finally:
        shutdown_distributed()


if __name__ == "__main__":
    main()
