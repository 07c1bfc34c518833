"""TrackNet training CLI of the port, with the flags of the JAX package's
train_tracknet.py plus `--device` (default `cuda`).

    python -m vision_conglomerate_torch.train_tracknet --config_path configs/tracknet/config.yaml \
        --batch_size 16 --epochs 100 --lr_schedule

The windows of the clips under train_config.data_path (`*/Clip*/Label.csv`)
are shuffled with seed 42 and split 70/30: the train loader drops its
partial last batch, and the eval loader pads its last batch by wrapping
(each window is scored once). Frames go to the card as uint8 and are
divided by 255 there. It writes what the JAX CLI writes:
metrics/tracknet/{train,eval}_metrics.csv (loss; loss, tp, tn, fp, fn,
precision, recall, f1) and plots, saved_model/tracknet/best_model/
TrackNet.ckpt.tar (lowest eval loss) with its config/config.yaml, and
snapshots under saved_model/tracknet/checkpoints/. The optimizer and
schedule come from the config (the shipped one: Adadelta, lr 1.0,
CosineAnnealingWarmRestarts with --lr_schedule). `model_config.remat`, on
by default at batch >= 32, recomputes each conv in the backward pass.
`--use_ddp` trains data-parallel under torchrun, as `train_det` does: the
global batch, the lr scaled by the number of ranks (the JAX CLI's device
count), writes on rank 0. `--profile_dir` writes a torch.profiler trace of
the first epoch there (`utils.profiling.trace`), the train step's spans in
it.
"""
import argparse
import logging

import numpy as np

from .train_det import LOG_DATE_FORMAT, LOG_FORMAT, setup_device

logger = logging.getLogger(__name__)


def make_datasets(config, data_path=None, cache: bool = False, split_percentage: float = 0.7):
    """(train, eval) TrackNetDatasets: the seed-42 split of the windows
    under data_path (default train_config.data_path), uint8 frames."""
    from .data.tracknet import TrackNetDataset

    tc = config["train_config"]
    img_cfg = tc["img_config"]
    kw = dict(num_stacks=int(img_cfg.get("num_stacks", 3)), img_wh=tuple(img_cfg["img_wh"]),
              avg_diameter=int(img_cfg.get("avg_diameter", 5)), cache=cache,
              transfer_dtype="uint8")
    train_ds = TrackNetDataset(data_path=data_path or tc["data_path"],
                               split_percentage=split_percentage, seed=42, **kw)
    return train_ds, TrackNetDataset(labels_df=train_ds.unused_labels_df, **kw)


def build(args, config, config_path):
    """(pipeline, train loader, eval loader) as `run` uses them."""
    import torch

    from .data.loader import DataLoader
    from .models import TrackNet
    from .train.base import resolve_remat_default
    from .train.lr_schedule import make_lr_scheduler
    from .train.optim import make_optimizer
    from .parallel.mesh import world_size
    from .train.tracknet_trainer import TrainTrackNetPipeline

    mc = config["model_config"]
    resolve_remat_default(mc, args.batch_size)  # the global batch
    dev = setup_device(args)
    tc = config["train_config"]
    train_ds, eval_ds = make_datasets(config, cache=args.cache_data)
    workers = int((tc.get("dataloader_config", {}) or {}).get("num_workers", 8) or 8)
    shuffle = bool((tc.get("dataloader_config", {}) or {}).get("shuffle", True))
    train_dl = DataLoader(train_ds, args.batch_size, shuffle=shuffle, num_workers=workers,
                          drop_last=True, shard=args.use_ddp)
    eval_dl = DataLoader(eval_ds, args.batch_size, shuffle=False, pad_last="wrap",
                         num_workers=workers, shard=args.use_ddp)

    dtype = torch.bfloat16 if mc.get("dtype") == "bfloat16" else torch.float32
    num_stacks = int(tc["img_config"].get("num_stacks", 3))
    model = TrackNet(mc, in_channels=3 * num_stacks, dtype=dtype, device=dev)
    opt_cfg = dict(tc["optimizer_config"])
    if getattr(args, "lr", None):
        opt_cfg["lr"] = float(args.lr)
    # the lr scales by the device count, as in the JAX CLI
    opt_cfg["lr"] = float(opt_cfg.get("lr", 1.0)) * world_size()
    optimizer, base_lr = make_optimizer(opt_cfg, model)
    scheduler = (make_lr_scheduler(tc.get("lr_scheduler_config"), base_lr)
                 if args.lr_schedule else None)
    pipeline = TrainTrackNetPipeline(
        model, optimizer,
        lr_scheduler=scheduler,
        lr_schedule_interval=args.lr_schedule_interval,
        checkpoint_path=args.checkpoint_path or None,
        config_path=config_path,
        init_scheme=mc.get("weight_init", "uniform"),
        tp_dist_tol=float(tc.get("tp_dist_tol", 4.0)),
        heatmap_threshold=int(tc.get("heatmap_threshold", 128)),
        decode=tc.get("heatmap_decode", "centroid"),
        hough_grad_config=tc.get("hough_grad_config", {}),
    )
    return pipeline, train_dl, eval_dl


def run(args, config, config_path):
    """Train for args.epochs (resuming at the checkpoint's LAST_EPOCH),
    keeping the best model by eval loss (`train_det.fit`); returns the
    pipeline."""
    from .train_det import fit

    return fit(args, *build(args, config, config_path))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="TrackNet Training")
    parser.add_argument("--batch_size", type=int, default=16, metavar="", help="Training batch size")
    parser.add_argument("--epochs", type=int, default=100, metavar="", help="Number of training epochs")
    parser.add_argument("--steps_per_epoch", type=int, default=None, metavar="", help="Max steps per epoch")
    parser.add_argument("--checkpoint_interval", type=int, default=10, metavar="", help="Number of epochs before persisting checkpoint to disk")
    parser.add_argument("--eval_interval", type=int, default=1, metavar="", help="Number of epochs before each evaluation")
    parser.add_argument("--no_verbose", action="store_true", help="Reduce training output verbosity")
    parser.add_argument("--lr_schedule", action="store_true", help="Use learning rate scheduler")
    parser.add_argument("--lr_schedule_interval", type=int, default=1, metavar="", help="Number of epochs before lr scheduling")
    parser.add_argument("--use_ddp", action="store_true", help="Data-parallel training, one process per device (launch with torchrun)")
    parser.add_argument("--checkpoint_path", type=str, default="", metavar="", help="Resume from this checkpoint")
    parser.add_argument("--config_path", type=str, default="configs/tracknet/config.yaml", metavar="", help="Config YAML path")
    parser.add_argument("--lr", type=float, default=0.0, metavar="", help="Override optimizer_config.lr (still scaled by device count); 0 = use config")
    parser.add_argument("--cache_data", action="store_true", help="Cache decoded frame windows in host RAM after the first epoch")
    parser.add_argument("--profile_dir", type=str, default="", metavar="", help="Write a torch.profiler trace of the first epoch here, with the port's spans")
    parser.add_argument("--device", type=str, default="cuda", metavar="", help="device to train on (cuda or cpu)")
    return parser


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format=LOG_FORMAT, datefmt=LOG_DATE_FORMAT)
    args = build_parser().parse_args(argv)
    np.random.seed(42)
    from .parallel.mesh import shutdown_distributed
    from .utils import load_yaml

    try:
        return run(args, load_yaml(args.config_path), args.config_path)
    finally:
        shutdown_distributed()


if __name__ == "__main__":
    main()
