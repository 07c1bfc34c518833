"""Detection training, the JAX package's train/detection_trainer.py in
PyTorch, on one device or data-parallel over the ranks of a process group
(`parallel.mesh`).

A train step: forward in train mode (BatchNorm updates its running
statistics), `detection_loss`, backward, optimizer step. An eval step: the
net in eval mode under no_grad, with a per-row `image_mask` that keeps the
wrap-padded rows of the last batch out of the metrics. Batches reach the
device two steps ahead (`data.loader.prefetch_to_device`) and images are
divided by 255 there. Each step's metrics are stacked into one vector and
summed on the device; the host reads the sum once, at the end of the
epoch, so no step waits on the host.

Under data parallelism each rank takes its shard of the global batch
(`DataLoader(shard=True)`): BatchNorm normalises with the shard's own
statistics, and before each optimizer step the gradients and the running
statistics are averaged over the ranks and the metrics combined
(`BasePipeline._sync_train_step`); an eval step weights each rank's means
by its valid rows (`_sync_eval_step`). Every rank seeds its flip
generator with one seed, as the JAX shards share one key.

Checkpoints use the JAX package's manifest format; a port snapshot keeps
its torch optimizer state under TORCH_OPTIMIZER_PARAMS, and a JAX
snapshot's optimizer state carries over (`optim.load_optax_state`).
"""
import logging
from typing import Any, Dict, Optional

import torch

from ..losses import DetectionLossConfig, detection_loss
from ..models import DetectionNet
from ..nn.initializers import INIT_SCHEMES
from ..data.loader import prefetch_to_device
from ..ops.preprocess import normalize_images, random_hflip
from ..parallel.mesh import broadcast_module_, rank, world_size
from ..utils.profiling import StepTimer
from ..weights import flax_to_state_dict, state_dict_to_flax
from .base import BasePipeline
from .checkpoint import to_torch
from .lr_schedule import LRScheduler
from .optim import fill_missing_grads, load_optax_state, set_learning_rate

logger = logging.getLogger(__name__)


class TrainDetectionPipeline(BasePipeline):
    """Trains `model` (already on its device) with `optimizer` (built over
    its parameters by `train.optim.make_optimizer`). The conv weights are
    re-drawn by `init_scheme` from `seed` unless it is empty; a
    `checkpoint_path` then restores weights, optimizer, schedule and
    history."""

    task = "detection"

    def __init__(
        self,
        model: DetectionNet,
        loss_cfg: DetectionLossConfig,
        optimizer: torch.optim.Optimizer,
        lr_scheduler: Optional[LRScheduler] = None,
        lr_schedule_interval: int = 1,
        model_name: Optional[str] = None,
        checkpoint_path: Optional[str] = None,
        config_path: Optional[str] = None,
        seed: int = 42,
        init_scheme: Optional[str] = "xavier",
        hflip_prob: float = 0.0,
    ):
        self.model = model
        self.loss_cfg = loss_cfg
        self.optimizer = optimizer
        self.lr_scheduler = lr_scheduler
        self.hflip_prob = hflip_prob
        self.device = model.sm_anchors.device
        super().__init__(
            model_name=model_name or type(model).__name__,
            config_path=config_path,
            lr_schedule_interval=lr_schedule_interval,
            num_keypoints=model.num_keypoints,
        )
        if init_scheme:
            INIT_SCHEMES[init_scheme](model, torch.Generator().manual_seed(seed))
        self._hflip_gen = torch.Generator(device=self.device).manual_seed(seed)
        logger.info(f"Number of model parameters: {sum(p.numel() for p in model.parameters())}")
        if checkpoint_path:
            self.load_checkpoint(checkpoint_path)
        broadcast_module_(model)

    # ----------------------------------------------------------- manifest
    def _manifest(self, snapshot: bool) -> Dict[str, Any]:
        manifest: Dict[str, Any] = {
            "LAST_EPOCH": self.last_epoch,
            "NETWORK_PARAMS": state_dict_to_flax(self.model.state_dict()),
            "NUM_CLASSES": self.model.num_classes,
        }
        if snapshot:
            manifest["TORCH_OPTIMIZER_PARAMS"] = self.optimizer.state_dict()
            manifest["METRICS"] = {"TRAIN": self._train_metrics, "EVAL": self._eval_metrics}
            if self.lr_scheduler:
                manifest["LR_SCHEDULER_PARAMS"] = self.lr_scheduler.state_dict()
        return manifest

    def _restore(self, manifest: Dict[str, Any]):
        self.model.load_state_dict(flax_to_state_dict(manifest["NETWORK_PARAMS"]))
        if "TORCH_OPTIMIZER_PARAMS" in manifest:
            self.optimizer.load_state_dict(to_torch(manifest["TORCH_OPTIMIZER_PARAMS"]))
        elif "OPTIMIZER_PARAMS" in manifest:
            load_optax_state(self.optimizer, self.model, manifest["OPTIMIZER_PARAMS"])
        if self.lr_scheduler and "LR_SCHEDULER_PARAMS" in manifest:
            self.lr_scheduler.load_state_dict(manifest["LR_SCHEDULER_PARAMS"])

    # --------------------------------------------------------------- steps
    def _sum_metrics(self):
        """The JAX trainer's _SUM_METRICS, and the batch_scale_loss
        aggregate (already scaled by the shard's rows in the loss)."""
        return ("seg_dropped_candidates",) + (
            ("aggregate_loss",) if self.loss_cfg.batch_scale_loss else ())

    def _anchors(self):
        m = self.model
        return (m.sm_anchors, m.md_anchors, m.lg_anchors)

    def _inputs(self, imgs: torch.Tensor) -> torch.Tensor:
        return normalize_images(imgs) if imgs.dtype == torch.uint8 else imgs

    def train_step(self, imgs, labels, mask) -> Dict[str, torch.Tensor]:
        """One optimizer step on a batch of NHWC images; metrics stay on
        the device."""
        x = self._inputs(imgs)
        if self.hflip_prob > 0:
            x, labels = random_hflip(self._hflip_gen, x, labels, prob=self.hflip_prob)
        preds = self.model(x.permute(0, 3, 1, 2))
        loss, metrics = detection_loss(preds, labels, mask, self._anchors(), self.loss_cfg)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        fill_missing_grads(self.optimizer)
        metrics = self._sync_train_step(metrics)
        self.optimizer.step()
        return metrics

    @torch.no_grad()
    def eval_step(self, imgs, labels, mask, image_mask) -> Dict[str, torch.Tensor]:
        preds = self.model(self._inputs(imgs).permute(0, 3, 1, 2))
        return detection_loss(preds, labels, mask, self._anchors(), self.loss_cfg,
                              image_mask=image_mask)[1]

    # ---------------------------------------------------------------- loop
    @property
    def _valid_modes(self):
        return ("train", "eval")

    def current_lr(self) -> float:
        if self.lr_scheduler:
            return self.lr_scheduler.get_lr()
        return self.optimizer.param_groups[0]["lr"]

    def train(self, dataloader, verbose: bool = False) -> Dict[str, float]:
        r = self.step(dataloader, "train", verbose)
        if self.lr_scheduler and (self.last_epoch % self.lr_schedule_interval == 0):
            self._scheduler_step()
        self.last_epoch += 1
        return r

    def evaluate(self, dataloader, verbose: bool = False) -> Dict[str, float]:
        r = self.step(dataloader, "eval", verbose)
        self._note_eval(r)
        return r

    def step(self, dataloader, mode: str, verbose: bool = False) -> Dict[str, float]:
        """One epoch of `mode` over `dataloader`; returns the metrics'
        mean over its batches and images_per_sec.

        Eval masks the wrap-padded rows of the final batch: the loader
        contract is in-order batches with padding only as trailing rows of
        the last one, so the valid rows are the leading
        len(dataset) - seen of the global batch. A loader without a
        `dataset` scores every row. Under data parallelism a batch is this
        rank's shard of the global batch.
        """
        if mode not in self._valid_modes:
            raise ValueError(f"Invalid mode {mode} expected one of {self._valid_modes}")
        train = mode == "train"
        self.model.train(train)
        if train:
            set_learning_rate(self.optimizer, self.current_lr())
        n_total = None
        if not train:
            n_total = len(getattr(dataloader, "dataset", ()) or ()) or None
        keys, total, count, seen = None, None, 0, 0
        timer = StepTimer()
        for batch in prefetch_to_device(dataloader, self.device):
            bsz = int(batch[0].shape[0])  # this rank's rows
            n_rows = bsz * world_size()  # the global batch's
            if train:
                metrics = self.train_step(*batch)
            else:
                if n_total is not None:
                    n_rows = min(n_rows, max(n_total - seen, 0))
                seen += n_rows
                if n_rows == 0:
                    continue
                n_local = min(max(n_rows - rank() * bsz, 0), bsz)
                image_mask = (torch.arange(bsz, device=self.device) < n_local).float()
                metrics = self._sync_eval_step(self.eval_step(*batch, image_mask), n_local)
            keys = list(metrics)
            vec = torch.stack([v.detach() for v in metrics.values()])
            total = vec if total is None else total.add_(vec)
            timer.tick(n_rows)
            count += 1
        if not train and n_total is not None and seen != n_total:
            raise RuntimeError(
                f"eval loader yielded {seen} rows but len(dataset) == {n_total}; the "
                "wrap-padding row mask needs in-order batches padded only at the tail "
                "(DataLoader pad_last='wrap')")
        # the one host read of the epoch; it also makes the wall clock honest
        sums = total.tolist() if total is not None else []
        metrics_avg = {k: v / max(count, 1) for k, v in zip(keys or (), sums)}
        metrics_avg["images_per_sec"] = timer.images_per_sec
        self._record(mode, metrics_avg, verbose)
        return metrics_avg
