"""TrackNet training on one device, the JAX package's
train/tracknet_trainer.py in PyTorch.

- A train step: uint8 frames divided by 255 on the device, the forward in
  train mode, the mean softmax cross entropy over every pixel of the
  256-way intensity classification, backward, optimizer step. The losses
  stay on the device until the end of the epoch; `steps_per_epoch` caps
  an epoch.
- Eval: per-sample loss (the mean over the pixels), so the wrap-padded
  tail rows of the last batch are left out and each window is scored once,
  with the reference's tail-batch mean; the argmax heatmap is decoded to
  one circle per window, by the on-device centroid decode or, with
  decode="hough", cv2.HoughCircles on the host; tp/fp/tn/fn per visibility
  class within `tp_dist_tol` pixels, then precision, recall and f1 exactly
  as the JAX package computes them (recall's denominator counts tp, tn, fp
  and fn of the visibility classes 1-3, tn included: a reference quirk).

Checkpoints use the JAX package's manifest format (TrackNet.ckpt.tar, no
NUM_CLASSES); a port snapshot keeps its torch optimizer state under
TORCH_OPTIMIZER_PARAMS, and a JAX snapshot's Adam or Adadelta state
carries over (`optim.load_optax_state`).
"""
import logging
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ..data.loader import prefetch_to_device
from ..losses.focal import softmax_cross_entropy
from ..models.tracknet import TrackNet
from ..nn.initializers import INIT_SCHEMES
from ..ops.heatmap import decode_heatmap_peaks, hough_decode
from ..ops.preprocess import normalize_images
from ..utils.profiling import StepTimer
from ..weights import flax_to_state_dict, state_dict_to_flax
from .base import BasePipeline
from .checkpoint import to_torch
from .lr_schedule import LRScheduler
from .optim import load_optax_state, set_learning_rate

logger = logging.getLogger(__name__)

def tracknet_logits_loss(logits: torch.Tensor, heatmaps: torch.Tensor) -> torch.Tensor:
    """Per-pixel softmax cross entropy (f32) of NCHW logits against (B, H,
    W) integer heatmaps, as (B, H, W). A channels_last batch's NHWC view is
    free."""
    return softmax_cross_entropy(logits.permute(0, 2, 3, 1), heatmaps.long())


def score_windows(counts: Dict[str, np.ndarray], others: np.ndarray, cx: np.ndarray,
                  cy: np.ndarray, found: np.ndarray, tp_dist_tol: float):
    """Add one batch's windows to the per-visibility-class counts (tp, fp,
    tn, fn: each a (4,) array)."""
    for i in range(others.shape[0]):
        vis = int(others[i][0])
        if found[i]:
            if vis != 0:
                dist = np.hypot(cx[i] - float(others[i][1]), cy[i] - float(others[i][2]))
                counts["tp"][vis] += dist <= tp_dist_tol
                counts["fp"][vis] += dist > tp_dist_tol
            else:
                counts["fp"][vis] += 1
        elif vis != 0:
            counts["fn"][vis] += 1
        else:
            counts["tn"][vis] += 1


def f1_metrics(counts: Dict[str, np.ndarray]) -> Dict[str, float]:
    tp, tn, fp, fn = (counts[k] for k in ("tp", "tn", "fp", "fn"))
    eps = 1e-8
    precision = tp.sum() / (tp.sum() + fp.sum() + eps)
    recall = tp.sum() / (tp[1:].sum() + tn[1:].sum() + fp[1:].sum() + fn[1:].sum() + eps)
    f1 = (2 * precision * recall) / (precision + recall + eps)
    return dict(tp=float(tp.sum()), tn=float(tn.sum()), fp=float(fp.sum()),
                fn=float(fn.sum()), precision=float(precision), recall=float(recall),
                f1=float(f1))


class TrainTrackNetPipeline(BasePipeline):
    """Trains `model` (already on its device) with `optimizer` (built over
    its parameters by `train.optim.make_optimizer`). The conv weights are
    re-drawn by `init_scheme` ("uniform", the shipped config's
    weight_init, or "xavier") from `seed` unless it is empty; a
    `checkpoint_path` then restores weights, optimizer, schedule and
    history."""

    task = "tracknet"
    eval_loss_key = "loss"

    def __init__(
        self,
        model: TrackNet,
        optimizer: torch.optim.Optimizer,
        lr_scheduler: Optional[LRScheduler] = None,
        lr_schedule_interval: int = 1,
        model_name: Optional[str] = None,
        checkpoint_path: Optional[str] = None,
        config_path: Optional[str] = None,
        seed: int = 42,
        init_scheme: Optional[str] = "uniform",
        tp_dist_tol: float = 4.0,
        heatmap_threshold: int = 128,
        decode: str = "centroid",
        hough_grad_config: Optional[Dict[str, Any]] = None,
    ):
        if decode not in ("centroid", "hough"):
            raise ValueError(f"unknown decode {decode!r} (centroid|hough)")
        if init_scheme and init_scheme not in INIT_SCHEMES:
            raise ValueError(f"Only {sorted(INIT_SCHEMES)} init supported, got {init_scheme}")
        self.model = model
        self.optimizer = optimizer
        self.lr_scheduler = lr_scheduler
        self.tp_dist_tol = tp_dist_tol
        self.heatmap_threshold = heatmap_threshold
        self.decode = decode
        self.hough_grad_config = hough_grad_config or {}
        self.device = next(model.parameters()).device
        super().__init__(
            model_name=model_name or type(model).__name__,
            config_path=config_path,
            lr_schedule_interval=lr_schedule_interval,
            num_keypoints=None,
        )
        if init_scheme:
            INIT_SCHEMES[init_scheme](model, torch.Generator().manual_seed(seed))
        logger.info(f"Number of model parameters: {sum(p.numel() for p in model.parameters())}")
        if checkpoint_path:
            self.load_checkpoint(checkpoint_path)

    # ----------------------------------------------------------- manifest
    def _manifest(self, snapshot: bool) -> Dict[str, Any]:
        manifest: Dict[str, Any] = {"LAST_EPOCH": self.last_epoch,
                                    "NETWORK_PARAMS": state_dict_to_flax(self.model.state_dict())}
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
    @staticmethod
    def _inputs(frames: torch.Tensor) -> torch.Tensor:
        """NHWC frames (uint8 divided by 255 here) as NCHW."""
        x = normalize_images(frames) if frames.dtype == torch.uint8 else frames
        return x.permute(0, 3, 1, 2)

    def train_step(self, frames: torch.Tensor, heatmaps: torch.Tensor) -> torch.Tensor:
        """One optimizer step; returns the loss on the device."""
        logits = self.model(self._inputs(frames))
        loss = tracknet_logits_loss(logits, heatmaps).mean()
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, frames: torch.Tensor, heatmaps: torch.Tensor,
                  model: Optional[nn.Module] = None):
        """(per-sample loss, argmax heatmaps, cx, cy, found) on the device;
        `model` (a deploy-form net) replaces the trained one."""
        logits = (model or self.model)(self._inputs(frames))
        loss = tracknet_logits_loss(logits, heatmaps).mean(dim=(1, 2))
        pred_hm = torch.argmax(logits, dim=1).to(torch.uint8)
        cx, cy, _, found = decode_heatmap_peaks(pred_hm, threshold=self.heatmap_threshold)
        return loss, pred_hm, cx, cy, found

    # ---------------------------------------------------------------- loop
    def current_lr(self) -> float:
        if self.lr_scheduler:
            return self.lr_scheduler.get_lr()
        return self.optimizer.param_groups[0]["lr"]

    def train(self, dataloader, verbose: bool = False,
              steps_per_epoch: Optional[int] = None) -> float:
        """One epoch (at most `steps_per_epoch` steps); returns the mean
        loss over its steps."""
        self.model.train()
        set_learning_rate(self.optimizer, self.current_lr())
        total, count = None, 0
        timer = StepTimer()
        for frames, heatmaps, _others in prefetch_to_device(dataloader, self.device):
            loss = self.train_step(frames, heatmaps)
            total = loss if total is None else total + loss
            timer.tick(frames.shape[0])
            count += 1
            if steps_per_epoch is not None and count >= steps_per_epoch:
                break
        loss = (total.item() if total is not None else 0.0) / max(count, 1)
        self._record("train", {"loss": loss, "images_per_sec": timer.images_per_sec}, verbose)
        if self.lr_scheduler and (self.last_epoch % self.lr_schedule_interval == 0):
            self._scheduler_step()
        self.last_epoch += 1
        return loss

    def evaluate(self, dataloader, verbose: bool = False,
                 model: Optional[nn.Module] = None) -> Dict[str, float]:
        """Eval loss and the f1 protocol over `dataloader`, scoring the
        leading len(dataset) rows of its batches (a wrap-padded tail's
        copies are left out; a loader without a dataset scores every row).
        `model` (a deploy-form net) replaces the trained one."""
        self.model.eval()
        counts = {k: np.zeros(4) for k in ("tp", "fp", "tn", "fn")}
        loss_sum, count, seen = 0.0, 0, 0
        n_total = len(getattr(dataloader, "dataset", ()) or ()) or None
        for frames, heatmaps, others in prefetch_to_device(dataloader, self.device):
            others = others.cpu().numpy()
            loss, pred_hm, cx, cy, found = self.eval_step(frames, heatmaps, model)
            n_valid = others.shape[0]
            if n_total is not None:
                n_valid = min(n_valid, max(n_total - seen, 0))
            seen += n_valid
            if n_valid == 0:
                continue
            loss_sum += float(loss[:n_valid].mean())
            count += 1
            if self.decode == "hough":
                circles = hough_decode(pred_hm.cpu().numpy(), self.heatmap_threshold,
                                       self.hough_grad_config)
                cx, cy, found = circles[:, 0], circles[:, 1], ~np.isnan(circles[:, 0])
            else:
                cx, cy, found = cx.cpu().numpy(), cy.cpu().numpy(), found.cpu().numpy()
            score_windows(counts, others[:n_valid], cx, cy, found, self.tp_dist_tol)
        metrics = dict(loss=loss_sum / max(count, 1), **f1_metrics(counts))
        self._record("eval", metrics, verbose)
        self._note_eval(metrics)
        if verbose:
            print("tp(vc0..3): {}  tn: {}  fp: {}  fn: {}".format(
                *(counts[k].astype(int) for k in ("tp", "tn", "fp", "fn"))))
        return metrics
