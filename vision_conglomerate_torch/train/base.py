"""Trainer plumbing shared with the JAX package's train/base.py: artifact
paths, config copies with num_keypoints injected, checkpoint manifests,
metric history, CSVs and plots.

Public surface as in the JAX package: .train/.evaluate/.step (in the
subclass), .save_checkpoint/.save_best_model/.load_checkpoint,
.best_eval_loss, .metrics_to_csv/.save_metrics_plots. Artifacts:
metrics/<task>/{train,eval}_metrics.csv and *_metrics_plot.jpg,
saved_model/<task>/best_model/<Model>.ckpt.tar, and snapshots under
saved_model/<task>/checkpoints/<unix time>/, each with config/config.yaml.
Under data parallelism only the primary process (rank 0) writes them and
prints the epoch lines (`parallel.mesh.process_is_primary`); every rank
keeps the same history, since the metrics are combined over the ranks.
"""
import logging
import os
import time
from datetime import datetime
from typing import Any, Dict, List, Optional, Tuple

import pandas as pd
import torch

from ..parallel.mesh import (all_reduce_sum_, batchnorm_statistics, is_distributed,
                             process_is_primary, world_size)
from ..utils.plots import save_metric_plots
from ..utils.profiling import span
from ..utils.yaml_io import load_yaml, save_yaml
from .checkpoint import load_checkpoint as _load_ckpt
from .checkpoint import save_checkpoint as _save_ckpt

logger = logging.getLogger(__name__)

# The JAX package turns `model_config.remat` on at batch >= 32 when the
# config leaves it unset; the port keeps the rule.
REMAT_AUTO_BATCH = 32


def resolve_remat_default(model_config: Dict[str, Any], batch_size: int) -> Dict[str, Any]:
    """`model_config.remat` = batch_size >= 32 when the config leaves it
    unset (absent or null); an explicit true/false wins. Returns the config,
    so the saved copy records the decision."""
    if model_config.get("remat") is None:
        model_config["remat"] = bool(batch_size >= REMAT_AUTO_BATCH)
    return model_config


class BasePipeline:
    task = "detection"
    # the eval metric that picks the best model
    eval_loss_key = "aggregate_loss"

    def __init__(self, model_name: str, config_path: Optional[str] = None,
                 lr_schedule_interval: int = 1, num_keypoints: Optional[int] = None):
        self.model_name = model_name
        self.config_path = config_path
        self.lr_schedule_interval = lr_schedule_interval
        self.num_keypoints = num_keypoints
        self.last_epoch = 0
        self._train_metrics: List[Dict[str, float]] = []
        self._eval_metrics: List[Dict[str, float]] = []
        self.last_eval_metrics: Optional[Dict[str, float]] = None
        self._evals_seen = 0
        self._plateau_evals_consumed = 0
        self.metrics_dir = f"metrics/{self.task}"
        self.checkpoints_dir = os.path.join(
            f"saved_model/{self.task}/checkpoints", str(int(time.time())))
        self.best_model_dir = f"saved_model/{self.task}/best_model"
        if config_path:
            self._save_config_copy(config_path, to_checkpoint_dir=True)
            self._save_config_copy(config_path, to_checkpoint_dir=False)

    def _note_eval(self, metrics: Dict[str, float]):
        """Trainers call this once per completed eval pass; plateau
        scheduling keys off the eval COUNT, not the train-epoch count."""
        self.last_eval_metrics = metrics
        self._evals_seen += 1

    def _scheduler_step(self):
        """Advance the lr scheduler one epoch. ReduceLROnPlateau keeps its
        torch-style step(metric) signature and is stepped once per NEW eval
        (torch users call step(val_loss) once per validation) — re-feeding a
        stale metric on non-eval epochs would burn patience eval_interval
        times too fast."""
        sched = self.lr_scheduler
        key = getattr(sched, "metric_key", None)
        if key is None:
            sched.step()
            return
        if self._evals_seen == self._plateau_evals_consumed:
            return  # no eval since the last plateau step
        self._plateau_evals_consumed = self._evals_seen
        metric = (self.last_eval_metrics or {}).get(key)
        if metric is None:
            logger.warning(
                "ReduceLROnPlateau watches eval metric %r but the last eval "
                "produced %s — scheduler not stepped (set lr_scheduler_config."
                "metric to one of those names)", key,
                sorted(self.last_eval_metrics or {}))
            return
        sched.step(metric)

    # ------------------------------------------------- data parallelism
    def _sum_metrics(self) -> Tuple[str, ...]:
        """Metrics that are per-batch sums, not means: the ranks' values add
        up (the JAX package's psum); every other metric is averaged."""
        return ()

    def _sync_train_step(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Between the backward and the optimizer step, under data
        parallelism: the gradients and the BatchNorm running statistics
        averaged over the ranks (pmean of grads and of the new batch_stats
        in the JAX per-shard step) in one all-reduce, and the step's metrics
        averaged (sum-type ones summed) in another, in the span
        `train.sync`. Without a process group the metrics come back as they
        are."""
        if not is_distributed():
            return metrics
        with span("train.sync"):
            n = world_size()
            all_reduce_sum_([p.grad for g in self.optimizer.param_groups for p in g["params"]
                             if p.grad is not None] + batchnorm_statistics(self.model), 1.0 / n)
            sums = self._sum_metrics()
            vec = torch.stack([v.detach().float() / (1 if k in sums else n)
                               for k, v in metrics.items()])
            all_reduce_sum_([vec])
            return dict(zip(metrics, vec.unbind()))

    def _sync_eval_step(self, metrics: Dict[str, torch.Tensor],
                        n_valid: int) -> Dict[str, torch.Tensor]:
        """An eval step's metrics combined over the ranks, as the JAX
        package's `_combine_metrics` with a weight: each rank's means
        weighted by its count of valid (not wrap-padded) rows, sum over sum;
        sum-type metrics summed; a rank without valid rows adds nothing."""
        if not is_distributed():
            return metrics
        vals = torch.stack([v.detach().float() for v in metrics.values()])
        is_sum = torch.tensor([k in self._sum_metrics() for k in metrics], device=vals.device)
        w = float(n_valid)
        contrib = torch.where(is_sum, vals, vals * w) if w > 0 else torch.zeros_like(vals)
        vec = torch.cat([contrib, torch.tensor([w], device=vals.device)])
        all_reduce_sum_([vec])
        out = torch.where(is_sum, vec[:-1], vec[:-1] / vec[-1].clamp(min=1e-9))
        return dict(zip(metrics, out.unbind()))

    # ------------------------------------------------------------ manifest
    def _manifest(self, snapshot: bool) -> Dict[str, Any]:
        raise NotImplementedError

    def _restore(self, manifest: Dict[str, Any]):
        raise NotImplementedError

    def _save_config_copy(self, config_path: str, to_checkpoint_dir: bool):
        if not process_is_primary():
            return
        dest = os.path.join(
            self.checkpoints_dir if to_checkpoint_dir else self.best_model_dir, "config")
        config = load_yaml(config_path)
        if "model_config" in config:
            config["model_config"]["num_keypoints"] = self.num_keypoints
        os.makedirs(dest, exist_ok=True)
        save_yaml(config, os.path.join(dest, "config.yaml"),
                  sort_keys=False, default_flow_style=True)

    def save_best_model(self):
        if not process_is_primary():
            return
        path = os.path.join(self.best_model_dir, f"{self.model_name}.ckpt.tar")
        _save_ckpt(path, self._manifest(snapshot=False))

    def save_checkpoint(self):
        if not process_is_primary():
            return
        stamp = str(datetime.now()).replace(":", "-")
        path = os.path.join(
            self.checkpoints_dir, f"{self.model_name}-{self.last_epoch}-{stamp}.ckpt.tar")
        _save_ckpt(path, self._manifest(snapshot=True))

    def load_checkpoint(self, path: str) -> Dict[str, Any]:
        manifest = _load_ckpt(path)
        self._restore(manifest)
        # a JAX snapshot pickles it as a 0-d numpy array, which `+= 1`
        # would then change in place
        self.last_epoch = int(manifest["LAST_EPOCH"])
        metrics = manifest.get("METRICS", {})
        self._train_metrics = list(metrics.get("TRAIN", []))
        self._eval_metrics = list(metrics.get("EVAL", []))
        return manifest

    def best_eval_loss(self) -> float:
        """Lowest eval loss (`eval_loss_key`) recorded so far, including
        history restored by load_checkpoint. The train CLI seeds its best-model tracking from
        this, so a resumed run cannot overwrite a better best_model/ with
        its first eval after the resume."""
        key = self.eval_loss_key
        vals = [m[key] for m in self._eval_metrics
                if key in m and m[key] == m[key]]
        return min(vals) if vals else float("inf")

    # ------------------------------------------------------------ metrics IO
    def _record(self, mode: str, metrics: Dict[str, float], verbose: bool):
        getattr(self, f"_{mode}_metrics").append(metrics)
        if verbose and process_is_primary():
            print(f"[{mode.title()}]: " + "\t".join(
                f"{k.replace('_', ' ')}: {v :.4f}" for k, v in metrics.items()))

    def annotate_last(self, mode: str, extra: Dict[str, float]):
        """Merge extra metrics (the --map_eval hook's mAP@50) into the most
        recent epoch record, so they reach the CSVs and plots."""
        history = getattr(self, f"_{mode}_metrics")
        if history:
            history[-1].update(extra)

    def metrics_to_csv(self):
        if not process_is_primary():
            return
        os.makedirs(self.metrics_dir, exist_ok=True)
        pd.DataFrame(self._train_metrics).to_csv(
            os.path.join(self.metrics_dir, "train_metrics.csv"), index=False)
        pd.DataFrame(self._eval_metrics).to_csv(
            os.path.join(self.metrics_dir, "eval_metrics.csv"), index=False)

    def save_metrics_plots(self):
        """metrics/<task>/{train,eval}_metrics_plot.jpg: each metric against
        the epoch (drawn with PIL, `utils.plots`)."""
        if not process_is_primary():
            return
        os.makedirs(self.metrics_dir, exist_ok=True)
        for mode in ("train", "eval"):
            history = getattr(self, f"_{mode}_metrics")
            if history:
                df = pd.DataFrame(history)
                save_metric_plots({c: df[c].to_numpy() for c in df.columns},
                                  os.path.join(self.metrics_dir, f"{mode}_metrics_plot.jpg"),
                                  mode.title())
