"""Segmentation training on one device, the JAX package's
train/segmentation_trainer.py in PyTorch.

As detection (`TrainDetectionPipeline`), but a batch is (imgs, labels,
label_mask, target_masks), the net also returns protos, and the loss is
`segmentation_loss`. There is no random flip: the JAX seg trainer's loss
skips it, so this trainer takes no `hflip_prob`. The "random" cap policy
draws from the trainer's own generator, seeded from `seed`, a fresh draw
each step; an eval step draws from a generator seeded with `seed` anew, so
evaluation is repeatable.
"""
from typing import Dict, Optional

import torch

from ..losses import SegmentationLossConfig, segmentation_loss
from ..models import SegmentationNet
from .detection_trainer import TrainDetectionPipeline
from .lr_schedule import LRScheduler
from .optim import fill_missing_grads


class TrainSegmentationPipeline(TrainDetectionPipeline):
    task = "segmentation"

    def __init__(
        self,
        model: SegmentationNet,
        loss_cfg: SegmentationLossConfig,
        optimizer: torch.optim.Optimizer,
        lr_scheduler: Optional[LRScheduler] = None,
        lr_schedule_interval: int = 1,
        model_name: Optional[str] = None,
        checkpoint_path: Optional[str] = None,
        config_path: Optional[str] = None,
        seed: int = 42,
        init_scheme: Optional[str] = "xavier",
    ):
        super().__init__(model, loss_cfg, optimizer, lr_scheduler=lr_scheduler,
                         lr_schedule_interval=lr_schedule_interval, model_name=model_name,
                         checkpoint_path=checkpoint_path, config_path=config_path, seed=seed,
                         init_scheme=init_scheme)
        self.seed = seed
        self.cap_generator = torch.Generator(device=self.device).manual_seed(seed)

    def train_step(self, imgs, labels, mask, target_masks) -> Dict[str, torch.Tensor]:
        preds, protos = self.model(self._inputs(imgs).permute(0, 3, 1, 2))
        loss, metrics = segmentation_loss(preds, labels, mask, protos, target_masks,
                                          self._anchors(), self.loss_cfg,
                                          generator=self.cap_generator)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        fill_missing_grads(self.optimizer)
        self.optimizer.step()
        return metrics

    @torch.no_grad()
    def eval_step(self, imgs, labels, mask, target_masks, image_mask) -> Dict[str, torch.Tensor]:
        preds, protos = self.model(self._inputs(imgs).permute(0, 3, 1, 2))
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        return segmentation_loss(preds, labels, mask, protos, target_masks, self._anchors(),
                                 self.loss_cfg, generator=generator, image_mask=image_mask)[1]
