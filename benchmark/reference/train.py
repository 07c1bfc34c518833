"""The first steps of TrackNet training in plain float32 PyTorch.

A step: uint8 frames / 255, the train-mode forward (BatchNorm on the batch
statistics of each shard), the mean softmax cross entropy over every
pixel of the 256-way intensity classification, the backward, the
gradients averaged over the shards, then `torch.optim.Adadelta`. With one
shard this is the single-device step; with n it is data parallelism over
n devices, each normalising with its own shard's statistics.

`fp8` puts the control in the program's place: every conv computes as
float8 training does (input and weight in e4m3, gradients in e5m2, each
with a per-tensor scale; `layers.Numerics`). `bf16` puts a witness there:
the convs compute in bfloat16, BatchNorm, the parameters and the loss in
float32, as in the program's bf16 training (`layers.Numerics`). `fault` plants a fault of the timed path:
"half_batch" steps on the first half of each shard's rows, "no_exchange"
steps on shard 0's gradient alone.
"""
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .layers import bf16_convs, fp8_convs


def pixel_loss(logits: torch.Tensor, heatmaps: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=1)
    return -logp.gather(1, heatmaps.long()[:, None])[:, 0].mean()


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def first_steps(model: torch.nn.Module, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                optimizer: Dict[str, float], shards: int = 1, fp8: bool = False,
                bf16: bool = False, fault: Optional[str] = None) -> Dict[str, object]:
    """Run len(batches) steps from the model's weights. Returns the loss of
    each step, each leaf's gradient norm at step 1 and each leaf's change
    after the last step."""
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = torch.optim.Adadelta(model.parameters(), lr=optimizer["lr"], rho=optimizer["rho"],
                               eps=optimizer["eps"], weight_decay=optimizer["weight_decay"])
    model.train()
    losses: List[float] = []
    grads: Dict[str, float] = {}
    numerics = fp8_convs() if fp8 else bf16_convs() if bf16 else nullcontext()
    with numerics:
        for step, (frames, heatmaps) in enumerate(batches):
            opt.zero_grad(set_to_none=True)
            total = 0.0
            for r, (f, h) in enumerate(zip(frames.chunk(shards), heatmaps.chunk(shards))):
                if fault == "half_batch":
                    f, h = f[:f.shape[0] // 2], h[:h.shape[0] // 2]
                x = f.float().div(255.0).permute(0, 3, 1, 2).contiguous()
                loss = pixel_loss(model(x), h)
                if fault == "no_exchange":
                    if r == 0:
                        loss.backward()
                else:
                    (loss / shards).backward()
                total += float(loss.detach()) / shards
            losses.append(total)
            if step == 0:
                grads = leaf_norms({k: p.grad for k, p in params.items() if p.grad is not None})
            opt.step()
    change = leaf_norms({k: params[k].detach() - start[k] for k in params})
    return {"losses": losses, "grad": grads, "change": change}
