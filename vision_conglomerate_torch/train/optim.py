"""Optimizers from the config block, as the JAX package's train/optim.py
names them, built as the torch.optim classes whose semantics the JAX
package reproduces with optax.

`optimizer_config` is {name, lr, and the class's own keywords}; keys the
class does not take are ignored, as in the JAX package, and AdamW's
weight_decay defaults to 0 there, so it does here too. The lr is set per
epoch through `param_groups` (`set_learning_rate`).

Anchors (`{sm,md,lg}_anchors`): with train_anchors=False they stay out of
the optimizer, so nothing ever changes them. With True they are in it, so
a non-zero weight_decay decays them, as optax does. The loss detaches them
and torch skips a parameter whose .grad is None, so `fill_missing_grads`
gives every parameter of the optimizer a zero gradient before the step.
"""
import inspect
from typing import Any, Dict, Iterator, Tuple

import torch
import torch.nn as nn

from ..weights import flax_to_state_dict

ANCHOR_PARAM_NAMES = ("sm_anchors", "md_anchors", "lg_anchors")

OPTIMIZERS = {
    name: getattr(torch.optim, name)
    for name in ("Adam", "AdamW", "SGD", "Adadelta", "RMSprop", "NAdam", "RAdam",
                 "Adamax", "Adagrad", "Rprop", "ASGD")
}


def make_optimizer(config: Dict[str, Any], model: nn.Module,
                   train_anchors: bool = True) -> Tuple[torch.optim.Optimizer, float]:
    """(optimizer over the model's parameters, base lr) from an
    optimizer_config block."""
    cfg = dict(config)
    name = cfg.pop("name", "Adam")
    lr = float(cfg.pop("lr", 1e-3))
    if name not in OPTIMIZERS:
        raise KeyError(f"Unknown optimizer {name!r}; supported: {', '.join(OPTIMIZERS)}")
    cls = OPTIMIZERS[name]
    accepted = inspect.signature(cls).parameters
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in cfg.items() if k in accepted and k not in ("params", "lr")}
    if name == "AdamW":
        kwargs.setdefault("weight_decay", 0.0)
    params = [p for n, p in model.named_parameters()
              if train_anchors or n not in ANCHOR_PARAM_NAMES]
    return cls(params, lr=lr, **kwargs), lr


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float):
    for group in optimizer.param_groups:
        group["lr"] = lr


def fill_missing_grads(optimizer: torch.optim.Optimizer):
    """A zero gradient for every parameter of the optimizer that got none
    (the detached anchors), so the step updates it as optax would."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def _find_state(tree: Any, class_name: str) -> Iterator[Any]:
    """Every node of a pickled optax state (its classes rebuilt by
    `train.checkpoint.load_checkpoint` as named tuples) of one class."""
    if type(tree).__name__ == class_name:
        yield tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for node in tree:
            yield from _find_state(node, class_name)


def load_optax_adam_state(optimizer: torch.optim.Optimizer, model: nn.Module, opt_state: Any):
    """Carry a JAX snapshot's Adam state (optax ScaleByAdamState: count, mu,
    nu) into a torch.optim.Adam over `model`: mu -> exp_avg, nu ->
    exp_avg_sq, count -> step. The state of any other optimizer raises."""
    found = list(_find_state(opt_state, "ScaleByAdamState"))
    if type(optimizer) is not torch.optim.Adam or len(found) != 1:
        raise NotImplementedError(
            f"resuming {type(optimizer).__name__} from a JAX snapshot's optimizer state is not "
            "in the port (ROADMAP §A.8); only Adam carries over")
    count, mu, nu = found[0]
    exp_avg = flax_to_state_dict({"params": mu})
    exp_avg_sq = flax_to_state_dict({"params": nu})
    names = {id(p): n for n, p in model.named_parameters()}
    for group in optimizer.param_groups:
        for p in group["params"]:
            n = names[id(p)]
            optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": exp_avg[n].to(p.device, p.dtype),
                "exp_avg_sq": exp_avg_sq[n].to(p.device, p.dtype),
            }
