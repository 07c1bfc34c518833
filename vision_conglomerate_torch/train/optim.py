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


def _optax_count(opt_state: Any) -> float:
    """The update count of an optax inject_hyperparams state (its first
    field, `count`)."""
    for name in ("InjectStatefulHyperparamsState", "InjectHyperparamsState"):
        found = list(_find_state(opt_state, name))
        if len(found) == 1:
            return float(found[0][0])
    raise NotImplementedError("a JAX snapshot's optimizer state without inject_hyperparams' "
                              "count is not read by the port (ROADMAP §A.8)")


def load_optax_state(optimizer: torch.optim.Optimizer, model: nn.Module, opt_state: Any):
    """Carry a JAX snapshot's optimizer state into the torch optimizer over
    `model`:
    - Adam (optax ScaleByAdamState: count, mu, nu): mu -> exp_avg, nu ->
      exp_avg_sq, count -> step;
    - Adadelta (optax ScaleByAdaDeltaState: e_g, e_x): e_g -> square_avg,
      e_x -> acc_delta, inject_hyperparams' count -> step. torch's Adadelta
      update is optax's: e_g = rho e_g + (1 - rho) g^2, delta = g sqrt(e_x
      + eps) / sqrt(e_g + eps), e_x = rho e_x + (1 - rho) delta^2, p -= lr
      delta, with the weight decay added to g first in both.
    The state of any other optimizer raises."""
    kind = type(optimizer)
    if kind is torch.optim.Adam:
        found = list(_find_state(opt_state, "ScaleByAdamState"))
        if len(found) == 1:
            count, mu, nu = found[0]
            slots = {"exp_avg": mu, "exp_avg_sq": nu}
    elif kind is torch.optim.Adadelta:
        found = list(_find_state(opt_state, "ScaleByAdaDeltaState"))
        if len(found) == 1:
            count = _optax_count(opt_state)
            slots = {"square_avg": found[0][0], "acc_delta": found[0][1]}
    else:
        found = []
    if len(found) != 1:
        raise NotImplementedError(
            f"resuming {kind.__name__} from a JAX snapshot's optimizer state is not "
            "in the port (ROADMAP §A.8); only Adam and Adadelta carry over")
    slots = {k: flax_to_state_dict({"params": v}) for k, v in slots.items()}
    names = {id(p): n for n, p in model.named_parameters()}
    for group in optimizer.param_groups:
        for p in group["params"]:
            n = names[id(p)]
            optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                **{k: v[n].to(p.device, p.dtype) for k, v in slots.items()},
            }
