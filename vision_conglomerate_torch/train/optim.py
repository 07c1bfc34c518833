"""Optimizers from the config block, as the JAX package's train/optim.py
names them. Ten are the torch.optim classes whose semantics the JAX
package reproduces with optax; RMSprop is the port's own `RMSprop` below,
because the JAX package builds optax.rmsprop, which differs from torch's.

`optimizer_config` is {name, lr, and the class's own keywords}; keys the
class does not take are ignored, as in the JAX package, and AdamW's
weight_decay defaults to 0 there, so it does here too. The lr is set per
epoch through `param_groups` (`set_learning_rate`).

Anchors (`{sm,md,lg}_anchors`): with train_anchors=False they stay out of
the optimizer, so nothing ever changes them. With True they are in it, so
a non-zero weight_decay decays them, as optax does. The loss detaches them
and torch skips a parameter whose .grad is None, so `fill_missing_grads`
gives every parameter of the optimizer a zero gradient before the step.

`load_optax_state` carries a JAX snapshot's optimizer state into any of
the eleven.
"""
import inspect
from typing import Any, Dict, Iterator, Tuple

import torch
import torch.nn as nn

from ..weights import flax_to_state_dict

ANCHOR_PARAM_NAMES = ("sm_anchors", "md_anchors", "lg_anchors")


class RMSprop(torch.optim.Optimizer):
    """The JAX package's RMSprop, optax.rmsprop(lr, decay=alpha, eps,
    momentum): nu = alpha nu + (1 - alpha) g^2, u = -lr g / sqrt(nu + eps)
    (eps inside the root), and with a non-zero momentum optax's trace over
    u, trace = momentum trace + u; then p += u (or the trace). torch's
    RMSprop puts eps outside the root and applies weight_decay and
    centered; the JAX package reads neither, so they are taken here and
    ignored. The state keeps optax's names, `nu` and `trace`."""

    def __init__(self, params, lr: float = 1e-2, alpha: float = 0.99, eps: float = 1e-8,
                 weight_decay: float = 0.0, momentum: float = 0.0, centered: bool = False):
        del weight_decay, centered  # ignored, as in the JAX package
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps, momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            alpha, eps, momentum, lr = (group[k] for k in ("alpha", "eps", "momentum", "lr"))
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                    if momentum:
                        state["trace"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(alpha).addcmul_(g, g, value=1 - alpha)
                update = g / (nu + eps).sqrt() * -lr
                if momentum:
                    update = state["trace"].mul_(momentum).add_(update)
                p.add_(update)
        return loss


OPTIMIZERS = {
    name: RMSprop if name == "RMSprop" else getattr(torch.optim, name)
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
    `train.checkpoint.load_checkpoint` as plain tuples of their fields, in
    order) of one class."""
    if type(tree).__name__ == class_name:
        yield tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for node in tree:
            yield from _find_state(node, class_name)


def _one_state(opt_state: Any, class_name: str, optimizer_name: str) -> Any:
    found = list(_find_state(opt_state, class_name))
    if len(found) != 1:
        raise ValueError(
            f"resuming {optimizer_name}: the JAX snapshot's optimizer state holds "
            f"{len(found)} {class_name} nodes, not one (the state of another optimizer?)")
    return found[0]


# Per torch optimizer: the optax state node that holds its per-parameter
# slots (the JAX package's make_optimizer builds each one), and which field
# of that node (by position) fills each torch slot. The update count comes
# from inject_hyperparams' `count`, the node's own count where it has one
# being the same number.
RESUME_SLOTS = {
    "Adam": ("ScaleByAdamState", {"exp_avg": 1, "exp_avg_sq": 2}),  # (count, mu, nu)
    "AdamW": ("ScaleByAdamState", {"exp_avg": 1, "exp_avg_sq": 2}),
    "RAdam": ("ScaleByAdamState", {"exp_avg": 1, "exp_avg_sq": 2}),
    # optax's adamax keeps the infinity norm in nu; torch's exp_inf also
    # holds its eps (max(b2 u, |g| + eps)), a drift of order eps
    "Adamax": ("ScaleByAdamState", {"exp_avg": 1, "exp_inf": 2}),
    "NAdam": ("NAdamState", {"exp_avg": 2, "exp_avg_sq": 3}),  # (count, mu_product, m, v)
    "SGD": ("TraceState", {"momentum_buffer": 0}),  # (trace,)
    "Adadelta": ("ScaleByAdaDeltaState", {"square_avg": 0, "acc_delta": 1}),  # (e_g, e_x)
    "RMSprop": ("ScaleByRmsState", {"nu": 0}),  # (nu,); the momentum trace below
    "Adagrad": ("ScaleByRssState", {"sum": 0}),  # (sum_of_squares,)
    "Rprop": ("RpropState", {"step_size": 1, "prev": 2}),  # (count, step_sizes, prev_grad)
    "ASGD": ("ASGDState", {}),  # (count, eta): no per-parameter slot
}


def _optax_count(opt_state: Any) -> float:
    """The update count of an optax inject_hyperparams state (its first
    field, `count`); the JAX package's make_optimizer always wraps in one."""
    for name in ("InjectStatefulHyperparamsState", "InjectHyperparamsState"):
        found = list(_find_state(opt_state, name))
        if len(found) == 1:
            return float(found[0][0])
    raise ValueError("the JAX snapshot's optimizer state has no inject_hyperparams count: "
                     "it was not built by the JAX package's make_optimizer")


def load_optax_state(optimizer: torch.optim.Optimizer, model: nn.Module, opt_state: Any):
    """Carry a JAX snapshot's optimizer state into the torch optimizer over
    `model`, for each of the JAX package's eleven optimizers
    (`RESUME_SLOTS`): the slots of the optax node, mapped by parameter name
    (`weights.flax_to_state_dict`, in each parameter's dtype), and `step` =
    the update count. The scalars that are not per parameter: NAdam's
    mu_product; ASGD's eta, with torch's mu = 1 / max(1, step - t0) and its
    Polyak average `ax` restarted at the parameters (optax keeps none; it
    never moves the iterate). RMSprop's momentum trace comes from optax's
    TraceState. A state of zero updates leaves the fresh optimizer as it
    is: torch then seeds Rprop's step sizes and ASGD's eta from the lr, as
    the JAX package does at count 0. A state that is not this optimizer's
    raises ValueError. The anchors that train_anchors=False keeps out of
    the optimizer are skipped."""
    name = next((n for n, cls in OPTIMIZERS.items() if type(optimizer) is cls), None)
    if name is None:
        raise ValueError(f"no JAX optimizer state maps onto {type(optimizer).__name__}")
    node_name, fields = RESUME_SLOTS[name]
    node = _one_state(opt_state, node_name, name)
    count = _optax_count(opt_state)
    if count == 0:
        return
    slots = {k: node[i] for k, i in fields.items()}
    if name == "RMSprop" and any(g["momentum"] for g in optimizer.param_groups):
        slots["trace"] = _one_state(opt_state, "TraceState", name)[0]
    slots = {k: flax_to_state_dict({"params": v}, dtype=None) for k, v in slots.items()}
    names = {id(p): n for n, p in model.named_parameters()}
    for group in optimizer.param_groups:
        for p in group["params"]:
            n = names[id(p)]
            state = {k: v[n].to(p.device, p.dtype) for k, v in slots.items()}
            if name != "RMSprop":
                # torch keeps `step` on the host (ASGD: beside the parameter)
                state["step"] = torch.tensor(count, dtype=torch.float32,
                                             device=p.device if name == "ASGD" else None)
            if name == "NAdam":
                state["mu_product"] = torch.tensor(float(node[1]), dtype=torch.float32)
            elif name == "ASGD":
                state["eta"] = torch.tensor(float(node[1]), dtype=torch.float32, device=p.device)
                state["mu"] = torch.tensor(1.0 / max(1.0, count - group["t0"]),
                                           dtype=torch.float32, device=p.device)
                state["ax"] = p.detach().clone()
            optimizer.state[p] = state
