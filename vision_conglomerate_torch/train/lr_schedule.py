"""LR schedulers with torch.optim.lr_scheduler semantics, a copy of the JAX
package's train/lr_schedule.py (pure Python), so a JAX snapshot's
LR_SCHEDULER_PARAMS loads here and the other way round.

The schedulers are host-side objects that give one lr per epoch; the
trainer writes it into the optimizer's param_groups. They are not
torch.optim.lr_scheduler classes because the checkpoint format is the JAX
package's `state_dict` (the object's `__dict__`).

CosineAnnealingWarmRestarts as in torch: T_cur increments on each .step();
on reaching T_i it wraps and T_i *= T_mult;
lr = eta_min + (base - eta_min) * (1 + cos(pi * T_cur / T_i)) / 2.
"""
import math
from typing import Any, Dict, Optional


class LRScheduler:
    def __init__(self, base_lr: float):
        self.base_lr = base_lr

    def get_lr(self) -> float:
        raise NotImplementedError

    def step(self):
        raise NotImplementedError

    def state_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)

    def load_state_dict(self, state: Dict[str, Any]):
        self.__dict__.update(state)


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, base_lr: float, T_0: int, T_mult: int = 1, eta_min: float = 0.0):
        super().__init__(base_lr)
        assert T_0 > 0
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min
        self.T_cur = 0
        self.T_i = T_0

    def get_lr(self) -> float:
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.T_cur / self.T_i)) / 2

    def step(self):
        self.T_cur += 1
        if self.T_cur >= self.T_i:
            self.T_cur -= self.T_i
            self.T_i *= self.T_mult


class ConstantLR(LRScheduler):
    """torch ConstantLR: lr = base_lr * factor until total_iters epochs have
    elapsed, then base_lr (NOT a flat lr — torch's defaults give lr/3 for the
    first 5 epochs; use no lr_scheduler_config at all for a constant lr)."""

    def __init__(self, base_lr: float, factor: float = 1.0 / 3,
                 total_iters: int = 5):
        super().__init__(base_lr)
        self.factor = factor
        self.total_iters = total_iters
        self.epoch = 0

    def get_lr(self) -> float:
        return self.base_lr * (self.factor if self.epoch < self.total_iters else 1.0)

    def step(self):
        self.epoch += 1


class CyclicLR(LRScheduler):
    """torch CyclicLR: lr oscillates between the optimizer lr (cycle floor,
    = torch's base_lr argument) and max_lr, rising for step_size_up steps and
    falling for step_size_down. Amplitude scaling per mode: "triangular"
    (none), "triangular2" (halved each cycle), "exp_range" (gamma**t).
    torch steps this per batch; the trainers step per epoch, so configure the
    step sizes in scheduler-step units. Momentum cycling (torch's
    cycle_momentum) is not supported: only cycle_momentum=False."""

    def __init__(self, base_lr: float, max_lr: float, step_size_up: int = 2000,
                 step_size_down: Optional[int] = None, mode: str = "triangular",
                 gamma: float = 1.0, cycle_momentum: bool = False):
        super().__init__(base_lr)
        if mode not in ("triangular", "triangular2", "exp_range"):
            raise ValueError("mode must be triangular|triangular2|exp_range")
        if cycle_momentum:
            raise ValueError(
                "cycle_momentum=True cycles torch SGD momentum groups, which "
                "has no equivalent in this optimizer stack; set "
                "cycle_momentum: false in lr_scheduler_config")
        self.max_lr = max_lr
        self.step_size_up = float(step_size_up)
        self.step_size_down = float(step_size_down if step_size_down is not None
                                    else step_size_up)
        self.mode = mode
        self.gamma = gamma
        self.t = 0

    def get_lr(self) -> float:
        total = self.step_size_up + self.step_size_down
        cycle = math.floor(1 + self.t / total)
        x = 1.0 + self.t / total - cycle
        step_ratio = self.step_size_up / total
        if x <= step_ratio:
            scale = x / step_ratio
        else:
            scale = (x - 1.0) / (step_ratio - 1.0)
        amp = (self.max_lr - self.base_lr) * scale
        if self.mode == "triangular2":
            amp *= 1.0 / (2.0 ** (cycle - 1))
        elif self.mode == "exp_range":
            amp *= self.gamma ** self.t
        return self.base_lr + amp

    def step(self):
        self.t += 1


class StepLR(LRScheduler):
    def __init__(self, base_lr: float, step_size: int, gamma: float = 0.1):
        super().__init__(base_lr)
        self.step_size = step_size
        self.gamma = gamma
        self.epoch = 0

    def get_lr(self) -> float:
        return self.base_lr * self.gamma ** (self.epoch // self.step_size)

    def step(self):
        self.epoch += 1


class CosineAnnealingLR(LRScheduler):
    def __init__(self, base_lr: float, T_max: int, eta_min: float = 0.0):
        super().__init__(base_lr)
        self.T_max = T_max
        self.eta_min = eta_min
        self.epoch = 0

    def get_lr(self) -> float:
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.epoch / self.T_max)) / 2

    def step(self):
        self.epoch += 1


class ExponentialLR(LRScheduler):
    """torch ExponentialLR: lr = base_lr * gamma**epoch."""

    def __init__(self, base_lr: float, gamma: float):
        super().__init__(base_lr)
        self.gamma = gamma
        self.epoch = 0

    def get_lr(self) -> float:
        return self.base_lr * self.gamma ** self.epoch

    def step(self):
        self.epoch += 1


class MultiStepLR(LRScheduler):
    """torch MultiStepLR: lr = base_lr * gamma**(#milestones <= epoch)."""

    def __init__(self, base_lr: float, milestones, gamma: float = 0.1):
        super().__init__(base_lr)
        self.milestones = sorted(int(m) for m in milestones)
        self.gamma = gamma
        self.epoch = 0

    def get_lr(self) -> float:
        k = sum(1 for m in self.milestones if m <= self.epoch)
        return self.base_lr * self.gamma ** k

    def step(self):
        self.epoch += 1


class LinearLR(LRScheduler):
    """torch LinearLR: factor interpolates start_factor -> end_factor over
    total_iters steps, then stays at end_factor."""

    def __init__(self, base_lr: float, start_factor: float = 1.0 / 3,
                 end_factor: float = 1.0, total_iters: int = 5):
        super().__init__(base_lr)
        self.start_factor = start_factor
        self.end_factor = end_factor
        self.total_iters = total_iters
        self.epoch = 0

    def get_lr(self) -> float:
        t = min(self.epoch, self.total_iters) / self.total_iters
        return self.base_lr * (
            self.start_factor + (self.end_factor - self.start_factor) * t)

    def step(self):
        self.epoch += 1


class PolynomialLR(LRScheduler):
    """torch PolynomialLR: lr = base_lr * (1 - epoch/total_iters)**power,
    clamped at 0 once epoch reaches total_iters."""

    def __init__(self, base_lr: float, total_iters: int = 5, power: float = 1.0):
        super().__init__(base_lr)
        self.total_iters = total_iters
        self.power = power
        self.epoch = 0

    def get_lr(self) -> float:
        t = min(self.epoch, self.total_iters)
        return self.base_lr * (1.0 - t / self.total_iters) ** self.power

    def step(self):
        self.epoch += 1


class OneCycleLR(LRScheduler):
    """torch OneCycleLR (three_phase=False): warm up initial_lr -> max_lr over
    pct_start of total_steps, then anneal to max_lr/div_factor/final_div_factor.
    torch steps this per batch; the trainers step per epoch, so configure
    total_steps in scheduler-step units (epochs here). base_lr is ignored,
    exactly like torch ignores the optimizer lr (max_lr rules) — which also
    means the CLI's lr x n_devices DDP scaling does NOT apply here (torch
    behaves identically); scale max_lr in the config for multi-device runs."""

    def __init__(self, base_lr: float, max_lr: float, total_steps: int,
                 pct_start: float = 0.3, anneal_strategy: str = "cos",
                 div_factor: float = 25.0, final_div_factor: float = 1e4):
        super().__init__(base_lr)
        if anneal_strategy not in ("cos", "linear"):
            raise ValueError("anneal_strategy must be 'cos' or 'linear'")
        initial_lr = max_lr / div_factor
        min_lr = initial_lr / final_div_factor
        # mirror torch's phase table: end_step boundaries, start/end lrs
        self.phases = [
            (float(pct_start * total_steps) - 1, initial_lr, max_lr),
            (float(total_steps) - 1, max_lr, min_lr),
        ]
        self.anneal_strategy = anneal_strategy
        self.total_steps = total_steps
        self.t = 0

    def _anneal(self, start: float, end: float, pct: float) -> float:
        if self.anneal_strategy == "cos":
            return end + (start - end) / 2.0 * (1 + math.cos(math.pi * pct))
        return (end - start) * pct + start

    def get_lr(self) -> float:
        start_step = 0.0
        for end_step, start_lr, end_lr in self.phases:
            if self.t <= end_step or (end_step, start_lr, end_lr) == self.phases[-1]:
                pct = (self.t - start_step) / (end_step - start_step)
                return self._anneal(start_lr, end_lr, min(max(pct, 0.0), 1.0))
            start_step = end_step
        raise AssertionError("unreachable")

    def step(self):
        self.t += 1


class ReduceLROnPlateau(LRScheduler):
    """torch ReduceLROnPlateau: cut lr by `factor` after `patience` epochs
    without metric improvement. Its torch step() signature differs too —
    step(metric) — and the trainers feed it the latest eval metric named by
    `metric` (default aggregate_loss; "loss" for TrackNet runs). A None
    metric (no eval yet) is a no-op."""

    def __init__(self, base_lr: float, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4,
                 threshold_mode: str = "rel", cooldown: int = 0,
                 min_lr: float = 0.0, eps: float = 1e-8,
                 metric: str = "aggregate_loss"):
        super().__init__(base_lr)
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        if threshold_mode not in ("rel", "abs"):
            raise ValueError("threshold_mode must be 'rel' or 'abs'")
        self.lr = base_lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.eps = eps
        self.metric_key = metric
        self.best = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def _is_better(self, current: float, best: float) -> bool:
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return current < best * (1.0 - self.threshold)
            return current < best - self.threshold
        if self.threshold_mode == "rel":
            return current > best * (1.0 + self.threshold)
        return current > best + self.threshold

    def get_lr(self) -> float:
        return self.lr

    def step(self, metric=None):
        if metric is None:
            return
        current = float(metric)
        if self.best is None or self._is_better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if self.lr - new_lr > self.eps:
                self.lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0


SCHEDULERS = {
    "CosineAnnealingWarmRestarts": CosineAnnealingWarmRestarts,
    "CosineAnnealingLR": CosineAnnealingLR,
    "StepLR": StepLR,
    "ConstantLR": ConstantLR,
    "CyclicLR": CyclicLR,
    "ExponentialLR": ExponentialLR,
    "MultiStepLR": MultiStepLR,
    "LinearLR": LinearLR,
    "PolynomialLR": PolynomialLR,
    "OneCycleLR": OneCycleLR,
    "ReduceLROnPlateau": ReduceLROnPlateau,
}


def make_lr_scheduler(config: Optional[Dict[str, Any]], base_lr: float) -> Optional[LRScheduler]:
    """Resolve by the reference's config convention (name + kwargs)."""
    if not config:
        return None
    cfg = dict(config)
    name = cfg.pop("name")
    if name not in SCHEDULERS:
        raise KeyError(f"Unknown lr scheduler {name!r}; available: {sorted(SCHEDULERS)}")
    # torch CyclicLR configs carry their own mandatory base_lr kwarg (the
    # cycle floor, overriding the optimizer lr — torch does the same); pop it
    # ONLY for CyclicLR so it doesn't collide with the positional base_lr.
    # For every other scheduler a config-level base_lr falls through to the
    # constructor and raises TypeError, exactly like torch's reflection path —
    # silently overriding the (device-scaled) optimizer lr would de-scale a
    # DDP run with no error.
    if name == "CyclicLR":
        base_lr = float(cfg.pop("base_lr", base_lr))
    return SCHEDULERS[name](base_lr, **cfg)
