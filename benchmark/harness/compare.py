"""The numbers that decide `correct`, each held to its limit.

Every number is a gap between what the timed path produced and what the
plain float32 reference (benchmark/reference) makes of the same seeded
weights and inputs, so 0 is perfect and a limit is the most a sound run
may read. The limits of a cell are in `benchmark/limits/<cell>.json`;
PERF.md gives the readings each was set from.

Serving TrackNet, on a sample of the windows served:
- heatmap_gap: the widest gap, over every pixel, by which the reference's
  logit of the class the served heatmap took lies below the reference's
  best logit, in units of the reference logits' standard deviation. The
  served answer is the heatmap with its track: where a served track lies
  more than TRACK_TOL_PX from the one the reference's tail (antialiased
  resize, centroid) makes of the served classes, the gap reads inf.

Training, over the first three steps (the reference follows them):
- loss_gap: the widest relative gap of a step's loss;
- loss1_gap: the first step's (steady where the later steps' chaos sets
  the widest: data parallelism's lr of 4 amplifies bf16 rounding through
  Adadelta's near-sign steps);
- grad_gap: the worst leaf's gap between the norms of its first gradient
  (the program's as its optimizer got it, read from the optimizer's state
  after step 1), against the reference's norm of that leaf or of the
  median leaf, whichever is larger;
- grad_median_gap: the median over the leaves of that gap of the first
  gradient: steady from seed to seed where the worst leaf is one small
  BatchNorm leaf's noise, and what a step on other rows (half the batch,
  or one rank's shard without the exchange) moves on every leaf;
- update_gap: the worst leaf's gap of its change after step 3.
The three count only the leaves whose reference gradient is at least a thousandth
of the median leaf's: a conv bias under a BatchNorm has a gradient of
nought (the normalisation takes out the very mean the bias adds), so its
gradient and its moves are round-off on both sides.
"""
import math
import statistics
from typing import Dict, List, Tuple

import torch

# f32 sums over a 1280x720 heatmap on the card against f64 ones: at most
# 8.1e-5 px over 12 seeds (PERF.md)
TRACK_TOL_PX = 1e-3


def finite_max(values, empty: float = math.inf) -> float:
    vals = list(values)
    if not vals:
        return empty
    return max(v if math.isfinite(v) else math.inf for v in vals)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys: List[str]) -> List[float]:
    """Each leaf's gap of norms, against the reference's norm of that leaf
    or of the median leaf, whichever is larger; a missing leaf reads inf."""
    med = statistics.median(ref[k] for k in keys)
    return [abs(prog.get(k, math.inf) - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keys: List[str]) -> float:
    return finite_max(leaf_gaps(prog, ref, keys)) if keys else math.inf


def worst_leaves(prog: Dict[str, float], ref: Dict[str, float], keys: List[str], n: int = 3
                 ) -> List[list]:
    """The n leaves with the widest gaps: [name, gap, program, reference]."""
    med = statistics.median(ref[k] for k in keys)
    gaps = [[k, abs(prog.get(k, math.inf) - ref[k]) / max(ref[k], med, 1e-30),
             prog.get(k), ref[k]] for k in keys]
    return sorted(gaps, key=lambda g: -g[1])[:n]


def train_look(prog: Dict[str, object], ref: Dict[str, object]) -> Dict[str, object]:
    rg = ref["grad"]
    med = statistics.median(rg.values())
    moving = sorted(k for k in rg if rg[k] >= 1e-3 * med)
    return {"grad": worst_leaves(prog["grad"], rg, moving),
            "update": worst_leaves(prog["change"], ref["change"], moving),
            "left_out": len(rg) - len(moving), "losses": [prog["losses"], ref["losses"]]}


def train_numbers(prog: Dict[str, object], ref: Dict[str, object]) -> Dict[str, float]:
    pl, rl = prog["losses"], ref["losses"]
    loss_gap = finite_max(abs(a - b) / abs(b) for a, b in zip(pl, rl)) \
        if len(pl) == len(rl) else math.inf
    rg = ref["grad"]
    med = statistics.median(rg.values())
    moving = sorted(k for k in rg if rg[k] >= 1e-3 * med)
    grad_gap = leaf_gap(prog["grad"], rg, moving)
    grad_median_gap = statistics.median(leaf_gaps(prog["grad"], rg, moving)) if moving \
        else math.inf
    update_gap = leaf_gap(prog["change"], ref["change"], moving)
    loss1_gap = abs(pl[0] - rl[0]) / abs(rl[0]) if pl and rl else math.inf
    return {"loss_gap": loss_gap, "loss1_gap": loss1_gap, "grad_gap": grad_gap,
            "grad_median_gap": grad_median_gap, "update_gap": update_gap}


def heatmap_numbers(ref_logits: List[torch.Tensor], served_classes: List[torch.Tensor]
                    ) -> float:
    """heatmap_gap over (256, H, W) reference logits and (H, W) served
    classes; a missing answer reads inf."""
    worst = 0.0
    for logits, cls in zip(ref_logits, served_classes):
        if cls is None or cls.shape != logits.shape[1:]:
            return math.inf
        best = logits.max(dim=0).values
        took = logits.gather(0, cls.long()[None])[0]
        worst = max(worst, float((best - took).max()) / float(logits.std()))
    return worst


def track_gap(served: List[torch.Tensor], ref: List[torch.Tensor]) -> float:
    worst = 0.0
    for a, b in zip(served, ref):
        if a is None:
            return math.inf
        a, b = a.double().flatten(), b.double().flatten()
        if bool((a.isnan() != b.isnan()).any()):
            return math.inf
        both = ~a.isnan()
        if bool(both.any()):
            worst = max(worst, float((a[both] - b[both]).abs().max()))
    return worst


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, list]]:
    """(correct, {name: [number, limit]}) over the numbers the cell's limits
    name (a cell compares the numbers that separate its readings; PERF.md):
    correct when each is finite and at most its limit; a named number the
    check did not give fails."""
    checks = {k: [numbers.get(k, math.inf), lim] for k, lim in limits.items()}
    ok = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    return ok, checks
