"""The port's optimizers against the JAX package's, at f64 on the CPU:
RMSprop's trajectory (the port follows optax.rmsprop, as the JAX package
does), and resuming each of the eleven optimizers from a JAX snapshot.

A resume case: the JAX package's make_optimizer takes K steps on a small
parameter tree (a conv's kernel and bias, and anchors that get no
gradient, as the detection loss detaches them), its checkpoint writer
saves the snapshot, the port reads it with `train.checkpoint.load_checkpoint`
and `train.optim.load_optax_state`, and both packages take N more steps on
the same gradients. Tolerances per case, on the parameters after every
step: 1e-9 where the two updates are one formula in another op order (the
f64 steps here drift by ~1e-15); tests/test_optim_schedulers.py's for
Adamax (1e-5: torch adds eps inside the infinity norm, optax to the
denominator), Rprop (1e-12) and ASGD (1e-7: torch keeps eta in f32).
Two differ from that file's, which hold them on a toy of three values
near 1: RAdam 1e-7 (one of the 72 kernel values read 1.3e-8 once the
rectified steps begin, past the toy's 1e-8), and
Adagrad 1e-6 (torch adds eps outside the root, optax inside; on the
anchors, whose gradient is the weight decay alone, ~3e-3, that moves
each step by ~1e-8; read 1.2e-7 after 5 steps).
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
import torch.nn as nn

from vision_conglomerate_tpu.train import checkpoint as jax_checkpoint
from vision_conglomerate_tpu.train.optim import make_optimizer as jax_make_optimizer

from vision_conglomerate_torch.train.checkpoint import load_checkpoint
from vision_conglomerate_torch.train.optim import (
    RMSprop, fill_missing_grads, load_optax_state, make_optimizer)
from vision_conglomerate_torch.weights import flax_to_state_dict, state_dict_to_flax

QUAD_TARGET = np.asarray([0.3, -1.2, 2.4], np.float64)
W0 = np.asarray([1.5, -2.0, 3.0], np.float64)


def _port_traj(cfg, steps=20):
    module = nn.Module()
    module.w = nn.Parameter(torch.tensor(W0, dtype=torch.float64))
    opt, _ = make_optimizer(cfg, module)
    t = torch.tensor(QUAD_TARGET, dtype=torch.float64)
    traj = []
    for _ in range(steps):
        opt.zero_grad()
        (0.5 * ((module.w - t) ** 2).sum()).backward()
        opt.step()
        traj.append(module.w.detach().numpy().copy())
    return np.stack(traj)


def _jax_traj(cfg, steps=20):
    with jax.enable_x64(True):
        tx, _ = jax_make_optimizer(cfg)
        w, t = jnp.asarray(W0), jnp.asarray(QUAD_TARGET)
        state = tx.init(w)
        traj = []
        for _ in range(steps):
            updates, state = tx.update(w - t, state, w)
            w = optax.apply_updates(w, updates)
            traj.append(np.asarray(w, np.float64))
    return np.stack(traj)


@pytest.mark.parametrize("cfg", [
    {"lr": 1e-2},
    {"lr": 1e-2, "momentum": 0.9},
    # the JAX package reads no weight_decay (nor centered) for RMSprop;
    # torch.optim.RMSprop was 0.83 away from it here after 20 steps
    {"lr": 1e-2, "weight_decay": 0.1},
    {"lr": 3e-3, "alpha": 0.9, "eps": 1e-6, "momentum": 0.5, "centered": True},
], ids=["plain", "momentum", "weight_decay", "alpha_eps_centered"])
def test_rmsprop_matches_jax(cfg):
    cfg = {"name": "RMSprop", **cfg}
    got, want = _port_traj(cfg), _jax_traj(cfg)
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    assert np.abs(got[-1] - W0).max() > 1e-2  # it moved


def test_rmsprop_keeps_optax_state_names():
    module = nn.Module()
    module.w = nn.Parameter(torch.ones(3))
    for momentum, keys in ((0.0, ["nu"]), (0.9, ["nu", "trace"])):
        opt, _ = make_optimizer({"name": "RMSprop", "lr": 0.1, "momentum": momentum}, module)
        assert isinstance(opt, RMSprop)
        module.w.grad = torch.ones(3)
        opt.step()
        assert sorted(opt.state[module.w]) == keys


# ------------------------------------------------------------------ resume

K_STEPS, N_STEPS = 3, 5

RESUME_CASES = {
    "Adam": ({"lr": 0.05}, 1e-9),
    "Adam_wd": ({"name": "Adam", "lr": 0.05, "weight_decay": 0.01, "betas": [0.8, 0.99]}, 1e-9),
    "AdamW": ({"lr": 0.05, "weight_decay": 0.1}, 1e-9),
    "SGD": ({"lr": 0.05}, 1e-9),
    "SGD_momentum": ({"name": "SGD", "lr": 0.05, "momentum": 0.9, "weight_decay": 0.01}, 1e-9),
    "SGD_nesterov": ({"name": "SGD", "lr": 0.05, "momentum": 0.9, "nesterov": True}, 1e-9),
    "Adadelta": ({"lr": 1.0, "weight_decay": 0.01}, 1e-9),
    "RMSprop": ({"lr": 1e-2}, 1e-9),
    "RMSprop_momentum": ({"name": "RMSprop", "lr": 1e-2, "momentum": 0.9}, 1e-9),
    "NAdam": ({"lr": 0.05, "weight_decay": 0.01}, 1e-9),
    "RAdam": ({"lr": 0.05}, 1e-7),
    "Adamax": ({"lr": 0.05}, 1e-5),
    "Adagrad": ({"lr": 0.1, "weight_decay": 0.01}, 1e-6),
    "Rprop": ({"lr": 0.01}, 1e-12),
    "ASGD": ({"lr": 0.05, "lambd": 1e-3, "weight_decay": 0.01}, 1e-7),
}


class _Tree(nn.Module):
    """flax {"conv": {"kernel": (3, 3, 2, 4), "bias": (4,)}, "sm_anchors": (3, 2)}."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(2, 4, 3, dtype=torch.float64)
        self.sm_anchors = nn.Parameter(torch.zeros(3, 2, dtype=torch.float64))


def _tree(rng, scale=1.0):
    return {"conv": {"kernel": rng.normal(size=(3, 3, 2, 4)) * scale,
                     "bias": rng.normal(size=4) * scale},
            "sm_anchors": rng.uniform(0.1, 0.5, (3, 2))}


def _grads(params, target):
    """The gradient of 0.5 |w - target|^2 of every leaf but the anchors,
    which get zero."""
    return {"conv": {k: params["conv"][k] - target["conv"][k] for k in ("kernel", "bias")},
            "sm_anchors": jnp.zeros_like(params["sm_anchors"])}


def _resume_case(case, train_anchors, tmp_path):
    cfg, tol = RESUME_CASES[case]
    cfg = {"name": case, **cfg} if "name" not in cfg else dict(cfg)
    rng = np.random.default_rng(7)
    start, target = _tree(rng), _tree(rng, scale=0.5)
    with jax.enable_x64(True):
        tx, _ = jax_make_optimizer(cfg, train_anchors=train_anchors)
        params = jax.tree_util.tree_map(jnp.asarray, start)
        jtarget = jax.tree_util.tree_map(jnp.asarray, target)
        state = tx.init(params)
        want = []
        for step in range(K_STEPS + N_STEPS):
            if step == K_STEPS:
                path = os.path.join(str(tmp_path), "jax", "Tree-3.ckpt.tar")
                jax_checkpoint.save_checkpoint(path, {
                    "LAST_EPOCH": K_STEPS, "NETWORK_PARAMS": {"params": params},
                    "OPTIMIZER_PARAMS": state})
            updates, state = tx.update(_grads(params, jtarget), state, params)
            params = optax.apply_updates(params, updates)
            if step >= K_STEPS:
                want.append(jax.tree_util.tree_map(np.asarray, params))

    manifest = load_checkpoint(path)
    tree = _Tree()
    tree.load_state_dict(flax_to_state_dict(manifest["NETWORK_PARAMS"], dtype=None))
    opt, _ = make_optimizer(cfg, tree, train_anchors=train_anchors)
    load_optax_state(opt, tree, manifest["OPTIMIZER_PARAMS"])
    torch_target = flax_to_state_dict({"params": target}, dtype=None)
    got = []
    for _ in range(N_STEPS):
        opt.zero_grad(set_to_none=True)
        for n, p in tree.named_parameters():
            if n != "sm_anchors":
                p.grad = p.detach() - torch_target[n]
        fill_missing_grads(opt)
        opt.step()
        got.append(state_dict_to_flax(
            {k: v.clone() for k, v in tree.state_dict().items()})["params"])
    return got, want, tol, start


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume_from_jax_snapshot(case, tmp_path):
    got, want, tol, start = _resume_case(case, True, tmp_path)
    for g, w in zip(got, want):
        for key in ("kernel", "bias"):
            np.testing.assert_allclose(g["conv"][key], w["conv"][key], atol=tol, rtol=0,
                                       err_msg=key)
        np.testing.assert_allclose(g["sm_anchors"], w["sm_anchors"], atol=tol, rtol=0)
    # the resumed steps moved the weights
    assert np.abs(got[-1]["conv"]["kernel"] - start["conv"]["kernel"]).max() > 1e-3


@pytest.mark.parametrize("case", ["Adam_wd", "SGD_momentum", "NAdam", "Rprop"])
def test_resume_with_frozen_anchors(case, tmp_path):
    """train_anchors=False: the JAX chain ends in the anchor freeze, the
    port keeps the anchors out of its optimizer; both resume and leave the
    anchors as they were."""
    got, want, tol, start = _resume_case(case, False, tmp_path)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["conv"]["kernel"], w["conv"]["kernel"], atol=tol, rtol=0)
        np.testing.assert_array_equal(g["sm_anchors"], start["sm_anchors"])
        np.testing.assert_array_equal(w["sm_anchors"], start["sm_anchors"])


def test_resume_state_of_another_optimizer_raises(tmp_path):
    """An Adadelta snapshot handed to Adam (or SGD) is still wrong input."""
    with jax.enable_x64(True):
        tx, _ = jax_make_optimizer({"name": "Adadelta", "lr": 1.0})
        state = tx.init(jax.tree_util.tree_map(jnp.asarray, _tree(np.random.default_rng(0))))
    path = os.path.join(str(tmp_path), "adadelta.ckpt.tar")
    jax_checkpoint.save_checkpoint(path, {"OPTIMIZER_PARAMS": state})
    opt_state = load_checkpoint(path)["OPTIMIZER_PARAMS"]
    tree = _Tree()
    for name in ("Adam", "SGD"):
        opt, _ = make_optimizer({"name": name, "lr": 0.1}, tree)
        with pytest.raises(ValueError, match="Adadelta|ScaleByAdamState|TraceState"):
            load_optax_state(opt, tree, opt_state)
