"""TrackNet training of the PyTorch port against the JAX package, in f32 on
the CPU: Adadelta's update against optax's, a 3-step trajectory with the
CosineAnnealingWarmRestarts schedule from one set of weights (the loss and
every parameter and running statistic after each step), resuming from a
JAX snapshot with the Adadelta state and the schedule carried over, the
port's own snapshot round trip, and the eval protocol (loss of wrap-padded
batches, tp/fp/tn/fn per visibility class, precision, recall, f1) on the
same predictions with the centroid and the hough decode.

Tolerances. The optimizer step alone: 1e-6 (one op apart). The
trajectory: this net's f32 train-mode gradients (BatchNorm over batch 2,
deep maps of 8x4) are 2-4e-4 (relative L2) from their f64 values in
either package, and Adadelta normalises each element by its own history,
so the per-element noise of small gradients passes into the update and
the next steps' gradients move further. So: the losses rtol 1e-4 at each
step (read up to 6e-6); the parameters after a step from one state (the
first step, and the step after resuming) atol 1e-4 / rtol 1e-3 (read
3e-5); after the later steps, each tensor's distance from the JAX one at
most half its update's norm (read 0.2), the conv biases in front of a
BatchNorm left out (their gradient is rounding noise in both). The lr is a
tenth of the shipped config's (the same schedule shape), which keeps the
read values there; eval counts exact, its loss rtol 1e-5.
"""
from unittest import mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from jax.sharding import NamedSharding, PartitionSpec

from vision_conglomerate_tpu.data.loader import DataLoader as JaxDataLoader
from vision_conglomerate_tpu.models import TrackNet as JaxTrackNet
from vision_conglomerate_tpu.parallel import make_mesh
from vision_conglomerate_tpu.train import TrainTrackNetPipeline as JaxPipeline
from vision_conglomerate_tpu.train import make_optimizer as jax_make_optimizer
from vision_conglomerate_tpu.train import tracknet_trainer as jax_tracknet_trainer
from vision_conglomerate_tpu.train.lr_schedule import make_lr_scheduler as jax_make_lr_scheduler

from vision_conglomerate_torch.data.loader import DataLoader
from vision_conglomerate_torch.models import TrackNet
from vision_conglomerate_torch.ops.heatmap import make_gt_heatmap_np
from vision_conglomerate_torch.train import tracknet_trainer
from vision_conglomerate_torch.train.lr_schedule import make_lr_scheduler
from vision_conglomerate_torch.train.optim import load_optax_state, make_optimizer
from vision_conglomerate_torch.train.tracknet_trainer import TrainTrackNetPipeline
from vision_conglomerate_torch.weights import flax_to_state_dict, state_dict_to_flax

from tests.test_torch_tracknet_model import CONFIG, H, W, port_tracknet
from tests.test_torch_weights import flat, to_numpy

OPT_CFG = {"name": "Adadelta", "lr": 0.1, "rho": 0.9, "eps": 1e-6, "weight_decay": 0}
SCHED_CFG = {"name": "CosineAnnealingWarmRestarts", "T_0": 2, "T_mult": 1, "eta_min": 0.07}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adadelta_step_matches_optax(weight_decay):
    """torch.optim.Adadelta is optax.adadelta: e_g -> square_avg, e_x ->
    acc_delta, the weight decay added to the gradient first."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=(5, 7)).astype(np.float32) * s for s in (1.0, 1e-3, 0.3)]
    cfg = {**OPT_CFG, "lr": 0.9, "weight_decay": weight_decay}
    tx, _ = jax_make_optimizer(cfg)
    params = {"w": jnp.asarray(p0)}
    state = tx.init(params)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    module = torch.nn.Module()
    module.w = p
    opt, _ = make_optimizer(cfg, module)
    for g in grads:
        updates, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, updates)
        p.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params["w"]),
                                   atol=1e-6, rtol=1e-6)
    e_g, e_x = state.inner_state[1]
    np.testing.assert_allclose(opt.state[p]["square_avg"].numpy(), np.asarray(e_g["w"]),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(opt.state[p]["acc_delta"].numpy(), np.asarray(e_x["w"]),
                               rtol=1e-5, atol=1e-12)


def make_batch(n: int, seed: int, offset: int = 0):
    """n windows: uint8 frames (row index in pixel 0), Gaussian heatmaps,
    others [visibility, x, y, status] (every 4th window invisible)."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, size=(n, H, W, 9), dtype=np.uint8)
    heatmaps, others = [], []
    for i in range(n):
        frames[i, 0, 0, 0] = offset + i
        vis = int((offset + i) % 4 != 3) * int(rng.integers(1, 4))
        x, y = int(rng.integers(4, W - 4)), int(rng.integers(4, H - 4))
        heatmaps.append(make_gt_heatmap_np(x, y, vis, (W, H), variance=5))
        others.append([vis, x if vis else -1, y if vis else -1, 0])
    return frames, np.stack(heatmaps), np.asarray(others, np.float32)


class MemDataset:
    def __init__(self, n: int, seed: int):
        self.items = list(zip(*make_batch(n, seed)))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    @staticmethod
    def collate_fn(batch):
        return tuple(np.stack(a) for a in zip(*batch))


def one_batch(batch):
    class Loader:
        def __len__(self):
            return 1

        def __iter__(self):
            yield batch
    return Loader()


def jax_pipeline(variables):
    """The JAX pipeline with the bridged variables in place of model.init
    and its re-initialisation, its state as the train step returns it. The
    constructor's re-initialisation is skipped and its optimizer init
    jitted: the state it builds is replaced at once (they were eager
    per-leaf ops: 26 s of the advanced net's fixture)."""
    model = JaxTrackNet(config=CONFIG)
    tx, base_lr = jax_make_optimizer(OPT_CFG)
    tx = tx._replace(init=jax.jit(tx.init))
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    with mock.patch.object(JaxTrackNet, "init", lambda self, *a, **k: jvars), \
            mock.patch.dict(jax_tracknet_trainer.INIT_SCHEMES,
                            {k: lambda p, key: p for k in jax_tracknet_trainer.INIT_SCHEMES}):
        pipe = JaxPipeline(model, tx, lr_scheduler=jax_make_lr_scheduler(SCHED_CFG, base_lr),
                           mesh=make_mesh(1), sample_input_shape=(H, W, 9))
    state = pipe.state.replace(params=jvars["params"], opt_state=tx.init(jvars["params"]),
                               step=jnp.zeros((), jnp.int32))
    pipe.state = jax.device_put(state, NamedSharding(pipe.mesh, PartitionSpec()))
    return pipe


def port_pipeline(variables, **kwargs):
    net = TrackNet(CONFIG)
    net.load_state_dict(flax_to_state_dict(variables))
    optimizer, base_lr = make_optimizer(OPT_CFG, net)
    return TrainTrackNetPipeline(net, optimizer, init_scheme=None,
                                 lr_scheduler=make_lr_scheduler(SCHED_CFG, base_lr), **kwargs)


def snapshot(pipe_vars):
    """Copies: a port state_dict's numpy views follow the in-place steps."""
    return {k: np.array(v) for k, v in flat(to_numpy(pipe_vars)).items()}


@pytest.fixture(scope="module")
def trajectory(tmp_path_factory):
    """3 epochs of one step each in both packages (the lr 0.1, 0.085, 0.1
    of the warm-restart schedule), then a wrap-padded eval; the JAX
    snapshot after them, and one more step on each side from it."""
    variables = state_dict_to_flax(port_tracknet(seed=21).train().state_dict())
    batches = [make_batch(2, seed=30 + i) for i in range(4)]
    eval_ds = MemDataset(5, seed=40)
    out = {"variables": variables}

    pipe = jax_pipeline(variables)
    out["jax_losses"], out["jax_vars"], out["jax_lr"] = [], [], []
    for b in batches[:3]:
        out["jax_lr"].append(pipe.current_lr())
        out["jax_losses"].append(pipe.train(one_batch(b)))
        out["jax_vars"].append(snapshot({"params": pipe.state.params,
                                         "batch_stats": pipe.state.batch_stats}))
    out["jax_eval"] = pipe.evaluate(JaxDataLoader(eval_ds, batch_size=2, pad_last="wrap"))
    ckpt_dir = tmp_path_factory.mktemp("jax_snapshot")
    pipe.checkpoints_dir = str(ckpt_dir)
    pipe.save_checkpoint()
    out["jax_snapshot"] = str(ckpt_dir)
    out["jax_opt_state"] = jax.device_get(pipe.state.opt_state)
    out["jax_lr_after"] = pipe.current_lr()
    out["jax_resumed_loss"] = pipe.train(one_batch(batches[3]))
    out["jax_resumed_vars"] = snapshot({"params": pipe.state.params,
                                        "batch_stats": pipe.state.batch_stats})

    port = port_pipeline(variables)
    out["port_losses"], out["port_vars"], out["port_lr"] = [], [], []
    for b in batches[:3]:
        out["port_lr"].append(port.current_lr())
        out["port_losses"].append(port.train(one_batch(b)))
        out["port_vars"].append(snapshot(state_dict_to_flax(port.model.state_dict())))
    out["port_eval"] = port.evaluate(DataLoader(eval_ds, batch_size=2, pad_last="wrap"))

    resumed = port_pipeline(variables, checkpoint_path=out["jax_snapshot"])
    out["resumed_epoch"] = resumed.last_epoch
    out["resumed_lr"] = resumed.current_lr()
    out["resumed_opt_state"] = {
        n: {k: v.clone() for k, v in resumed.optimizer.state[p].items()}
        for n, p in resumed.model.named_parameters()}
    out["port_resumed_loss"] = resumed.train(one_batch(batches[3]))
    out["port_resumed_vars"] = snapshot(state_dict_to_flax(resumed.model.state_dict()))
    out["batches"] = batches
    return out


def test_trajectory_losses_and_schedule_match_jax(trajectory):
    got, want = trajectory["port_losses"], trajectory["jax_losses"]
    assert np.isfinite(got).all() and len(set(got)) == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(trajectory["port_lr"], trajectory["jax_lr"], rtol=1e-7)
    assert trajectory["port_lr"][1] < 0.1 == trajectory["port_lr"][2]


def pre_bn_bias(k) -> bool:
    return k[-1] == "bias" and k[-2] == "conv" and k[2] != "dec_13"


@pytest.mark.parametrize("step", [0, 1, 2])
def test_trajectory_params_and_batch_stats_match_jax(trajectory, step):
    got, want = trajectory["port_vars"][step], trajectory["jax_vars"][step]
    start = flat(trajectory["variables"])
    assert sorted(got) == sorted(want)
    for k in want:
        if step == 0:
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-3,
                                       err_msg="/".join(k))
        elif not pre_bn_bias(k):
            dist = np.linalg.norm(got[k] - want[k])
            assert dist <= 0.5 * np.linalg.norm(want[k] - start[k]), ("/".join(k), dist)
    kernel = ("params", "decoder", "dec_13", "conv", "kernel")
    var = ("batch_stats", "encoder", "enc_0", "norm", "BatchNorm_0", "var")
    assert not np.allclose(got[kernel], start[kernel], atol=1e-4)
    assert not np.allclose(got[var], start[var], atol=1e-4)


def test_trajectory_eval_of_wrap_padded_batches_matches_jax(trajectory):
    got, want = trajectory["port_eval"], trajectory["jax_eval"]
    assert list(got) == list(want)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for k in ("tp", "tn", "fp", "fn", "precision", "recall", "f1"):
        assert got[k] == pytest.approx(float(want[k]), abs=1e-12), k
    assert got["tp"] + got["tn"] + got["fp"] + got["fn"] == 5


def test_resume_from_jax_snapshot_carries_adadelta_state(trajectory):
    """The JAX snapshot's e_g / e_x become square_avg / acc_delta with
    inject_hyperparams' count as the step; the schedule and the epoch
    resume; one more step then matches the JAX pipeline's."""
    e_g, e_x = trajectory["jax_opt_state"].inner_state[1]
    want_g = flax_to_state_dict({"params": e_g})
    want_x = flax_to_state_dict({"params": e_x})
    assert sorted(trajectory["resumed_opt_state"]) == sorted(
        k for k in want_g if not k.endswith("num_batches_tracked"))
    for name, st in trajectory["resumed_opt_state"].items():
        assert float(st["step"]) == 3.0
        np.testing.assert_array_equal(st["square_avg"].numpy(), want_g[name].numpy())
        np.testing.assert_array_equal(st["acc_delta"].numpy(), want_x[name].numpy())
    assert trajectory["resumed_epoch"] == 3
    assert trajectory["resumed_lr"] == pytest.approx(trajectory["jax_lr_after"], rel=1e-7)
    np.testing.assert_allclose(trajectory["port_resumed_loss"], trajectory["jax_resumed_loss"],
                               rtol=1e-4)
    got, want = trajectory["port_resumed_vars"], trajectory["jax_resumed_vars"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-3, err_msg="/".join(k))


def test_resume_other_optimizers_raise(trajectory):
    """Another optimizer resumes from its own JAX state (SGD's momentum
    trace here; every optimizer in tests/test_torch_optim_resume.py); the
    Adadelta state handed to Adam or SGD is wrong input and raises."""
    net = TrackNet(CONFIG)
    sgd_cfg = {"name": "SGD", "lr": 0.1, "momentum": 0.9}
    tx, _ = jax_make_optimizer(sgd_cfg)
    params = trajectory["variables"]["params"]
    _, sgd_state = tx.update(params, tx.init(params), params)
    sgd, _ = make_optimizer(sgd_cfg, net)
    load_optax_state(sgd, net, sgd_state)
    want = flax_to_state_dict({"params": sgd_state.inner_state[0].trace})
    for name, p in net.named_parameters():
        np.testing.assert_array_equal(sgd.state[p]["momentum_buffer"].numpy(),
                                      want[name].numpy())
    for name in ("Adam", "SGD"):
        opt, _ = make_optimizer({"name": name, "lr": 0.1}, net)
        with pytest.raises(ValueError, match="not one"):
            load_optax_state(opt, net, trajectory["jax_opt_state"])


def test_port_snapshot_round_trip(trajectory, tmp_path):
    """A port snapshot keeps its torch optimizer state and the schedule;
    a new pipeline restores weights, Adadelta state, lr and epoch."""
    variables = trajectory["variables"]
    pipe = port_pipeline(variables)
    pipe.train(one_batch(trajectory["batches"][0]))
    pipe.checkpoints_dir = str(tmp_path)
    pipe.save_checkpoint()
    back = port_pipeline(variables, checkpoint_path=str(tmp_path))
    assert back.last_epoch == 1 and back.current_lr() == pipe.current_lr()
    for (n, a), b in zip(pipe.model.state_dict().items(), back.model.state_dict().values()):
        assert torch.equal(a, b), n
    for pa, pb in zip(pipe.model.parameters(), back.model.parameters()):
        for key in ("square_avg", "acc_delta"):
            assert torch.equal(pipe.optimizer.state[pa][key], back.optimizer.state[pb][key])


def predicted(n: int):
    """Fixed predictions per window row: heatmaps with a blob near the
    ball (a hit), far from it (a miss), or none; centroid and hough both
    see them."""
    frames, heatmaps, others = make_batch(n, seed=50)
    rng = np.random.default_rng(51)
    hms = np.zeros((n, H, W), np.uint8)
    for i in range(n):
        kind = i % 3
        if kind == 2:
            continue
        x, y = (others[i, 1], others[i, 2]) if others[i, 0] and kind == 0 else \
            (int(rng.integers(5, W - 5)), int(rng.integers(5, H - 5)))
        yy, xx = np.mgrid[0:H, 0:W]
        hms[i][(yy - y) ** 2 + (xx - x) ** 2 <= 9] = 200
    return (frames, heatmaps, others), hms


@pytest.mark.parametrize("decode", ["centroid", "hough"])
def test_eval_counts_and_f1_on_the_same_predictions_match_jax(decode):
    """Both pipelines' evaluate over one wrap-padded loader, their
    forwards replaced by the same predicted heatmaps."""
    from vision_conglomerate_tpu.ops.heatmap import decode_heatmap_peaks as jax_decode
    from vision_conglomerate_torch.ops.heatmap import decode_heatmap_peaks

    n = 11
    (frames, heatmaps, others), hms = predicted(n)

    class Data(MemDataset):
        def __init__(self):
            self.items = list(zip(frames, heatmaps, others))

    jax_pipe = mock.Mock(spec=JaxPipeline)
    jax_pipe.decode, jax_pipe.tp_dist_tol, jax_pipe.heatmap_threshold = decode, 4.0, 128
    jax_pipe.hough_grad_config, jax_pipe.state = {}, None
    jax_pipe._prefetch = lambda dl, host_indices=(): iter(dl)
    jax_pipe._hough_decode = lambda hm: JaxPipeline._hough_decode(jax_pipe, hm)

    def jax_forward(_state, f, _h):
        hm = jnp.asarray(hms[np.asarray(f)[:, 0, 0, 0]])
        cx, cy, _, found = jax_decode(hm, threshold=128)
        return jnp.zeros(hm.shape[0]), hm, cx, cy, found

    jax_pipe._eval_forward = jax_forward
    want = JaxPipeline.evaluate(jax_pipe, JaxDataLoader(Data(), batch_size=4, pad_last="wrap"))

    port = TrainTrackNetPipeline(TrackNet(CONFIG), make_optimizer(OPT_CFG, TrackNet(CONFIG))[0],
                                 init_scheme=None, decode=decode)

    def port_step(f, _h, model=None):
        hm = torch.from_numpy(hms[f[:, 0, 0, 0].numpy()])
        cx, cy, _, found = decode_heatmap_peaks(hm)
        return torch.zeros(hm.shape[0]), hm, cx, cy, found

    port.eval_step = port_step
    got = port.evaluate(DataLoader(Data(), batch_size=4, pad_last="wrap"))
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), abs=1e-12), k
    assert got["tp"] > 0 and got["fp"] > 0 and got["fn"] > 0 and got["tn"] + got["fp"] > 0
    assert got["tp"] + got["tn"] + got["fp"] + got["fn"] == n


def test_f1_recall_denominator_quirk():
    """recall = tp / (tp + tn + fp + fn of visibility classes 1-3): a tn
    of class 1 counts in it (the reference's formula)."""
    counts = {k: np.zeros(4) for k in ("tp", "fp", "tn", "fn")}
    counts["tp"][1], counts["fn"][2], counts["tn"][1], counts["tn"][0] = 2, 1, 1, 5
    m = tracknet_trainer.f1_metrics(counts)
    assert m["recall"] == pytest.approx(2 / 4, rel=1e-6)
    assert m["precision"] == pytest.approx(1.0, rel=1e-6)
    assert m["tn"] == 6
