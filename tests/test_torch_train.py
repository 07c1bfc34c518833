"""Training numerics of the PyTorch port against the JAX package, in f32 on
the CPU: BatchNorm's running statistics, the optimizers with the anchor
rule, the lr schedule, the Xavier init, the data order, and a 3-step
training trajectory of the detector from one set of weights.

Tolerances: BatchNorm and optimizer steps 1e-5 / 1e-6 (one op apart); the
trajectory's per-step losses rtol 1e-4, its parameters and BatchNorm
statistics after 3 steps atol 1e-4 / rtol 1e-3, its eval metrics rtol 1e-4
(Adam amplifies last-bit gradient differences into ~lr-sized steps).
"""
from unittest import mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from jax.sharding import NamedSharding, PartitionSpec
import torch.nn as nn

from vision_conglomerate_tpu.data.loader import DataLoader as JaxDataLoader
from vision_conglomerate_tpu.losses import DetectionLossConfig as JaxLossConfig
from vision_conglomerate_tpu.models import DetectionNet as JaxDetectionNet
from vision_conglomerate_tpu.nn import blocks as jax_blocks
from vision_conglomerate_tpu.ops.preprocess import random_hflip as jax_random_hflip
from vision_conglomerate_tpu.parallel import make_mesh
from vision_conglomerate_tpu.train import TrainDetectionPipeline as JaxPipeline
from vision_conglomerate_tpu.train import make_optimizer as jax_make_optimizer
from vision_conglomerate_tpu.train.lr_schedule import make_lr_scheduler as jax_make_lr_scheduler

from vision_conglomerate_torch.data.loader import DataLoader
from vision_conglomerate_torch.losses import DetectionLossConfig
from vision_conglomerate_torch.models.detection import DetectionNet
from vision_conglomerate_torch.nn.blocks import BatchNorm2d
from vision_conglomerate_torch.nn.initializers import xavier_conv_init
from vision_conglomerate_torch.ops.preprocess import random_hflip
from vision_conglomerate_torch.train.detection_trainer import TrainDetectionPipeline
from vision_conglomerate_torch.train.lr_schedule import make_lr_scheduler
from vision_conglomerate_torch.train.optim import fill_missing_grads, make_optimizer
from vision_conglomerate_torch.weights import flax_to_state_dict, state_dict_to_flax

from tests.test_torch_weights import (
    ANCHORS, CONFIG, NUM_CLASSES, flat, port_detection_net, to_numpy)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: as fast for these small tensors, and parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_batchnorm_train_step_matches_flax():
    """Train-mode output and running statistics after one step, including
    the biased batch variance in running_var."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 4, 6)) * 2 + 0.5).astype(np.float32)  # NHWC
    jax_bn = jax_blocks.BatchNorm()
    variables = to_numpy(jax_bn.init(jax.random.PRNGKey(0), jnp.asarray(x), False))
    variables["params"]["BatchNorm_0"] = {
        "scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
        "bias": rng.normal(0, 0.1, 6).astype(np.float32)}
    old_mean = rng.normal(0, 0.1, 6).astype(np.float32)
    old_var = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    variables["batch_stats"]["BatchNorm_0"] = {"mean": old_mean, "var": old_var}
    want, mut = jax_bn.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])

    port = BatchNorm2d(6)
    bn = variables["params"]["BatchNorm_0"]
    port.load_state_dict({"weight": torch.from_numpy(bn["scale"]),
                          "bias": torch.from_numpy(bn["bias"]),
                          "running_mean": torch.from_numpy(old_mean),
                          "running_var": torch.from_numpy(old_var),
                          "num_batches_tracked": torch.tensor(0)})
    got = port.train()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    stats = mut["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-5)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(stats["var"]), atol=1e-5)
    biased = x.reshape(-1, 6).var(axis=0)  # ddof 0
    np.testing.assert_allclose(port.running_var.numpy(), 0.9 * old_var + 0.1 * biased,
                               atol=1e-5)
    # eval mode normalises with the running statistics
    got_eval = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    want_eval = jax_bn.apply({"params": variables["params"], "batch_stats": mut["batch_stats"]},
                             jnp.asarray(x), False)
    np.testing.assert_allclose(got_eval.detach().numpy(), np.asarray(want_eval), atol=1e-5)


@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
def test_batchnorm_train_statistics_at_f32_rounding(layout):
    """Train mode on a stem-sized map (2 x 16 x 320 x 320; the train step
    hands BatchNorm channels_last maps, the NHWC images permuted) is within
    f32 rounding of the f64 normalisation, on 1 thread and on 4 alike.
    torch's CPU kernel on a channels_last map alone was 5.4e-5 off on 1
    thread and 3.5e-6 on 8."""
    g = torch.Generator().manual_seed(0)
    x = (torch.rand(2, 16, 320, 320, generator=g) * 0.3
         + torch.randn(1, 16, 1, 1, generator=g) * 0.3)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    bn = BatchNorm2d(16)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.normal_(0.0, 0.1, generator=g)
    xd = x.double()
    mean = xd.mean((0, 2, 3), keepdim=True)
    var = xd.var((0, 2, 3), unbiased=False, keepdim=True)
    want = ((xd - mean) / torch.sqrt(var + bn.eps) * bn.weight.double()[:, None, None]
            + bn.bias.double()[:, None, None])
    outs = []
    for threads in (1, 4):
        torch.set_num_threads(threads)
        try:
            outs.append(bn.train()(x).detach())
        finally:
            torch.set_num_threads(1)
    for got in outs:
        assert ((got.double() - want).norm() / want.norm()).item() < 1e-6
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-6, atol=1e-6)


OPT_CASES = {
    "adam": {"name": "Adam", "lr": 1e-2},
    "adam_wd": {"name": "Adam", "lr": 1e-2, "weight_decay": 0.1, "betas": [0.8, 0.99]},
    "adamw": {"name": "AdamW", "lr": 1e-2, "weight_decay": 0.1},
    "sgd_momentum": {"name": "SGD", "lr": 1e-2, "momentum": 0.9, "weight_decay": 0.1},
}


class _Tree(nn.Module):
    """Three parameters: a conv-like weight, a bias and frozen-grad anchors."""

    def __init__(self, arrays):
        super().__init__()
        self.weight = nn.Parameter(torch.from_numpy(arrays["weight"].copy()))
        self.bias = nn.Parameter(torch.from_numpy(arrays["bias"].copy()))
        self.sm_anchors = nn.Parameter(torch.from_numpy(arrays["sm_anchors"].copy()),
                                       requires_grad=False)


@pytest.mark.parametrize("train_anchors", [True, False], ids=["anchors_trained", "anchors_frozen"])
@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_steps_match_optax(case, train_anchors):
    """Two steps of make_optimizer in each package on one small tree; the
    anchors get no gradient (the loss detaches them)."""
    rng = np.random.default_rng(1)
    params = {"weight": rng.normal(size=(5, 4, 3, 3)).astype(np.float32),
              "bias": rng.normal(size=5).astype(np.float32),
              "sm_anchors": rng.uniform(0.1, 0.5, (3, 2)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) if k != "sm_anchors" else np.zeros(v.shape))
              .astype(np.float32) for k, v in params.items()} for _ in range(2)]

    tx, _ = jax_make_optimizer(OPT_CASES[case], train_anchors=train_anchors)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)

    tree = _Tree(params)
    opt, lr = make_optimizer(OPT_CASES[case], tree, train_anchors=train_anchors)
    assert lr == OPT_CASES[case]["lr"]
    assert any(p is tree.sm_anchors for p in opt.param_groups[0]["params"]) == train_anchors
    for g in grads:
        opt.zero_grad(set_to_none=True)
        tree.weight.grad = torch.from_numpy(g["weight"])
        tree.bias.grad = torch.from_numpy(g["bias"])
        fill_missing_grads(opt)
        opt.step()
    for name, p in tree.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[name]), atol=1e-6,
                                   rtol=1e-5, err_msg=name)
    decays = train_anchors and OPT_CASES[case].get("weight_decay")
    moved = not np.array_equal(tree.sm_anchors.detach().numpy(), params["sm_anchors"])
    assert moved == bool(decays)


def test_cosine_warm_restarts_sequence_and_state_dict():
    cfg = {"name": "CosineAnnealingWarmRestarts", "T_0": 7, "T_mult": 2, "eta_min": 1e-6}
    port, ref = make_lr_scheduler(cfg, 1e-3), jax_make_lr_scheduler(cfg, 1e-3)
    opt = torch.optim.SGD([nn.Parameter(torch.zeros(1))], lr=1e-3)
    torch_sched = torch.optim.lr_scheduler.CosineAnnealingWarmRestarts(
        opt, T_0=7, T_mult=2, eta_min=1e-6)
    for _ in range(50):
        lr = port.get_lr()
        assert lr == ref.get_lr()
        np.testing.assert_allclose(lr, torch_sched.get_last_lr()[0], rtol=1e-12)
        port.step()
        ref.step()
        opt.step()
        torch_sched.step()
    # a state_dict carries over both ways mid-cycle
    other_ref, other_port = jax_make_lr_scheduler(cfg, 1e-3), make_lr_scheduler(cfg, 1e-3)
    other_ref.load_state_dict(port.state_dict())
    other_port.load_state_dict(ref.state_dict())
    for _ in range(10):
        assert port.get_lr() == other_ref.get_lr() == other_port.get_lr()
        for s in (port, other_ref, other_port):
            s.step()


def test_xavier_conv_init():
    net = DetectionNet(NUM_CLASSES, CONFIG, anchors=ANCHORS, device="cpu")
    xavier_conv_init(net, torch.Generator().manual_seed(3))
    again = xavier_conv_init(DetectionNet(NUM_CLASSES, CONFIG, anchors=ANCHORS, device="cpu"),
                             torch.Generator().manual_seed(3))
    convs = [m for m in net.modules() if isinstance(m, nn.Conv2d)]
    assert len(convs) > 50
    for m in convs:
        cout, cin, kh, kw = m.weight.shape
        bound = np.sqrt(6.0 / ((cin + cout) * kh * kw))
        w = m.weight.detach().abs()
        assert w.max() <= bound
        if w.numel() >= 1000:  # a uniform draw reaches close to its bound
            assert w.max() > 0.95 * bound and abs(w.mean() - bound / 2) < 0.05 * bound
        if m.bias is not None:
            assert torch.all(m.bias == 0.01)
    for a, b in zip(net.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("prob", [0.0, 1.0])
def test_random_hflip_matches_jax(prob):
    """Images mirrored left-right and label x -> 1 - x. The draws differ
    between the packages (torch.Generator, JAX key), so they agree at
    probability 0 and 1."""
    rng = np.random.default_rng(8)
    imgs = rng.uniform(size=(3, 6, 5, 3)).astype(np.float32)
    labels = rng.uniform(size=(3, 4, 5)).astype(np.float32)
    got_i, got_l = random_hflip(torch.Generator().manual_seed(0), torch.from_numpy(imgs),
                                torch.from_numpy(labels), prob=prob)
    want_i, want_l = jax_random_hflip(jax.random.PRNGKey(0), jnp.asarray(imgs),
                                      jnp.asarray(labels), prob=prob)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=1e-7)
    assert np.array_equal(got_i.numpy(), imgs[:, :, ::-1]) == (prob == 1.0)


class _MemDataset:
    """In-memory detection samples with a padding collate (max 4 labels)."""

    def __init__(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        self.items = []
        for _ in range(n):
            img = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
            k = int(rng.integers(1, 4))
            labels = np.concatenate([
                rng.integers(0, NUM_CLASSES, (k, 1)),
                rng.uniform(0.2, 0.8, (k, 2)),
                rng.uniform(0.1, 0.4, (k, 2))], axis=1).astype(np.float32)
            self.items.append((img, labels))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    @staticmethod
    def collate_fn(batch):
        imgs, labels = zip(*batch)
        out = np.zeros((len(imgs), 4, 5), np.float32)
        mask = np.zeros((len(imgs), 4), bool)
        for i, lab in enumerate(labels):
            out[i, :len(lab)] = lab
            mask[i, :len(lab)] = True
        return np.stack(imgs), out, mask


def test_loaders_give_the_same_batches():
    """Shuffled from one seed, with a wrap-padded last batch, both loaders
    give the same batches over two epochs."""
    ds = _MemDataset(5, seed=4)
    port = DataLoader(ds, batch_size=2, shuffle=True, num_workers=2, pad_last="wrap", seed=42)
    ref = JaxDataLoader(ds, batch_size=2, shuffle=True, num_workers=2, pad_last="wrap", seed=42)
    assert len(port) == len(ref) == 3
    for _ in range(2):
        for got, want in zip(port, ref):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def _one_batch(batch):
    """A loader of one batch, without a dataset (no eval row mask)."""
    class Loader:
        def __len__(self):
            return 1

        def __iter__(self):
            yield batch
    return Loader()


LOSS_KW = dict(num_classes=NUM_CLASSES, box_w=0.1, class_w=0.3, label_smoothing=0.001)
# Adam at a small, linear step (lr 1e-3, eps 1). At batch 2 of 64x64
# images, train-mode BatchNorm normalises the deepest maps over 8 values, and
# the gradients' last bits differ by ~1e-4 of their largest element between
# two thread counts of one package (~4e-4 between the packages). At eps 1e-8
# Adam turns such differences in small gradients, and the pure rounding
# noise of the conv biases in front of a BatchNorm, into lr-sized steps of
# either sign, and at lr 1e-2 three steps grow them past any tolerance. The
# optimizer tests above hold the default eps.
OPT_CFG = {"name": "Adam", "lr": 1e-3, "eps": 1.0}


@pytest.fixture(scope="module")
def trajectory():
    """3 train steps and a wrap-padded eval in each package, from one set of
    weights (seeded port init with non-trivial BatchNorm state, bridged)."""
    variables = state_dict_to_flax(port_detection_net(CONFIG, seed=21).state_dict())
    train_ds = _MemDataset(6, seed=5)
    batches = [train_ds.collate_fn(train_ds.items[2 * i:2 * i + 2]) for i in range(3)]
    eval_ds = _MemDataset(3, seed=6)

    # JAX: the pipeline takes the bridged variables in place of model.init
    model = JaxDetectionNet(num_classes=NUM_CLASSES, config=CONFIG, anchors=ANCHORS)
    tx, _ = jax_make_optimizer(OPT_CFG)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    with mock.patch.object(JaxDetectionNet, "init", lambda self, *a, **k: jvars):
        pipe = JaxPipeline(model, JaxLossConfig(**LOSS_KW), tx, mesh=make_mesh(1),
                           sample_input_shape=(64, 64, 3), init_scheme="")
    # the state as the train step returns it (an int32 step, replicated on
    # the mesh), so the step compiles once
    pipe.state = jax.device_put(pipe.state.replace(step=jnp.zeros((), jnp.int32)),
                                NamedSharding(pipe.mesh, PartitionSpec()))
    jax_losses = [pipe.train(_one_batch(b))["aggregate_loss"] for b in batches]
    jax_eval = pipe.evaluate(JaxDataLoader(eval_ds, batch_size=2, pad_last="wrap"))
    jax_vars = to_numpy({"params": pipe.state.params, "batch_stats": pipe.state.batch_stats})

    net = DetectionNet(NUM_CLASSES, CONFIG, anchors=ANCHORS, device="cpu")
    net.load_state_dict(flax_to_state_dict(variables))
    optimizer, _ = make_optimizer(OPT_CFG, net)
    port = TrainDetectionPipeline(net, DetectionLossConfig(**LOSS_KW), optimizer, init_scheme=None)
    port_losses = [port.train(_one_batch(b))["aggregate_loss"] for b in batches]
    port_eval = port.evaluate(DataLoader(eval_ds, batch_size=2, pad_last="wrap"))
    port_vars = state_dict_to_flax(net.state_dict())
    return dict(variables=variables, jax_losses=jax_losses, port_losses=port_losses,
                jax_eval=jax_eval, port_eval=port_eval, jax_vars=jax_vars, port_vars=port_vars)


def test_trajectory_losses_match_jax(trajectory):
    got, want = trajectory["port_losses"], trajectory["jax_losses"]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[0] != got[1] != got[2]


def test_trajectory_params_and_batch_stats_match_jax(trajectory):
    got, want, start = (flat(trajectory[k]) for k in ("port_vars", "jax_vars", "variables"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-3, err_msg="/".join(k))
    # the steps moved the weights and the running statistics
    kernel = ("params", "backbone", "conv0", "conv", "kernel")
    var = ("batch_stats", "backbone", "conv0", "norm", "BatchNorm_0", "var")
    assert not np.allclose(got[kernel], start[kernel], atol=1e-4)
    assert not np.allclose(got[var], start[var], atol=1e-4)
    assert all(got[k].dtype == np.float32 for k in got)


def test_trajectory_eval_of_wrap_padded_batches_matches_jax(trajectory):
    got, want = trajectory["port_eval"], trajectory["jax_eval"]
    assert sorted(got) == sorted(want)
    for k in want:
        if k != "images_per_sec":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
