"""Stage rematerialization in the PyTorch port: a train step with
`model_config.remat` equals the step without it, at 1e-6, in the forward's
outputs, the loss, every gradient, the BatchNorm running statistics after
the step and the parameters after Adam. The port's step without remat is
held to the JAX package's by tests/test_torch_train.py, and the JAX
package's remat to its own step by tests/test_remat.py; this closes the
loop without compiling a rematerialized JAX net.
"""
import numpy as np
import pytest
import torch
import torch.nn as nn

from vision_conglomerate_torch import train_det
from vision_conglomerate_torch.losses import DetectionLossConfig, detection_loss
from vision_conglomerate_torch.models.detection import DetectionNet
from vision_conglomerate_torch.nn import blocks
from vision_conglomerate_torch.train.detection_trainer import TrainDetectionPipeline
from vision_conglomerate_torch.train.optim import make_optimizer
from vision_conglomerate_torch.utils import load_yaml

from tests.test_torch_train_cli import _workspace
from tests.test_torch_weights import ANCHORS, CONFIG, NUM_CLASSES, SILU_CONFIG, port_detection_net

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed: int = 0, n: int = 2):
    rng = np.random.default_rng(seed)
    imgs = torch.from_numpy(rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8))
    labels = torch.zeros(n, 4, 5)
    mask = torch.zeros(n, 4, dtype=torch.bool)
    for i in range(n):
        k = int(rng.integers(1, 4))
        labels[i, :k] = torch.from_numpy(np.concatenate([
            rng.integers(0, NUM_CLASSES, (k, 1)), rng.uniform(0.2, 0.8, (k, 2)),
            rng.uniform(0.1, 0.4, (k, 2))], axis=1).astype(np.float32))
        mask[i, :k] = True
    return imgs, labels, mask


def _net(config, remat: bool, state, dtype=torch.float32):
    net = DetectionNet(NUM_CLASSES, {**config, "remat": remat}, anchors=ANCHORS, dtype=dtype,
                       device="cpu")
    net.load_state_dict(state)
    return net.train()


def _forward_backward(net, batch):
    imgs, labels, mask = batch
    preds = net((imgs.float() / 255).permute(0, 3, 1, 2))
    loss, _ = detection_loss(preds, labels, mask, (net.sm_anchors, net.md_anchors, net.lg_anchors),
                             DetectionLossConfig(num_classes=NUM_CLASSES))
    loss.backward()
    return dict(preds=[p.detach() for p in preds], loss=loss.detach(),
                grads={n: p.grad for n, p in net.named_parameters() if p.grad is not None},
                stats={n: b.clone() for n, b in net.named_buffers() if "running_" in n})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("config", [CONFIG, SILU_CONFIG], ids=["canonical", "silu_branches"])
def test_remat_step_equals_plain_step(config, dtype):
    """Outputs, loss, gradients and running statistics, with the
    recompute seen to run: BatchNorm runs again in the backward pass."""
    state = port_detection_net(config, seed=7).state_dict()
    batch = _batch()
    calls = {"n": 0}
    forward = blocks.BatchNorm2d.forward

    def counting(self, x):
        calls["n"] += 1
        return forward(self, x)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(blocks.BatchNorm2d, "forward", counting)
        for remat in (False, True):
            calls["n"] = 0
            out[remat] = _forward_backward(_net(config, remat, state, dtype), batch)
            out[remat]["bn_calls"] = calls["n"]
    want, got = out[False], out[True]
    assert got["bn_calls"] > want["bn_calls"]  # recomputed in backward
    for g, w in zip(got["preds"], want["preds"]):
        torch.testing.assert_close(g, w, **TOL)
    torch.testing.assert_close(got["loss"], want["loss"], **TOL)
    assert sorted(got["grads"]) == sorted(want["grads"]) and len(want["grads"]) > 100
    for name, w in want["grads"].items():
        torch.testing.assert_close(got["grads"][name], w, **TOL, msg=name)
    for name, w in want["stats"].items():
        torch.testing.assert_close(got["stats"][name], w, **TOL, msg=name)
    # the step moved each running statistic once, not twice
    moved = {n: (w - state[n]).abs().max().item() for n, w in want["stats"].items()}
    assert max(moved.values()) > 1e-3


def test_remat_adam_step_equals_plain_step():
    """One TrainDetectionPipeline step each: metrics and every parameter
    and buffer after Adam."""
    state = port_detection_net(CONFIG, seed=8).state_dict()
    batch = _batch(seed=1)
    nets = {}
    for remat in (False, True):
        net = _net(CONFIG, remat, state)
        opt, _ = make_optimizer({"name": "Adam", "lr": 1e-3}, net)
        pipe = TrainDetectionPipeline(net, DetectionLossConfig(num_classes=NUM_CLASSES), opt,
                                      init_scheme=None)
        nets[remat] = (net, pipe.train_step(*batch))
    (net0, m0), (net1, m1) = nets[False], nets[True]
    for k in m0:
        torch.testing.assert_close(m1[k], m0[k], **TOL, msg=k)
    for (k, v), w in zip(net1.state_dict().items(), net0.state_dict().values()):
        torch.testing.assert_close(v, w, **TOL, msg=k)


def test_stage_restores_dropout_rng():
    """A checkpointed stage with dropout recomputes the same mask, so its
    gradients are the plain stage's."""
    torch.manual_seed(0)
    stage_mod = nn.Sequential(nn.Linear(16, 16), nn.Dropout(0.5), nn.Linear(16, 4))
    x = torch.randn(8, 16)
    grads = []
    for remat in (False, True):
        stage_mod.zero_grad()
        torch.manual_seed(1)
        blocks.stage(stage_mod, x, remat=remat).square().sum().backward()
        grads.append([p.grad.clone() for p in stage_mod.parameters()])
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_stage_without_autograd_is_the_plain_call(monkeypatch):
    """Under no_grad (eval, serving) no stage is checkpointed."""
    def refuse(*a, **k):
        raise AssertionError("checkpoint called without autograd")

    monkeypatch.setattr(blocks, "checkpoint", refuse)
    net = _net(CONFIG, True, port_detection_net(CONFIG, seed=9).state_dict()).eval()
    with torch.no_grad():
        preds = net(torch.zeros(1, 3, 64, 64), inference=True)
    assert preds.shape[0] == 1 and torch.isfinite(preds).all()


@pytest.mark.parametrize("model_cfg,want", [
    ({}, (False, False)),
    ({"remat": True}, (True, True)),
    ({"remat": True, "cspbackbone_config": {**CONFIG["cspbackbone_config"], "remat": False}},
     (False, True)),
], ids=["off", "on", "backbone_override"])
def test_remat_reaches_backbone_and_neck(model_cfg, want):
    net = DetectionNet(NUM_CLASSES, {**CONFIG, **model_cfg}, anchors=ANCHORS, device="cpu")
    assert (net.backbone.remat, net.neck.remat) == want


@pytest.mark.parametrize("batch_size,remat", [(16, False), (32, True)])
def test_train_det_turns_remat_on_at_batch_32(tmp_path, monkeypatch, batch_size, remat):
    """The CLI's default: remat from batch 32 when the config leaves it
    unset; the port builds that pipeline (no raise)."""
    _workspace(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    args = train_det.build_parser().parse_args([
        "--config_path", "config.yaml", "--anchors_path", "anchors.yaml", "--batch_size",
        str(batch_size), "--no_verbose", "--device", "cpu"])
    config = load_yaml(args.config_path)
    pipe, _, _ = train_det.build(args, config, args.config_path, args.anchors_path)
    assert config["model_config"]["remat"] is remat
    assert (pipe.model.backbone.remat, pipe.model.neck.remat) == (remat, remat)
