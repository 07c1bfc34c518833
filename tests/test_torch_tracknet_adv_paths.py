"""TrackNet's advanced architecture through the PyTorch port's training,
serving and eval paths, on the CPU, at a tiny copy of
configs/tracknet/config_advanced.yaml (canonical RepVGG blocks, Adam and
the warm-restart schedule with eta_min 1e-5; widths 0.25, depths 0.2,
64x32): one Adam step against the JAX pipeline's (loss, gradients,
BatchNorm statistics, the update), resuming from the JAX snapshot with its Adam
state and one more step on both sides, `run_tracknet_inference` on a
frame folder against the JAX runner (the fused deploy form on both sides)
and against `use_reparam=False`, and the three CLIs with `--device cpu`:
train_tracknet's artifacts, inference_tracknet on a video and a folder,
eval_tracknet in the train form and `--deploy`.

Tolerances. The step runs on a batch of 8 (train-mode BatchNorm at 32x64
is ill-conditioned on fewer images: see
tests/test_torch_tracknet_adv_model.py): loss rtol 1e-5, the global
gradient norm rtol 1e-4 (read 4.5e-6), each gradient tensor within 2e-3
of its L2 norm (read up to 6.8e-4), BatchNorm statistics atol 1e-5. Adam's
first update is lr * g / (|g| + eps), about lr times the gradient's sign,
so it passes the rounding noise of small gradient elements on at full
size: each tensor's update is held by its cosine with the JAX one, at
least 0.98. The conv biases in front of a BatchNorm are left out (their
gradient is rounding noise in both). After the resumed step, the loss
rtol 1e-4. Serving: output.csv's x, y, r atol
1e-3 px; eval: the two forms' f1 and counts equal, their loss rtol 1e-4.
"""
import copy
import functools
import json
import os
from unittest import mock

import numpy as np
import pandas as pd
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding, PartitionSpec

from vision_conglomerate_tpu.infer import tracknet_runner as jax_runner
from vision_conglomerate_tpu.models import TrackNet as JaxTrackNet
from vision_conglomerate_tpu.parallel import make_mesh
from vision_conglomerate_tpu.train import TrainTrackNetPipeline as JaxPipeline
from vision_conglomerate_tpu.train import make_optimizer as jax_make_optimizer
from vision_conglomerate_tpu.train.lr_schedule import make_lr_scheduler as jax_make_lr_scheduler

from vision_conglomerate_torch import eval_tracknet, inference_tracknet, train_tracknet
from vision_conglomerate_torch.infer import tracknet_runner
from vision_conglomerate_torch.models import TrackNet
from vision_conglomerate_torch.train.checkpoint import save_checkpoint
from vision_conglomerate_torch.train.lr_schedule import make_lr_scheduler
from vision_conglomerate_torch.train.optim import make_optimizer
from vision_conglomerate_torch.train.tracknet_trainer import TrainTrackNetPipeline
from vision_conglomerate_torch.weights import flax_to_state_dict, state_dict_to_flax

from tests.test_torch_tracknet_adv_model import port_tracknet
from tests.test_torch_tracknet_data import write_video
from tests.test_torch_tracknet_serve import frames_of
from tests.test_torch_tracknet_train import make_batch, one_batch
from tests.test_torch_weights import flat, to_numpy
from tests.test_tracknet import _write_clip

H, W = 32, 64


def tiny_config(data_path: str = "data/tracknet") -> dict:
    """configs/tracknet/config_advanced.yaml at widths 0.25, depths 0.2,
    64x32, 2 loader workers."""
    with open(os.path.join(os.path.dirname(__file__), "..", "configs", "tracknet",
                           "config_advanced.yaml")) as f:
        config = yaml.safe_load(f)
    for section in config["model_config"]["advanced_arch_config"].values():
        if isinstance(section, dict):
            for cfg in section.values():
                cfg.update(width_multiple=0.25, depth_multiple=0.2)
    tc = config["train_config"]
    tc["data_path"] = data_path
    tc["img_config"]["img_wh"] = [W, H]
    tc["dataloader_config"]["num_workers"] = 2
    return config


CONFIG = tiny_config()
MC = CONFIG["model_config"]
OPT_CFG = CONFIG["train_config"]["optimizer_config"]
SCHED_CFG = CONFIG["train_config"]["lr_scheduler_config"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tiny_config_is_the_shipped_one_cut_in_width():
    assert MC["architecture"] == "advanced" and OPT_CFG["name"] == "Adam"
    assert tracknet_runner.adv_repvgg_canonical(MC)
    assert SCHED_CFG["eta_min"] == 1e-5 and MC["weight_init"] == "uniform"
    silu = copy.deepcopy(MC)
    silu["advanced_arch_config"]["decoder_config"]["deconvrepbipan_config"][
        "repvgg_branch_act"] = "silu"
    assert not tracknet_runner.adv_repvgg_canonical(silu)
    unset = copy.deepcopy(MC)
    del unset["advanced_arch_config"]["encoder_config"]["repbipan_config"]["repvgg_branch_act"]
    assert not tracknet_runner.adv_repvgg_canonical(unset)


def jax_pipeline(variables):
    """The JAX pipeline with the bridged variables in place of model.init
    and its re-initialisation, its state as the train step returns it."""
    model = JaxTrackNet(config=MC)
    tx, base_lr = jax_make_optimizer(OPT_CFG)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    with mock.patch.object(JaxTrackNet, "init", lambda self, *a, **k: jvars):
        pipe = JaxPipeline(model, tx, lr_scheduler=jax_make_lr_scheduler(SCHED_CFG, base_lr),
                           mesh=make_mesh(1), sample_input_shape=(H, W, 9))
    state = pipe.state.replace(params=jvars["params"], opt_state=tx.init(jvars["params"]),
                               step=jnp.zeros((), jnp.int32))
    pipe.state = jax.device_put(state, NamedSharding(pipe.mesh, PartitionSpec()))
    return pipe


def port_pipeline(variables, **kwargs):
    net = TrackNet(MC)
    net.load_state_dict(flax_to_state_dict(variables))
    optimizer, base_lr = make_optimizer(OPT_CFG, net)
    return TrainTrackNetPipeline(net, optimizer, init_scheme=None,
                                 lr_scheduler=make_lr_scheduler(SCHED_CFG, base_lr), **kwargs)


def snapshot(tree):
    return {k: np.array(v) for k, v in flat(to_numpy(tree)).items()}


@pytest.fixture(scope="module")
def adam(tmp_path_factory):
    """One Adam step on both sides from one set of weights, the JAX
    snapshot after it, and one more step on both sides, the port's resumed
    from that snapshot."""
    variables = state_dict_to_flax(port_tracknet(MC, seed=21).train().state_dict())
    batches = [make_batch(8, seed=30 + i) for i in range(2)]
    out = {"variables": variables}

    pipe = jax_pipeline(variables)
    out["jax_loss"] = pipe.train(one_batch(batches[0]))
    out["jax_vars"] = snapshot({"params": pipe.state.params,
                                "batch_stats": pipe.state.batch_stats})
    ckpt_dir = tmp_path_factory.mktemp("jax_adam_snapshot")
    pipe.checkpoints_dir = str(ckpt_dir)
    pipe.save_checkpoint()
    out["jax_opt_state"] = jax.device_get(pipe.state.opt_state)
    out["jax_lr_after"] = pipe.current_lr()
    out["jax_resumed_loss"] = pipe.train(one_batch(batches[1]))

    port = port_pipeline(variables)
    port.model.train()
    x, hm = (torch.from_numpy(a) for a in batches[0][:2])
    out["port_loss"] = port.train_step(x, hm).item()
    out["port_grads"] = {n: p.grad.numpy().copy() for n, p in port.model.named_parameters()}
    out["port_vars"] = snapshot(state_dict_to_flax(port.model.state_dict()))

    resumed = port_pipeline(variables, checkpoint_path=str(ckpt_dir))
    out["resumed_epoch"], out["resumed_lr"] = resumed.last_epoch, resumed.current_lr()
    out["resumed_opt_state"] = {n: {k: v.clone() for k, v in resumed.optimizer.state[p].items()}
                                for n, p in resumed.model.named_parameters()}
    out["port_resumed_loss"] = resumed.train(one_batch(batches[1]))
    return out


def pre_bn_bias(k) -> bool:
    return k[-1] == "bias" and k[-2] == "conv" and "deconv4" not in k


def jax_adam_state(adam):
    """(count, mu, nu) of the JAX snapshot's optax ScaleByAdamState."""
    found = [s for s in jax.tree_util.tree_leaves(
        adam["jax_opt_state"], is_leaf=lambda n: type(n).__name__ == "ScaleByAdamState")
        if type(s).__name__ == "ScaleByAdamState"]
    assert len(found) == 1
    return found[0]


def test_adam_step_matches_the_jax_pipeline(adam):
    """One step: the loss, the gradients (the JAX pipeline's read back from
    its first moment, mu = (1 - b1) g after one step), the running
    statistics, and the update's direction."""
    assert adam["port_loss"] == pytest.approx(float(adam["jax_loss"]), rel=1e-5)
    _, mu, _ = jax_adam_state(adam)
    b1 = OPT_CFG["betas"][0]
    want_g = {n: v.numpy() / (1 - b1) for n, v in flax_to_state_dict({"params": mu}).items()
              if not n.endswith("num_batches_tracked")}
    got_g = adam["port_grads"]
    assert sorted(got_g) == sorted(want_g)
    norm = lambda gs: np.sqrt(sum(np.sum(np.square(g, dtype=np.float64)) for g in gs.values()))  # noqa: E731
    assert norm(got_g) == pytest.approx(norm(want_g), rel=1e-4)
    for n, g in got_g.items():
        if not pre_bn_bias(tuple(n.split("."))):
            assert np.linalg.norm(g - want_g[n]) <= 2e-3 * np.linalg.norm(want_g[n]), n
    got, want, start = adam["port_vars"], adam["jax_vars"], flat(adam["variables"])
    assert sorted(got) == sorted(want)
    for k in want:
        if k[0] == "batch_stats":
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-5,
                                       err_msg="/".join(k))
        elif not pre_bn_bias(k):
            du, dw = got[k] - start[k], want[k] - start[k]
            cos = np.sum(du * dw) / (np.linalg.norm(du) * np.linalg.norm(dw))
            assert cos >= 0.98, ("/".join(k), cos)
            assert np.abs(du).max() <= 1.001 * OPT_CFG["lr"]


def test_resume_from_jax_snapshot_carries_adam_state(adam):
    """The JAX snapshot's mu / nu become exp_avg / exp_avg_sq with count as
    the step (a kernel's moments take the same layout, the transpose
    conv's flip included, as its weight); the epoch and the schedule resume;
    one more step matches the JAX pipeline's."""
    count, mu, nu = jax_adam_state(adam)
    want_m, want_v = flax_to_state_dict({"params": mu}), flax_to_state_dict({"params": nu})
    assert sorted(adam["resumed_opt_state"]) == sorted(
        k for k in want_m if not k.endswith("num_batches_tracked"))
    for name, st in adam["resumed_opt_state"].items():
        assert float(st["step"]) == float(count) == 1.0
        np.testing.assert_array_equal(st["exp_avg"].numpy(), want_m[name].numpy())
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), want_v[name].numpy())
    assert adam["resumed_epoch"] == 1
    assert adam["resumed_lr"] == pytest.approx(adam["jax_lr_after"], rel=1e-7)
    assert adam["port_resumed_loss"] == pytest.approx(float(adam["jax_resumed_loss"]), rel=1e-4)


SERVE_CONFIG = {"model_config": MC,
                "train_config": {"img_config": {"img_wh": [W, H], "num_stacks": 3},
                                 "heatmap_threshold": 128}}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("adv_ckpt") / "TrackNet.ckpt.tar")
    net = port_tracknet(MC, seed=13)
    save_checkpoint(path, {"LAST_EPOCH": 0, "NETWORK_PARAMS": state_dict_to_flax(net.state_dict())})
    return path


def serve_csv(out: str) -> pd.DataFrame:
    return pd.read_csv(os.path.join(out, "output.csv"))


def test_serving_a_frame_folder_matches_jax_and_the_train_form(tmp_path, checkpoint):
    """The JAX runner (fused deploy form, served in f32) and the port's,
    fused (RepVGG blocks fused, matmul and conv3x3 plain versions) and with
    use_reparam=False (the train form): the same output.csv rows."""
    folder = _write_clip(str(tmp_path / "tn"), n_frames=9, size=(80, 40))
    kw = dict(batch_size=4, with_summary=True)
    f32 = functools.partial(jax_runner.load_tracknet_model, dtype=jnp.float32)
    with mock.patch.object(jax_runner, "load_tracknet_model", f32):
        want = serve_csv(jax_runner.run_tracknet_inference(
            folder, checkpoint, SERVE_CONFIG, storage_path=str(tmp_path / "jax"), **kw))
    model = tracknet_runner.load_tracknet_model(checkpoint, MC, device="cpu")
    assert any(getattr(m, "deploy", False) for m in model.modules())
    for use_reparam in (True, False):
        got = serve_csv(tracknet_runner.run_tracknet_inference(
            folder, checkpoint, SERVE_CONFIG, device="cpu", use_reparam=use_reparam,
            storage_path=str(tmp_path / f"port_{use_reparam}"), **kw))
        assert list(got.columns) == ["frame", "x", "y", "r"] and len(got) > 0
        assert got["frame"].tolist() == want["frame"].tolist()
        np.testing.assert_allclose(got[["x", "y", "r"]].to_numpy(),
                                   want[["x", "y", "r"]].to_numpy(), atol=1e-3)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """train_tracknet's CLI on the CPU at the tiny advanced config: 13
    frames -> 11 windows -> 7 train (2 steps of 3) and 4 eval."""
    root = tmp_path_factory.mktemp("adv_cli")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        _write_clip("data/tracknet", n_frames=13)
        with open("config.yaml", "w") as f:
            yaml.safe_dump(CONFIG, f)
        pipe = train_tracknet.main(["--config_path", "config.yaml", "--batch_size", "3",
                                    "--epochs", "2", "--checkpoint_interval", "1",
                                    "--lr_schedule", "--no_verbose", "--device", "cpu"])
    finally:
        os.chdir(cwd)
    return root, pipe


def test_train_cli_trains_the_advanced_net_with_adam(trained):
    root, pipe = trained
    assert len(pipe._train_metrics) == 2 and all(np.isfinite(m["loss"])
                                                 for m in pipe._train_metrics + pipe._eval_metrics)
    assert type(pipe.optimizer).__name__ == "Adam"
    assert pipe.optimizer.defaults["betas"] == (0.9, 0.999)
    assert 1e-5 < pipe.current_lr() < 1e-3  # the warm-restart schedule, eta_min 1e-5
    for rel in ("metrics/tracknet/train_metrics.csv", "metrics/tracknet/eval_metrics.csv",
                "saved_model/tracknet/best_model/TrackNet.ckpt.tar",
                "saved_model/tracknet/best_model/config/config.yaml"):
        assert os.path.isfile(os.path.join(root, rel)), rel
    ev = pd.read_csv(os.path.join(root, "metrics/tracknet/eval_metrics.csv"))
    assert (ev[["tp", "tn", "fp", "fn"]].sum(axis=1) == 4).all()
    assert isinstance(pipe.model.encoder.enc_module_p2.repblock0.conv1.conv3x3.conv,
                      torch.nn.Conv2d)


def test_eval_cli_scores_both_forms_alike(trained, capsys):
    """eval_tracknet on the trained checkpoint, train form and --deploy
    (BatchNorm folded, RepVGG fused): the JAX CLI's keys, and the same f1
    and counts from both forms."""
    root, _ = trained
    out = {}
    cwd = os.getcwd()
    os.chdir(root)
    try:
        for form in ([], ["--deploy"]):
            got = eval_tracknet.main(["--batch_size", "3", "--device", "cpu"] + form)
            printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
            assert printed == got
            out[got["form"]] = got
    finally:
        os.chdir(cwd)
    train, deploy = out["train"], out["deploy"]
    assert list(train) == ["f1", "precision", "recall", "tp", "tn", "fp", "fn", "eval_loss",
                           "num_windows", "decode", "form", "weights"]
    assert train["num_windows"] == 4
    for k in ("f1", "precision", "recall", "tp", "tn", "fp", "fn"):
        assert train[k] == deploy[k], k
    assert deploy["eval_loss"] == pytest.approx(train["eval_loss"], rel=1e-4)


@pytest.mark.parametrize("source", ["video", "folder"])
def test_inference_cli_serves_the_trained_checkpoint(trained, source, tmp_path):
    root, _ = trained
    path = (write_video(str(tmp_path / "clip.mp4"), n=10, wh=(80, 40)) if source == "video"
            else "data/tracknet/game1/Clip1")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        out = inference_tracknet.main(["--path", path, "--device", "cpu", "--with_summary",
                                       "--batch_size", "4"])
        served = frames_of(os.path.join(out, "video.mp4"))
        assert served.shape[0] == (10 if source == "video" else 13)
        csv = serve_csv(out)
        assert list(csv.columns) == ["frame", "x", "y", "r"]
        assert len(csv) == 0 or csv["frame"].min() >= 3
    finally:
        os.chdir(cwd)
