"""The port's train_det CLI on the CPU, on a synthetic workspace (the shapes
of tests/test_cli_train.py): the artifacts it writes, auto-anchors, resume
from its own snapshots, and checkpoints across packages (the port's best
model and snapshot in the JAX package, a JAX snapshot with optax state in
the port, in a fresh interpreter that must end with no JAX module loaded).
"""
import hashlib
import os
import shutil
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import yaml
from PIL import Image

import jax
import jax.numpy as jnp
import torch

from vision_conglomerate_tpu.models import DetectionNet as JaxDetectionNet
from vision_conglomerate_tpu.losses import DetectionLossConfig as JaxLossConfig
from vision_conglomerate_tpu.parallel import make_mesh
from vision_conglomerate_tpu.train import TrainDetectionPipeline as JaxPipeline
from vision_conglomerate_tpu.train import make_optimizer as jax_make_optimizer
from vision_conglomerate_tpu.train.lr_schedule import make_lr_scheduler as jax_make_lr_scheduler

from vision_conglomerate_torch import train_det
from vision_conglomerate_torch.models.detection import DetectionNet
from vision_conglomerate_torch.train.checkpoint import load_checkpoint
from vision_conglomerate_torch.weights import flax_to_state_dict

from tests.test_torch_weights import flat, to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ANCHORS = os.path.join(REPO, "configs", "detection", "anchors.yaml")
BEST = "saved_model/detection/best_model/DetectionNet.ckpt.tar"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vision_conglomerate_tpu")

CONFIG = {
    "model_config": {
        "train_anchors": True,
        "backbone": "CSPBackBone",
        "neck": "RepBiPAN",
        "head": "EffiDecHead",
        "cspbackbone_config": {"width_multiple": 0.25, "depth_multiple": 0.2},
        "repbipan_config": {"width_multiple": 0.25, "depth_multiple": 0.2},
        "effidechead_config": {"width_multiple": 0.5},
    },
    "auto_anchors_config": {
        "threshold": 4.0, "score_tol": 0.8, "bpr_tol": 1.0,
        "num_generations": 3, "kmeans_iter": 5,
        "mut_proba": 0.9, "sigma": 0.1, "update_anchors_cfg": True,
    },
    "train_config": {
        "data_path": "data/detection",
        # in order, so a resumed run sees the batches of an uninterrupted one
        "dataloader_config": {"shuffle": False, "num_workers": 2, "max_labels": 8},
        "img_config": {"img_ext": "png", "img_wh": [64, 64]},
        "loss_config": {"box_w": 0.1, "class_w": 0.3, "conf_w": 1.0,
                        "label_smoothing": 0.001},
        "optimizer_config": {"name": "Adam", "lr": 1e-3},
        "lr_scheduler_config": {"name": "CosineAnnealingWarmRestarts",
                                "T_0": 10, "T_mult": 1, "eta_min": 1e-6},
    },
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: as fast for these small tensors, and parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _write_dataset(root, n, size=64, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        img = (rng.uniform(size=(size, size, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, f"img_{i}.png"))
        with open(os.path.join(root, f"img_{i}.txt"), "w") as f:
            f.write("0 0.5 0.5 0.3 0.3\n1 0.25 0.25 0.15 0.2\n")


def _workspace(root, config=CONFIG):
    """data/, config.yaml and a copy of the repo's anchors.yaml under root."""
    _write_dataset(os.path.join(root, "data/detection/train"), 4)
    _write_dataset(os.path.join(root, "data/detection/valid"), 2, seed=1)
    with open(os.path.join(root, "config.yaml"), "w") as f:
        yaml.safe_dump(config, f)
    shutil.copy(REPO_ANCHORS, os.path.join(root, "anchors.yaml"))


def _train(cwd, *extra):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return train_det.main(["--config_path", "config.yaml", "--anchors_path", "anchors.yaml",
                               "--batch_size", "2", "--checkpoint_interval", "1",
                               "--lr_schedule", "--no_verbose", "--device", "cpu", *extra])
    finally:
        os.chdir(old)


def _snapshot(cwd, epoch):
    snaps = [os.path.join(r, f) for r, _, fs in os.walk(os.path.join(cwd, "saved_model"))
             for f in fs if f.startswith(f"DetectionNet-{epoch}-")]
    assert len(snaps) == 1, snaps
    return snaps[0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run A: 2 epochs. Run B: resumed from A's epoch-1 snapshot to epoch 2."""
    repo_anchors = _sha(REPO_ANCHORS)
    a = str(tmp_path_factory.mktemp("run_a"))
    _workspace(a)
    copy_before = _sha(os.path.join(a, "anchors.yaml"))
    pipe_a = _train(a, "--epochs", "2")
    b = str(tmp_path_factory.mktemp("run_b"))
    _workspace(b)
    pipe_b = _train(b, "--epochs", "2", "--checkpoint_path", _snapshot(a, 1))
    assert _sha(REPO_ANCHORS) == repo_anchors
    return dict(a=a, b=b, pipe_a=pipe_a, pipe_b=pipe_b, copy_before=copy_before)


def test_cli_writes_artifacts(runs):
    a = runs["a"]
    for rel in ("metrics/detection/train_metrics.csv", "metrics/detection/eval_metrics.csv",
                "metrics/detection/train_metrics_plot.jpg", "metrics/detection/eval_metrics_plot.jpg",
                BEST, "saved_model/detection/best_model/config/config.yaml"):
        assert os.path.isfile(os.path.join(a, rel)), rel
    _snapshot(a, 1), _snapshot(a, 2)
    with open(os.path.join(a, "saved_model/detection/best_model/config/config.yaml")) as f:
        assert "num_keypoints" in yaml.safe_load(f)["model_config"]
    hist = runs["pipe_a"]._train_metrics
    assert len(hist) == 2 and all(np.isfinite(m["aggregate_loss"]) for m in hist)
    manifest = load_checkpoint(os.path.join(a, BEST))
    kernel = manifest["NETWORK_PARAMS"]["params"]["backbone"]["conv0"]["conv"]["kernel"]
    assert kernel.dtype == np.float32 and "OPTIMIZER_PARAMS" not in manifest


def test_auto_anchors_rewrite_only_the_given_copy(runs):
    """The repo's anchors fit the synthetic boxes poorly, so auto-anchors
    rewrote the workspace copy; the repo file is unchanged (checked in the
    fixture) and the model trained with the new anchors."""
    a = runs["a"]
    path = os.path.join(a, "anchors.yaml")
    assert _sha(path) != runs["copy_before"]
    with open(path) as f:
        new = yaml.safe_load(f)["anchors"]
    np.testing.assert_allclose(runs["pipe_a"].model.sm_anchors.detach().numpy(), new["sm"],
                               rtol=1e-6)


def test_resume_from_port_snapshot_matches_uninterrupted(runs):
    a, b = runs["pipe_a"], runs["pipe_b"]
    assert b.last_epoch == a.last_epoch == 2
    assert len(b._train_metrics) == 2  # one restored, one trained
    for got, want in ((b._train_metrics[1], a._train_metrics[1]),
                      (b._eval_metrics[-1], a._eval_metrics[-1])):
        for k in want:
            if k != "images_per_sec":
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    for (k, v), w in zip(b.model.state_dict().items(), a.model.state_dict().values()):
        torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)


@pytest.fixture(scope="module")
def jax_pipeline(runs):
    """A JAX pipeline over the CLI's model config, its initial variables
    taken from the port's best model in place of model.init."""
    manifest = load_checkpoint(os.path.join(runs["a"], BEST))
    variables = jax.tree_util.tree_map(jnp.asarray, manifest["NETWORK_PARAMS"])
    model = JaxDetectionNet(num_classes=2, config=CONFIG["model_config"])
    tx, base_lr = jax_make_optimizer(CONFIG["train_config"]["optimizer_config"])
    sched = jax_make_lr_scheduler(CONFIG["train_config"]["lr_scheduler_config"], base_lr)
    with mock.patch.object(JaxDetectionNet, "init", lambda self, *a, **k: variables):
        pipe = JaxPipeline(model, JaxLossConfig(num_classes=2), tx, lr_scheduler=sched,
                           mesh=make_mesh(1), sample_input_shape=(64, 64, 3), init_scheme="")
    return pipe, manifest


def test_port_best_model_runs_in_jax(runs, jax_pipeline):
    pipe, manifest = jax_pipeline
    x = np.random.default_rng(7).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: pipe.model.apply(v, x, train=False))(
        manifest["NETWORK_PARAMS"], jnp.asarray(x))
    net = DetectionNet(2, CONFIG["model_config"], device="cpu")
    net.load_state_dict(flax_to_state_dict(manifest["NETWORK_PARAMS"]))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        assert np.isfinite(np.asarray(w)).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_port_snapshot_loads_in_jax(runs, jax_pipeline):
    pipe, _ = jax_pipeline
    path = _snapshot(runs["a"], 2)
    manifest = pipe.load_checkpoint(path)
    assert pipe.last_epoch == 2 and len(pipe._train_metrics) == 2
    assert "TORCH_OPTIMIZER_PARAMS" in manifest and "OPTIMIZER_PARAMS" not in manifest
    want = flat(manifest["NETWORK_PARAMS"]["params"])
    got = flat(to_numpy(pipe.state.params))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert pipe.lr_scheduler.T_cur == runs["pipe_a"].lr_scheduler.T_cur == 2


_RESUME = """
import json, sys
import numpy as np, torch
from argparse import Namespace
from vision_conglomerate_torch import train_det
from vision_conglomerate_torch.utils import load_yaml

config = load_yaml("config.yaml")
args = Namespace(batch_size=2, epochs=2, checkpoint_interval=1, eval_interval=1, no_verbose=True,
                 lr_schedule=True, lr_schedule_interval=1, use_ddp=False, map_eval=False,
                 checkpoint_path=sys.argv[1], profile_dir="", lr=0.0, device="cpu")
pipe, train_dl, _ = train_det.build(args, config, "config.yaml", "anchors.yaml")
want = np.load(sys.argv[2])
opt = pipe.optimizer
names = {id(p): n for n, p in pipe.model.named_parameters()}
for p in opt.param_groups[0]["params"]:
    st = opt.state[p]
    assert float(st["step"]) == 1.0, st["step"]
    for key in ("exp_avg", "exp_avg_sq"):
        np.testing.assert_array_equal(st[key].numpy(), want[key + ":" + names[id(p)]])
assert pipe.last_epoch == 1 and pipe.lr_scheduler.T_cur == 3
loss = pipe.train(train_dl)["aggregate_loss"]
assert np.isfinite(loss) and all(float(opt.state[p]["step"]) == 3.0
                                 for p in opt.param_groups[0]["params"])
bad = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
print(json.dumps({"loss": loss, "bad": bad}))
sys.exit(1 if bad else 0)
"""


def test_jax_snapshot_with_optax_state_resumes_in_port(tmp_path, jax_pipeline):
    """One Adam update in the JAX package, saved as a snapshot; a fresh
    interpreter resumes it in the port with the moments and count carried
    over, trains an epoch, and has no JAX module loaded."""
    pipe, manifest = jax_pipeline
    params = pipe.state.params
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.random.default_rng(p.size).normal(size=p.shape), p.dtype), params)
    updates, opt_state = jax.jit(pipe.tx.update)(grads, pipe.tx.init(params), params)
    pipe.state = pipe.state.replace(opt_state=opt_state)
    pipe.lr_scheduler = jax_make_lr_scheduler(CONFIG["train_config"]["lr_scheduler_config"], 1e-3)
    for _ in range(3):
        pipe.lr_scheduler.step()
    pipe.last_epoch = 1
    pipe.checkpoints_dir = str(tmp_path / "jax_snapshot")
    pipe.save_checkpoint()
    (snap,) = os.listdir(pipe.checkpoints_dir)
    snap = os.path.join(pipe.checkpoints_dir, snap)
    with open(snap, "rb") as f:
        assert b"optax" in f.read()  # the manifest pickles optax classes

    adam = opt_state.inner_state[0]
    want = {}
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        for name, v in flax_to_state_dict({"params": to_numpy(tree)}).items():
            want[f"{key}:{name}"] = v.numpy()
    np.savez(tmp_path / "want.npz", **want)

    ws = tmp_path / "ws"
    ws.mkdir()
    _workspace(str(ws))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-c", _RESUME.replace("FORBIDDEN", repr(FORBIDDEN)), snap,
         str(tmp_path / "want.npz")],
        cwd=ws, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert '"bad": []' in proc.stdout
