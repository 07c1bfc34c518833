"""TrackNet serving and the three TrackNet CLIs of the PyTorch port against
the JAX package, on the CPU: `run_tracknet_inference` on a tiny clip (at
frame_skips 0 and 1) and on a frame folder, from one checkpoint, against
the JAX runner (served in f32, as the port serves on the CPU): video.mp4's
frames, output.csv's rows; the per-batch gap filling; and the CLIs with
`--device cpu` (train_tracknet's artifacts, eval_tracknet's JSON line
against the JAX CLI's on the same checkpoint and data, inference_tracknet's
outputs, the raises of the parts not in the port).

Tolerances: output.csv's x, y, r atol 1e-3 px (f32 centroids of the same
blobs); decoded video frames mean |d| <= 1 (the same drawing of the same
tracks through two mp4v encodes); eval f1 and counts exact, its loss rtol
1e-4.
"""
import contextlib
import functools
import json
import os
from unittest import mock

import cv2
import numpy as np
import pandas as pd
import pytest
import yaml

import jax.numpy as jnp
import torch

from vision_conglomerate_tpu.infer import tracknet_runner as jax_runner

from vision_conglomerate_torch import eval_tracknet, inference_tracknet, train_tracknet
from vision_conglomerate_torch.infer import tracknet_runner
from vision_conglomerate_torch.train.checkpoint import save_checkpoint
from vision_conglomerate_torch.weights import state_dict_to_flax

from tests.test_torch_tracknet_data import write_video
from tests.test_torch_tracknet_model import CONFIG, port_tracknet
from tests.test_tracknet import _write_clip

SERVE_CONFIG = {
    "model_config": CONFIG,
    "train_config": {"img_config": {"img_wh": [64, 32], "num_stacks": 3},
                     "heatmap_threshold": 128},
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tn_ckpt") / "TrackNet.ckpt.tar")
    net = port_tracknet(seed=13)
    save_checkpoint(path, {"LAST_EPOCH": 0, "NETWORK_PARAMS": state_dict_to_flax(net.state_dict())})
    return path


def frames_of(video: str) -> np.ndarray:
    cap = cv2.VideoCapture(video)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return np.stack(out)


@pytest.mark.parametrize("source,frame_skips", [("video", 0), ("video", 1), ("folder", 0)])
def test_run_tracknet_inference_matches_jax(tmp_path, checkpoint, source, frame_skips):
    if source == "video":
        path = write_video(str(tmp_path / "clip.mp4"), n=10, wh=(80, 40))
        # the 2 lead-in frames, then a frame per window of kept frames
        n_frames = 10 if frame_skips == 0 else 2 + (5 - 2)
    else:
        path = _write_clip(str(tmp_path / "tn"), n_frames=9, size=(80, 40))
        n_frames = 9
    kw = dict(batch_size=4, with_summary=True, frame_skips=frame_skips, img_ext="jpg")
    f32 = functools.partial(jax_runner.load_tracknet_model, dtype=jnp.float32)
    with mock.patch.object(jax_runner, "load_tracknet_model", f32):
        want = jax_runner.run_tracknet_inference(path, checkpoint, SERVE_CONFIG,
                                                 storage_path=str(tmp_path / "jax"), **kw)
    got = tracknet_runner.run_tracknet_inference(path, checkpoint, SERVE_CONFIG, device="cpu",
                                                 storage_path=str(tmp_path / "port"), **kw)
    got_frames, want_frames = frames_of(os.path.join(got, "video.mp4")), \
        frames_of(os.path.join(want, "video.mp4"))
    assert got_frames.shape == want_frames.shape and got_frames.shape[0] == n_frames
    assert np.abs(got_frames.astype(int) - want_frames.astype(int)).mean() <= 1.0
    got_csv, want_csv = (pd.read_csv(os.path.join(d, "output.csv")) for d in (got, want))
    assert list(got_csv.columns) == ["frame", "x", "y", "r"]
    assert len(got_csv) > 0 and got_csv["frame"].tolist() == want_csv["frame"].tolist()
    assert got_csv["frame"].min() >= 3  # the lead-in frames have no track
    np.testing.assert_allclose(got_csv[["x", "y", "r"]].to_numpy(),
                               want_csv[["x", "y", "r"]].to_numpy(), atol=1e-3)


def test_fill_gaps_per_batch():
    """np.interp over the missing rows when at least half were found; a
    batch with fewer found rows, or none, stays as it is."""
    nan = np.nan
    half = np.array([[0, 0, 1], [nan, nan, nan], [4, 8, 3], [nan, nan, nan]], float)
    filled = tracknet_runner.fill_gaps(half.copy())
    np.testing.assert_allclose(filled, [[0, 0, 1], [2, 4, 2], [4, 8, 3], [4, 8, 3]])
    few = np.array([[1, 1, 1], [nan] * 3, [nan] * 3, [nan] * 3, [nan] * 3], float)
    np.testing.assert_array_equal(tracknet_runner.fill_gaps(few.copy()), few)
    none = np.full((3, 3), nan)
    np.testing.assert_array_equal(tracknet_runner.fill_gaps(none.copy()), none)


def test_serve_raises_for_what_is_not_ported(tmp_path, checkpoint):
    """What the port does not serve raises (a module TrackNet does not
    take: KeyError, as in the JAX package); int8 (ROADMAP §A.10), left out
    until it was done, now serves: on a frame folder it gives the JAX
    runner's int8 tracks (both in f32, the same int8 arithmetic: x, y, r
    within 1e-3 px), and without the deploy form it raises, as there."""
    clip = _write_clip(str(tmp_path / "tn"), n_frames=9, size=(80, 40))
    kw = dict(batch_size=4, with_summary=True, quantize="int8")
    f32 = functools.partial(jax_runner.load_tracknet_model, dtype=jnp.float32)
    with mock.patch.object(jax_runner, "load_tracknet_model", f32):
        want = jax_runner.run_tracknet_inference(clip, checkpoint, SERVE_CONFIG,
                                                 storage_path=str(tmp_path / "jax"), **kw)
    got = tracknet_runner.run_tracknet_inference(clip, checkpoint, SERVE_CONFIG, device="cpu",
                                                 storage_path=str(tmp_path / "o"), **kw)
    got_csv, want_csv = (pd.read_csv(os.path.join(d, "output.csv")) for d in (got, want))
    assert len(got_csv) > 0 and got_csv["frame"].tolist() == want_csv["frame"].tolist()
    np.testing.assert_allclose(got_csv[["x", "y", "r"]].to_numpy(),
                               want_csv[["x", "y", "r"]].to_numpy(), atol=1e-3)
    with pytest.raises(ValueError, match="deploy"):
        tracknet_runner.run_tracknet_inference(clip, checkpoint, SERVE_CONFIG, quantize="int8",
                                               use_reparam=False, device="cpu")
    with pytest.raises(OSError):
        tracknet_runner.run_tracknet_inference(str(tmp_path / "nothing"), checkpoint,
                                               SERVE_CONFIG, device="cpu")
    # BasicHead is a detection head: TRACKNET_MODULES does not hold it, in
    # either package
    with pytest.raises(KeyError):
        tracknet_runner.load_tracknet_model(
            checkpoint, {**CONFIG, "architecture": "advanced", "advanced_arch_config": {
                "encoder_modules": ["CSPNet", "RepBiPAN"],
                "decoder_modules": ["DeconvRepBiPAN", "BasicHead"]}}, use_reparam=False,
            device="cpu")


TRAIN_CONFIG = {
    "model_config": CONFIG,
    "train_config": {
        "data_path": "data/tracknet",
        "tp_dist_tol": 4.0,
        "heatmap_threshold": 128,
        "heatmap_decode": "centroid",
        "dataloader_config": {"shuffle": True, "num_workers": 2},
        "img_config": {"img_wh": [64, 32], "num_stacks": 3, "avg_diameter": 5},
        "optimizer_config": {"name": "Adadelta", "lr": 1.0, "rho": 0.9, "eps": 1.0e-6,
                             "weight_decay": 0},
        "lr_scheduler_config": {"name": "CosineAnnealingWarmRestarts", "T_0": 250, "T_mult": 1,
                                "eta_min": 0.7},
    },
}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """train_tracknet's CLI on the CPU in a workspace: 13 frames -> 11
    windows -> 7 train (2 steps of 3) and 4 eval (a ragged tail at 3)."""
    root = tmp_path_factory.mktemp("tn_cli")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        _write_clip("data/tracknet", n_frames=13)
        with open("config.yaml", "w") as f:
            yaml.safe_dump(TRAIN_CONFIG, f)
        pipe = train_tracknet.main(["--config_path", "config.yaml", "--batch_size", "3",
                                    "--epochs", "2", "--checkpoint_interval", "1",
                                    "--lr_schedule", "--no_verbose", "--device", "cpu"])
    finally:
        os.chdir(cwd)
    return root, pipe


def test_train_cli_writes_the_jax_clis_artifacts(trained):
    root, pipe = trained
    assert len(pipe._train_metrics) == 2 and all(np.isfinite(m["loss"]) for m in pipe._train_metrics)
    for rel in ("metrics/tracknet/train_metrics.csv", "metrics/tracknet/eval_metrics.csv",
                "metrics/tracknet/train_metrics_plot.jpg",
                "saved_model/tracknet/best_model/TrackNet.ckpt.tar",
                "saved_model/tracknet/best_model/config/config.yaml"):
        assert os.path.isfile(os.path.join(root, rel)), rel
    ev = pd.read_csv(os.path.join(root, "metrics/tracknet/eval_metrics.csv"))
    assert list(ev.columns) == ["loss", "tp", "tn", "fp", "fn", "precision", "recall", "f1"]
    assert (ev[["tp", "tn", "fp", "fn"]].sum(axis=1) == 4).all()  # every eval window once
    snaps = [f for _, _, fs in os.walk(os.path.join(root, "saved_model/tracknet/checkpoints"))
             for f in fs if f.endswith(".ckpt.tar")]
    assert len(snaps) == 2
    assert pipe.optimizer.__class__.__name__ == "Adadelta" and pipe.current_lr() < 1.0


@pytest.mark.parametrize("form", ["train", "deploy"])
def test_eval_cli_matches_the_jax_cli(trained, form, capsys):
    """The same JSON keys, f1 and counts as the JAX package's
    eval_tracknet.py on the port-trained checkpoint and the same clips."""
    import eval_tracknet as jax_eval_cli

    root, _ = trained
    argv = ["--weights_path", "saved_model/tracknet/best_model/TrackNet.ckpt.tar",
            "--batch_size", "3"] + (["--deploy"] if form == "deploy" else [])
    cwd = os.getcwd()
    os.chdir(root)
    try:
        with mock.patch("vision_conglomerate_tpu.data.tracknet.TrackNetDataset.__init__",
                        _seeded_init()), _jitted_jax_init():
            want = jax_eval_cli.run(jax_eval_cli.build_parser().parse_args(argv))
        capsys.readouterr()
        with mock.patch("vision_conglomerate_torch.data.tracknet.TrackNetDataset.__init__",
                        _seeded_init(port=True)):
            got = eval_tracknet.main(argv + ["--device", "cpu"])
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    finally:
        os.chdir(cwd)
    assert printed == got and list(got) == list(want)
    assert got["form"] == want["form"] == form and got["num_windows"] == 4
    for k in ("f1", "precision", "recall", "tp", "tn", "fp", "fn", "decode"):
        assert got[k] == want[k], k
    assert got["eval_loss"] == pytest.approx(want["eval_loss"], rel=1e-4)


@contextlib.contextmanager
def _jitted_jax_init():
    """The JAX TrackNet's init and the JAX trainer's init schemes, jitted:
    the same values as eager (the checkpoint replaces them in any case) at
    a fraction of the compile time of their eager ops."""
    import jax

    from vision_conglomerate_tpu.models import TrackNet as JaxTrackNet
    from vision_conglomerate_tpu.train import tracknet_trainer as jax_tracknet_trainer

    init = JaxTrackNet.init

    def jitted(self, key, x, **kw):
        return jax.jit(lambda k, xs: init(self, k, xs, **kw))(key, x)

    with mock.patch.object(JaxTrackNet, "init", jitted), mock.patch.dict(
            jax_tracknet_trainer.INIT_SCHEMES,
            {k: jax.jit(v) for k, v in jax_tracknet_trainer.INIT_SCHEMES.items()}):
        yield


def _seeded_init(port: bool = False):
    """TrackNetDataset.__init__ with seed 0 where the CLI leaves the eval
    set's shuffle unseeded (both packages), so both see one order."""
    if port:
        from vision_conglomerate_torch.data.tracknet import TrackNetDataset
    else:
        from vision_conglomerate_tpu.data.tracknet import TrackNetDataset
    orig = TrackNetDataset.__init__

    def init(self, *args, seed=None, **kwargs):
        orig(self, *args, seed=0 if seed is None else seed, **kwargs)
    return init


def test_inference_cli_serves_the_trained_checkpoint(trained):
    root, _ = trained
    cwd = os.getcwd()
    os.chdir(root)
    try:
        out = inference_tracknet.main(["--path", "data/tracknet/game1/Clip1", "--device", "cpu",
                                       "--with_summary", "--batch_size", "4"])
        assert frames_of(os.path.join(out, "video.mp4")).shape[0] == 13
        assert list(pd.read_csv(os.path.join(out, "output.csv")).columns) == [
            "frame", "x", "y", "r"]
        # int8 (ROADMAP §A.10) serves and scores: --quantize int8 implies
        # the deploy form, and eval_tracknet's line says "int8"
        out = inference_tracknet.main(["--path", "data/tracknet/game1/Clip1", "--device", "cpu",
                                       "--with_summary", "--batch_size", "4",
                                       "--quantize", "int8"])
        assert frames_of(os.path.join(out, "video.mp4")).shape[0] == 13
        deploy = eval_tracknet.main(["--device", "cpu", "--deploy", "--batch_size", "3"])
        int8 = eval_tracknet.main(["--device", "cpu", "--quantize", "int8", "--batch_size", "3"])
        assert int8["form"] == "int8" and list(int8) == list(deploy)
        assert int8["num_windows"] == deploy["num_windows"]
        assert int8["eval_loss"] == pytest.approx(deploy["eval_loss"], rel=0.05)
    finally:
        os.chdir(cwd)


def test_cli_defaults_and_raises(trained):
    """The CLIs default to cuda and take the JAX CLI's flags; --use_ddp
    without torchrun builds in a world of one (gloo on the CPU): the lr is
    the config's times 1 and both loaders shard (tests/test_torch_ddp*.py
    run two ranks)."""
    from vision_conglomerate_torch.parallel import mesh

    for mod in (train_tracknet, eval_tracknet, inference_tracknet):
        assert mod.build_parser().parse_args([]).device == "cuda"
    jax_flags = {"--batch_size", "--epochs", "--steps_per_epoch", "--checkpoint_interval",
                 "--eval_interval", "--no_verbose", "--lr_schedule", "--lr_schedule_interval",
                 "--use_ddp", "--checkpoint_path", "--config_path", "--lr", "--cache_data"}
    assert jax_flags <= set(train_tracknet.build_parser()._option_string_actions)
    args = train_tracknet.build_parser().parse_args(
        ["--use_ddp", "--batch_size", "3", "--device", "cpu"])
    root, _ = trained
    cwd = os.getcwd()
    os.chdir(root)
    try:
        pipe, train_dl, eval_dl = train_tracknet.build(args, TRAIN_CONFIG, None)
        assert mesh.is_distributed() and mesh.world_size() == 1
        assert pipe.optimizer.param_groups[0]["lr"] == 1.0
        assert train_dl.shard and eval_dl.shard and train_dl.batch_size == 3
    finally:
        mesh.shutdown_distributed()
        os.chdir(cwd)
    assert not mesh.is_distributed()
