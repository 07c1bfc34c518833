"""The keypoint paths of the PyTorch port's entry points against the JAX
package's, on the CPU: train_det on keypoint data (the saved config
carries num_keypoints, --map_eval writes pck), eval_det's PCK fields (f32
and int8), the PCK harness, and inference_det on images and on a video
with tracked classes, where the keypoints are drawn and ride the tracker.

Data: dev/make_shapes_dataset.py's keypoint rule at 64x64 (2 keypoints an
object, about 10% with vis 0), PNG. The net is tests/test_torch_train_cli's
small config (width 0.25, depth 0.2, 64x64). Tolerances: metrics 1e-4
(both forwards f32; the JAX side compiles one forward); the keypoints
handed to the drawing 1e-3 px and their visibility class exactly; the
harness on given predictions exactly (the same numpy arithmetic).
"""
import functools
import os
from collections import namedtuple
from unittest import mock

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

import jax.numpy as jnp

import eval_det as jax_eval_det
from dev.make_shapes_dataset import make_split
from vision_conglomerate_tpu.infer import runner as jax_runner
from vision_conglomerate_tpu.tools import eval_harness as jax_eval_harness

from vision_conglomerate_torch import eval_det, inference_det
from vision_conglomerate_torch.data.detection import DetectionDataset
from vision_conglomerate_torch.infer import runner
from vision_conglomerate_torch.ops.postprocess import PostProcessResult
from vision_conglomerate_torch.tools import eval_harness
from vision_conglomerate_torch.tools.eval_harness import (
    evaluate_checkpoint_map, evaluate_pipeline_map)
from vision_conglomerate_torch.train.checkpoint import save_checkpoint
from vision_conglomerate_torch.utils import save_yaml
from vision_conglomerate_torch.weights import state_dict_to_flax

from tests.test_torch_keypoints import KP, KP_CONFIG, port_kp_net
from tests.test_torch_train_cli import BEST, CONFIG, REPO_ANCHORS, _train
from tests.test_torch_video import SERVE_KW, frame_at, tracking_net, write_clip
from tests.test_torch_weights import NUM_CLASSES

cv2 = pytest.importorskip("cv2")

SIZE = 64
METRIC_TOL = 1e-4
PCK_KEYS = ["pck10", "pck_matched", "num_visible_keypoints"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ train
@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """train_det (port, CPU) for one epoch with --map_eval on 4 + 3
    keypoint images; the JAX eval_det's JSON line on its best model, in f32
    and in int8."""
    ws = str(tmp_path_factory.mktemp("kp_train"))
    make_split(os.path.join(ws, "data/detection/train"), 4, SIZE, np.random.default_rng(0),
               keypoints=True, ext="png")
    make_split(os.path.join(ws, "data/detection/valid"), 3, SIZE, np.random.default_rng(1),
               keypoints=True, ext="png")
    with open(os.path.join(ws, "config.yaml"), "w") as f:
        yaml.safe_dump({**CONFIG, "model_config": {
            **CONFIG["model_config"], "effidechead_config": KP_CONFIG["effidechead_config"]},
            "train_config": {**CONFIG["train_config"],
                             "loss_config": {**CONFIG["train_config"]["loss_config"],
                                             "keypoints_w": 5.0}}}, f)
    with open(REPO_ANCHORS) as src, open(os.path.join(ws, "anchors.yaml"), "w") as dst:
        dst.write(src.read())
    pipe = _train(ws, "--epochs", "1", "--map_eval")
    argv = ["--weights_path", os.path.join(ws, BEST), "--data_dir",
            os.path.join(ws, "data/detection/valid"), "--batch_size", "2"]
    f32 = functools.partial(jax_eval_harness.evaluate_checkpoint_map, dtype=jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_eval_harness, "evaluate_checkpoint_map", f32)
        want = {q: jax_eval_det.run(jax_eval_det.build_parser().parse_args(
            argv + ["--quantize", q])) for q in ("none", "int8")}
    return dict(ws=ws, pipe=pipe, argv=argv, want=want)


def test_train_det_saves_num_keypoints(trained):
    """The saved config carries num_keypoints, as the JAX trainer's does,
    so the best model reloads with its keypoint head (the port once
    passed None here, and the reload lost the head)."""
    best_cfg = os.path.join(trained["ws"], os.path.dirname(BEST), "config", "config.yaml")
    with open(best_cfg) as f:
        model_config = yaml.safe_load(f)["model_config"]
    assert model_config["num_keypoints"] == KP
    model, _ = runner.load_detection_model(os.path.join(trained["ws"], BEST), model_config,
                                           num_keypoints=model_config["num_keypoints"],
                                           device="cpu")
    assert all(h.keypoints_layer.out_channels == 3 * 5 * KP for h in model.head)
    assert trained["pipe"].model.num_keypoints == KP


def test_train_det_map_eval_writes_pck(trained):
    df = pd.read_csv(os.path.join(trained["ws"], "metrics/detection/eval_metrics.csv"))
    assert {"map50", "pck", "kp_loss", "kpv_loss", "kpc_loss"} <= set(df.columns)
    assert len(df) == 1 and 0.0 <= df["pck"].iloc[0] <= 1.0
    assert trained["pipe"]._eval_metrics[-1]["pck"] == df["pck"].iloc[0]


def test_train_metrics_carry_the_keypoint_losses(trained):
    df = pd.read_csv(os.path.join(trained["ws"], "metrics/detection/train_metrics.csv"))
    vals = df[["kp_loss", "kpv_loss", "kpc_loss"]].to_numpy()
    assert np.isfinite(vals).all() and (vals > 0).all()


# ------------------------------------------------------------------- eval
def _assert_lines_match(got, want):
    assert list(got) == list(want)
    assert list(got)[2:5] == PCK_KEYS
    for k in ("map50", "pck10", "pck_matched"):
        assert abs(got[k] - want[k]) <= METRIC_TOL, k
    assert got["num_visible_keypoints"] == want["num_visible_keypoints"] > 0


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_eval_det_prints_pck_as_jax(trained, quantize, capsys):
    capsys.readouterr()
    got = eval_det.main(trained["argv"] + ["--quantize", quantize, "--device", "cpu"])
    _assert_lines_match(got, trained["want"][quantize])
    assert got["quantize"] == quantize


def test_evaluate_pipeline_map_scores_pck_as_the_checkpoint(trained):
    """The live pipeline's PCK is its best model's in the train form."""
    ws = trained["ws"]
    with open(os.path.join(ws, os.path.dirname(BEST), "config", "config.yaml")) as f:
        config = yaml.safe_load(f)
    ds = DetectionDataset(os.path.join(ws, "data/detection/valid"), img_wh=(SIZE, SIZE))
    got = evaluate_pipeline_map(trained["pipe"], ds, batch_size=2)
    want = evaluate_checkpoint_map(os.path.join(ws, BEST), config,
                                   os.path.join(ws, "data/detection/valid"), batch_size=2,
                                   use_reparam=False, device="cpu")
    for k in ("map", "pck", "pck_matched", "num_visible_keypoints", "num_matched_keypoints",
              "pck_radius"):
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


@pytest.mark.parametrize("jitter", [0.0, 3.0])
def test_pck_harness_matches_jax_on_given_predictions(tmp_path, jitter):
    """Both harnesses score the same predictions (the ground truth moved by
    `jitter` px, plus a stray box) on a keypoint directory: the ground-truth
    keypoints go back from bbox-relative to pixels alike."""
    data = str(tmp_path / "valid")
    make_split(data, 5, SIZE, np.random.default_rng(4), keypoints=True, ext="png")
    ds = DetectionDataset(data, img_wh=(SIZE, SIZE))
    rng = np.random.default_rng(5)
    batches = []
    for lo in range(0, len(ds), 2):
        _, labels, mask = ds.collate_fn([ds[i] for i in range(lo, min(lo + 2, len(ds)))])
        b, k = labels.shape[0], labels.shape[1] + 1
        boxes = np.zeros((b, k, 4), np.float32)
        kps = np.zeros((b, k, KP, 3), np.float32)
        for i in range(b):
            lab = labels[i]
            xyxy = np.concatenate([lab[:, 1:3] - lab[:, 3:5] / 2,
                                   lab[:, 1:3] + lab[:, 3:5] / 2], axis=-1) * SIZE
            boxes[i, :-1] = xyxy + rng.normal(0, 0.3, xyxy.shape)
            kp = lab[:, 5:].reshape(-1, KP, 3).copy()
            kp = np.where(np.isfinite(kp), kp, 0.0)
            span = xyxy[:, None, 2:] - xyxy[:, None, :2]
            kps[i, :-1, :, :2] = (xyxy[:, None, :2] + kp[..., :2] * span
                                  + rng.normal(0, jitter, kp[..., :2].shape))
            kps[i, :-1, :, 2] = kp[..., 2]
            boxes[i, -1] = [1, 1, 9, 9]
        valid = np.concatenate([mask, np.ones((b, 1), bool)], axis=1)
        scores = rng.uniform(0.1, 1, (b, k)).astype(np.float32)
        classes = np.where(valid, np.concatenate([labels[..., 0], np.zeros((b, 1))], 1), 0)
        batches.append((boxes, scores, classes.astype(np.int32), valid, kps))

    def forward(make):
        it = iter(batches)
        return lambda imgs: make(*next(it))

    jax_result = namedtuple("R", "boxes_xyxy scores classes valid keypoints mask_coefs")
    got = eval_harness._collect_and_score(
        forward(lambda *a: PostProcessResult(*(torch.from_numpy(x) for x in a),
                                             torch.zeros(a[0].shape[:2] + (0,)))),
        ds, 2, NUM_CLASSES, (SIZE, SIZE), num_keypoints=KP)
    want = jax_eval_harness._collect_and_score(
        forward(lambda *a: jax_result(*a, np.zeros(a[0].shape[:2] + (0,)))),
        ds, 2, NUM_CLASSES, (SIZE, SIZE), num_keypoints=KP)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)
    assert got["num_matched_keypoints"] > 0
    if jitter == 0:  # every matched keypoint on its ground truth
        assert got["pck_matched"] == 1.0
    else:
        assert got["pck_matched"] < 1.0


# ------------------------------------------------------------------ serve
def _recording(fn, log):
    """fn (apply_keypoints) that also keeps each keypoints array."""
    def wrapped(img, keypoints):
        log.append(np.array(keypoints, np.float64))
        return fn(img, keypoints)
    return wrapped


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A keypoint checkpoint (its conf and class layers standardised on the
    clip, as tests/test_torch_video.py does) served on 4 images of 96x80
    (both og dims differ, so the rescale fires) and on the clip with
    tracked classes and frame skips, through both runners; the keypoints
    each handed to its drawing."""
    root = tmp_path_factory.mktemp("kp_serve")
    best = root / "saved_model" / "detection" / "best_model"
    ckpt = str(best / "DetectionNet.ckpt.tar")
    net = tracking_net(net=port_kp_net(seed=41))
    save_checkpoint(ckpt, {"LAST_EPOCH": 0, "NUM_CLASSES": NUM_CLASSES,
                           "NETWORK_PARAMS": state_dict_to_flax(net.state_dict())})
    config = {"model_config": {**KP_CONFIG, "num_keypoints": KP},
              "train_config": {"img_config": {"img_wh": [SIZE, SIZE]}}}
    (best / "config").mkdir()
    save_yaml(config, str(best / "config" / "config.yaml"))
    imgs = root / "imgs"
    imgs.mkdir()
    for t in range(4):
        cv2.imwrite(str(imgs / f"img_{t}.png"),
                    cv2.cvtColor(cv2.resize(frame_at(3 * t), (96, 80)), cv2.COLOR_RGB2BGR))
    write_clip(str(root / "clip.mp4"))
    kp = {}
    runs = {"images": (str(imgs), dict(batch_size=3, score_threshold=0.3, max_detections=8)),
            "video": (str(root / "clip.mp4"), SERVE_KW)}
    for name, (path, kw) in runs.items():
        kp[name] = {"jax": [], "port": []}
        with mock.patch.object(jax_runner, "load_detection_model", functools.partial(
                jax_runner.load_detection_model, dtype=jnp.float32)), \
                mock.patch.object(jax_runner, "apply_keypoints", _recording(
                    jax_runner.apply_keypoints, kp[name]["jax"])), \
                mock.patch.object(runner, "apply_keypoints", _recording(
                    runner.apply_keypoints, kp[name]["port"])):
            jax_runner.run_detection_inference(path, ckpt, config,
                                               storage_path=str(root / f"{name}_jax"), **kw)
            runner.run_detection_inference(path, ckpt, config, device="cpu",
                                           storage_path=str(root / f"{name}_port"), **kw)
    return dict(root=root, ckpt=ckpt, config=config, kp=kp)


def _assert_keypoints_match(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[-1] == 3 and g.shape[0] % KP == 0
        np.testing.assert_allclose(g[:, :2], w[:, :2], atol=1e-3, rtol=0)
        np.testing.assert_array_equal(g[:, 2], w[:, 2])


def test_serve_images_draws_the_keypoints_of_jax(served):
    """One drawing call an image, every kept box's keypoints in og pixels."""
    got = served["kp"]["images"]["port"]
    _assert_keypoints_match(got, served["kp"]["images"]["jax"])
    assert len(got) == 4 and all(len(g) == 8 * KP for g in got)
    assert max(np.abs(g[:, :2]).max() for g in got) > SIZE  # rescaled to 96x80
    files = sorted(os.listdir(served["root"] / "images_port"))
    assert files == [f"img_{t}.png" for t in range(4)]


def test_serve_video_keypoints_ride_the_tracker_as_jax(served):
    """On the clip (tracked_classes [1], frame_skips 1) the tracked rows'
    keypoint payloads reach the drawing in the JAX runner's order."""
    got = served["kp"]["video"]["port"]
    _assert_keypoints_match(got, served["kp"]["video"]["jax"])
    assert len(got) >= 3
    assert sorted(os.listdir(served["root"] / "video_port")) == ["output.csv", "video.mp4"]


def test_inference_det_cli_serves_keypoints_in_int8(served, monkeypatch):
    """inference_det --quantize int8 on the keypoint checkpoint: the first
    batch calibrates, every image gets its keypoints drawn."""
    log = []
    monkeypatch.setattr(runner, "apply_keypoints", _recording(runner.apply_keypoints, log))
    monkeypatch.chdir(served["root"])
    out = inference_det.main(["--path", str(served["root"] / "imgs"), "--device", "cpu",
                              "--quantize", "int8", "--batch_size", "4",
                              "--score_threshold", "0.3"])
    assert sorted(os.listdir(out)) == [f"img_{t}.png" for t in range(4)]
    assert len(log) == 4
    assert all(len(g) > 0 and len(g) % KP == 0 and np.isfinite(g).all() for g in log)
