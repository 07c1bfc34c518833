"""Video serving of the PyTorch port against the JAX package on the CPU, and
the port's prefetch thread.

One tiny checkpoint (width 0.25, depth 0.2, 64x64) serves a 12-frame clip
of two shapes moving on disjoint lanes through both runners' video
branches, with `tracked_classes` and `frame_skips` (both in f32; the JAX
runner compiles one forward). The checkpoint's weights are random from a
seed, and its conf and class layers are rescaled on the clip so that the
scores spread over ByteTrack's bands (low 0.1-0.35, births from 0.45).
Tolerances: the tracks handed to the drawing agree in frame, track id and
class exactly, in box within 1e-3 px and in score within 1e-4; output.csv
agrees row for row in frame, track id and class, in confidence within
1e-4, and in X, Y, W, H within 1 (the CSV truncates pixels to int, so a
value on an integer boundary may fall either way).
"""
import functools
import os
import threading
from unittest import mock

import numpy as np
import pandas as pd
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from vision_conglomerate_tpu.infer import runner as jax_runner

from vision_conglomerate_torch import inference_det
from vision_conglomerate_torch.infer import runner
from vision_conglomerate_torch.train.checkpoint import save_checkpoint
from vision_conglomerate_torch.utils import save_yaml
from vision_conglomerate_torch.weights import state_dict_to_flax

from tests.test_torch_weights import CONFIG, NUM_CLASSES, port_detection_net

cv2 = pytest.importorskip("cv2")

SIZE = 64
N_FRAMES = 12
SERVE_KW = dict(batch_size=3, iou_threshold=0.35, score_threshold=0.1, box_allowance=0,
                max_detections=16, with_summary=True, tracked_classes=[1], frame_skips=1,
                fps=10)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frame_at(t: int) -> np.ndarray:
    """A square slides right along y=20, a disk slides left along y=44."""
    img = np.full((SIZE, SIZE, 3), 30, np.uint8)
    cx0 = 12 + 2 * t
    img[12:28, cx0 - 8:cx0 + 8] = (220, 40, 40)
    cx1 = 52 - 2 * t
    yy, xx = np.mgrid[:SIZE, :SIZE]
    img[(yy - 44) ** 2 + (xx - cx1) ** 2 <= 49] = (40, 220, 40)
    return img


def write_clip(path: str, n_frames: int = N_FRAMES, fps: int = 10):
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (SIZE, SIZE))
    assert writer.isOpened()
    for t in range(n_frames):
        writer.write(cv2.cvtColor(frame_at(t), cv2.COLOR_RGB2BGR))
    writer.release()


def tracking_net(seed: int = 0, conf_mean: float = -3.0, scale: float = 2.0, net=None):
    """A seeded port net (or `net`) whose conf and class logits are
    standardised over the clip's frames: per head and output channel, mean
    conf_mean (0 for classes) and std `scale`."""
    net = port_detection_net(CONFIG, seed=seed) if net is None else net
    x = torch.from_numpy(np.stack([frame_at(t) for t in range(N_FRAMES)]) / 255.0).float()
    feats, hooks = {}, []
    for i, head in enumerate(net.head):
        for key in ("regression_fmap_layer", "classification_fmap_layer"):
            hooks.append(getattr(head, key).register_forward_hook(
                lambda m, a, out, k=(key, i): feats.__setitem__(k, out)))
    with torch.no_grad():
        net(x.permute(0, 3, 1, 2))
        for h in hooks:
            h.remove()
        for i, head in enumerate(net.head):
            for layer, key, mean in ((head.conf_layer, "regression_fmap_layer", conf_mean),
                                     (head.cls_layer, "classification_fmap_layer", 0.0)):
                z = F.conv2d(feats[(key, i)], layer.weight, layer.bias)
                gain = scale / z.std(dim=(0, 2, 3))
                layer.bias.copy_((layer.bias - z.mean(dim=(0, 2, 3))) * gain + mean)
                layer.weight.mul_(gain[:, None, None, None])
    return net


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """root/ with saved_model/detection/best_model/{DetectionNet.ckpt.tar,
    config/config.yaml} (the CLI's default paths) and clip.mp4."""
    root = tmp_path_factory.mktemp("video")
    best = root / "saved_model" / "detection" / "best_model"
    ckpt = str(best / "DetectionNet.ckpt.tar")
    save_checkpoint(ckpt, {"LAST_EPOCH": 0, "NUM_CLASSES": NUM_CLASSES,
                           "NETWORK_PARAMS": state_dict_to_flax(tracking_net().state_dict())})
    config = {"model_config": CONFIG, "train_config": {"img_config": {"img_wh": [SIZE, SIZE]}}}
    (best / "config").mkdir()
    save_yaml(config, str(best / "config" / "config.yaml"))
    write_clip(str(root / "clip.mp4"))
    return root, ckpt, config


def _recording(fn, log):
    """fn (apply_bboxes_from_tracks) that also keeps each tracks array."""
    def wrapped(img, tracks, **kw):
        log.append(np.array(tracks, np.float64))
        return fn(img, tracks, **kw)
    return wrapped


def _read_csv(path) -> pd.DataFrame:
    return pd.read_csv(os.path.join(path, "output.csv"))


def _frame_count(path) -> int:
    cap = cv2.VideoCapture(os.path.join(path, "video.mp4"))
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()


@pytest.fixture(scope="module")
def served(clip):
    """The clip through both runners' video branches: output dirs and the
    tracks each handed to its drawing."""
    root, ckpt, config = clip
    tracks = {"jax": [], "port": []}
    with mock.patch.object(jax_runner, "load_detection_model", functools.partial(
            jax_runner.load_detection_model, dtype=jnp.float32)), \
            mock.patch.object(jax_runner, "apply_bboxes_from_tracks", _recording(
                jax_runner.apply_bboxes_from_tracks, tracks["jax"])), \
            mock.patch.object(runner, "apply_bboxes_from_tracks", _recording(
                runner.apply_bboxes_from_tracks, tracks["port"])):
        out_jax = jax_runner.run_detection_inference(
            str(root / "clip.mp4"), ckpt, config, storage_path=str(root / "out_jax"), **SERVE_KW)
        out_port = runner.run_detection_inference(
            str(root / "clip.mp4"), ckpt, config, storage_path=str(root / "out_port"),
            device="cpu", **SERVE_KW)
    return dict(jax=out_jax, port=out_port, tracks=tracks)


def test_tracks_match_jax_runner(served):
    got, want = served["tracks"]["port"], served["tracks"]["jax"]
    assert len(got) == len(want) >= N_FRAMES // 2 - 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[:, [0, 2]], w[:, [0, 2]])  # track id, class
        np.testing.assert_allclose(g[:, 1], w[:, 1], atol=1e-4, rtol=0)
        np.testing.assert_allclose(g[:, 3:], w[:, 3:], atol=1e-3, rtol=0)


def test_csv_matches_jax_runner(served):
    got, want = _read_csv(served["port"]), _read_csv(served["jax"])
    assert list(got.columns) == list(want.columns) == [
        "frame", "track_id", "confidence", "class", "X", "Y", "W", "H"]
    assert len(got) == len(want) > N_FRAMES
    for col in ("frame", "track_id", "class"):
        np.testing.assert_array_equal(got[col], want[col], err_msg=col)
    np.testing.assert_allclose(got["confidence"], want["confidence"], atol=1e-4, rtol=0)
    coords = ["X", "Y", "W", "H"]
    assert np.abs(got[coords].to_numpy() - want[coords].to_numpy()).max() <= 1
    # tracked_classes kept class 1 only; frame_skips 1 kept frames 0, 2, ..
    # numbered 0-5; tracks persist across frames
    assert set(got["class"]) == {1}
    assert got["frame"].max() == N_FRAMES // 2 - 1
    assert got.groupby("track_id")["frame"].nunique().max() >= 3


def test_video_matches_jax_runner(served):
    for key in ("jax", "port"):
        assert sorted(os.listdir(served[key])) == ["output.csv", "video.mp4"]
    assert _frame_count(served["port"]) == _frame_count(served["jax"]) == N_FRAMES // 2


def test_cli_serves_video_with_fps_and_frame_skips(clip, monkeypatch):
    """--fps and --frame_skips reach the video branch through the CLI."""
    root, _, _ = clip
    monkeypatch.chdir(root)
    out = inference_det.main(["--path", str(root / "clip.mp4"), "--device", "cpu",
                              "--batch_size", "4", "--score_threshold", "0.1", "--fps", "7",
                              "--frame_skips", "2", "--with_summary"])
    cap = cv2.VideoCapture(os.path.join(out, "video.mp4"))
    try:
        assert cap.get(cv2.CAP_PROP_FPS) == 7
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == N_FRAMES // 3
    finally:
        cap.release()
    assert _read_csv(out)["frame"].max() == N_FRAMES // 3 - 1


def test_serial_equals_prefetched(clip, served, monkeypatch):
    """VCT_INFER_PREFETCH=0 (decode, copy and forward in turn) writes the
    same CSV as the prefetch thread; every frame is written without
    frame_skips."""
    root, ckpt, config = clip
    monkeypatch.setenv("VCT_INFER_PREFETCH", "0")
    out = runner.run_detection_inference(
        str(root / "clip.mp4"), ckpt, config, storage_path=str(root / "out_serial"),
        device="cpu", **SERVE_KW)
    pd.testing.assert_frame_equal(_read_csv(out), _read_csv(served["port"]))
    kw = dict(SERVE_KW, frame_skips=0)
    out = runner.run_detection_inference(
        str(root / "clip.mp4"), ckpt, config, storage_path=str(root / "out_all"),
        device="cpu", **kw)
    assert _frame_count(out) == N_FRAMES


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "vct-infer-prefetch" and t.is_alive()]


def _batches(n, fail_at=None, closed=None):
    try:
        for i in range(n):
            if i == fail_at:
                raise ValueError("decode failed")
            yield np.full((2, 4, 4, 3), i, np.float32), np.zeros((2, 8, 8, 3), np.uint8)
    finally:
        if closed is not None:
            closed.set()


def test_prefetch_surfaces_decode_errors():
    got = []
    with pytest.raises(ValueError, match="decode failed"):
        for imgs, dev_imgs, _ in runner._prefetch_batches(_batches(5, fail_at=2),
                                                          torch.device("cpu")):
            got.append(float(dev_imgs[0, 0, 0, 0]))
    assert got == [0.0, 1.0]
    assert not _prefetch_threads()


def test_prefetch_early_break_ends_the_thread():
    """A consumer that stops after one batch of an endless source: the
    worker stops, closes the source and exits; nothing stays queued."""
    closed = threading.Event()
    it = runner._prefetch_batches(_batches(10 ** 9, closed=closed), torch.device("cpu"), depth=2)
    imgs, dev_imgs, _ = next(it)
    assert torch.equal(dev_imgs, torch.from_numpy(imgs))
    assert len(_prefetch_threads()) == 1
    it.close()
    assert closed.wait(timeout=5) and not _prefetch_threads()

