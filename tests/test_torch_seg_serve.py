"""Segmentation serving of the PyTorch port against the JAX runner on the
CPU, both in f32: images and a clip through `run_detection_inference(task=
"segmentation")`, the inference_seg CLI with --crop_masks, and the seg entry
points' refusal to drift to the CPU on their own.

The checkpoint is a seeded port SegmentationNet (tiny config of
tests/test_torch_seg_model.py), written in the JAX format, with its conf
and class layers rescaled on the clip's frames (tests/test_torch_video.py)
so that scores spread over ByteTrack's bands. Both runners draw masks with
a random colour map, so the masks handed to `apply_segments` are compared
in place of the images. Tolerances: output.csv as in
tests/test_torch_serve.py (classes and frames exact, confidence 1e-4, the
int-truncated X, Y, W, H within 1); masks equal but for at most 0.1% of
the pixels, those whose f32 value sits at the 0.5 threshold.
"""
import functools
import os
from unittest import mock

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from vision_conglomerate_tpu.infer import runner as jax_runner

from vision_conglomerate_torch import eval_seg, inference_seg, train_seg
from vision_conglomerate_torch.infer import runner
from vision_conglomerate_torch.train.checkpoint import save_checkpoint
from vision_conglomerate_torch.utils import save_yaml
from vision_conglomerate_torch.weights import state_dict_to_flax

from tests.test_torch_seg_model import SEG_CONFIG, port_seg_net
from tests.test_torch_video import N_FRAMES, SIZE, tracking_net, write_clip
from tests.test_torch_weights import NUM_CLASSES

IMG_KW = dict(batch_size=2, score_threshold=0.01, with_summary=True, max_detections=12)
VIDEO_KW = dict(batch_size=3, iou_threshold=0.35, score_threshold=0.1, box_allowance=0,
                max_detections=16, with_summary=True, tracked_classes=[1], frame_skips=1,
                fps=10)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """root/ with saved_model/segmentation/best_model/{SegmentationNet.ckpt.tar,
    config/config.yaml} (the CLI's default paths), two 80x96 images (both og
    dims differ from 64x64, so the rescale and an uneven mask upsample run)
    and clip.mp4."""
    root = tmp_path_factory.mktemp("segserve")
    best = root / "saved_model" / "segmentation" / "best_model"
    ckpt = str(best / "SegmentationNet.ckpt.tar")
    net = tracking_net(net=port_seg_net(seed=0))
    save_checkpoint(ckpt, {"LAST_EPOCH": 0, "NUM_CLASSES": NUM_CLASSES,
                           "NETWORK_PARAMS": state_dict_to_flax(net.state_dict())})
    config = {"model_config": SEG_CONFIG,
              "train_config": {"img_config": {"img_wh": [SIZE, SIZE]}}}
    (best / "config").mkdir()
    save_yaml(config, str(best / "config" / "config.yaml"))
    (root / "imgs").mkdir()
    rng = np.random.default_rng(22)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, size=(80, 96, 3), dtype=np.uint8)).save(
            root / "imgs" / f"im{i}.png")
    write_clip(str(root / "clip.mp4"))
    return root, ckpt, config


def _recording(fn, log):
    """apply_segments that also keeps each mask stack it draws."""
    def wrapped(img, masks, **kw):
        log.append(np.array(masks, bool))
        return fn(img, masks, **kw)
    return wrapped


def _serve_both(root, ckpt, config, path, tag, **kw):
    """path through the JAX runner (f32) and the port (cpu); returns
    {"jax"/"port": (output dir, [mask stacks drawn])}."""
    out = {}
    masks = {"jax": [], "port": []}
    with mock.patch.object(jax_runner, "load_detection_model", functools.partial(
            jax_runner.load_detection_model, dtype=jnp.float32)), \
            mock.patch.object(jax_runner, "apply_segments", _recording(
                jax_runner.apply_segments, masks["jax"])), \
            mock.patch.object(runner, "apply_segments", _recording(
                runner.apply_segments, masks["port"])):
        out["jax"] = jax_runner.run_detection_inference(
            path, ckpt, config, task="segmentation", storage_path=str(root / f"{tag}_jax"), **kw)
        out["port"] = runner.run_detection_inference(
            path, ckpt, config, task="segmentation", storage_path=str(root / f"{tag}_port"),
            device="cpu", **kw)
    return {k: (out[k], masks[k]) for k in out}


def _read_csv(path) -> pd.DataFrame:
    return pd.read_csv(os.path.join(path, "output.csv"))


def assert_csv_close(got: pd.DataFrame, want: pd.DataFrame, exact=("frame", "class")):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) > 0
    for col in exact:
        np.testing.assert_array_equal(got[col], want[col], err_msg=col)
    np.testing.assert_allclose(got["confidence"], want["confidence"], atol=1e-4, rtol=0)
    coords = ["X", "Y", "W", "H"]
    assert np.abs(got[coords].to_numpy() - want[coords].to_numpy()).max() <= 1


def assert_masks_close(got, want, min_drawn: int):
    assert len(got) == len(want) >= min_drawn
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[0] > 0
        assert (g != w).mean() <= 1e-3
        assert 0 < w.sum() < w.size


@pytest.mark.parametrize("crop", [False, True], ids=["uncropped", "crop_masks"])
def test_image_serving_matches_jax_runner(workspace, crop):
    root, ckpt, config = workspace
    res = _serve_both(root, ckpt, config, str(root / "imgs"), f"imgs_{crop}", crop_masks=crop,
                      **IMG_KW)
    assert_csv_close(_read_csv(res["port"][0]), _read_csv(res["jax"][0]))
    assert_masks_close(res["port"][1], res["jax"][1], min_drawn=2)
    assert all(m.shape[1:] == (80, 96) for m in res["port"][1])
    assert sorted(os.listdir(res["port"][0])) == ["img_0.png", "img_1.png", "output.csv"]


def test_video_serving_matches_jax_runner(workspace):
    """ByteTrack on the clip with tracked_classes and frame_skips: the
    track rows and the masks of the kept class's boxes."""
    root, ckpt, config = workspace
    res = _serve_both(root, ckpt, config, str(root / "clip.mp4"), "video", **VIDEO_KW)
    got, want = _read_csv(res["port"][0]), _read_csv(res["jax"][0])
    assert_csv_close(got, want, exact=("frame", "track_id", "class"))
    assert set(got["class"]) == {1} and got["frame"].max() == N_FRAMES // 2 - 1
    assert_masks_close(res["port"][1], res["jax"][1], min_drawn=N_FRAMES // 2 - 1)
    assert sorted(os.listdir(res["port"][0])) == ["output.csv", "video.mp4"]


def test_inference_seg_cli_with_crop_masks(workspace, monkeypatch):
    """The CLI reads saved_model/segmentation/best_model; --crop_masks
    leaves no mask pixel outside its box (inclusive edges)."""
    root, _, _ = workspace
    monkeypatch.chdir(root)
    drawn, boxes = [], []

    def record_boxes(img, bboxes, **kw):
        boxes.append(np.array(bboxes))
        return draw(img, bboxes, **kw)

    draw = runner.apply_bboxes
    monkeypatch.setattr(runner, "apply_segments", _recording(runner.apply_segments, drawn))
    monkeypatch.setattr(runner, "apply_bboxes", record_boxes)
    out = inference_seg.main(["--path", str(root / "imgs"), "--device", "cpu",
                              "--score_threshold", "0.01", "--with_summary", "--crop_masks",
                              "--box_allowance", "0"])
    assert sorted(os.listdir(out)) == ["img_0.png", "img_1.png", "output.csv"]
    assert len(drawn) == len(boxes) == 2
    for masks, bb in zip(drawn, boxes):
        ys, xs = np.mgrid[:80, :96]
        for m, (_, _, x1, y1, x2, y2) in zip(masks, bb):
            inside = (xs >= x1) & (xs <= x2) & (ys >= y1) & (ys <= y2)
            assert not (m & ~inside).any()


def test_seg_entry_points_need_cuda(workspace, monkeypatch, tmp_path):
    """Without --device every seg entry point asks for cuda and, without
    it, raises instead of running on the CPU."""
    root, ckpt, config = workspace
    monkeypatch.chdir(root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config_path = str(tmp_path / "config.yaml")
    save_yaml({**config, "train_config": {**config["train_config"],
                                          "data_path": str(tmp_path)}}, config_path)
    for call in (
            lambda: runner.run_detection_inference(str(root / "imgs"), ckpt, config,
                                                   task="segmentation"),
            lambda: inference_seg.main(["--path", str(root / "imgs")]),
            lambda: eval_seg.main(["--weights_path", ckpt, "--data_dir", str(root / "imgs")]),
            lambda: train_seg.main(["--config_path", config_path])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
