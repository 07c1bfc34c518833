"""Serve tail and end-to-end serving of the PyTorch port against the JAX
package on the CPU, and the port's refusal to drift to the CPU on its own.

NMS keep sets are compared exactly, on distinct scores so that tie order
cannot differ. End to end, both packages serve the same JAX-written
checkpoint in f32; `output.csv` holds int-truncated pixel coordinates, so
a coordinate may differ by 1 where an f32 value sits on an integer
boundary, and confidences agree within 1e-4.
"""
import functools
import os

import numpy as np
import pandas as pd
import pytest

import jax.numpy as jnp
import torch
from PIL import Image

from vision_conglomerate_tpu.infer import runner as jax_runner
from vision_conglomerate_tpu.ops.nms import batched_nms as jax_batched_nms
from vision_conglomerate_tpu.ops.postprocess import postprocess_detections as jax_postprocess
from vision_conglomerate_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint

from vision_conglomerate_torch import inference_det
from vision_conglomerate_torch.device import resolve_device
from vision_conglomerate_torch.infer import runner
from vision_conglomerate_torch.nn.quantize import quantizable_modules
from vision_conglomerate_torch.ops.nms import batched_nms
from vision_conglomerate_torch.ops.postprocess import postprocess_detections
from vision_conglomerate_torch.utils import save_yaml
from vision_conglomerate_torch.weights import state_dict_to_flax

from tests.test_nms_postprocess import _greedy_nms_np
from tests.test_torch_seg_model import SEG_CONFIG, port_seg_net
from tests.test_torch_weights import CONFIG, NUM_CLASSES, jax_detection_variables


def _distinct_boxes(seed: int, n: int = 64):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 100, size=(n, 2))
    wh = rng.uniform(5, 40, size=(n, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    scores = np.unique(rng.uniform(0.01, 1.0, size=n).astype(np.float32))[::-1]
    return boxes[:len(scores)], scores.copy()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_nms_matches_sequential_greedy(seed):
    boxes, scores = _distinct_boxes(seed)
    n = len(scores)
    out = batched_nms(torch.from_numpy(boxes[None]), torch.from_numpy(scores[None]),
                      torch.zeros((1, n), dtype=torch.int32), iou_threshold=0.5,
                      score_threshold=0.0, max_detections=n, pre_nms_topk=n,
                      class_agnostic=True)
    got = sorted(out.indices[0][out.valid[0]].tolist())
    assert got == _greedy_nms_np(boxes, scores, 0.5)


@pytest.mark.parametrize("class_agnostic", [True, False])
@pytest.mark.parametrize("topk_method", ["exact", "approx"])
def test_batched_nms_matches_jax(class_agnostic, topk_method):
    """"approx" is exact torch.topk in the port; the JAX side runs exact
    top-k, which the CPU gives for both names."""
    per = [_distinct_boxes(s) for s in (4, 5)]
    n = min(len(s) for _, s in per)
    boxes = np.stack([b[:n] for b, _ in per])
    scores = np.stack([s[:n] for _, s in per])
    classes = np.random.default_rng(6).integers(0, 3, size=(2, n)).astype(np.int32)
    kw = dict(iou_threshold=0.4, score_threshold=0.2, max_detections=20, pre_nms_topk=48,
              class_agnostic=class_agnostic)
    want = jax_batched_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), **kw)
    got = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                      torch.from_numpy(classes), topk_method=topk_method, **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    v = got.valid.numpy()
    np.testing.assert_array_equal(got.indices.numpy()[v], np.asarray(want.indices)[v])
    np.testing.assert_array_equal(got.classes.numpy()[v], np.asarray(want.classes)[v])
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=0)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=0)


def test_postprocess_matches_jax():
    rng = np.random.default_rng(7)
    b, m, c = 2, 300, 3
    preds = np.concatenate([
        rng.normal(size=(b, m, 1 + c)),
        rng.uniform(20, 200, size=(b, m, 2)),
        rng.uniform(5, 60, size=(b, m, 2))], axis=-1).astype(np.float32)
    kw = dict(num_classes=c, iou_threshold=0.35, score_threshold=0.1, box_allowance=4.0,
              max_detections=100)
    want = jax_postprocess(jnp.asarray(preds), **kw)
    got = postprocess_detections(torch.from_numpy(preds), **kw)
    v = np.asarray(want.valid)
    assert v.sum() > 10
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.classes.numpy()[v], np.asarray(want.classes)[v])
    np.testing.assert_allclose(got.boxes_xyxy.numpy()[v], np.asarray(want.boxes_xyxy)[v],
                               atol=1e-4, rtol=1e-6)
    np.testing.assert_allclose(got.scores.numpy()[v], np.asarray(want.scores)[v],
                               atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A JAX-written checkpoint, its config, and two 80x96 images (both og
    dims differ from the 64x64 net input, so the rescale fires)."""
    root = tmp_path_factory.mktemp("serve")
    best = root / "saved_model" / "detection" / "best_model"
    ckpt = str(best / "DetectionNet.ckpt.tar")
    jax_save_checkpoint(ckpt, {"LAST_EPOCH": 0, "NUM_CLASSES": NUM_CLASSES,
                               "NETWORK_PARAMS": jax_detection_variables(seed=21)})
    config = {"model_config": CONFIG, "train_config": {"img_config": {"img_wh": [64, 64]}}}
    (best / "config").mkdir()
    save_yaml(config, str(best / "config" / "config.yaml"))
    imgs = root / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(22)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, size=(80, 96, 3), dtype=np.uint8)).save(
            imgs / f"im{i}.png")
    return root, ckpt, config


def _read_csv(path) -> pd.DataFrame:
    return pd.read_csv(os.path.join(path, "output.csv"))


def test_serving_matches_jax_runner(served, monkeypatch):
    root, ckpt, config = served
    monkeypatch.chdir(root)
    # the JAX runner serves in bf16 by default; compare both in f32
    monkeypatch.setattr(jax_runner, "load_detection_model", functools.partial(
        jax_runner.load_detection_model, dtype=jnp.float32))
    kw = dict(batch_size=2, score_threshold=0.01, with_summary=True)
    want = _read_csv(jax_runner.run_detection_inference(
        str(root / "imgs"), ckpt, config, storage_path=str(root / "out_jax"), **kw))
    out = runner.run_detection_inference(
        str(root / "imgs"), ckpt, config, storage_path=str(root / "out_port"),
        device="cpu", **kw)
    got = _read_csv(out)
    assert len(want) > 10 and list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got["frame"], want["frame"])
    np.testing.assert_array_equal(got["class"], want["class"])
    np.testing.assert_allclose(got["confidence"], want["confidence"], atol=1e-4, rtol=0)
    coords = ["X", "Y", "W", "H"]
    assert np.abs(got[coords].to_numpy() - want[coords].to_numpy()).max() <= 1
    assert sorted(os.listdir(out)) == ["img_0.png", "img_1.png", "output.csv"]


@pytest.mark.parametrize("form", [[], ["--no_reparam"]], ids=["deploy", "train_form"])
def test_cli_serves_on_cpu(served, monkeypatch, form):
    root, _, _ = served
    monkeypatch.chdir(root)
    out = inference_det.main(["--path", str(root / "imgs" / "im0.png"), "--device", "cpu",
                              "--score_threshold", "0.01", "--with_summary", *form])
    assert sorted(os.listdir(out)) == ["img_0.png", "output.csv"]
    assert len(_read_csv(out)) > 0


def test_no_silent_cpu(served, monkeypatch):
    """Without a device argument every entry point asks for cuda and, on a
    machine without it, raises instead of running on the CPU."""
    root, ckpt, config = served
    monkeypatch.chdir(root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.load_detection_model(ckpt, CONFIG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.run_detection_inference(str(root / "imgs"), ckpt, config)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inference_det.main(["--path", str(root / "imgs")])
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("kwargs,item", [
    (dict(quantize="int8"), "§A.10"), (dict(task="segmentation", quantize="int8"), "§A.10")])
def test_unported_modes_raise(served, tmp_path, monkeypatch, kwargs, item):
    """The modes that ROADMAP item `item` (int8) left out of the port until
    it was done now serve on the CPU: the first batch calibrates the int8
    form of every quantizable conv (`runner.quantize_model_int8`), and the
    rows agree with the f32 deploy form's within int8 noise (the same
    frames and classes, confidences within 0.05). Without the deploy form
    int8 raises, as in the JAX package."""
    root, ckpt, config = served
    task = kwargs.get("task", "detection")
    if task == "segmentation":
        seg_config = {**config, "model_config": SEG_CONFIG}
        ckpt = str(tmp_path / "SegmentationNet.ckpt.tar")
        jax_save_checkpoint(ckpt, {"LAST_EPOCH": 0, "NUM_CLASSES": NUM_CLASSES,
                                   "NETWORK_PARAMS": state_dict_to_flax(
                                       port_seg_net(seed=23).state_dict())})
        config = seg_config
    quantized = []
    calibrate = runner.quantize_model_int8

    def spy(model, *args, **kw):
        quantized.append(calibrate(model, *args, **kw))
        return quantized[-1]

    monkeypatch.setattr(runner, "quantize_model_int8", spy)
    kw = dict(batch_size=2, score_threshold=0.01, with_summary=True, device="cpu", task=task)
    want = _read_csv(runner.run_detection_inference(
        str(root / "imgs"), ckpt, config, storage_path=str(tmp_path / "f32"), **kw))
    assert not quantized
    out = runner.run_detection_inference(str(root / "imgs"), ckpt, config,
                                         storage_path=str(tmp_path / "int8"),
                                         **{**kw, **kwargs})
    assert item == "§A.10" and len(quantized) == 1
    convs = quantizable_modules(quantized[0])
    assert len(convs) > 20 and all(hasattr(m, "q_kernel") for m in convs.values())
    got = _read_csv(out)
    # rows near the score threshold or an NMS decision may come and go:
    # 9 in 10 of each side's rows have a partner on the other (same frame
    # and class, X/Y/W/H within 1 px, confidence within 0.05)
    keys = ["frame", "class", "X", "Y", "W", "H"]
    pairs = got.merge(want, on=["frame", "class"], suffixes=("", "_f32"))
    close = (pairs[[f"{k}_f32" for k in keys[2:]]].to_numpy()
             - pairs[keys[2:]].to_numpy()).__abs__().max(axis=1) <= 1
    close &= (pairs["confidence"] - pairs["confidence_f32"]).abs().to_numpy() <= 0.05
    matched = pairs[close]
    assert len(want) > 10
    for side in (got, want):
        assert len(matched[keys].drop_duplicates()) >= 0.9 * len(side)
    with pytest.raises(ValueError, match="deploy"):
        runner.run_detection_inference(str(root / "imgs"), ckpt, config, use_reparam=False,
                                       **{**kw, **kwargs})


def test_video_raises(served, tmp_path):
    """A video file that cv2 cannot open raises (video serving itself is
    held against the JAX runner in tests/test_torch_video.py)."""
    _, ckpt, config = served
    video = tmp_path / "clip.mp4"
    video.write_bytes(b"")
    with pytest.raises(OSError, match="cannot open"):
        runner.run_detection_inference(str(video), ckpt, config, device="cpu")
