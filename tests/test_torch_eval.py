"""mAP of the PyTorch port against the JAX package on the CPU: the scoring
functions on seeded predictions, `evaluate_checkpoint_map` through both
packages' eval_det CLIs on one tiny checkpoint, `train_det --map_eval`,
and `evaluate_pipeline_map` on a live train-form net.

Tolerances: the scoring functions agree to 1e-12 (the same float64 numpy
arithmetic); a checkpoint's mAP and per-class AP to 1e-4 (both forwards
in f32; the JAX side compiles one forward).
"""
import functools
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

import eval_det as jax_eval_det
from vision_conglomerate_tpu.tools import eval_harness as jax_eval_harness
from vision_conglomerate_tpu.tools import map_eval as jax_map_eval

from vision_conglomerate_torch import eval_det
from vision_conglomerate_torch.data.detection import DetectionDataset
from vision_conglomerate_torch.infer import runner
from vision_conglomerate_torch.losses import DetectionLossConfig
from vision_conglomerate_torch.tools import map_eval
from vision_conglomerate_torch.tools.eval_harness import (
    evaluate_checkpoint_map, evaluate_checkpoint_seg, evaluate_pipeline_map)
from vision_conglomerate_torch.train.checkpoint import save_checkpoint
from vision_conglomerate_torch.train.detection_trainer import TrainDetectionPipeline
from vision_conglomerate_torch.train.optim import make_optimizer
from vision_conglomerate_torch.utils import save_yaml
from vision_conglomerate_torch.weights import state_dict_to_flax

from tests.test_torch_seg_data import write_polygon_dataset
from tests.test_torch_seg_model import SEG_CONFIG, port_seg_net
from tests.test_torch_train_cli import _train, _workspace
from tests.test_torch_weights import CONFIG, NUM_CLASSES, port_detection_net

SIZE = 64
N_IMAGES = 6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _predictions(seed: int, n_images: int = 8, num_classes: int = 3):
    """Per image predictions (boxes, scores, classes) and ground truths
    (boxes, classes): predictions are jittered copies of the ground truth
    plus random boxes, with classes partly wrong; one class has no ground
    truth in some seeds."""
    rng = np.random.default_rng(seed)
    preds, gts = [], []
    for _ in range(n_images):
        m = int(rng.integers(0, 5))
        xy = rng.uniform(0, 80, (m, 2))
        gt = np.concatenate([xy, xy + rng.uniform(5, 40, (m, 2))], axis=1)
        gc = rng.integers(0, num_classes - (seed % 2), m)
        keep = rng.uniform(size=m) < 0.8
        pb = gt[keep] + rng.normal(0, 3, (int(keep.sum()), 4))
        pc = np.where(rng.uniform(size=int(keep.sum())) < 0.8, gc[keep],
                      rng.integers(0, num_classes, int(keep.sum())))
        k = int(rng.integers(0, 6))
        xy = rng.uniform(0, 80, (k, 2))
        pb = np.concatenate([pb, np.concatenate([xy, xy + rng.uniform(5, 40, (k, 2))], axis=1)])
        pc = np.concatenate([pc, rng.integers(0, num_classes, k)])
        preds.append((pb.astype(np.float32), rng.uniform(0, 1, len(pb)).astype(np.float32), pc))
        gts.append((gt.astype(np.float32), gc))
    return preds, gts


@pytest.mark.parametrize("iou", [0.5, 0.75])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_compute_map_matches_jax(seed, iou):
    preds, gts = _predictions(seed)
    got = map_eval.compute_map(preds, gts, 3, iou_threshold=iou)
    want = jax_map_eval.compute_map(preds, gts, 3, iou_threshold=iou)
    assert 0.0 < got["map"] < 1.0
    np.testing.assert_allclose(got["map"], want["map"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got["ap_per_class"], want["ap_per_class"], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got["num_gt_per_class"], want["num_gt_per_class"])
    if iou == 0.5:
        assert map_eval.compute_map50(preds, gts, 3)["map"] == got["map"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_average_precision_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    tp = rng.uniform(size=n) < 0.6
    recall = np.cumsum(tp) / max(int(tp.sum()), 1) * rng.uniform(0.5, 1.0)
    precision = np.cumsum(tp) / np.arange(1, n + 1)
    np.testing.assert_allclose(map_eval.average_precision(recall, precision),
                               jax_map_eval.average_precision(recall, precision),
                               rtol=0, atol=1e-12)


def _write_yolo_dir(root, n, seed):
    """n 64x64 PNGs (already at the net's size, so both packages read the
    same pixels) with 1-3 large boxes of classes 0 and 1 each."""
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    for i in range(n):
        img = rng.integers(0, 60, (SIZE, SIZE, 3), dtype=np.uint8)
        rows = []
        for _ in range(int(rng.integers(1, 4))):
            w, h = rng.uniform(0.3, 0.7, 2)
            cx, cy = rng.uniform(w / 2, 1 - w / 2), rng.uniform(h / 2, 1 - h / 2)
            cls = int(rng.integers(0, NUM_CLASSES))
            x0, y0 = int((cx - w / 2) * SIZE), int((cy - h / 2) * SIZE)
            img[y0:y0 + int(h * SIZE), x0:x0 + int(w * SIZE)] = (200, 60 + 120 * cls, 40)
            rows.append(f"{cls} {cx:.6f} {cy:.6f} {w:.6f} {h:.6f}")
        Image.fromarray(img).save(os.path.join(root, f"img_{i}.png"))
        with open(os.path.join(root, f"img_{i}.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    """A port-written checkpoint of a seeded net with its config, a 6-image
    YOLO dir, and the JSON line of the JAX package's eval_det CLI on them
    (f32 forward, batch 4: the JAX harness pads the last batch)."""
    root = tmp_path_factory.mktemp("eval")
    best = root / "best_model"
    ckpt = str(best / "DetectionNet.ckpt.tar")
    save_checkpoint(ckpt, {"LAST_EPOCH": 0, "NUM_CLASSES": NUM_CLASSES,
                           "NETWORK_PARAMS": state_dict_to_flax(
                               port_detection_net(CONFIG, seed=5).state_dict())})
    config = {"model_config": CONFIG,
              "train_config": {"img_config": {"img_wh": [SIZE, SIZE], "img_ext": "png"}}}
    (best / "config").mkdir()
    save_yaml(config, str(best / "config" / "config.yaml"))
    _write_yolo_dir(str(root / "valid"), N_IMAGES, seed=6)
    argv = ["--weights_path", ckpt, "--data_dir", str(root / "valid"), "--batch_size", "4"]
    f32 = functools.partial(jax_eval_harness.evaluate_checkpoint_map, dtype=jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_eval_harness, "evaluate_checkpoint_map", f32)
        want = jax_eval_det.run(jax_eval_det.build_parser().parse_args(argv))
    return dict(root=root, ckpt=ckpt, config=config, argv=argv, want=want)


def test_evaluate_checkpoint_map_matches_jax(evaluated):
    got = evaluate_checkpoint_map(evaluated["ckpt"], evaluated["config"],
                                  str(evaluated["root"] / "valid"), batch_size=4, device="cpu")
    want = evaluated["want"]
    assert got["num_images"] == want["num_images"] == N_IMAGES
    assert want["map50"] > 0
    np.testing.assert_allclose(got["map"], want["map50"], rtol=0, atol=1e-4)
    ap = [np.nan if v is None else v for v in want["ap_per_class"]]
    np.testing.assert_allclose(got["ap_per_class"], ap, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["num_gt_per_class"], want["num_gt_per_class"])
    # one batch or four: the same images are scored
    again = evaluate_checkpoint_map(evaluated["ckpt"], evaluated["config"],
                                    str(evaluated["root"] / "valid"), batch_size=16,
                                    device="cpu")
    assert again["map"] == got["map"]


def test_eval_det_cli_prints_the_jax_keys(evaluated, capsys):
    capsys.readouterr()
    out = eval_det.main(evaluated["argv"] + ["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    assert list(out) == list(evaluated["want"])
    assert abs(out["map50"] - evaluated["want"]["map50"]) <= 1e-4
    assert out["num_images"] == N_IMAGES and out["quantize"] == "none"


def _int8_eval_det(e, monkeypatch):
    """eval_det --quantize int8 on the CPU and the JAX package's eval_det
    --quantize int8 (its harness in f32) on the same checkpoint and data."""
    f32 = functools.partial(jax_eval_harness.evaluate_checkpoint_map, dtype=jnp.float32)
    monkeypatch.setattr(jax_eval_harness, "evaluate_checkpoint_map", f32)
    argv = e["argv"] + ["--quantize", "int8"]
    want = jax_eval_det.run(jax_eval_det.build_parser().parse_args(argv))
    return eval_det.main(argv + ["--device", "cpu"]), want, 1e-4


def _int8_eval_seg(e, monkeypatch):
    """evaluate_checkpoint_seg in int8 and in f32 on a seeded seg net over
    a polygon directory: int8 moves the masks' metrics by int8 noise."""
    ckpt = str(e["root"] / "seg" / "SegmentationNet.ckpt.tar")
    save_checkpoint(ckpt, {"LAST_EPOCH": 0, "NUM_CLASSES": NUM_CLASSES,
                           "NETWORK_PARAMS": state_dict_to_flax(port_seg_net(seed=8).state_dict())})
    data = str(e["root"] / "seg" / "valid")
    write_polygon_dataset(data, n=5, size=(SIZE, SIZE), seed=9)
    config = {**e["config"], "model_config": SEG_CONFIG}
    kw = dict(batch_size=4, device="cpu")
    want = evaluate_checkpoint_seg(ckpt, config, data, **kw)
    return evaluate_checkpoint_seg(ckpt, config, data, quantize="int8", **kw), want, 0.05


@pytest.mark.parametrize("call,item", [(_int8_eval_det, "§A.10"), (_int8_eval_seg, "§A.10")],
                         ids=["int8", "segmentation"])
def test_unported_evaluations_raise(evaluated, monkeypatch, call, item):
    """The evaluations that ROADMAP item `item` (int8) left out of the port
    until it was done now run on the CPU: the first batch calibrates the
    int8 form (`runner.quantize_model_int8`, spied on here), and the
    metrics match the JAX package's int8 eval_det within 1e-4 (both in
    f32; the same int8 arithmetic), or the f32 form's within 0.05 (seg).
    int8 without the deploy form raises, as in the JAX package."""
    calls = []
    calibrate = runner.quantize_model_int8

    def spy(model, *args, **kw):
        calls.append(sum(hasattr(m, "q_kernel") for m in calibrate(model, *args, **kw).modules()))
        return model

    monkeypatch.setattr(runner, "quantize_model_int8", spy)
    got, want, tol = call(evaluated, monkeypatch)
    assert item == "§A.10" and len(calls) == 1 and calls[0] > 20
    assert list(got) == list(want)
    for k, v in want.items():
        if k == "quantize":
            assert got[k] == v == "int8"
        elif isinstance(v, (float, list)) and k != "num_gt_per_class":
            np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                       np.asarray([np.nan if a is None else a for a in v]
                                                  if isinstance(v, list) else v, np.float64),
                                       atol=tol, rtol=0, err_msg=k)
        else:
            assert np.array_equal(got[k], v), k
    with pytest.raises(ValueError, match="use_reparam|deploy"):
        evaluate_checkpoint_map(evaluated["ckpt"], evaluated["config"],
                                str(evaluated["root"] / "valid"), quantize="int8",
                                use_reparam=False, device="cpu")


def test_train_det_map_eval_writes_map50(tmp_path):
    ws = str(tmp_path)
    _workspace(ws)
    pipe = _train(ws, "--epochs", "1", "--map_eval")
    df = pd.read_csv(os.path.join(ws, "metrics/detection/eval_metrics.csv"))
    assert "map50" in df.columns and len(df) == 1
    assert 0.0 <= df["map50"].iloc[0] <= 1.0
    assert pipe._eval_metrics[-1]["map50"] == df["map50"].iloc[0]


@pytest.mark.parametrize("training", [True, False], ids=["train_mode", "eval_mode"])
def test_evaluate_pipeline_map_leaves_the_net_as_it_was(evaluated, training):
    """Running statistics and parameters do not move, the net's mode comes
    back, and the score is the train-form checkpoint's own."""
    net = port_detection_net(CONFIG, seed=5).train(training)
    opt, _ = make_optimizer({"name": "Adam", "lr": 1e-3}, net)
    pipe = TrainDetectionPipeline(net, DetectionLossConfig(num_classes=NUM_CLASSES), opt,
                                  init_scheme=None)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    ds = DetectionDataset(str(evaluated["root"] / "valid"), img_wh=(SIZE, SIZE))
    got = evaluate_pipeline_map(pipe, ds, batch_size=4)
    assert net.training == training
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]), k
    want = evaluate_checkpoint_map(evaluated["ckpt"], evaluated["config"],
                                   str(evaluated["root"] / "valid"), batch_size=4,
                                   use_reparam=False, device="cpu")
    assert got["map"] == want["map"] > 0
