"""Segmentation training and evaluation of the PyTorch port against the JAX
package, in f32 on the CPU, through the entry points.

- one train step of TrainSegmentationPipeline with cap_policy "first"
  against the JAX pipeline from the same bridged weights: loss and metrics
  rtol 1e-4, parameters and BatchNorm statistics atol 1e-4 / rtol 1e-3
  (the tolerances of tests/test_torch_train.py's trajectory);
- the train_seg CLI for 2 epochs writes the JAX CLI's artifacts, and its
  config rules (overlap_masks, mask_store_wh) are the JAX CLI's;
- evaluate_checkpoint_seg equals the JAX harness within 1e-5 on a tiny net
  taken 60 steps on four images (so mask mAP and dice are not zero), and
  eval_seg prints the JAX CLI's JSON keys with the same values.
"""
import functools
import importlib
import json
import os
from unittest import mock

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

from vision_conglomerate_tpu.losses import SegmentationLossConfig as JaxSegLossConfig
from vision_conglomerate_tpu.models import SegmentationNet as JaxSegmentationNet
from vision_conglomerate_tpu.parallel import make_mesh
from vision_conglomerate_tpu.tools import eval_harness as jax_eval_harness
from vision_conglomerate_tpu.train import TrainSegmentationPipeline as JaxSegPipeline
from vision_conglomerate_tpu.train import make_optimizer as jax_make_optimizer

from vision_conglomerate_torch import eval_seg, train_seg
from vision_conglomerate_torch.data.loader import DataLoader
from vision_conglomerate_torch.data.segmentation import SegmentationDataset
from vision_conglomerate_torch.losses import SegmentationLossConfig
from vision_conglomerate_torch.models import SegmentationNet
from vision_conglomerate_torch.tools.eval_harness import evaluate_checkpoint_seg
from vision_conglomerate_torch.train.checkpoint import save_checkpoint
from vision_conglomerate_torch.train.optim import make_optimizer
from vision_conglomerate_torch.train.segmentation_trainer import TrainSegmentationPipeline
from vision_conglomerate_torch.utils import load_yaml, save_yaml
from vision_conglomerate_torch.weights import flax_to_state_dict, state_dict_to_flax

from tests.test_torch_seg_data import write_polygon_dataset
from tests.test_torch_seg_model import SEG_CONFIG, port_seg_net
from tests.test_torch_train import OPT_CFG, _one_batch
from tests.test_torch_weights import ANCHORS, NUM_CLASSES, flat, to_numpy

SIZE = 64
LOSS_KW = dict(num_classes=NUM_CLASSES, box_w=0.1, class_w=0.3, label_smoothing=0.001,
               cap_policy="first", seg_candidates_per_image=8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("segtrain") / "data"
    write_polygon_dataset(str(root / "train"), n=6, size=(SIZE, SIZE), seed=1, max_polygons=4)
    write_polygon_dataset(str(root / "valid"), n=4, size=(SIZE, SIZE), seed=2, max_polygons=4)
    return root


def _batch(data_root, n=2):
    ds = SegmentationDataset(str(data_root / "train"), img_wh=(SIZE, SIZE), max_labels=6,
                             mask_store_wh=(SIZE // 4, SIZE // 4))
    return ds.collate_fn([ds[i] for i in range(1, 1 + n)])


def test_one_train_step_matches_jax(data_root):
    batch = _batch(data_root)
    variables = state_dict_to_flax(port_seg_net(seed=21).state_dict())

    model = JaxSegmentationNet(num_classes=NUM_CLASSES, config=SEG_CONFIG, anchors=ANCHORS)
    tx, _ = jax_make_optimizer(OPT_CFG)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    with mock.patch.object(JaxSegmentationNet, "init", lambda self, *a, **k: jvars):
        pipe = JaxSegPipeline(model, JaxSegLossConfig(**LOSS_KW), tx, mesh=make_mesh(1),
                              sample_input_shape=(SIZE, SIZE, 3), init_scheme="")
    pipe.state = jax.device_put(pipe.state.replace(step=jnp.zeros((), jnp.int32)),
                                NamedSharding(pipe.mesh, PartitionSpec()))
    want = pipe.train(_one_batch(batch))
    want_vars = to_numpy({"params": pipe.state.params, "batch_stats": pipe.state.batch_stats})

    net = SegmentationNet(NUM_CLASSES, SEG_CONFIG, anchors=ANCHORS, device="cpu")
    net.load_state_dict(flax_to_state_dict(variables))
    optimizer, _ = make_optimizer(OPT_CFG, net)
    port = TrainSegmentationPipeline(net, SegmentationLossConfig(**LOSS_KW), optimizer,
                                     init_scheme=None)
    got = port.train(_one_batch(batch))
    assert sorted(got) == sorted(want)
    assert {"seg_loss", "dice_score", "seg_dropped_candidates"} <= set(got)
    for k in want:
        if k != "images_per_sec":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    got_vars, want_flat, start = (flat(t) for t in (state_dict_to_flax(net.state_dict()),
                                                    want_vars, variables))
    assert sorted(got_vars) == sorted(want_flat)
    for k in want_flat:
        np.testing.assert_allclose(got_vars[k], want_flat[k], atol=1e-4, rtol=1e-3,
                                   err_msg="/".join(k))
    var = ("batch_stats", "proto_seg_module", "conv2", "norm", "BatchNorm_0", "var")
    assert not np.allclose(got_vars[var], start[var], atol=1e-4)


def _workspace(root, data_root, **train_config):
    config = load_yaml(os.path.join(os.path.dirname(__file__), "..", "configs", "segmentation",
                                    "config.yaml"))
    config["model_config"] = {**SEG_CONFIG, "dtype": "float32"}
    tc = config["train_config"]
    tc["data_path"] = str(data_root)
    tc["img_config"] = {"img_ext": "png", "img_wh": [SIZE, SIZE]}
    tc["dataloader_config"] = {"shuffle": True, "num_workers": 2, "max_labels": 6}
    tc["loss_config"]["seg_candidates_per_image"] = 8
    tc.update(train_config)
    config["auto_anchors_config"]["num_generations"] = 10
    config["auto_anchors_config"]["kmeans_iter"] = 5
    save_yaml(config, os.path.join(root, "config.yaml"))
    save_yaml({"anchors": ANCHORS}, os.path.join(root, "anchors.yaml"))
    return config


def test_train_seg_cli_writes_the_jax_artifacts(data_root, tmp_path, monkeypatch):
    ws = str(tmp_path)
    _workspace(ws, data_root)
    monkeypatch.chdir(ws)
    pipe = train_seg.main(["--config_path", "config.yaml", "--anchors_path", "anchors.yaml",
                           "--batch_size", "2", "--epochs", "2", "--lr_schedule",
                           "--checkpoint_interval", "1", "--no_verbose", "--device", "cpu"])
    assert isinstance(pipe, TrainSegmentationPipeline) and pipe.last_epoch == 2
    for rel in ("metrics/segmentation/train_metrics.csv",
                "metrics/segmentation/eval_metrics.csv",
                "metrics/segmentation/train_metrics_plot.jpg",
                "metrics/segmentation/eval_metrics_plot.jpg",
                "saved_model/segmentation/best_model/SegmentationNet.ckpt.tar",
                "saved_model/segmentation/best_model/config/config.yaml"):
        assert os.path.isfile(os.path.join(ws, rel)), rel
    snaps = [f for _, _, fs in os.walk(os.path.join(ws, "saved_model/segmentation/checkpoints"))
             for f in fs]
    assert sum(f.endswith(".ckpt.tar") for f in snaps) == 2 and "config.yaml" in snaps
    for mode in ("train", "eval"):
        df = pd.read_csv(os.path.join(ws, f"metrics/segmentation/{mode}_metrics.csv"))
        assert len(df) == 2
        for col in ("aggregate_loss", "seg_loss", "dice_score", "seg_dropped_candidates"):
            assert col in df.columns and np.isfinite(df[col]).all(), (mode, col)
    # the JAX package reads what the port wrote
    from vision_conglomerate_tpu.train.checkpoint import load_checkpoint as jax_load

    manifest = jax_load(os.path.join(
        ws, "saved_model/segmentation/best_model/SegmentationNet.ckpt.tar"))
    assert manifest["NUM_CLASSES"] == NUM_CLASSES
    assert "proto_seg_module" in manifest["NETWORK_PARAMS"]["params"]


@pytest.mark.parametrize("train_config,overlap,store", [
    ({}, True, (16, 16)),
    ({"overlap_masks": False}, False, (16, 16)),
    ({"img_config": {"img_ext": "png", "img_wh": [SIZE, SIZE], "mask_scale_factor": 0.5}},
     True, None),
], ids=["defaults", "train_config_overlap_wins", "mask_scale_factor"])
def test_train_seg_config_rules(data_root, tmp_path, train_config, overlap, store):
    """train_config.overlap_masks wins over loss_config's (here true); the
    masks are stored at img_wh // 4 unless mask_scale_factor is set."""
    config = _workspace(str(tmp_path), data_root, **train_config)
    ds = train_seg.make_dataset(config, "train")
    assert ds.overlap_masks == overlap and ds.mask_store_wh == store
    assert train_seg.make_loss_config(config, NUM_CLASSES).overlap_masks == overlap
    if store is None:
        assert ds.mask_scale_factor == 0.5 and ds[1][2].shape[-2:] == (SIZE // 2, SIZE // 2)


@pytest.fixture(scope="module")
def learned(data_root, tmp_path_factory):
    """A tiny SegmentationNet taken 60 Adam steps on four valid images,
    saved with its config beside it."""
    torch.manual_seed(0)
    root = tmp_path_factory.mktemp("learned")
    ds = SegmentationDataset(str(data_root / "valid"), img_wh=(SIZE, SIZE), max_labels=6,
                             mask_store_wh=(SIZE // 4, SIZE // 4))
    batch = [torch.from_numpy(a) for a in ds.collate_fn([ds[i] for i in range(4)])]
    net = port_seg_net(seed=3).train()
    opt, _ = make_optimizer({"name": "Adam", "lr": 3e-3}, net)
    pipe = TrainSegmentationPipeline(net, SegmentationLossConfig(**LOSS_KW), opt,
                                     init_scheme=None)
    for _ in range(60):
        pipe.train_step(*batch)
    ckpt = str(root / "SegmentationNet.ckpt.tar")
    save_checkpoint(ckpt, {"LAST_EPOCH": 0, "NUM_CLASSES": NUM_CLASSES,
                           "NETWORK_PARAMS": state_dict_to_flax(net.state_dict())})
    config = {"model_config": SEG_CONFIG,
              "train_config": {"img_config": {"img_wh": [SIZE, SIZE], "img_ext": "png"}}}
    (root / "config").mkdir()
    save_yaml(config, str(root / "config" / "config.yaml"))
    return ckpt, config


@pytest.fixture(scope="module")
def jax_eval(learned, data_root):
    ckpt, config = learned
    return jax_eval_harness.evaluate_checkpoint_seg(ckpt, config, str(data_root / "valid"),
                                                    batch_size=3, dtype=jnp.float32)


@pytest.mark.parametrize("crop", [False, True], ids=["uncropped", "crop_masks"])
def test_evaluate_checkpoint_seg_matches_jax(learned, data_root, jax_eval, crop):
    ckpt, config = learned
    kw = dict(batch_size=3, crop_masks=crop)
    want = jax_eval if not crop else jax_eval_harness.evaluate_checkpoint_seg(
        ckpt, config, str(data_root / "valid"), dtype=jnp.float32, **kw)
    got = evaluate_checkpoint_seg(ckpt, config, str(data_root / "valid"), device="cpu", **kw)
    assert sorted(got) == sorted(want)
    if not crop:
        assert want["mask_map"] > 0 and want["dice"] > 0
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k], np.float64), np.asarray(v, np.float64),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_eval_seg_prints_the_jax_cli_line(learned, data_root, jax_eval, capsys):
    """The root eval_seg.py's JSON line, its harness result given by the
    JAX harness in f32, against the port's CLI on the CPU."""
    ckpt, _ = learned
    argv = ["--weights_path", ckpt, "--data_dir", str(data_root / "valid"), "--batch_size", "3"]
    root_cli = importlib.import_module("eval_seg")
    with mock.patch.object(jax_eval_harness, "evaluate_checkpoint_seg",
                           lambda *a, **k: jax_eval):
        want = root_cli.run(root_cli.build_parser().parse_args(argv))
    capsys.readouterr()
    got = eval_seg.main(argv + ["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got
    assert list(got) == list(want)
    for k, v in want.items():
        if k in ("mask_ap_per_class",):
            np.testing.assert_allclose(np.asarray(got[k], float), np.asarray(v, float),
                                       atol=1e-5)
        elif isinstance(v, float):
            assert abs(got[k] - v) <= 1e-5, k
        else:
            assert got[k] == v, k
    # int8 (ROADMAP §A.10) scores the learned net within int8 noise of f32
    int8 = eval_seg.main(argv + ["--device", "cpu", "--quantize", "int8"])
    assert list(int8) == list(got) and int8["quantize"] == "int8"
    for k in ("mask_map50", "dice", "box_map50"):
        assert abs(int8[k] - got[k]) <= 0.05, k
