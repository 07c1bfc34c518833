"""int8 on a trained net: the port's eval_det mAP@50 in int8 equals the
JAX package's on the same trained checkpoint, on the CPU.

A small detector (tests/test_torch_weights.py's CONFIG, 64x64) takes 150
Adam steps on 8 images with large boxes (tests/test_torch_eval.py's YOLO
dir), so its activations are a trained net's, not a random one's; then
both packages' `evaluate_checkpoint_map` score it in f32 and in int8 (the
JAX harness in f32). The int8 scores must be equal within 1e-9 (the same
quantized sets, scales and exact int sums; only the f32 epilogue's last
bits may differ, which moves no ranking here) and above 0; the f32 scores
within 1e-4, as tests/test_torch_eval.py holds them.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vision_conglomerate_tpu.tools import eval_harness as jax_eval_harness

from vision_conglomerate_torch.data.detection import DetectionDataset
from vision_conglomerate_torch.losses import DetectionLossConfig
from vision_conglomerate_torch.tools.eval_harness import evaluate_checkpoint_map
from vision_conglomerate_torch.train.checkpoint import save_checkpoint
from vision_conglomerate_torch.train.detection_trainer import TrainDetectionPipeline
from vision_conglomerate_torch.train.optim import make_optimizer
from vision_conglomerate_torch.weights import state_dict_to_flax

from tests.test_torch_eval import SIZE, _write_yolo_dir
from tests.test_torch_weights import CONFIG, NUM_CLASSES, port_detection_net

STEPS = 150


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_int8_map_of_a_trained_net_matches_jax(tmp_path):
    data = str(tmp_path / "valid")
    _write_yolo_dir(data, 8, seed=6)
    torch.manual_seed(0)
    net = port_detection_net(CONFIG, seed=5).train()
    opt, _ = make_optimizer({"name": "Adam", "lr": 3e-3}, net)
    pipe = TrainDetectionPipeline(net, DetectionLossConfig(num_classes=NUM_CLASSES), opt,
                                  init_scheme=None)
    ds = DetectionDataset(data, img_wh=(SIZE, SIZE))
    batch = [torch.from_numpy(a) for a in ds.collate_fn([ds[i] for i in range(len(ds))])]
    losses = [pipe.train_step(*batch)["aggregate_loss"].item() for _ in range(STEPS)]
    assert losses[-1] < losses[0] / 4
    ckpt = str(tmp_path / "best" / "DetectionNet.ckpt.tar")
    save_checkpoint(ckpt, {"LAST_EPOCH": 0, "NUM_CLASSES": NUM_CLASSES,
                           "NETWORK_PARAMS": state_dict_to_flax(net.state_dict())})
    config = {"model_config": CONFIG,
              "train_config": {"img_config": {"img_wh": [SIZE, SIZE], "img_ext": "png"}}}
    got, want = {}, {}
    for q in (None, "int8"):
        got[q] = evaluate_checkpoint_map(ckpt, config, data, batch_size=8, quantize=q,
                                         device="cpu")
        want[q] = jax_eval_harness.evaluate_checkpoint_map(ckpt, config, data, batch_size=8,
                                                           quantize=q, dtype=jnp.float32)
    print(f"trained net mAP@50: f32 port {got[None]['map']:.6f} jax {want[None]['map']:.6f}; "
          f"int8 port {got['int8']['map']:.6f} jax {want['int8']['map']:.6f}")
    assert got[None]["map"] == pytest.approx(want[None]["map"], abs=1e-4)
    assert want["int8"]["map"] > 0
    assert got["int8"]["map"] == pytest.approx(want["int8"]["map"], abs=1e-9)
    np.testing.assert_allclose(got["int8"]["ap_per_class"], want["int8"]["ap_per_class"],
                               atol=1e-9, rtol=0)
