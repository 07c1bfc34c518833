"""Training, the CLIs and reference checkpoints with the detector's
alternate components, against the JAX package, in f32 on the CPU: one
train step of ResNetBackBone + RepBiPAN (bilinear resizes) + BasicHead
(loss, metrics, gradients, BatchNorm statistics), the train / serve / eval
CLIs on such a config, and the reference-checkpoint loader
(`tools.torch_port`) on synthetic reference-named state_dicts.

Weights come from seeded port nets with non-trivial BatchNorm state,
bridged with `weights.state_dict_to_flax`; the JAX nets are only applied.
Tolerances: the train step's loss rtol 1e-5, its metrics rtol 1e-5 / atol
1e-6 (a mean CIoU near 0.02 over f32 boxes of two nets), each parameter's
gradient within 1e-3 of its largest magnitude (f32 sums over the batch and
the image in another order: the stem BatchNorm's bias gradients read up
to 1e-4 of it; a conv bias in front of a train-mode BatchNorm has no
gradient in exact arithmetic, so both sides' must stay under 1e-6) and the BatchNorm statistics atol 1e-5; the reference
loader's forwards atol 1e-4 / rtol 1e-4 (decoded boxes atol 2e-3 / rtol
1e-3, as tests/test_torch_detection.py holds the detector).
"""
import os

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from vision_conglomerate_tpu.losses import DetectionLossConfig as JaxLossConfig
from vision_conglomerate_tpu.losses import detection_loss as jax_detection_loss
from vision_conglomerate_tpu.models import DetectionNet as JaxDetectionNet
from vision_conglomerate_tpu.models import TrackNet as JaxTrackNet
from vision_conglomerate_tpu.nn import blocks as jax_blocks
from vision_conglomerate_tpu.tools.torch_port import convert_torch_state_dict

from vision_conglomerate_torch import eval_det, train_det
from vision_conglomerate_torch.infer.runner import load_detection_model, run_detection_inference
from vision_conglomerate_torch.losses import DetectionLossConfig, detection_loss
from vision_conglomerate_torch.models import DetectionNet, TrackNet
from vision_conglomerate_torch.nn import blocks
from vision_conglomerate_torch.tools import torch_port
from vision_conglomerate_torch.weights import state_dict_to_flax

from tests.test_torch_alternates import NETS, NUM_CLASSES, nchw, nhwc, seeded
from tests.test_torch_train_cli import CONFIG as CLI_CONFIG
from tests.test_torch_train_cli import _workspace
from tests.test_torch_weights import ANCHORS, flat, to_numpy

NET_TOL = dict(atol=2e-3, rtol=1e-3)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -------------------------------------------------------------- training
LOSS_KW = dict(num_classes=NUM_CLASSES, box_w=0.1, class_w=0.3, label_smoothing=0.001)


def test_one_train_step_matches_jax():
    """ResNetBackBone + RepBiPAN (bilinear) + BasicHead in train mode: the
    loss and its metrics, the gradient of every parameter and the
    BatchNorm running statistics after the step, against the JAX net and
    loss (BasicHead's packed output reaches the loss in the JAX layout)."""
    config = NETS["resnet_basichead"]
    net = seeded(DetectionNet(NUM_CLASSES, config, anchors=ANCHORS), seed=47).train()
    variables = state_dict_to_flax(
        {k: v.clone() for k, v in net.state_dict().items()})  # train mode updates in place
    rng = np.random.default_rng(48)
    x = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    labels = np.zeros((2, 4, 5), np.float32)
    mask = np.zeros((2, 4), bool)
    labels[:, 0] = [1, 0.5, 0.5, 0.3, 0.3]
    labels[:, 1] = [2, 0.25, 0.3, 0.1, 0.12]
    mask[:, :2] = True
    jm = JaxDetectionNet(num_classes=NUM_CLASSES, config=config, anchors=ANCHORS)

    def jax_loss(params):
        preds, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jnp.asarray(x), train=True, mutable=["batch_stats"])
        anchors = [params[f"{k}_anchors"] for k in ("sm", "md", "lg")]
        loss, metrics = jax_detection_loss(preds, jnp.asarray(labels), jnp.asarray(mask),
                                           anchors, JaxLossConfig(**LOSS_KW))
        return loss, (metrics, mut)

    (want_loss, (want_m, mut)), want_g = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        variables["params"])
    preds = net(nchw(x))
    loss, got_m = detection_loss(list(preds), torch.from_numpy(labels), torch.from_numpy(mask),
                                 [net.sm_anchors, net.md_anchors, net.lg_anchors],
                                 DetectionLossConfig(**LOSS_KW))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for k in want_m:
        np.testing.assert_allclose(got_m[k].item(), float(want_m[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    grads = {k: v for k, v in net.state_dict().items()}  # buffers mark the BatchNorms
    for n, p in net.named_parameters():
        grads[n] = p.grad if p.grad is not None else torch.zeros_like(p)
    got_g = flat(state_dict_to_flax(grads)["params"])
    want_g = flat(to_numpy(want_g))
    assert sorted(got_g) == sorted(want_g)
    before_bn = {k for k in want_g if k[-2:] == ("conv", "bias")
                 and k[:-2] + ("norm", "BatchNorm_0", "scale") in want_g}
    assert before_bn
    for k, w in want_g.items():
        if k in before_bn:  # zero in exact arithmetic: rounding noise on both sides
            assert np.abs(got_g[k]).max() < 1e-6 and np.abs(w).max() < 1e-6, "/".join(k)
        else:
            assert np.abs(got_g[k] - w).max() <= 1e-3 * np.abs(w).max() + 1e-9, "/".join(k)
    got_s = flat(state_dict_to_flax(net.state_dict())["batch_stats"])
    for k, w in flat(to_numpy(mut["batch_stats"])).items():
        np.testing.assert_allclose(got_s[k], w, atol=1e-5, err_msg="/".join(k))


ALT_CLI_CONFIG = {**CLI_CONFIG, "model_config": {
    "train_anchors": True, "backbone": "ResNetBackBone", "neck": "RepBiPAN", "head": "BasicHead",
    "resnetbackbone_config": {"block": "BasicBlock", "block_layers": [1, 1, 1, 1]},
    "repbipan_config": {"width_multiple": 0.25, "depth_multiple": 0.2,
                        "upsample_mode": "bilinear", "repvgg_branch_act": None},
    "basichead_config": {"width_multiple": 0.5}}}


def test_train_serve_and_eval_clis_take_the_alternates(tmp_path):
    """train_det (--map_eval) on a ResNetBackBone + BasicHead config: the
    saved config keeps the alternate keys, so the best model reloads into
    the same net; inference_det's runner serves it (f32 and int8) and
    eval_det scores it, on the CPU."""
    root = str(tmp_path)
    _workspace(root, ALT_CLI_CONFIG)
    old = os.getcwd()
    os.chdir(root)
    try:
        pipe = train_det.main(["--config_path", "config.yaml", "--anchors_path", "anchors.yaml",
                               "--batch_size", "2", "--epochs", "1", "--no_verbose",
                               "--map_eval", "--device", "cpu"])
    finally:
        os.chdir(old)
    assert np.isfinite(pipe._train_metrics[-1]["aggregate_loss"])
    best = os.path.join(root, "saved_model/detection/best_model")
    with open(os.path.join(best, "config", "config.yaml")) as f:
        saved_config = yaml.safe_load(f)
    saved = saved_config["model_config"]
    for key in ("backbone", "head", "resnetbackbone_config", "repbipan_config",
                "basichead_config"):
        assert saved[key] == ALT_CLI_CONFIG["model_config"][key], key
    model, _ = load_detection_model(os.path.join(best, "DetectionNet.ckpt.tar"), saved,
                                    device="cpu", use_reparam=False)
    trained = pipe.model.state_dict()
    for k, v in model.state_dict().items():  # checkpoints drop num_batches_tracked
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, trained[k].float()), k
    for quant in (None, "int8"):
        out = run_detection_inference(os.path.join(root, "data/detection/valid"),
                                      os.path.join(best, "DetectionNet.ckpt.tar"), saved_config,
                                      batch_size=2, score_threshold=0.0, with_summary=True,
                                      storage_path=os.path.join(root, f"served_{quant}"),
                                      device="cpu", quantize=quant)
        assert sum(f.endswith(".png") for f in os.listdir(out)) == 2
    res = eval_det.run(eval_det.build_parser().parse_args([
        "--weights_path", os.path.join(best, "DetectionNet.ckpt.tar"),
        "--data_dir", os.path.join(root, "data/detection/valid"), "--device", "cpu"]))
    assert res["num_images"] == 2 and 0.0 <= res["map50"] <= 1.0


# ------------------------------------------------ reference checkpoints
def to_reference_names(state):
    """A port state_dict under the reference's module names: torchvision's
    `layerL.B` and `downsample.0/1`, TrackNet base's `_enc_modules.N` /
    `_dec_modules.N`."""
    out = {}
    for k, v in state.items():
        parts = []
        for seg in k.split("."):
            head, _, tail = seg.rpartition("_")
            if seg in ("downsample_conv", "downsample_bn"):
                parts += ["downsample", "0" if seg.endswith("conv") else "1"]
            elif head.startswith("layer") and tail.isdigit():
                parts += [head, tail]
            elif head in ("enc", "dec") and tail.isdigit():
                parts += [f"_{head}_modules", tail]
            else:
                parts.append(seg)
        out[".".join(parts)] = v.clone()
    return out


TN_CONFIG = {"architecture": "base", "base_arch_config": {
    "encoder_config": {"width_multiple": 0.25}, "decoder_config": {"width_multiple": 0.25}}}


@pytest.mark.parametrize("name", ["resnet_basichead", "resnet_bottleneck", "tracknet_base"])
def test_reference_loader_matches_the_jax_converter(name, tmp_path):
    """A synthetic reference-named state_dict (torchvision's ResNet
    layers and downsamples, TrackNet base's module lists): the loader gives
    the port's own state_dict back, and the port's forward equals the JAX
    forward of the same dict through the JAX package's
    convert_torch_state_dict. load_reference_checkpoint reads a torch
    .pth.tar manifest, and the CLI writes a checkpoint the serve loader
    reads."""
    if name == "tracknet_base":
        net = seeded(TrackNet(TN_CONFIG), seed=49)
        jm, x, kw = JaxTrackNet(config=TN_CONFIG), nhwc((1, 32, 64, 9), seed=50), {}
        config, task = {"model_config": TN_CONFIG}, "tracknet"
    else:
        net = seeded(DetectionNet(NUM_CLASSES, NETS[name], anchors=ANCHORS), seed=49)
        jm = JaxDetectionNet(num_classes=NUM_CLASSES, config=NETS[name], anchors=ANCHORS)
        x, kw = nhwc((1, 64, 64, 3), seed=50), dict(inference=True)
        config, task = {"model_config": NETS[name]}, "detection"
    port_state = net.state_dict()
    ref = to_reference_names(port_state)
    assert any(".downsample.0." in k or "_enc_modules.0." in k for k in ref)
    converted = torch_port.convert_reference_state_dict(ref)
    assert sorted(converted) == sorted(port_state)
    for k, v in port_state.items():
        assert torch.equal(converted[k], v.float() if v.is_floating_point() else v), k
    path = str(tmp_path / "ref.pth.tar")
    torch.save({"LAST_EPOCH": 3, "NETWORK_PARAMS": ref, "NUM_CLASSES": NUM_CLASSES}, path)
    loaded, num_classes = torch_port.load_reference_checkpoint(path, config, task)
    assert num_classes == NUM_CLASSES
    want = jax.jit(lambda v, xs: jm.apply(v, xs, train=False, **kw))(
        convert_torch_state_dict(ref), jnp.asarray(x))
    with torch.no_grad():
        got = loaded(nchw(x), **kw)
    if name == "tracknet_base":
        got = got.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(NET_TOL if kw else TOL))
    if name != "tracknet_base":
        out = str(tmp_path / "port.ckpt.tar")
        torch_port.main([path, out])
        served, _ = load_detection_model(out, NETS[name], device="cpu", use_reparam=False)
        with torch.no_grad():
            np.testing.assert_allclose(served(nchw(x), **kw).numpy(), got.numpy(), atol=1e-6)


def test_reference_loader_keeps_torchs_transpose_conv():
    """A transpose conv's reference weight loads as it is, so the port
    computes what torch computes; the JAX converter maps it without the
    flip that flax's ConvTranspose needs (ROADMAP §C), so the JAX forward
    of that tree differs, and the port's own bridge (which flips) agrees."""
    port = seeded(blocks.ConvTransposeBNorm(6, 4, 3, 2, 1), seed=51)
    ref = {k: v.clone() for k, v in port.state_dict().items()}
    converted = torch_port.convert_reference_state_dict(ref)
    port.load_state_dict(converted)
    x = nhwc((1, 5, 7, 6), seed=52)
    ct = port.conv_transpose
    bn = port.norm
    want = F.silu(F.batch_norm(F.conv_transpose2d(nchw(x), ref["conv_transpose.weight"],
                                                  ref["conv_transpose.bias"], 2, 1),
                               bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0,
                               bn.eps))
    with torch.no_grad():
        got = port(nchw(x))
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    jm = jax_blocks.ConvTransposeBNorm(4, kernel_size=3, stride=2, padding=1)
    unflipped = jm.apply(convert_torch_state_dict(ref), jnp.asarray(x), train=False)
    flipped = jm.apply(state_dict_to_flax(converted), jnp.asarray(x), train=False)
    got_nhwc = got.permute(0, 2, 3, 1).numpy()
    assert np.abs(np.asarray(unflipped) - got_nhwc).max() > 0.1
    np.testing.assert_allclose(np.asarray(flipped), got_nhwc, **TOL)
    assert ct.weight.shape == (6, 4, 3, 3)
