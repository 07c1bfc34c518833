"""The detector's alternate components on the port's serve paths, against
the JAX package, in f32 on the CPU: the serve-fast decode
(`ops.serve_decode.decode_and_postprocess`) and the deploy and int8 forms
of the two nets chip_smoke.py drives (ResNetBackBone + RepBiPAN with
bilinear resizes + BasicHead, and CSPBackBone with the space-to-depth stem
and `early_min_channels`).

Weights come from seeded port nets with non-trivial BatchNorm state,
bridged with `weights.state_dict_to_flax`; the JAX nets are only applied.
Tolerances: the decode's kept rows equal up to the order of equal scores
(scores 1e-6, boxes 1e-3 px, coefficients 1e-6); deploy nets atol 2e-3 /
rtol 1e-3 (boxes in pixels), as tests/test_torch_detection.py holds the
detector; int8 as tests/test_torch_int8_detection.py (x_q equal, layers
1e-6, free-running nets 2e-2).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vision_conglomerate_tpu.models import DetectionNet as JaxDetectionNet
from vision_conglomerate_tpu.nn.blocks import bn_folding, fused_pointwise
from vision_conglomerate_tpu.nn.reparam import deploy_transform as jax_deploy_transform
from vision_conglomerate_tpu.ops.serve_decode import (
    decode_and_postprocess as jax_decode_and_postprocess)

from vision_conglomerate_torch.infer.runner import load_detection_model
from vision_conglomerate_torch.models import DetectionNet, SegmentationNet
from vision_conglomerate_torch.nn import blocks, quantize
from vision_conglomerate_torch.nn.reparam import deploy_transform
from vision_conglomerate_torch.ops import serve_decode
from vision_conglomerate_torch.ops.postprocess import postprocess_detections
from vision_conglomerate_torch.train.checkpoint import save_checkpoint
from vision_conglomerate_torch.weights import state_dict_to_flax

from tests import test_torch_int8_detection as int8_tests
from tests.test_torch_alternates import NETS, NUM_CLASSES, nchw, seeded
from tests.test_torch_seg_model import SEG_CONFIG
from tests.test_torch_weights import ANCHORS

NET_TOL = dict(atol=2e-3, rtol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ serve-fast decode
SEG_BASIC = {**SEG_CONFIG, "head": "BasicHead", "basichead_config": {"width_multiple": 0.5}}
DECODE_CASES = {
    "effidechead": dict(net=("detection", NETS["csp_s2d"]), og=None, kw={}),
    "basichead_og": dict(net=("detection", NETS["resnet_basichead"]), og=(80, 96),
                         kw=dict(box_allowance=4.0, topk_method="approx")),
    "seg_coefs": dict(net=("segmentation", SEG_CONFIG), og=None, kw={}),
    "basichead_seg_og": dict(net=("segmentation", SEG_BASIC), og=(72, 100), kw={}),
}


def kept_rows(res, with_coefs=False):
    """Each image's kept rows [score, class, x1, y1, x2, y2 (, coefs)],
    sorted by score, then box: the order of equal scores aside."""
    out = []
    for i in range(res.scores.shape[0]):
        v = np.asarray(res.valid[i]).astype(bool)
        cols = [np.asarray(res.scores[i])[v, None], np.asarray(res.classes[i])[v, None],
                np.asarray(res.boxes_xyxy[i])[v]]
        if with_coefs:
            cols.append(np.asarray(res.mask_coefs[i])[v])
        rows = np.concatenate([c.astype(np.float64) for c in cols], axis=1)
        out.append(rows[np.lexsort(tuple(rows[:, j] for j in range(5, -1, -1)) + (-rows[:, 0],))])
    return out


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_and_postprocess_matches_the_decode_and_jax(case):
    """From the raw fields (EffiDecHead's per-field maps, BasicHead's
    packed map; seg with its mask coefficients; the og rescale where both
    dims differ; box_allowance): the same kept rows as the net's decode +
    postprocess_detections, and as the JAX package's serve_decode on the
    same fields (NHWC)."""
    c = DECODE_CASES[case]
    task, config = c["net"]
    cls = SegmentationNet if task == "segmentation" else DetectionNet
    net = seeded(cls(NUM_CLASSES, config, anchors=ANCHORS), seed=40)
    num_masks = net.num_masks
    x = nchw(np.random.default_rng(41).uniform(size=(2, 64, 64, 3)).astype(np.float32))
    kw = dict(iou_threshold=0.5, score_threshold=0.05, max_detections=60, **c["kw"])
    with torch.no_grad():
        raw = net(x, raw_fields=True)
        preds = net(x, inference=True, og_size=c["og"])
    if task == "segmentation":
        raw, preds = raw[0], preds[0]
    got = serve_decode.decode_and_postprocess(raw, (64, 64), NUM_CLASSES, num_masks,
                                              og_size=c["og"], **kw)
    want = postprocess_detections(preds, NUM_CLASSES, num_masks, **kw)
    anchors, fields = raw
    jax_raw = ({k: jnp.asarray(v.numpy()) for k, v in anchors.items()},
               [{k: jnp.asarray(v.permute(0, 2, 3, 1).numpy()) for k, v in f.items()}
                for f in fields])
    jax_res = jax_decode_and_postprocess(jax_raw, (64, 64), NUM_CLASSES, num_masks,
                                         og_size=c["og"], **kw)
    assert got.mask_coefs.shape[-1] == num_masks and got.keypoints.shape[-2] == 0
    for other in (want, jax_res):
        for g, w in zip(kept_rows(got, bool(num_masks)), kept_rows(other, bool(num_masks))):
            assert len(g) == len(w) > 0
            np.testing.assert_allclose(g[:, :2], w[:, :2], atol=1e-6)
            np.testing.assert_allclose(g[:, 2:6], w[:, 2:6], atol=1e-3)
            np.testing.assert_allclose(g[:, 6:], w[:, 6:], atol=1e-6)
    assert not got.mask_coefs[~got.valid].any()


def test_decode_and_postprocess_refuses_keypoint_heads():
    net = seeded(DetectionNet(NUM_CLASSES, NETS["resnet_basichead"], anchors=ANCHORS,
                              num_keypoints=1), seed=42)
    with torch.no_grad():
        raw = net(torch.zeros(1, 3, 64, 64), raw_fields=True)
    with pytest.raises(NotImplementedError, match="keypoint"):
        serve_decode.decode_and_postprocess(raw, (64, 64), NUM_CLASSES)
    with pytest.raises(ValueError):
        serve_decode.decode_and_postprocess(raw, (64, 64), NUM_CLASSES, topk_method="lax")


# ------------------------------------------------------ deploy and int8
SERVE_NETS = ["csp_s2d", "resnet_basichead"]


def _checkpoint(path, net):
    save_checkpoint(path, {"LAST_EPOCH": 0, "NUM_CLASSES": NUM_CLASSES,
                           "NETWORK_PARAMS": state_dict_to_flax(net.state_dict())})
    return path


@pytest.mark.parametrize("name", SERVE_NETS)
def test_deploy_form_matches_jax_and_routes_as_designed(name, tmp_path, monkeypatch):
    """The serve loader's deploy form (BN folded into every ConvBNorm,
    RepVGG fused) against the JAX package's (deploy_transform under
    bn_folding + fused_pointwise), decoded to an og size. The convs that
    reach the conv3x3 kernel: the s2d stem (Cin 12, 3x3/s1) and
    BasicHead's stem_layer among them; ResNet's convs (their BatchNorms
    are `bnN` siblings, which neither package folds) and BasicHead's 1x1
    `conv` stay on PyTorch's conv."""
    config = NETS[name]
    net = seeded(DetectionNet(NUM_CLASSES, config, anchors=ANCHORS), seed=43)
    ckpt = _checkpoint(str(tmp_path / "DetectionNet.ckpt.tar"), net)
    calls = []
    conv3x3 = blocks.conv3x3_bias_act
    monkeypatch.setattr(blocks, "conv3x3_bias_act",
                        lambda x, *a: calls.append(tuple(x.shape)) or conv3x3(x, *a))
    model, _ = load_detection_model(ckpt, config, device="cpu")
    x = np.random.default_rng(44).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        got = model(nchw(x), inference=True, og_size=(80, 96))
    variables = state_dict_to_flax(net.state_dict())
    dp, ds = jax_deploy_transform(variables["params"], variables["batch_stats"])
    with bn_folding(), fused_pointwise():
        want = JaxDetectionNet(num_classes=NUM_CLASSES, config=config, anchors=ANCHORS,
                               deploy=True).apply({"params": dp, **({"batch_stats": ds} if ds
                                                                   else {})},
                                                  jnp.asarray(x), train=False, inference=True,
                                                  og_size=(80, 96))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **NET_TOL)
    cins = sorted({s[-1] for s in calls})
    if name == "csp_s2d":
        assert (2, 32, 32, 12) in calls  # the s2d stem
        assert not hasattr(model.backbone.conv0, "norm")
    else:
        assert hasattr(model.backbone.bn1, "running_mean") and hasattr(model.backbone, "conv2")
        assert all(c not in (3,) for c in cins)  # no ResNet stem on the kernel
        assert sum(isinstance(m, blocks.BasicHead) for m in model.modules()) == 3
        stems = [h.stem_layer.conv.in_channels for h in model.head]
        assert all(any(s[-1] == c for s in calls) for c in stems)


def _int8_case(name):
    config = NETS[name]
    train_form = seeded(DetectionNet(NUM_CLASSES, config, anchors=ANCHORS), seed=45)
    x = np.random.default_rng(46).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    return int8_tests.Case(
        name, lambda: DetectionNet(NUM_CLASSES, config, anchors=ANCHORS, deploy=True, folded=True,
                                   device="cpu"),
        JaxDetectionNet(num_classes=NUM_CLASSES, config=config, anchors=ANCHORS, deploy=True),
        deploy_transform(train_form.state_dict()), x, inference=True)


@pytest.fixture(scope="module", params=SERVE_NETS)
def int8_case(request):
    return _int8_case(request.param)


def test_int8_quantizes_what_jax_quantizes(int8_case):
    """The quantized convs are the JAX package's: the s2d stem and
    BasicHead's stem_layer become int8; ResNet's convs and BasicHead's 1x1
    conv stay float."""
    net, _ = int8_tests.assert_quantized_sets_match(int8_case)
    q = {p for p, m in quantize.quantizable_modules(net).items() if hasattr(m, "q_kernel")}
    if int8_case.name == "csp_s2d":
        assert "backbone.conv0" in q and net.backbone.conv0.q_kernel.shape[1] == 12
    else:
        assert {f"head.{i}.stem_layer" for i in range(3)} <= q
        assert not any(p.startswith("backbone") for p in q)
        assert all(hasattr(h, "conv") for h in net.head)


@pytest.mark.parametrize("check", ["scales", "layers", "forward", "near_f32"])
def test_int8_form_matches_jax(int8_case, check):
    {"scales": int8_tests.assert_scales_match, "layers": int8_tests.assert_layers_match,
     "forward": int8_tests.assert_forward_matches,
     "near_f32": int8_tests.assert_near_f32}[check](int8_case)
