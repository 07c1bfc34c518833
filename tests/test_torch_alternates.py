"""The detector's alternate components in the PyTorch port against the JAX
package, in f32 on the CPU: the general resize (every method of
`jax.image.resize` at x2, x0.5 and an odd size), ResNetBackBone
(BasicBlock and Bottleneck), BasicHead (plain, with masks, with
keypoints; its packed raw fields), EffiDecHead's raw fields, the
space-to-depth stem and `s2d_stem_kernel`, `early_min_channels`, the
registry's tables, the weight bridge of the new trees (the JAX model's
own `init` tree, key for key and shape for shape) and whole DetectionNets
built from them (train form, per-scale outputs and the inference decode).

Weights come from seeded port modules with non-trivial BatchNorm state,
bridged with `weights.state_dict_to_flax`; inputs are made with numpy from
a seed; the JAX modules are only applied (their `init` only shaped, with
`jax.eval_shape`). Tolerances: resizes atol 1e-5; modules and the
train-form nets' per-scale outputs atol 1e-4 / rtol 1e-4; the decoded
nets atol 2e-3 / rtol 1e-3 (boxes in pixels), as
tests/test_torch_detection.py holds the detector.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from vision_conglomerate_tpu import registry as jax_registry
from vision_conglomerate_tpu.models import DetectionNet as JaxDetectionNet
from vision_conglomerate_tpu.nn import backbones as jax_backbones
from vision_conglomerate_tpu.nn import blocks as jax_blocks
from vision_conglomerate_tpu.nn.reparam import s2d_stem_kernel as jax_s2d_stem_kernel
from vision_conglomerate_tpu.ops.resize import (
    bilinear_resize_chw_like_torch as jax_bilinear_chw, resize_hwc, resize_nhwc)

from vision_conglomerate_torch import registry
from vision_conglomerate_torch.models import DetectionNet
from vision_conglomerate_torch.nn import backbones, blocks
from vision_conglomerate_torch.nn.blocks import init_weights_, randomize_batchnorm_
from vision_conglomerate_torch.nn.reparam import s2d_stem_kernel
from vision_conglomerate_torch.ops.resize import (
    bilinear_resize_chw_like_torch, resize_chw, resize_nchw)
from vision_conglomerate_torch.weights import flax_to_state_dict, state_dict_to_flax

from tests.test_torch_weights import ANCHORS, flat

TOL = dict(atol=1e-4, rtol=1e-4)
NET_TOL = dict(atol=2e-3, rtol=1e-3)
NUM_CLASSES = 3
W = {"width_multiple": 0.25, "depth_multiple": 0.2}

# small versions of the two nets chip_smoke.py drives at full width, and
# the other alternates the JAX package's tests/test_registry_matrix.py trains
NETS = {
    "resnet_basichead": {
        "backbone": "ResNetBackBone", "neck": "RepBiPAN", "head": "BasicHead",
        "resnetbackbone_config": {"block": "BasicBlock", "block_layers": [1, 1, 1, 1]},
        "repbipan_config": {**W, "upsample_mode": "bilinear", "repvgg_branch_act": None},
        "basichead_config": {"width_multiple": 0.5}},
    "csp_s2d": {
        "backbone": "CSPBackBone", "neck": "RepBiPAN", "head": "EffiDecHead",
        "cspbackbone_config": {**W, "space_to_depth_stem": True, "early_min_channels": 64},
        "repbipan_config": {**W, "repvgg_branch_act": None},
        "effidechead_config": {"width_multiple": 0.5}},
    "resnet_bottleneck": {
        "backbone": "ResNetBackBone", "neck": "RepBiPAN", "head": "EffiDecHead",
        "resnetbackbone_config": {"block": "Bottleneck", "block_layers": [1, 1, 1, 1]},
        "repbipan_config": {**W, "upsample_mode": "bicubic"},
        "effidechead_config": {"width_multiple": 0.5}},
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded(module: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    g = torch.Generator().manual_seed(seed)
    return randomize_batchnorm_(init_weights_(module, g), g).eval()


def nhwc(shape, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def jax_apply(module, port: torch.nn.Module, x: np.ndarray, **kw):
    variables = state_dict_to_flax(port.state_dict())
    return jax.jit(lambda v, xs: module.apply(v, xs, **kw))(variables, jnp.asarray(x))


def init_tree(module, x_shape):
    """{flax path: shape} of the JAX module's own init, shaped only."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros(x_shape)))
    return {tuple(p.key for p in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_leaves_with_path(shapes)}


# ---------------------------------------------------------------- resize
METHODS = ["nearest", "linear", "bilinear", "cubic", "bicubic", "lanczos3", "lanczos5"]
RESIZES = {"x2": dict(scale=2.0), "x0.5": dict(scale=0.5), "size_7x17": dict(size=(7, 17))}


@pytest.mark.parametrize("how", sorted(RESIZES))
@pytest.mark.parametrize("method", METHODS)
def test_resize_matches_jax(method, how):
    """Every `jax.image.resize` method, by scale and to an odd size: the
    weights, the antialiasing on the way down, Keys' a = -0.5, the
    half-pixel nearest (the x2 / x0.5 nearest by scale keep the fast
    forms, as the JAX package's)."""
    x = nhwc((2, 12, 10, 3), seed=2)
    want = np.asarray(resize_nhwc(jnp.asarray(x), method=method, **RESIZES[how]))
    got = resize_nchw(nchw(x), method=method, **RESIZES[how]).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_resize_differs_from_torch_where_jax_does():
    """jax's linear x0.5 antialiases (not every second pixel, as torch's
    bilinear without antialias), its cubic is Keys a = -0.5 (torch's
    bicubic a = -0.75), its nearest by size half-pixel (torch's
    nearest-exact): the port follows jax in all three."""
    x = nchw(nhwc((1, 16, 16, 2), seed=3))
    lin = resize_nchw(x, 0.5, method="bilinear")
    assert (lin - F.interpolate(x, scale_factor=0.5, mode="bilinear")).abs().max() > 1e-2
    np.testing.assert_allclose(
        lin.numpy(), F.interpolate(x, scale_factor=0.5, mode="bilinear", antialias=True).numpy(),
        atol=1e-5)
    cub = resize_nchw(x, 2.0, method="bicubic")
    assert (cub - F.interpolate(x, scale_factor=2.0, mode="bicubic")).abs().max() > 1e-2
    near = resize_nchw(x, size=(8, 5), method="nearest")
    np.testing.assert_array_equal(near.numpy(),
                                  F.interpolate(x, size=(8, 5), mode="nearest-exact").numpy())


def test_resize_keeps_channels_last_and_the_chw_helpers_match_jax():
    x = nhwc((2, 9, 11, 4), seed=4)
    cl = nchw(x)
    assert resize_nchw(cl, 2.0, method="linear").is_contiguous(memory_format=torch.channels_last)
    img = x[0]
    want = np.asarray(resize_hwc(jnp.asarray(img), (5, 13), method="lanczos3"))
    got = resize_chw(torch.from_numpy(img).permute(2, 0, 1), (5, 13), "lanczos3")
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), want, atol=1e-5)
    chw = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    np.testing.assert_allclose(
        bilinear_resize_chw_like_torch(torch.from_numpy(chw), (4, 20)).numpy(),
        np.asarray(jax_bilinear_chw(jnp.asarray(chw), (4, 20))), atol=1e-5)
    with pytest.raises(ValueError):
        resize_nchw(cl, 2.0, method="area")


# --------------------------------------------------------------- modules
@pytest.mark.parametrize("block", ["BasicBlock", "Bottleneck"])
def test_resnet_backbone_matches_jax(block):
    """Both stems (no BatchNorm between them), the blocks with and without
    a downsample, the four maps; in eval mode and in train mode (batch
    statistics, and the running statistics after the step)."""
    layers = (2, 1, 1, 1)
    port = seeded(backbones.ResNetBackBone(3, block=block, block_layers=layers), seed=5)
    assert hasattr(port, "layer1_0") and hasattr(port, "layer1_1")
    assert hasattr(port.layer2_0, "downsample_conv")
    assert hasattr(port.layer1_0, "downsample_conv") == (block == "Bottleneck")
    assert not hasattr(port.layer1_1, "downsample_conv")
    jm = jax_backbones.ResNetBackBone(block=block, block_layers=layers)
    x = nhwc((2, 64, 64, 3), seed=6)
    variables = state_dict_to_flax(
        {k: v.clone() for k, v in port.state_dict().items()})  # train mode updates in place
    want = jax.jit(lambda v, xs: jm.apply(v, xs, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(nchw(x))
    assert [g.shape[1] for g in got] == list(backbones.resnet_out_channels(block))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), **TOL)
    want_t, mut = jax.jit(lambda v, xs: jm.apply(v, xs, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got_t = port.train()(nchw(x))
    for g, w in zip(got_t, want_t):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), **TOL)
    stats = state_dict_to_flax(port.state_dict())["batch_stats"]
    for k, v in flat(stats).items():
        np.testing.assert_allclose(v, np.asarray(flat(mut["batch_stats"])[k]), atol=1e-5,
                                   err_msg="/".join(k))


HEAD_CASES = {"plain": {}, "masks": {"num_masks": 4}, "keypoints": {"num_keypoints": 2}}


@pytest.mark.parametrize("case", sorted(HEAD_CASES))
def test_basic_head_matches_jax(case):
    """Stem width round(cin * w) (Python's round: 20 * 0.5 = 10, 22 *
    0.25 = 5.5 -> 6), the anchor-major packing (channel a * D + d) of
    conf | cls | bbox | masks | keypoints, and the packed raw field."""
    kw = HEAD_CASES[case]
    for cin, wm in ((20, 0.5), (22, 0.25)):
        port = seeded(blocks.BasicHead(cin, NUM_CLASSES, width_multiple=wm, **kw), seed=7)
        assert port.stem_layer.conv.out_channels == round(cin * wm)
        d = 5 + NUM_CLASSES + kw.get("num_masks", 0) + 5 * kw.get("num_keypoints", 0)
        assert port.conv.out_channels == 3 * d
        jm = jax_blocks.BasicHead(num_classes=NUM_CLASSES, width_multiple=wm, **kw)
        x = nhwc((2, 6, 5, cin), seed=8)
        want = jax_apply(jm, port, x, train=False)
        want_raw = jax_apply(jm, port, x, train=False, raw_fields=True)
        with torch.no_grad():
            got = port(nchw(x))
            got_raw = port(nchw(x), raw_fields=True)
        assert got.shape == (2, 6, 5, 3, d)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert list(got_raw) == ["packed"]
        np.testing.assert_allclose(got_raw["packed"].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want_raw["packed"]), **TOL)


@pytest.mark.parametrize("case", ["plain", "masks_and_keypoints"])
def test_effidechead_raw_fields_match_jax(case):
    """EffiDecHead's raw fields: the 1x1 layers' maps by field, NCHW here
    and NHWC there; the packed output is their per-anchor concat."""
    kw = {} if case == "plain" else {"num_masks": 4, "num_keypoints": 1}
    port = seeded(blocks.EffiDecHead(16, NUM_CLASSES, width_multiple=0.5, **kw), seed=9)
    jm = jax_blocks.EffiDecHead(num_classes=NUM_CLASSES, width_multiple=0.5, **kw)
    x = nhwc((2, 4, 6, 16), seed=10)
    want = jax_apply(jm, port, x, train=False, raw_fields=True)
    with torch.no_grad():
        got = port(nchw(x), raw_fields=True)
        packed = port(nchw(x))
    assert list(got) == ["conf", "cls", "bbox"] + (["masks", "keypoints"] if kw else [])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(), np.asarray(want[k]), **TOL)
    parts = [got[k].permute(0, 2, 3, 1).reshape(2, 4, 6, 3, -1) for k in got]
    np.testing.assert_allclose(packed.numpy(), torch.cat(parts, -1).numpy())


def test_space_to_depth_and_the_s2d_stem_kernel():
    """The channel order ((dy * 2 + dx) * C + c) is the JAX package's; the
    6x6/s2/p2 conv equals the 3x3/s1/p1 conv with the rearranged weight
    over space_to_depth (on the port's own conv, the padding band
    included); the rearrangement is the JAX package's, transposed."""
    x = nhwc((2, 16, 12, 3), seed=11)
    want = np.asarray(jax_backbones.space_to_depth_nhwc(jnp.asarray(x)))
    got = backbones.space_to_depth(nchw(x))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    w = torch.from_numpy(nhwc((8, 6, 6, 3), seed=12)).permute(0, 3, 1, 2).contiguous()
    w3 = s2d_stem_kernel(w)
    assert w3.shape == (8, 12, 3, 3)
    np.testing.assert_array_equal(
        w3.permute(2, 3, 1, 0).numpy(),
        np.asarray(jax_s2d_stem_kernel(jnp.asarray(w.permute(2, 3, 1, 0).numpy()))))
    stem = F.conv2d(nchw(x), w, stride=2, padding=2)
    s2d = F.conv2d(got, w3, stride=1, padding=1)
    np.testing.assert_allclose(s2d.numpy(), stem.numpy(), atol=1e-5)


CSP_CASES = {"s2d": {"space_to_depth_stem": True}, "early_64": {"early_min_channels": 64},
             "s2d_early_64": {"space_to_depth_stem": True, "early_min_channels": 64}}


@pytest.mark.parametrize("case", sorted(CSP_CASES))
def test_cspnet_variants_match_jax(case):
    """The s2d stem (`conv0` 3x3 over 4 * 3 channels) and
    early_min_channels (the first three widths raised to 64; the out
    channels through the registry); the four maps."""
    kw = CSP_CASES[case]
    port = seeded(backbones.CSPNet(3, **W, **kw), seed=13)
    early = kw.get("early_min_channels")
    assert port.conv0.conv.in_channels == (12 if kw.get("space_to_depth_stem") else 3)
    assert port.conv0.conv.kernel_size == ((3, 3) if kw.get("space_to_depth_stem") else (6, 6))
    assert port.conv0.conv.out_channels == (64 if early else 8)
    out = registry.BACKBONES["CSPNet"].out_channels(**W, **kw)
    assert out == jax_registry.BACKBONES["CSPNet"].out_channels(**W, **kw)
    assert out == jax_backbones.cspnet_out_channels(0.25, early)
    jm = jax_backbones.CSPNet(**W, **kw)
    x = nhwc((2, 64, 64, 3), seed=14)
    want = jax_apply(jm, port, x, train=False)
    with torch.no_grad():
        got = port(nchw(x))
    assert tuple(g.shape[1] for g in got) == out
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), **TOL)


# ------------------------------------------------- registry, bridge, nets
def test_registry_tables_equal_the_jax_packages():
    """Every name of the JAX registry's tables resolves in the port and
    builds; the out-channel functions agree; an unknown name raises
    KeyError in both."""
    for table in ("BACKBONES", "NECKS", "HEADS", "TRACKNET_MODULES"):
        assert sorted(getattr(registry, table)) == sorted(getattr(jax_registry, table)), table
    for name in ("ResNetBackBone", "BasicHead"):
        assert registry.resolve(registry.BACKBONES if name == "ResNetBackBone"
                                else registry.HEADS, name).cls.__name__ == name
    for block in ("BasicBlock", "Bottleneck"):
        assert (registry.BACKBONES["ResNetBackBone"].out_channels(block=block)
                == jax_registry.BACKBONES["ResNetBackBone"].out_channels(block=block))
    assert not registry.takes(backbones.ResNetBackBone, "remat")
    for table in (registry.BACKBONES, registry.HEADS, registry.TRACKNET_MODULES):
        with pytest.raises(KeyError):
            registry.resolve(table, "NoSuchModule")
    with pytest.raises(KeyError):
        registry.resolve(registry.TRACKNET_MODULES, "ResNetBackBone")


@pytest.mark.parametrize("name", sorted(NETS) + ["basichead_masks_keypoints"])
def test_bridge_gives_the_jax_init_tree(name):
    """The bridge of a port net gives exactly the flax tree that the JAX
    model's own init makes (keys and shapes; ResNet's `layer{L}_{B}`,
    `bnN/BatchNorm_0`, `downsample_conv`; BasicHead's `stem_layer`,
    `conv`), and comes back to the same state_dict."""
    if name == "basichead_masks_keypoints":
        config, kw = NETS["resnet_basichead"], dict(num_keypoints=2)
    else:
        config, kw = NETS[name], {}
    port = seeded(DetectionNet(NUM_CLASSES, config, anchors=ANCHORS, **kw), seed=15)
    variables = state_dict_to_flax(port.state_dict())
    got = {k: tuple(np.shape(v)) for k, v in flat(variables).items()}
    jm = JaxDetectionNet(num_classes=NUM_CLASSES, config=config, anchors=ANCHORS, **kw)
    assert got == init_tree(jm, (1, 64, 64, 3))
    back = flax_to_state_dict(variables)
    for k, v in port.state_dict().items():
        assert torch.equal(back[k], v.float()), k


@pytest.mark.parametrize("inference", [False, True], ids=["train_decode", "inference"])
@pytest.mark.parametrize("name", sorted(NETS))
def test_detection_net_matches_jax(name, inference):
    """Whole DetectionNets of the alternates in the train form: per-scale
    train decodes, or the flattened inference decode rescaled to an og
    size."""
    config = NETS[name]
    port = seeded(DetectionNet(NUM_CLASSES, config, anchors=ANCHORS), seed=16)
    jm = JaxDetectionNet(num_classes=NUM_CLASSES, config=config, anchors=ANCHORS)
    x = nhwc((2, 64, 64, 3), seed=17)
    kw = dict(inference=True, og_size=(80, 96)) if inference else {}
    want = jax_apply(jm, port, x, train=False, **kw)
    with torch.no_grad():
        got = port(nchw(x), **kw)
    got, want = ([got], [want]) if inference else (list(got), list(want))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **(NET_TOL if inference else TOL))


def test_remat_skips_resnet_as_in_jax():
    """model_config.remat reaches only modules that take it: the ResNet
    backbone builds without it, the neck gets it."""
    config = {**NETS["resnet_basichead"], "remat": True}
    net = DetectionNet(NUM_CLASSES, config, anchors=ANCHORS)
    assert net.neck.remat and not hasattr(net.backbone, "remat")
