"""SegmentationNet of the PyTorch port against the JAX package, in f32 on
the CPU: ProtoSegModule, the head's mask branch, the mask-coefficient
decode, the whole net in train form and in the folded deploy form, and the
weight bridge with `mask_fmap_layer`.

Weights come from a seeded port net (non-trivial BatchNorm state) bridged
with `weights.state_dict_to_flax`, so the JAX net is only applied, never
initialised. Inputs are made with numpy from a seed. The port's protos are
NCHW (B, K, H/4, W/4) and the JAX package's NHWC: the tests transpose.

Tolerances: blocks, per-scale raw outputs and protos atol 1e-5 / rtol
1e-5 (the same f32 arithmetic in another summation order); decoded
predictions (pixels up to the input size) atol 1e-4 / rtol 1e-5; the
deploy form against the train form, where BN folding reassociates the
arithmetic, atol 2e-4 / rtol 1e-5.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vision_conglomerate_tpu.models import SegmentationNet as JaxSegmentationNet
from vision_conglomerate_tpu.models import detection as jax_detection
from vision_conglomerate_tpu.nn import blocks as jax_blocks
from vision_conglomerate_tpu.nn.blocks import bn_folding, fused_pointwise
from vision_conglomerate_tpu.nn.reparam import deploy_transform as jax_deploy_transform
from vision_conglomerate_tpu.tools.torch_port import convert_torch_state_dict

from vision_conglomerate_torch.models import SegmentationNet, detection
from vision_conglomerate_torch.nn import blocks
from vision_conglomerate_torch.nn.blocks import init_weights_, randomize_batchnorm_
from vision_conglomerate_torch.nn.reparam import deploy_transform
from vision_conglomerate_torch.weights import flax_to_state_dict, state_dict_to_flax

from tests.test_torch_weights import ANCHORS, CONFIG, NUM_CLASSES, flat, jax_init

# tests/test_seg_inference.py's small seg config: width 0.25, depth 0.2,
# 8 masks, c_h 32, at 64x64
NUM_MASKS = 8
SEG_CONFIG = {**CONFIG, "num_masks": NUM_MASKS, "protos_config": {"c_h": 32},
              "effidechead_config": {"width_multiple": 0.5, "masks_fmap_depth": 1}}
HW = 64
TOL = dict(atol=1e-5, rtol=1e-5)


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


def port_seg_net(seed: int = 0, config=SEG_CONFIG, **kwargs) -> SegmentationNet:
    """A port SegmentationNet with weights and BatchNorm state from a
    seeded torch.Generator, in eval mode."""
    g = torch.Generator().manual_seed(seed)
    net = SegmentationNet(NUM_CLASSES, config, anchors=ANCHORS, device="cpu", **kwargs)
    return randomize_batchnorm_(init_weights_(net, g), g).eval()


def test_proto_seg_module_parity():
    x = np.random.default_rng(0).normal(size=(2, 6, 5, 16)).astype(np.float32)
    jax_mod = jax_blocks.ProtoSegModule(out_channels=4, c_h=24)
    variables = jax_init(jax_mod, x)
    want = np.asarray(jax_mod.apply(variables, jnp.asarray(x), False))
    port = blocks.ProtoSegModule(16, 4, c_h=24)
    port.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = port.eval()(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 12, 10, 4)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("masks_depth", [1, 2])
def test_effidechead_mask_branch_parity(masks_depth):
    """Output [conf, cls, bbox, masks] per anchor."""
    x = np.random.default_rng(1).normal(size=(2, 6, 4, 32)).astype(np.float32)
    jax_head = jax_blocks.EffiDecHead(num_classes=3, num_anchors=3, num_masks=5,
                                      width_multiple=0.5, masks_fmap_depth=masks_depth)
    variables = jax_init(jax_head, x)
    want = np.asarray(jax_head.apply(variables, jnp.asarray(x), False))
    port = blocks.EffiDecHead(32, 3, num_anchors=3, num_masks=5, width_multiple=0.5,
                              masks_fmap_depth=masks_depth)
    port.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = port.eval()(_nchw(x)).numpy()
    assert got.shape == want.shape == (2, 6, 4, 3, 1 + 3 + 4 + 5)
    np.testing.assert_allclose(got, want, **TOL)


def test_decode_with_masks_matches_jax():
    """tanh'd coefficients in both decodes; the rescale carries them."""
    rng = np.random.default_rng(3)
    pred = (rng.normal(size=(2, 4, 6, 3, 5 + NUM_CLASSES + NUM_MASKS)) * 2).astype(np.float32)
    anchors = np.asarray(ANCHORS["md"], np.float32)
    for inference in (False, True):
        want = jax_detection.decode_scale(jnp.asarray(pred), jnp.asarray(anchors), (64, 128),
                                          NUM_CLASSES, num_masks=NUM_MASKS, inference=inference)
        got = detection.decode_scale(torch.from_numpy(pred), torch.from_numpy(anchors),
                                     (64, 128), NUM_CLASSES, NUM_MASKS, inference=inference)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        coefs = got.numpy()[..., 5 + NUM_CLASSES:]
        np.testing.assert_allclose(coefs, np.tanh(pred[..., 5 + NUM_CLASSES:]), **TOL)
    want = jax_detection.rescale_preds_to_size(jnp.asarray(pred), (128, 64), (1280, 720),
                                               NUM_CLASSES, num_masks=NUM_MASKS)
    got = detection.rescale_preds_to_size(torch.from_numpy(pred), (128, 64), (1280, 720),
                                          NUM_CLASSES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)


@pytest.fixture(scope="module")
def seg_case():
    net = port_seg_net(seed=11)
    x = np.random.default_rng(12).uniform(size=(2, HW, HW, 3)).astype(np.float32)
    return net, state_dict_to_flax(net.state_dict()), x


def test_weight_bridge_covers_the_jax_tree(seg_case):
    """The bridged tree has exactly the JAX SegmentationNet's paths and
    shapes (from jax.eval_shape, no init), `mask_fmap_layer_0`,
    `masks_layer` and `proto_seg_module/conv{1,2,3}` included; the JAX
    package's own converter gives the same tree, and it maps back to the
    state_dict unchanged."""
    net, variables, x = seg_case
    model = JaxSegmentationNet(num_classes=NUM_CLASSES, config=SEG_CONFIG, anchors=ANCHORS)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                               train=False))
    want = {k: tuple(v.shape) for k, v in flat(shapes).items()}
    got = {k: tuple(v.shape) for k, v in flat(variables).items()}
    assert got == want
    names = {"/".join(k) for k in got}
    for head in range(3):
        assert f"params/head_{head}/mask_fmap_layer_0/conv/kernel" in names
        assert f"params/head_{head}/masks_layer/kernel" in names
    for conv in ("conv1", "conv2", "conv3"):
        assert f"params/proto_seg_module/{conv}/conv/kernel" in names
        assert f"batch_stats/proto_seg_module/{conv}/norm/BatchNorm_0/var" in names
    sd = net.state_dict()
    jax_tree = convert_torch_state_dict(sd)
    for k, v in flat(variables).items():
        np.testing.assert_array_equal(np.asarray(flat(jax_tree)[k]), v, err_msg="/".join(k))
    back = flax_to_state_dict(variables)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v.float() if v.is_floating_point() else v), k


def test_train_form_parity(seg_case):
    """Per-scale raw outputs (coefficients tanh'd) and protos in eval mode."""
    net, variables, x = seg_case
    jax_net = JaxSegmentationNet(num_classes=NUM_CLASSES, config=SEG_CONFIG, anchors=ANCHORS)
    want_preds, want_protos = jax.jit(
        lambda v, a: jax_net.apply(v, a, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got_preds, got_protos = net(_nchw(x))
    assert got_protos.shape == (2, NUM_MASKS, HW // 4, HW // 4)
    np.testing.assert_allclose(got_protos.permute(0, 2, 3, 1).numpy(), np.asarray(want_protos),
                               **TOL)
    for g, w in zip(got_preds, want_preds):
        assert g.shape == w.shape and g.shape[-1] == 5 + NUM_CLASSES + NUM_MASKS
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("og_size", [None, (96, 160)], ids=["no_og", "rescaled"])
def test_deploy_form_parity(seg_case, og_size):
    """The folded SegmentationNet equals the JAX deploy form (bn_folding +
    fused_pointwise, the Pallas matmul in interpret mode) and the port's
    own train form in eval mode: decoded predictions and protos."""
    net, variables, x = seg_case
    dp, ds = jax_deploy_transform(variables["params"], variables["batch_stats"])
    jax_deploy = JaxSegmentationNet(num_classes=NUM_CLASSES, config=SEG_CONFIG,
                                    anchors=ANCHORS, deploy=True)
    with bn_folding(), fused_pointwise():
        want_preds, want_protos = jax_deploy.apply(
            {"params": dp, **({"batch_stats": ds} if ds else {})}, jnp.asarray(x),
            train=False, inference=True, og_size=og_size)
    deploy = SegmentationNet(NUM_CLASSES, SEG_CONFIG, deploy=True, folded=True, device="cpu")
    deploy.load_state_dict(deploy_transform(net.state_dict()))
    assert all(not isinstance(m, torch.nn.BatchNorm2d) for m in deploy.modules())
    with torch.no_grad():
        got_preds, got_protos = deploy.eval()(_nchw(x), inference=True, og_size=og_size)
        train_preds, train_protos = net(_nchw(x), inference=True, og_size=og_size)
    m = 3 * ((HW // 8) ** 2 + (HW // 16) ** 2 + (HW // 32) ** 2)
    assert got_preds.shape == (2, m, 5 + NUM_CLASSES + NUM_MASKS)
    np.testing.assert_allclose(got_preds.numpy(), np.asarray(want_preds), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(got_protos.permute(0, 2, 3, 1).numpy(), np.asarray(want_protos),
                               **TOL)
    np.testing.assert_allclose(got_preds.numpy(), train_preds.numpy(), atol=2e-4, rtol=1e-5)
    np.testing.assert_allclose(got_protos.numpy(), train_protos.numpy(), atol=2e-4, rtol=1e-5)
