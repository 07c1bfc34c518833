"""Forward parity of the PyTorch port's detection blocks and DetectionNet
with the JAX package, in f32 on the CPU, on weights and inputs made with
numpy from a seed and bridged with `weights.flax_to_state_dict`.

Tolerances: blocks 1e-4 (same f32 arithmetic, other summation order);
whole model atol 2e-3 / rtol 1e-3, the tolerance of
tests/test_fused_matmul.py's deploy equivalence (decoded boxes are in
pixels, and BN folding reassociates the f32 arithmetic).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vision_conglomerate_tpu.models import DetectionNet as JaxDetectionNet
from vision_conglomerate_tpu.models import detection as jax_detection
from vision_conglomerate_tpu.nn import blocks as jax_blocks
from vision_conglomerate_tpu.nn.blocks import bn_folding, fused_pointwise
from vision_conglomerate_tpu.nn.reparam import deploy_transform as jax_deploy_transform

from vision_conglomerate_torch.models import detection
from vision_conglomerate_torch.models.detection import DetectionNet
from vision_conglomerate_torch.nn import blocks
from vision_conglomerate_torch.nn.reparam import deploy_transform
from vision_conglomerate_torch.weights import flax_to_state_dict

from tests.test_torch_weights import (
    ANCHORS, CONFIG, NUM_CLASSES, jax_detection_variables, jax_init, to_numpy)


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


# (name, JAX module, port module factory, input NHWC shape)
BLOCKS = [
    ("convbnorm_3x3", jax_blocks.ConvBNorm(16, kernel_size=3),
     lambda: blocks.ConvBNorm(8, 16, 3), (2, 12, 10, 8)),
    ("convbnorm_1x1", jax_blocks.ConvBNorm(24, kernel_size=1),
     lambda: blocks.ConvBNorm(8, 24, 1), (2, 8, 8, 8)),
    ("convbnorm_s2", jax_blocks.ConvBNorm(16, kernel_size=3, stride=2),
     lambda: blocks.ConvBNorm(8, 16, 3, 2), (1, 16, 16, 8)),
    ("repvgg_silu_identity", jax_blocks.RepVGGBlock(16, 16, branch_activation="silu"),
     lambda: blocks.RepVGGBlock(16, 16, branch_activation="silu"), (2, 8, 8, 16)),
    ("repvgg_canonical_identity", jax_blocks.RepVGGBlock(16, 16, branch_activation=None),
     lambda: blocks.RepVGGBlock(16, 16, branch_activation=None), (2, 8, 8, 16)),
    ("repvgg_canonical", jax_blocks.RepVGGBlock(8, 16, branch_activation=None),
     lambda: blocks.RepVGGBlock(8, 16, branch_activation=None), (2, 8, 8, 8)),
    ("repblock_3", jax_blocks.RepBlock(16, n=3, branch_activation=None),
     lambda: blocks.RepBlock(8, 16, n=3, branch_activation=None), (1, 8, 8, 8)),
    ("c3", jax_blocks.C3Module(16, num_bottlenecks=2),
     lambda: blocks.C3Module(16, 16, num_bottlenecks=2), (2, 8, 8, 16)),
    ("cspsppf", jax_blocks.CSPSPPFModule(32),
     lambda: blocks.CSPSPPFModule(32, 32), (1, 8, 8, 32)),
]


@pytest.mark.parametrize("name,jax_mod,make_port,shape", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_block_parity(name, jax_mod, make_port, shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    variables = jax_init(jax_mod, x)
    want = np.asarray(jax_mod.apply(variables, jnp.asarray(x), False))
    port = make_port()
    port.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = port.eval()(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_effidechead_parity():
    x = np.random.default_rng(1).normal(size=(2, 6, 4, 32)).astype(np.float32)
    jax_head = jax_blocks.EffiDecHead(num_classes=3, num_anchors=3, width_multiple=0.5)
    variables = jax_init(jax_head, x)
    want = np.asarray(jax_head.apply(variables, jnp.asarray(x), False))
    port = blocks.EffiDecHead(32, 3, num_anchors=3, width_multiple=0.5)
    port.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = port.eval()(_nchw(x)).numpy()
    assert got.shape == want.shape == (2, 6, 4, 3, 8)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_bic_and_resize_parity():
    """Nearest x2 repeats, nearest x0.5 takes even indices (as in JAX)."""
    rng = np.random.default_rng(2)
    c1 = rng.normal(size=(1, 4, 6, 8)).astype(np.float32)
    c0 = rng.normal(size=(1, 8, 12, 4)).astype(np.float32)
    p2 = rng.normal(size=(1, 2, 3, 16)).astype(np.float32)
    jax_bic = jax_blocks.BiCwithNoConvModule(out_channels=8)
    variables = jax_init(jax_bic, c1, c0=jnp.asarray(c0), p2=jnp.asarray(p2))
    want = np.asarray(jax_bic.apply(variables, jnp.asarray(c1), jnp.asarray(c0),
                                    jnp.asarray(p2), False))
    port = blocks.BiCwithNoConvModule(8, 4, 16, 8)
    port.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = port.eval()(_nchw(c1), _nchw(c0), _nchw(p2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_decode_matches_jax():
    """Non-square grid and input, so the [h/ny, w/nx] stride quirk shows."""
    rng = np.random.default_rng(3)
    pred = rng.normal(size=(2, 4, 6, 3, 5 + NUM_CLASSES)).astype(np.float32)
    anchors = np.asarray(ANCHORS["md"], np.float32)
    for inference in (False, True):
        want = jax_detection.decode_scale(jnp.asarray(pred), jnp.asarray(anchors), (64, 128),
                                          NUM_CLASSES, inference=inference)
        got = detection.decode_scale(torch.from_numpy(pred), torch.from_numpy(anchors),
                                     (64, 128), NUM_CLASSES, inference=inference)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    want = jax_detection.rescale_preds_to_size(jnp.asarray(pred), (128, 64), (1280, 720),
                                               NUM_CLASSES)
    got = detection.rescale_preds_to_size(torch.from_numpy(pred), (128, 64), (1280, 720),
                                          NUM_CLASSES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(detection.make_2dgrid(6, 4).numpy(),
                                  np.asarray(jax_detection.make_2dgrid(6, 4)))


@pytest.fixture(scope="module")
def model_case():
    variables = jax_detection_variables(seed=11)
    x = np.random.default_rng(12).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    return variables, x


def test_train_form_parity(model_case):
    """Per-scale (N, ny, nx, na, D) outputs of the train form in eval mode."""
    variables, x = model_case
    jax_net = JaxDetectionNet(num_classes=NUM_CLASSES, config=CONFIG, anchors=ANCHORS)
    want = jax.jit(lambda v, xs: jax_net.apply(v, xs, train=False))(variables, jnp.asarray(x))
    net = DetectionNet(NUM_CLASSES, CONFIG, device="cpu")
    net.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = net.eval()(_nchw(x))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("og_size", [None, (96, 160), (64, 160)],
                         ids=["no_og", "both_differ", "one_differs"])
def test_deploy_forward_matches_jax_deploy(model_case, og_size):
    """The port's deploy form equals the JAX deploy form under bn_folding()
    + fused_pointwise() (the Pallas matmul in interpret mode), and equals
    the port's own train-form eval forward."""
    variables, x = model_case
    dp, ds = jax_deploy_transform(variables["params"], variables["batch_stats"])
    jax_deploy = JaxDetectionNet(num_classes=NUM_CLASSES, config=CONFIG, anchors=ANCHORS,
                                 deploy=True)
    with bn_folding(), fused_pointwise():
        want = np.asarray(jax.jit(lambda v, xs: jax_deploy.apply(
            v, xs, train=False, inference=True, og_size=og_size))(
            {"params": dp, **({"batch_stats": ds} if ds else {})}, jnp.asarray(x)))

    state = flax_to_state_dict(variables)
    deploy = DetectionNet(NUM_CLASSES, CONFIG, deploy=True, folded=True, device="cpu")
    deploy.load_state_dict(deploy_transform(state))
    train_form = DetectionNet(NUM_CLASSES, CONFIG, device="cpu")
    train_form.load_state_dict(state)
    with torch.no_grad():
        got = deploy.eval()(_nchw(x), inference=True, og_size=og_size).numpy()
        got_train = train_form.eval()(_nchw(x), inference=True, og_size=og_size).numpy()
    assert got.shape == want.shape == (2, 3 * (8 * 8 + 4 * 4 + 2 * 2), 5 + NUM_CLASSES)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(got_train, got, atol=2e-3, rtol=1e-3)
