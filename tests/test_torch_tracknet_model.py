"""TrackNet (base architecture) of the PyTorch port against the JAX package,
in f32 on the CPU: the weight bridge over the TrackNet tree, the train-form
forward (eval and train mode, with BatchNorm's running statistics), the
BN-folded deploy form, the inference heatmap with its antialiased resize,
the full-width channel plan (the 126-channel quirk), the uniform init,
per-conv remat, the deploy form's routing onto the conv3x3 kernel, the
kernel wrapper's index check and the raises of the architecture choice.

Weights come from a seeded port net (uniform init, non-trivial BatchNorm
state) bridged with `weights.state_dict_to_flax`, so the JAX net is only
applied, never initialised. Inputs are made with numpy from a seed. The
port is NCHW and the JAX package NHWC: the tests transpose.

Tolerances: logits atol 1e-4 / rtol 1e-4 (the same f32 arithmetic through
18 convs in another summation order); the deploy form, where BN folding
reassociates the arithmetic, atol 2e-4 / rtol 1e-4; BatchNorm running
statistics atol 1e-5. Heatmaps: the argmax is equal wherever the top two
logits are more than 1e-4 apart, and the resize to another size is within
1 LSB (torch's and jax.image's antialiased weights differ in the last
bits, which can move a value across .5 before the rounding).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from vision_conglomerate_tpu.models import TrackNet as JaxTrackNet
from vision_conglomerate_tpu.nn.blocks import bn_folding
from vision_conglomerate_tpu.nn.reparam import deploy_transform as jax_deploy_transform

from vision_conglomerate_torch.models import TrackNet
from vision_conglomerate_torch.models import tracknet as tn
from vision_conglomerate_torch.nn import blocks
from vision_conglomerate_torch.nn.blocks import randomize_batchnorm_
from vision_conglomerate_torch.nn.initializers import uniform_conv_init
from vision_conglomerate_torch.nn.reparam import deploy_transform
from vision_conglomerate_torch.ops import conv3x3
from vision_conglomerate_torch.weights import flax_to_state_dict, state_dict_to_flax

from tests.test_torch_weights import flat, to_numpy

# tests/test_tracknet.py's small config: width 0.25 at 64x32
CONFIG = {
    "weight_init": "uniform",
    "architecture": "base",
    "base_arch_config": {
        "encoder_config": {"width_multiple": 0.25},
        "decoder_config": {"width_multiple": 0.25},
    },
}
FULL = {"architecture": "base", "base_arch_config": {
    "encoder_config": {"width_multiple": 1.0}, "decoder_config": {"width_multiple": 1.0}}}
H, W = 32, 64
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_tracknet(config=CONFIG, seed: int = 0, **kwargs) -> TrackNet:
    """A port TrackNet with the uniform init and non-trivial BatchNorm state
    from a seeded torch.Generator, in eval mode."""
    g = torch.Generator().manual_seed(seed)
    net = TrackNet(config, **kwargs)
    return randomize_batchnorm_(uniform_conv_init(net, g), g).eval()


def frames(n: int = 2, seed: int = 1, hw=(H, W)) -> np.ndarray:
    return np.random.default_rng(seed).uniform(size=(n, *hw, 9)).astype(np.float32)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def case():
    net = port_tracknet(seed=3)
    return net, state_dict_to_flax(net.state_dict()), frames()


def test_weight_bridge_covers_the_jax_tree(case):
    """The bridged tree has exactly the JAX TrackNet's paths and shapes
    (jax.eval_shape, no init), dec_13 with a bias and no norm; the bridge
    round-trips the state_dict exactly."""
    net, variables, x = case
    shapes = jax.eval_shape(lambda: JaxTrackNet(config=CONFIG).init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 9)), train=False))
    want = {k: tuple(v.shape) for k, v in flat(shapes).items()}
    got = {k: tuple(v.shape) for k, v in flat(variables).items()}
    assert got == want
    assert ("params", "decoder", "dec_13", "conv", "bias") in got
    assert not any(k[:4] == ("batch_stats", "decoder", "dec_13", "norm") for k in got)
    back = flax_to_state_dict(variables)
    state = net.state_dict()
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        assert torch.equal(back[k], v.float() if v.is_floating_point() else v), k


def test_train_form_logits_match_jax(case):
    net, variables, x = case
    want = np.asarray(jax.jit(lambda v, xs: JaxTrackNet(config=CONFIG).apply(
        v, xs, train=False))(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = net(nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, H, W, 256)
    np.testing.assert_allclose(got, want, **TOL)


def test_train_mode_forward_and_batch_stats_match_jax(case):
    """Train mode normalises with the batch statistics and updates the
    running ones (flax's biased-variance rule)."""
    net, variables, x = case
    logits, mut = jax.jit(lambda v, xs: JaxTrackNet(config=CONFIG).apply(
        v, xs, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    train_net = port_tracknet(seed=3).train()
    with torch.no_grad():
        got = train_net(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(logits), **TOL)
    want_stats = flat(to_numpy({"batch_stats": mut["batch_stats"]}))
    got_stats = flat(state_dict_to_flax(train_net.state_dict()))
    for k, v in want_stats.items():
        np.testing.assert_allclose(got_stats[k], v, atol=1e-5, rtol=1e-5, err_msg="/".join(k))


def test_deploy_form_logits_match_jax(case):
    """BN folded (the JAX package's deploy_transform under bn_folding)
    against the port's deploy form, which runs every conv, dec_13 included,
    through conv_bias_act (the kernel's plain version on the CPU)."""
    net, variables, x = case
    params, stats = jax_deploy_transform(variables["params"], variables["batch_stats"],
                                         fuse_repvgg=False)
    with bn_folding(True):
        want = np.asarray(jax.jit(lambda v, xs: JaxTrackNet(config=CONFIG).apply(
            v, xs, train=False))({"params": params, "batch_stats": stats}, jnp.asarray(x)))
    dep = TrackNet(CONFIG, folded=True)
    dep.load_state_dict(deploy_transform(net.state_dict(), fuse_repvgg=False))
    with torch.no_grad():
        got = dep.eval()(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("og_size", [None, (H, W), (45, 80), (20, 40), (24, 96)],
                         ids=["none", "same", "up", "down", "mixed"])
def test_inference_heatmap_matches_jax(case, og_size):
    """argmax -> uint8 -> (antialiased linear resize, round, clip) where the
    size differs: the JAX model's inference output against the port's."""
    net, variables, x = case
    logits = np.asarray(JaxTrackNet(config=CONFIG).apply(variables, jnp.asarray(x), train=False))
    want = np.asarray(JaxTrackNet(config=CONFIG).apply(
        variables, jnp.asarray(x), train=False, inference=True, og_size=og_size))
    with torch.no_grad():
        got = net(nchw(x), inference=True, og_size=og_size).numpy()
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-4
    if og_size is None or tuple(og_size) == (H, W):
        np.testing.assert_array_equal(got[clear], want[clear])
        assert clear.mean() > 0.99
    else:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("dst", [(45, 80), (20, 40), (24, 96), (33, 63)])
def test_heatmap_resize_within_one_lsb_of_jax(dst):
    """The resize alone on random uint8 heatmaps with a saturated blob:
    equal but for values at a .5 boundary, which differ by 1."""
    rng = np.random.default_rng(7)
    hm = rng.integers(0, 256, size=(2, H, W)).astype(np.uint8)
    hm[:, 5:9, 7:12] = 255
    want = np.asarray(jnp.clip(jnp.round(jax.image.resize(
        jnp.asarray(hm, jnp.float32), (2, *dst), method="linear", antialias=True)), 0, 255
    ).astype(jnp.uint8))
    onehot = F.one_hot(torch.from_numpy(hm).long(), 256).permute(0, 3, 1, 2).float()
    got = tn.heatmap_from_logits(onehot, dst).numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_full_width_channel_plan_matches_jax():
    """Width 1.0 at 16x32: the tree (dec_7 384 -> 126, dec_8 126 -> 128,
    dec_2 768 -> 256, dec_13 64 -> 256) and the logits."""
    net = port_tracknet(FULL, seed=5)
    variables = state_dict_to_flax(net.state_dict())
    x = frames(1, seed=6, hw=(16, 32))
    shapes = jax.eval_shape(lambda: JaxTrackNet(config=FULL).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 32, 9)), train=False))
    assert {k: tuple(v.shape) for k, v in flat(shapes).items()} == {
        k: tuple(v.shape) for k, v in flat(variables).items()}
    kernel = lambda name, part: variables["params"][part][name]["conv"]["kernel"].shape  # noqa: E731
    assert kernel("dec_7", "decoder") == (3, 3, 384, 126)
    assert kernel("dec_8", "decoder") == (3, 3, 126, 128)
    assert kernel("dec_2", "decoder") == (3, 3, 768, 256)
    assert kernel("dec_13", "decoder") == (3, 3, 64, 256)
    assert kernel("enc_0", "encoder") == (3, 3, 9, 64)
    want = np.asarray(JaxTrackNet(config=FULL).apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = net(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)


def test_uniform_conv_init():
    net = TrackNet(CONFIG)
    uniform_conv_init(net, torch.Generator().manual_seed(0))
    convs = [m for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == 18
    w = torch.cat([m.weight.flatten() for m in convs])
    assert w.abs().max() <= 0.05 and abs(w.mean().item()) < 2e-3
    assert abs(w.std().item() - 0.1 / 12 ** 0.5) < 2e-3  # U(-0.05, 0.05)
    assert all(m.bias is None or not m.bias.any() for m in convs)
    again = uniform_conv_init(TrackNet(CONFIG), torch.Generator().manual_seed(0))
    assert torch.equal(convs[0].weight, again.encoder.enc_0.conv.weight)


def test_remat_matches_plain_step():
    """Per-conv remat recomputes in the backward pass: the same loss,
    gradients and running statistics (updated once) as without."""
    x = nchw(frames(2, seed=8))
    target = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (2, H, W)))
    results = []
    for remat in (False, True):
        net = port_tracknet({**CONFIG, "remat": remat}, seed=4).train()
        loss = F.cross_entropy(net(x), target)
        loss.backward()
        results.append((loss.item(), {n: p.grad.clone() for n, p in net.named_parameters()},
                        {n: b.clone() for n, b in net.named_buffers() if "running" in n}))
    (l0, g0, s0), (l1, g1, s1) = results
    assert l0 == pytest.approx(l1, rel=1e-6)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], atol=1e-6, rtol=1e-5)
    for n in s0:
        torch.testing.assert_close(s1[n], s0[n], atol=1e-7, rtol=1e-6)


def test_deploy_form_routes_every_conv_to_conv3x3(monkeypatch):
    """All 18 folded convs, dec_13 included, take the conv3x3 route with
    ReLU; the train form takes none. enc_0 runs over the frame stack with
    the deploy form's zero channels (9 -> 16, nn/channel_pad.py)."""
    calls = []

    def spy(x, w, b, activation):
        calls.append((tuple(x.shape), tuple(w.shape), activation))
        return conv3x3.conv3x3_bias_act_plain(x, w, b, activation)

    monkeypatch.setattr(blocks, "conv3x3_bias_act", spy)
    x = nchw(frames(1))
    with torch.no_grad():
        port_tracknet()(x)
        assert calls == []
        TrackNet(CONFIG, folded=True).eval()(x)
    assert len(calls) == 18 and {c[2] for c in calls} == {"relu"}
    assert calls[0][0] == (1, H, W, 16) and calls[-1][1][-1] == 256


def test_advanced_architecture_raises():
    """The advanced architecture is ported (tests/test_torch_tracknet_adv_model.py);
    as in the JAX package it raises KeyError for a name that
    TRACKNET_MODULES does not hold (ResNetBackBone is a detection backbone
    only) and for an unknown one; an unknown architecture raises."""
    def advanced(first):
        return {**CONFIG, "architecture": "advanced", "advanced_arch_config": {
            "encoder_modules": [first, "RepBiPAN"],
            "decoder_modules": ["DeconvRepBiPAN", "DeconvCSPNet"]}}

    with pytest.raises(KeyError):
        TrackNet(advanced("ResNetBackBone"))
    with pytest.raises(KeyError):
        TrackNet(advanced("VGG"))
    with pytest.raises(ValueError):
        TrackNet({**CONFIG, "architecture": "vgg"})


def test_conv_wrapper_checks_the_pixel_rows_not_the_elements():
    """dec_13 at batch 64 (3.7e9 output elements, 9.2e8 input elements)
    passes the wrapper's check: the kernel's offsets into x and y are
    64-bit. M = B*H*W = 2^31 pixel rows does not, nor anything past
    2^31 - 128, which the launcher's int grid arithmetic rounds up to a
    whole 128-row tile."""
    bf16 = torch.bfloat16
    w = torch.empty(3, 3, 64, 256, dtype=bf16, device="meta")
    b = torch.empty(256, device="meta")
    conv3x3.check_conv_args(torch.empty(64, 352, 640, 64, dtype=bf16, device="meta"), w, b,
                            "relu")
    assert 64 * 352 * 640 * 256 >= 2 ** 31
    with pytest.raises(ValueError, match="32-bit"):
        conv3x3.check_conv_args(torch.empty(2 ** 17, 128, 128, 64, dtype=bf16, device="meta"),
                                w, b, "relu")
    w8 = torch.empty(3, 3, 8, 8, dtype=bf16, device="meta")
    b8 = torch.empty(8, device="meta")
    conv3x3.check_conv_args(torch.empty(1, 1, 2 ** 31 - 128, 8, dtype=bf16, device="meta"),
                            w8, b8, "relu")
    with pytest.raises(ValueError, match="32-bit"):
        conv3x3.check_conv_args(torch.empty(1, 1, 2 ** 31 - 127, 8, dtype=bf16, device="meta"),
                                w8, b8, "relu")
