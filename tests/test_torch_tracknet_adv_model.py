"""TrackNet's advanced architecture (CSPNet + RepBiPAN encoder,
DeconvRepBiPAN + DeconvCSPNet decoder) of the PyTorch port against the JAX
package, in f32 on the CPU, at tests/test_tracknet.py's ADV_CONFIG (widths
0.25, depths 0.2, 32x64, 9 channels): the weight bridge over the tree, the
train-form logits (eval and train mode, with BatchNorm's running
statistics), the fused deploy form (canonical RepVGG blocks fused, every
BatchNorm folded), the BN-fold-only form of a config with branch-activated
RepVGG blocks, the inference heatmap, and the CSPNet + BiPAN / DeconvBiPAN +
DeconvCSPNet combo of tests/test_registry_matrix.py. Then the deploy form's
routing at the shipped config_advanced.yaml's widths (both kernels, every
Cin a multiple of 8), remat, and the raises.

Weights come from a seeded port net (xavier init, non-trivial BatchNorm
state) bridged with `weights.state_dict_to_flax`, so the JAX net is only
applied (jitted, one compile per form), never initialised. Inputs are made
with numpy from a seed. The port is NCHW and the JAX package NHWC: the
tests transpose.

Tolerances: logits atol 1e-4 / rtol 1e-4 (the same f32 arithmetic in
another summation order), and within 1e-4 of the logits' largest
magnitude, since a random net's eval-mode logits are small; the deploy
forms, where folding and fusion reassociate the arithmetic, atol 2e-4 /
rtol 1e-4; BatchNorm running statistics atol 1e-5 (train-mode logits:
see that test). Heatmaps: equal where
the top two logits are more than 1e-4 apart, within 1 LSB after a resize
to another size (as tests/test_torch_tracknet_model.py holds the base).
"""
import copy

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
from vision_conglomerate_torch.nn import blocks
from vision_conglomerate_torch.nn.blocks import randomize_batchnorm_
from vision_conglomerate_torch.nn.initializers import xavier_conv_init
from vision_conglomerate_torch.nn.reparam import deploy_transform
from vision_conglomerate_torch.ops import conv3x3, fused_matmul
from vision_conglomerate_torch.utils import load_yaml
from vision_conglomerate_torch.weights import flax_to_state_dict, state_dict_to_flax

from tests.test_torch_weights import flat, to_numpy
from tests.test_tracknet import ADV_CONFIG

H, W = 32, 64
TOL = dict(atol=1e-4, rtol=1e-4)
DEPLOY_TOL = dict(atol=2e-4, rtol=1e-4)
_W = {"width_multiple": 0.25, "depth_multiple": 0.2}
# tests/test_registry_matrix.py's encoder/decoder combo
COMBO_CONFIG = {
    "weight_init": "xavier",
    "architecture": "advanced",
    "advanced_arch_config": {
        "encoder_modules": ["CSPNet", "BiPAN"],
        "decoder_modules": ["DeconvBiPAN", "DeconvCSPNet"],
        "encoder_config": {"cspnet_config": dict(_W), "bipan_config": dict(_W)},
        "decoder_config": {"deconvbipan_config": dict(_W), "deconvcspnet_config": dict(_W)},
    },
}
CONFIGS = {"advanced": ADV_CONFIG, "combo": COMBO_CONFIG}


def canonical(config, branch_act=None):
    """The config with every *repbipan* block's repvgg_branch_act set."""
    out = copy.deepcopy(config)
    for section in out["advanced_arch_config"].values():
        if isinstance(section, dict):
            for key, cfg in section.items():
                if "repbipan" in key:
                    cfg["repvgg_branch_act"] = branch_act
    return out


CANONICAL = canonical(ADV_CONFIG)  # the shipped config's block form
SILU = canonical(ADV_CONFIG, "silu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_tracknet(config, seed: int = 0, **kwargs) -> TrackNet:
    """A port TrackNet with the xavier init and non-trivial BatchNorm state
    from a seeded torch.Generator, in eval mode."""
    g = torch.Generator().manual_seed(seed)
    net = TrackNet(config, **kwargs)
    return randomize_batchnorm_(xavier_conv_init(net, g), g).eval()


def frames(n: int = 2, seed: int = 1, hw=(H, W)) -> np.ndarray:
    return np.random.default_rng(seed).uniform(size=(n, *hw, 9)).astype(np.float32)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def port_logits(net, x: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return net(nchw(x)).permute(0, 2, 3, 1).numpy()


def assert_logits_close(got, want, tol=TOL):
    assert got.shape == want.shape == (2, H, W, 256)
    np.testing.assert_allclose(got, want, **tol)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


OG_SIZES = {"none": None, "same": (H, W), "up": (45, 80), "down": (20, 40)}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    """(name, config, port net, bridged variables, frames, JAX eval logits,
    JAX inference heatmaps by og size), one JAX compile per config."""
    config = CONFIGS[request.param]
    net = port_tracknet(config, seed=3)
    variables = state_dict_to_flax(net.state_dict())
    x = frames()
    model = JaxTrackNet(config=config)

    @jax.jit
    def apply(v, xs):
        hms = {k: model.apply(v, xs, train=False, inference=True, og_size=og)
               for k, og in OG_SIZES.items()}
        return model.apply(v, xs, train=False), hms

    logits, hms = apply(variables, jnp.asarray(x))
    return request.param, config, net, variables, x, np.asarray(logits), \
        {k: np.asarray(v) for k, v in hms.items()}


def test_weight_bridge_covers_the_jax_tree(case):
    """The bridged tree has exactly the JAX TrackNet's paths and shapes
    (jax.eval_shape, no init): `encoder/enc_module_p1`, ..., `deconv4`'s
    conv with a bias and no norm; the bridge round-trips the state_dict."""
    name, config, net, variables, _, _, _ = case
    shapes = jax.eval_shape(lambda: JaxTrackNet(config=config).init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 9)), train=False))
    want = {k: tuple(v.shape) for k, v in flat(shapes).items()}
    got = {k: tuple(v.shape) for k, v in flat(variables).items()}
    assert got == want
    p = variables["params"]
    assert set(p["encoder"]) == {"enc_module_p1", "enc_module_p2"}
    assert set(p["decoder"]) == {"dec_module_p1", "dec_module_p2"}
    assert set(p["decoder"]["dec_module_p2"]["deconv4"]["conv"]) == {"conv"}
    assert "bias" in p["decoder"]["dec_module_p2"]["deconv4"]["conv"]["conv"]
    if name == "advanced":
        assert "sppf0" not in p["encoder"]["enc_module_p2"]
        assert "cspsppf" in p["decoder"]["dec_module_p1"]
    else:
        assert set(p["encoder"]["enc_module_p2"]["sppf0"]) == {"conv1", "conv2"}
    back = flax_to_state_dict(variables)
    state = net.state_dict()
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        assert torch.equal(back[k], v.float() if v.is_floating_point() else v), k


def test_train_form_logits_match_jax(case):
    _, _, net, _, x, want, _ = case
    assert_logits_close(port_logits(net, x), want)


def test_train_mode_forward_and_batch_stats_match_jax(case):
    """Train mode normalises with the batch statistics and updates the
    running ones (flax's biased-variance rule), on a batch of 8. Train
    mode at this size is ill-conditioned: the stride-32 maps are 1x2, so
    each deep BatchNorm normalises over 2 values an image. On a batch of 2
    a 1-ulp change of the input moves the port's own logits by up to 1e-2
    and its statistics past 1e-5; on 8 the statistics hold at 1e-5 and the
    logits at a relative L2 distance of 1e-3 (read: 1.8-2.6e-4; the port's
    own 1-ulp distance is within 3x of it)."""
    _, config, _, variables, _, _, _ = case
    x = frames(8, seed=2)
    logits, mut = jax.jit(lambda v, xs: JaxTrackNet(config=config).apply(
        v, xs, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    train_net = port_tracknet(config, seed=3).train()
    with torch.no_grad():
        got = train_net(nchw(x)).permute(0, 2, 3, 1).numpy()
    want = np.asarray(logits)
    assert got.shape == want.shape == (8, H, W, 256)
    assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)
    want_stats = flat(to_numpy({"batch_stats": mut["batch_stats"]}))
    got_stats = flat(state_dict_to_flax(train_net.state_dict()))
    assert set(want_stats) == {k for k in got_stats if k[0] == "batch_stats"}
    for k, v in want_stats.items():
        np.testing.assert_allclose(got_stats[k], v, atol=1e-5, rtol=1e-5, err_msg="/".join(k))


def jax_deploy_logits(config, variables, x, fuse_repvgg):
    params, stats = jax_deploy_transform(variables["params"], variables["batch_stats"],
                                         fuse_repvgg=fuse_repvgg)
    model = JaxTrackNet(config=config, deploy=fuse_repvgg)

    def apply(v, xs):
        with bn_folding(True):
            return model.apply(v, xs, train=False)

    deployed = {"params": params}
    if stats:
        deployed["batch_stats"] = stats
    return np.asarray(jax.jit(apply)(deployed, jnp.asarray(x)))


def port_deploy_net(config, net, fuse_repvgg):
    dep = TrackNet(config, folded=True, deploy=fuse_repvgg)
    dep.load_state_dict(deploy_transform(net.state_dict(), fuse_repvgg=fuse_repvgg))
    return dep.eval()


def test_fused_deploy_form_matches_jax():
    """Canonical RepVGG blocks (the shipped form) fused into one 3x3 conv
    each and every BatchNorm folded: the JAX package's deploy_transform +
    TrackNet(deploy=True) under bn_folding against the port's deploy form,
    which runs every stride-1 conv through conv_bias_act (the kernels'
    plain versions on the CPU)."""
    net = port_tracknet(CANONICAL, seed=7)
    x = frames(seed=8)
    want = jax_deploy_logits(CANONICAL, state_dict_to_flax(net.state_dict()), x, True)
    dep = port_deploy_net(CANONICAL, net, True)
    assert any(isinstance(m, blocks.RepVGGBlock) and m.deploy for m in dep.modules())
    assert not any(isinstance(m, blocks.BatchNorm2d) for m in dep.modules())
    got = port_logits(dep, x)
    assert_logits_close(got, want, DEPLOY_TOL)
    assert_logits_close(got, port_logits(net, x), DEPLOY_TOL)


@pytest.mark.parametrize("name", ["silu_branches", "combo"])
def test_folded_only_form_matches_jax(name):
    """BatchNorm folding alone: a config whose RepVGG blocks keep their
    branch SiLUs (they cannot fuse; the identity BatchNorm stays), and the
    BiPAN combo (no RepVGG blocks)."""
    config = SILU if name == "silu_branches" else COMBO_CONFIG
    net = port_tracknet(config, seed=9)
    x = frames(seed=10)
    want = jax_deploy_logits(config, state_dict_to_flax(net.state_dict()), x, False)
    dep = port_deploy_net(config, net, False)
    got = port_logits(dep, x)
    assert_logits_close(got, want, DEPLOY_TOL)
    assert_logits_close(got, port_logits(net, x), DEPLOY_TOL)


@pytest.mark.parametrize("og", sorted(OG_SIZES))
def test_inference_heatmap_matches_jax(case, og):
    """argmax -> uint8 -> (antialiased linear resize, round, clip) where the
    size differs: the JAX model's inference output against the port's."""
    _, _, net, _, x, logits, hms = case
    want = hms[og]
    with torch.no_grad():
        got = net(nchw(x), inference=True, og_size=OG_SIZES[og]).numpy()
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-4
    if og in ("none", "same"):
        np.testing.assert_array_equal(got[clear], want[clear])
        assert clear.mean() > 0.95
    else:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_deploy_form_routes_stride1_convs_to_both_kernels(monkeypatch):
    """At the shipped config_advanced.yaml's widths (0.5, depth 0.3) on a
    32x64 input: the fused deploy form sends every folded 1x1 conv to the
    matmul kernel and every stride-1 3x3 conv (fused RepBlocks, C3 and
    CSPSPPF 3x3s, ConvBNormUpsample convs, deconv4 with SiLU and 256
    outputs) to conv3x3, each with a Cin that is a multiple of 8, so none
    takes the element-load path; the train form launches neither."""
    calls = []

    def spy(route, plain):
        def fn(x, w, b, activation):
            calls.append((route, x.shape[-1], w.shape[-1], activation))
            return plain(x, w, b, activation)
        return fn

    monkeypatch.setattr(blocks, "pointwise_conv_act",
                        spy("matmul", fused_matmul.pointwise_conv_act))
    monkeypatch.setattr(blocks, "conv3x3_bias_act", spy("conv3x3", conv3x3.conv3x3_bias_act_plain))
    config = load_yaml("configs/tracknet/config_advanced.yaml")["model_config"]
    x = nchw(frames(1))
    with torch.no_grad():
        TrackNet(config).eval()(x)
        assert calls == []
        TrackNet(config, folded=True, deploy=True).eval()(x)
    routes = [c[0] for c in calls]
    assert routes.count("matmul") > 0 and routes.count("conv3x3") > 0
    assert all(cin % 8 == 0 for _, cin, _, _ in calls)
    assert {c[3] for c in calls} == {"silu"}
    assert calls[-1] == ("conv3x3", 32, 256, "silu")  # deconv4 at half resolution
    n_convs = sum(isinstance(m, torch.nn.Conv2d) for m in TrackNet(
        config, folded=True, deploy=True).modules())
    stem_and_downsamples = 5 + 2  # CSPNet's conv0-conv4, RepBiPAN's conv2 and conv3
    assert len(calls) == n_convs - stem_and_downsamples


def test_remat_matches_plain_step():
    """Stage remat recomputes in the backward pass: the same loss,
    gradients and running statistics (updated once) as without."""
    x = nchw(frames(2, seed=11))
    target = torch.from_numpy(np.random.default_rng(12).integers(0, 256, (2, H, W)))
    results = []
    for remat in (False, True):
        net = port_tracknet({**ADV_CONFIG, "remat": remat}, seed=4).train()
        assert all(getattr(m, "remat", remat) == remat for m in net.modules()
                   if hasattr(m, "remat"))
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


def test_advanced_model_raises():
    with pytest.raises(ValueError, match="divisible by 32"):
        TrackNet(ADV_CONFIG)(torch.zeros(1, 9, 40, 64))
    three = copy.deepcopy(ADV_CONFIG)
    three["advanced_arch_config"]["encoder_modules"] += ["RepBiPAN"]
    with pytest.raises(ValueError, match="two modules"):
        TrackNet(three)
    with pytest.raises(ValueError, match="branch_activation=None"):
        TrackNet(SILU, folded=True, deploy=True)
