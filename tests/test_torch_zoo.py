"""The rest of the module zoo that TrackNet's advanced architecture brought
into the PyTorch port, against the JAX package, in f32 on the CPU:
SPPFModule (its [y, p2, p2, p3] concat), ConvBNormUpsample,
ConvTransposeBNorm with its weight bridge (the spatial flip) and its
BatchNorm fold, the out-channels functions of BiPAN, DeconvBiPAN,
RepBiPAN, DeconvRepBiPAN and DeconvCSPNet, DeconvRepBiPAN with BiC convs,
a DetectionNet with a BiPAN neck, the registry's tables and the raises of
the names still to port.

Weights come from seeded port modules (non-trivial BatchNorm state)
bridged with `weights.state_dict_to_flax`; inputs are made with numpy from
a seed; the JAX modules are only applied. Tolerances: modules atol 1e-5 /
rtol 1e-5 (the transpose conv's, train form and folded, as the bridge
must give the same output); the DeconvRepBiPAN and DetectionNet outputs
atol 1e-4 / rtol 1e-4, as tests/test_torch_detection.py holds the
detector.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vision_conglomerate_tpu import registry as jax_registry
from vision_conglomerate_tpu.models import DetectionNet as JaxDetectionNet
from vision_conglomerate_tpu.nn import backbones as jax_backbones
from vision_conglomerate_tpu.nn import blocks as jax_blocks
from vision_conglomerate_tpu.nn import necks as jax_necks
from vision_conglomerate_tpu.nn.reparam import fold_conv_bn_params as jax_fold

from vision_conglomerate_torch import registry
from vision_conglomerate_torch.models import DetectionNet
from vision_conglomerate_torch.nn import backbones, blocks, necks
from vision_conglomerate_torch.nn.blocks import init_weights_, randomize_batchnorm_
from vision_conglomerate_torch.nn.initializers import INIT_SCHEMES
from vision_conglomerate_torch.nn.reparam import fold_conv_bn_params
from vision_conglomerate_torch.weights import flax_to_state_dict, state_dict_to_flax

from tests.test_torch_weights import flat

TOL = dict(atol=1e-5, rtol=1e-5)


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


def run_port(module, x: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return module(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()


def run_jax(module, variables, x: np.ndarray, folded: bool = False) -> np.ndarray:
    def apply(v, xs):
        with jax_blocks.bn_folding(folded):
            return module.apply(v, xs, train=False)
    return np.asarray(apply(variables, jnp.asarray(x)))


def test_sppf_matches_jax_with_its_concat_quirk():
    """SPPF's conv2 reads [y, p2, p2, p3]: its output equals the JAX
    package's, and swapping the weights of its 2nd and 3rd input blocks
    (p1's slot, which holds p2, and p2's) leaves it as it is."""
    port = seeded(blocks.SPPFModule(16, 24), seed=2)
    x = nhwc((2, 9, 11, 16))
    variables = state_dict_to_flax(port.state_dict())
    want = run_jax(jax_blocks.SPPFModule(24), variables, x)
    got = run_port(port, x)
    np.testing.assert_allclose(got, want, **TOL)
    c_h = 12
    with torch.no_grad():
        w = port.conv2.conv.weight
        w[:, c_h:2 * c_h], w[:, 2 * c_h:3 * c_h] = w[:, 2 * c_h:3 * c_h].clone(), \
            w[:, c_h:2 * c_h].clone()
    np.testing.assert_allclose(run_port(port, x), got, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("no_batchnorm", [False, True], ids=["bn", "no_bn"])
def test_conv_bnorm_upsample_matches_jax(no_batchnorm):
    """A 3x3 ConvBNorm then nearest x2; with no_batchnorm a conv with its
    bias and SiLU (DeconvCSPNet's deconv4). The folded form matches the
    JAX package's under bn_folding."""
    port = seeded(blocks.ConvBNormUpsample(8, 16, 2, no_batchnorm=no_batchnorm), seed=3)
    x = nhwc((2, 5, 7, 8))
    variables = state_dict_to_flax(port.state_dict())
    jax_mod = jax_blocks.ConvBNormUpsample(16, scale=2, no_batchnorm=no_batchnorm)
    want = run_jax(jax_mod, variables, x)
    got = run_port(port, x)
    assert got.shape == (2, 10, 14, 16)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got[:, ::2, ::2], got[:, 1::2, 1::2])
    folded = blocks.ConvBNormUpsample(8, 16, 2, no_batchnorm=no_batchnorm, folded=True).eval()
    folded.load_state_dict(fold_conv_bn_params(port.state_dict()))
    params, stats = jax_fold(variables["params"], variables.get("batch_stats", {}))
    fv = {"params": params, **({"batch_stats": stats} if stats else {})}
    np.testing.assert_allclose(run_port(folded, x), run_jax(jax_mod, fv, x, folded=True),
                               **TOL)


TRANSPOSE_CASES = {"k2s2": dict(kernel_size=2, stride=2),
                   "k3s2p1": dict(kernel_size=3, stride=2, padding=1)}


@pytest.mark.parametrize("form", ["train", "folded"])
@pytest.mark.parametrize("case", sorted(TRANSPOSE_CASES))
def test_conv_transpose_bnorm_matches_jax(case, form):
    """The bridged weights give the JAX ConvTransposeBNorm's output, in the
    train form and BN-folded (the fold scales dim 1, the transpose conv's
    output channels; use_bias=False still gets a bias)."""
    kw = TRANSPOSE_CASES[case]
    port = seeded(blocks.ConvTransposeBNorm(4, 6, use_bias=False, **kw), seed=4)
    x = nhwc((2, 5, 5, 4))
    variables = state_dict_to_flax(port.state_dict())
    jax_mod = jax_blocks.ConvTransposeBNorm(6, use_bias=False, **kw)
    if form == "folded":
        params, stats = jax_fold(variables["params"], variables["batch_stats"])
        assert not stats
        want = run_jax(jax_mod, {"params": params}, x, folded=True)
        state = fold_conv_bn_params(port.state_dict())
        assert sorted(state) == ["conv_transpose.bias", "conv_transpose.weight"]
        port = blocks.ConvTransposeBNorm(4, 6, use_bias=False, folded=True, **kw).eval()
        port.load_state_dict(state)
    else:
        want = run_jax(jax_mod, variables, x)
    got = run_port(port, x)
    side = 10 if case == "k2s2" else 9  # (i - 1) * s - 2p + k
    assert got.shape == want.shape == (2, side, side, 6)
    np.testing.assert_allclose(got, want, **TOL)


def test_conv_transpose_bridge_flips_the_kernel():
    """flax kernel (kh, kw, I, O) <-> torch weight (I, O, kh, kw) flipped in
    both spatial dims, both ways; the unflipped mapping (the JAX package's
    tools/torch_port.py) gives another output."""
    port = seeded(blocks.ConvTransposeBNorm(4, 6, 3, 2, 1, no_batchnorm=True), seed=5)
    variables = state_dict_to_flax(port.state_dict())
    kernel = variables["params"]["conv_transpose"]["kernel"]
    weight = port.conv_transpose.weight.detach().numpy()
    assert kernel.shape == (3, 3, 4, 6)
    np.testing.assert_array_equal(kernel, weight.transpose(2, 3, 0, 1)[::-1, ::-1])
    back = flax_to_state_dict(variables)
    assert torch.equal(back["conv_transpose.weight"], port.conv_transpose.weight)
    x = nhwc((1, 5, 5, 4))
    jax_mod = jax_blocks.ConvTransposeBNorm(6, kernel_size=3, stride=2, padding=1,
                                           no_batchnorm=True)
    unflipped = {"params": {"conv_transpose": {
        "kernel": weight.transpose(2, 3, 0, 1), "bias": variables["params"]["conv_transpose"]
        ["bias"]}}}
    got = run_port(port, x)
    np.testing.assert_allclose(got, run_jax(jax_mod, variables, x), **TOL)
    assert np.abs(got - run_jax(jax_mod, unflipped, x)).max() > 0.1


@pytest.mark.parametrize("scheme", sorted(INIT_SCHEMES))
def test_initializers_reach_transpose_convs(scheme):
    m = blocks.ConvTransposeBNorm(4, 6, 3, 2, 1)
    INIT_SCHEMES[scheme](m, torch.Generator().manual_seed(0))
    w = m.conv_transpose.weight
    bound = 0.05 if scheme == "uniform" else (6.0 / ((4 + 6) * 9)) ** 0.5
    assert w.abs().max() <= bound and w.abs().max() > 0.8 * bound
    assert torch.all(m.conv_transpose.bias == (0.0 if scheme == "uniform" else 0.01))


IN4 = (40, 80, 160, 320)
NECK_FNS = ["bipan_out_channels", "deconv_bipan_out_channels", "repbipan_out_channels",
            "deconv_repbipan_out_channels"]


@pytest.mark.parametrize("bic_with_conv", [False, True], ids=["bic", "bic_conv"])
@pytest.mark.parametrize("width", [0.25, 0.5])
@pytest.mark.parametrize("fn", NECK_FNS)
def test_neck_out_channels_match_jax(fn, width, bic_with_conv):
    kw = dict(width_multiple=width, bic_with_conv=bic_with_conv, depth_multiple=0.3)
    assert getattr(necks, fn)(IN4, **kw) == getattr(jax_necks, fn)(IN4, **kw)


@pytest.mark.parametrize("width", [0.25, 0.5, 1.0])
def test_deconv_cspnet_out_channels_match_jax(width):
    assert backbones.deconv_cspnet_out_channels(width) == \
        jax_backbones.deconv_cspnet_out_channels(width)


@pytest.mark.parametrize("name", ["BiPAN", "DeconvBiPAN", "RepBiPAN", "DeconvRepBiPAN"])
def test_neck_out_channels_are_what_the_module_gives(name):
    """Each registered neck's out-channels function against the widths of
    its own forward's four maps (strides 4/8/16/32 in, widths 0.25)."""
    spec = registry.resolve(registry.TRACKNET_MODULES, name)
    cfg = {"width_multiple": 0.25, "depth_multiple": 0.2}
    cin = (16, 32, 64, 128)
    module = spec.cls(cin, **cfg).eval()
    maps = [torch.zeros(1, c, 32 // s, 64 // s) for c, s in zip(cin, (4, 8, 16, 32))]
    with torch.no_grad():
        outs = module(maps)
    assert tuple(o.shape[1] for o in outs) == spec.out_channels(cin, **cfg)


def test_deconv_repbipan_with_bic_convs_matches_jax():
    """DeconvRepBiPAN with BiCwithConvModule (bic_with_conv=True), the
    other channel plan, on four maps at strides 4/8/16/32."""
    cin = (16, 32, 64, 128)
    cfg = dict(width_multiple=0.25, depth_multiple=0.2, bic_with_conv=True)
    port = seeded(necks.DeconvRepBiPAN(cin, **cfg), seed=6)
    maps = [nhwc((2, 32 // s, 64 // s, c), seed=7 + i)
            for i, (c, s) in enumerate(zip(cin, (4, 8, 16, 32)))]
    variables = state_dict_to_flax(port.state_dict())
    want = jax.jit(lambda v, m: jax_necks.DeconvRepBiPAN(**cfg).apply(v, m, train=False))(
        variables, [jnp.asarray(m) for m in maps])
    with torch.no_grad():
        got = port([torch.from_numpy(m).permute(0, 3, 1, 2) for m in maps])
    assert [tuple(g.shape[1:2]) for g in got] == [(c,) for c in necks.deconv_repbipan_out_channels(
        cin, **cfg)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


def test_detection_net_with_a_bipan_neck_matches_jax():
    """NECKS now holds BiPAN: a DetectionNet with it builds (deploy reaches
    only the necks that take it) and its per-scale outputs match the JAX
    package's."""
    config = {"backbone": "CSPBackBone", "neck": "BiPAN", "head": "EffiDecHead",
              "cspbackbone_config": {"width_multiple": 0.25, "depth_multiple": 0.2},
              "bipan_config": {"width_multiple": 0.25, "depth_multiple": 0.2},
              "effidechead_config": {"width_multiple": 0.5}}
    port = seeded(DetectionNet(2, config), seed=8)
    assert not registry.takes(necks.BiPAN, "deploy") and registry.takes(necks.RepBiPAN, "deploy")
    DetectionNet(2, config, deploy=True, folded=True)
    x = nhwc((1, 64, 64, 3), seed=9)
    variables = state_dict_to_flax(port.state_dict())
    want = jax.jit(lambda v, xs: JaxDetectionNet(num_classes=2, config=config).apply(
        v, xs, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_registry_tables_match_jax():
    assert sorted(registry.TRACKNET_MODULES) == sorted(jax_registry.TRACKNET_MODULES)
    assert sorted(registry.NECKS) == sorted(jax_registry.NECKS)
    assert registry.NOT_PORTED == {"ResNetBackBone", "BasicHead"}
    jax_names = set(jax_registry.BACKBONES) | set(jax_registry.NECKS) | set(jax_registry.HEADS)
    port_names = set(registry.BACKBONES) | set(registry.NECKS) | set(registry.HEADS)
    assert port_names | registry.NOT_PORTED == jax_names
    for name, spec in registry.TRACKNET_MODULES.items():
        assert spec.cls.__name__ == name and spec.out_channels is not None


@pytest.mark.parametrize("name", sorted(registry.NOT_PORTED))
def test_not_ported_names_raise_with_their_roadmap_item(name):
    for table in (registry.BACKBONES, registry.HEADS, registry.TRACKNET_MODULES):
        with pytest.raises(NotImplementedError, match="§A.13"):
            registry.resolve(table, name)
    with pytest.raises(KeyError):
        registry.resolve(registry.TRACKNET_MODULES, "NoSuchModule")


def test_bridge_of_a_zoo_tree_round_trips():
    """SPPF, ConvBNormUpsample and ConvTransposeBNorm in one tree: the
    bridge gives flax paths (norm/BatchNorm_0, conv_transpose/kernel) and
    comes back to the same state_dict."""
    m = torch.nn.Module()
    m.sppf = blocks.SPPFModule(8, 8)
    m.up = blocks.ConvBNormUpsample(8, 8, 2)
    m.ct = blocks.ConvTransposeBNorm(8, 8, 2, 2)
    seeded(m, seed=10)
    variables = state_dict_to_flax(m.state_dict())
    keys = set(flat(variables))
    assert ("params", "ct", "conv_transpose", "kernel") in keys
    assert ("batch_stats", "up", "conv", "norm", "BatchNorm_0", "var") in keys
    back = flax_to_state_dict(variables)
    for k, v in m.state_dict().items():
        assert torch.equal(back[k], v), k
