"""The serve form's zero channels (nn/channel_pad.py) on the CPU.

The serve form pads the three kernel-routed convs whose channel counts
are not multiples of 16 (TrackNet base's enc_0 and dec_7 -> dec_8, CSPNet's
space-to-depth stem), so that on the card each takes the conv kernels'
vector path. Checked here, in f32 (bf16 form) and int8 on the kernels'
plain versions:
- padding then conv equals the unpadded conv bit for bit, and the padded
  output channels are exact zeros (plain bf16 and s8 versions);
- the producers write the padded layout: `widen` (the frame stack's cast)
  and `space_to_depth` with a channel count;
- the padded TrackNet base deploy form (width 0.5: 9 -> 16 frame channels
  and dec_7's 63 -> 64, through `load_tracknet_model`) against the JAX
  package's deploy form at tests/test_torch_tracknet_model.py's deploy
  tolerance (atol 2e-4, rtol 1e-4), and against the unpadded port bit
  for bit;
- its int8 form (`quantize_model_int8`) against the unpadded int8 form bit
  for bit, with finite scales on the padded rows, and against the JAX
  package's int8 net within tests/test_torch_int8_detection.py's OUT_REL;
- the padded s2d stem (CSPNet, width 0.25) against the JAX package's
  deploy form, the whole csp_s2d detector through `load_detection_model`
  against the unpadded one bit for bit, bf16 form and int8;
- the state_dict, weights.py's flax tree and a saved checkpoint of a
  padded serve net equal the unpadded one's, and the padded tensors
  follow what a later load_state_dict or load_int8_state_ writes;
- routing: every conv3x3 or s8 conv call of a padded deploy form
  (TrackNet base at full width, csp_s2d) has a Cin that is a multiple of
  the values in 16 bytes (8 bf16, 16 int8), the vector path's channel
  rule (csrc/igemm_sm90.cuh `vector_path`); the unpadded forms do not.

The unpadded port is the same deploy form with its marks taken off
(`unpadded`).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from vision_conglomerate_tpu.models import TrackNet as JaxTrackNet
from vision_conglomerate_tpu.nn import backbones as jax_backbones
from vision_conglomerate_tpu.nn.blocks import bn_folding
from vision_conglomerate_tpu.nn.reparam import deploy_transform as jax_deploy_transform

from vision_conglomerate_torch.infer.runner import load_detection_model, quantize_model_int8
from vision_conglomerate_torch.infer.tracknet_runner import load_tracknet_model
from vision_conglomerate_torch.models import DetectionNet, TrackNet
from vision_conglomerate_torch.nn import backbones, blocks, channel_pad, quantize
from vision_conglomerate_torch.nn.reparam import deploy_transform
from vision_conglomerate_torch.ops import conv3x3, int8
from vision_conglomerate_torch.train.checkpoint import load_checkpoint, save_checkpoint
from vision_conglomerate_torch.weights import state_dict_to_flax

from tests.test_torch_alternates import NETS, seeded
from tests.test_torch_int8_detection import OUT_REL, Case
from tests.test_torch_tracknet_model import FULL, frames, nchw, port_tracknet
from tests.test_torch_weights import ANCHORS, flat

HALF = {"weight_init": "uniform", "architecture": "base", "base_arch_config": {
    "encoder_config": {"width_multiple": 0.5}, "decoder_config": {"width_multiple": 0.5}}}
DEPLOY_TOL = dict(atol=2e-4, rtol=1e-4)  # test_torch_tracknet_model's deploy-form tolerance
NUM_CLASSES = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def unpadded(net):
    """`net` with every conv's channel-padding mark taken off: the deploy
    form as it was before the serve form padded."""
    for m in net.modules():
        if getattr(m, "pad_channels", None):
            m.pad_channels = None
    return net


def served(m):
    """The float deploy-form tensors a ConvBNorm serves with."""
    return channel_pad.serve_conv_weights(m, m.conv)


def zero_padded(t: torch.Tensor, shape, fill: float = 0.0) -> torch.Tensor:
    out = t.new_full(shape, fill)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


# (Cin, Cout) -> (padded Cin, padded Cout): dec_8, enc_0, the s2d stem, dec_7
PLAIN_CASES = {"dec_8": (126, 128, 128, 128), "enc_0": (9, 64, 16, 64),
               "s2d_stem": (12, 64, 16, 64), "dec_7": (384, 126, 384, 128)}


@pytest.mark.parametrize("act", ["relu", "silu"])
@pytest.mark.parametrize("name", sorted(PLAIN_CASES))
def test_plain_conv_padding_is_exact(name, act):
    cin, cout, cin_p, cout_p = PLAIN_CASES[name]
    rng = np.random.default_rng(61)
    x = torch.from_numpy(rng.normal(size=(2, 6, 10, cin)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 3, cin, cout)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(cout,)).astype(np.float32))
    want = conv3x3.conv3x3_bias_act_plain(x, w, b, act)
    got = conv3x3.conv3x3_bias_act_plain(zero_padded(x, (2, 6, 10, cin_p)),
                                         zero_padded(w, (3, 3, cin_p, cout_p)),
                                         zero_padded(b, (cout_p,)), act)
    assert torch.equal(got[..., :cout], want)
    assert not got[..., cout:].any()


@pytest.mark.parametrize("name", sorted(PLAIN_CASES))
def test_plain_s8_conv_padding_is_exact(name):
    cin, cout, cin_p, cout_p = PLAIN_CASES[name]
    g = torch.Generator().manual_seed(62)
    x = torch.randint(-127, 128, (2, 6, 10, cin), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (3, 3, cin, cout), generator=g, dtype=torch.int8)
    scale = torch.rand(cout, generator=g) * 1e-4
    bias = torch.randn(cout, generator=g)
    want = int8.conv3x3_s8_bias_act_plain(x, w, scale, bias, "relu")
    got = int8.conv3x3_s8_bias_act_plain(
        zero_padded(x, (2, 6, 10, cin_p)), zero_padded(w, (3, 3, cin_p, cout_p)),
        zero_padded(scale, (cout_p,), 1.0), zero_padded(bias, (cout_p,)), "relu")
    assert torch.equal(got[..., :cout], want)
    assert not got[..., cout:].any()


def test_producers_write_the_padded_layout():
    x = nchw(frames(2, seed=63, hw=(8, 12)))
    wide = channel_pad.widen(x, 16, torch.bfloat16)
    assert wide.shape == (2, 16, 8, 12) and wide.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(wide, F.pad(x, (0, 0, 0, 0, 0, 7)).to(torch.bfloat16))
    assert channel_pad.widen(x, 9, torch.float32) is x
    rgb = x[:, :3].contiguous(memory_format=torch.channels_last)
    s2d = backbones.space_to_depth(rgb, 16)
    assert s2d.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(s2d, F.pad(backbones.space_to_depth(rgb), (0, 0, 0, 0, 0, 4)))
    assert torch.equal(backbones.space_to_depth(rgb, 12), backbones.space_to_depth(rgb))


# ------------------------------------------------------------- TrackNet
@pytest.fixture(scope="module")
def tn(tmp_path_factory):
    """A seeded width-0.5 TrackNet as a checkpoint, its deploy state, the
    frames, and the JAX package's deploy-form logits (NHWC)."""
    net = port_tracknet(HALF, seed=51)
    ckpt = str(tmp_path_factory.mktemp("tn") / "TrackNet.ckpt.tar")
    save_checkpoint(ckpt, {"LAST_EPOCH": 0, "NETWORK_PARAMS": state_dict_to_flax(net.state_dict())})
    state = deploy_transform(net.state_dict(), fuse_repvgg=False)
    x = frames(2, seed=52)
    variables = state_dict_to_flax(net.state_dict())
    params, stats = jax_deploy_transform(variables["params"], variables["batch_stats"],
                                         fuse_repvgg=False)
    with bn_folding(True):
        want = np.asarray(jax.jit(lambda v, xs: JaxTrackNet(config=HALF).apply(
            v, xs, train=False))({"params": params, "batch_stats": stats}, jnp.asarray(x)))
    return ckpt, state, x, want


def unpadded_tracknet(state, config=HALF):
    dep = unpadded(TrackNet(config, folded=True))
    dep.load_state_dict(state)
    return dep.eval()


def test_padded_tracknet_deploy_matches_jax(tn):
    ckpt, state, x, want = tn
    net = load_tracknet_model(ckpt, HALF, device="cpu")
    enc, dec = net.encoder, net.decoder
    assert tuple(served(enc.enc_0)[0].shape) == (32, 16, 3, 3)
    w7, b7 = served(dec.dec_7)
    assert tuple(w7.shape) == (64, 192, 3, 3) and not w7[63:].any()
    assert tuple(b7.shape) == (64,) and not b7[63:].any()
    assert tuple(served(dec.dec_8)[0].shape) == (64, 64, 3, 3)
    assert served(dec.dec_2)[0] is dec.dec_2.conv.weight
    with torch.no_grad():
        got = net(nchw(x))
        ref = unpadded_tracknet(state)(nchw(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **DEPLOY_TOL)
    assert torch.equal(got, ref)


def test_padded_int8_tracknet_equals_unpadded_and_matches_jax(tn):
    ckpt, state, x, _ = tn
    calib = nchw(x)
    net = load_tracknet_model(ckpt, HALF, device="cpu", quantize="int8")
    quantize_model_int8(net, calib, inference=True, og_size=x.shape[1:3])
    ref = unpadded_tracknet(state)
    quantize.int8_quantize_(ref, quantize.collect_calibration(ref, [calib], inference=True,
                                                              og_size=x.shape[1:3]))
    q7, s7, b7 = channel_pad.serve_q_params(net.decoder.dec_7)
    assert tuple(q7.shape) == (64, 192, 3, 3)
    assert torch.isfinite(s7).all() and (s7[63:] == 1).all()
    assert not q7[63:].any() and not b7[63:].any()
    assert tuple(channel_pad.serve_q_params(net.decoder.dec_8)[0].shape) == (64, 64, 3, 3)
    assert tuple(channel_pad.serve_q_params(net.encoder.enc_0)[0].shape) == (32, 16, 3, 3)
    assert channel_pad.in_channels(net.encoder.enc_0, 9) == 9  # the quantize pass pads
    for k, v in ref.state_dict().items():  # the same calibration and q parameters
        assert torch.equal(net.state_dict()[k], v), k
    with torch.no_grad():
        got = net(calib)
        assert torch.equal(got, ref(calib))
    case = Case("tracknet_half", lambda: TrackNet(HALF, folded=True), JaxTrackNet(config=HALF),
                state, x, nchw_outputs=(0,))
    bridged = case.bridged_int8_net()
    assert channel_pad.padding(bridged.decoder.dec_8) == (64, 64)
    (out,), _ = case.outputs(bridged)
    rel = np.abs(out - case.jax_out[0]).max() / np.abs(case.jax_out[0]).max()
    assert rel <= OUT_REL, rel


# ------------------------------------------------------- the s2d stem
def test_padded_s2d_backbone_matches_jax():
    kw = dict(width_multiple=0.25, depth_multiple=0.2, space_to_depth_stem=True)
    train_form = seeded(backbones.CSPNet(3, **kw), seed=64)
    state = deploy_transform(train_form.state_dict(), fuse_repvgg=False)
    x = np.random.default_rng(65).normal(size=(2, 64, 64, 3)).astype(np.float32)
    variables = state_dict_to_flax(train_form.state_dict())
    params, stats = jax_deploy_transform(variables["params"], variables["batch_stats"],
                                         fuse_repvgg=False)
    with bn_folding(True):
        want = jax.jit(lambda v, xs: jax_backbones.CSPNet(**kw).apply(v, xs, train=False))(
            {"params": params, "batch_stats": stats}, jnp.asarray(x))
    nets = []
    for pad in (False, True):
        net = backbones.CSPNet(3, **kw, folded=True)
        net.load_state_dict(state)
        nets.append(net.eval() if pad else unpadded(net).eval())
    assert tuple(served(nets[1].conv0)[0].shape) == (8, 16, 3, 3)
    with torch.no_grad():
        ref, got = (net(nchw(x)) for net in nets)
    for g, r, w in zip(got, ref, want):
        assert torch.equal(g, r)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), **DEPLOY_TOL)


def test_padded_csp_s2d_detector_equals_unpadded(tmp_path):
    """The csp_s2d detector through load_detection_model (padded stem)
    against the same deploy form unpadded, bf16 form (f32 here) and int8."""
    config = NETS["csp_s2d"]
    train_form = seeded(DetectionNet(NUM_CLASSES, config, anchors=ANCHORS), seed=66)
    ckpt = str(tmp_path / "DetectionNet.ckpt.tar")
    save_checkpoint(ckpt, {"LAST_EPOCH": 0, "NUM_CLASSES": NUM_CLASSES,
                           "NETWORK_PARAMS": state_dict_to_flax(train_form.state_dict())})
    x = torch.from_numpy(np.random.default_rng(67).uniform(size=(2, 3, 64, 64)).astype(
        np.float32)).contiguous(memory_format=torch.channels_last)
    ref = unpadded(DetectionNet(NUM_CLASSES, config, anchors=ANCHORS, deploy=True, folded=True))
    ref.load_state_dict(deploy_transform(train_form.state_dict()))
    ref.eval()
    for q in (None, "int8"):
        net, _ = load_detection_model(ckpt, config, device="cpu", quantize=q)
        if q:
            quantize_model_int8(net, x, inference=True)
            quantize.int8_quantize_(ref, quantize.collect_calibration(ref, [x], inference=True))
            assert tuple(channel_pad.serve_q_params(net.backbone.conv0)[0].shape[:2]) == (64, 16)
        else:
            assert tuple(served(net.backbone.conv0)[0].shape[:2]) == (64, 16)
        with torch.no_grad():
            got, want = net(x, inference=True), ref(x, inference=True)
        assert torch.equal(got, want), q


# ------------------------------------------------ state, bridge, checkpoint
def test_padding_leaves_state_bridge_and_checkpoint_unchanged(tn, tmp_path):
    ckpt, state, x, _ = tn
    for q in (None, "int8"):
        net = load_tracknet_model(ckpt, HALF, device="cpu", quantize=q)
        ref = unpadded_tracknet(state)
        if q:
            for m in (net, ref):
                calib = quantize.collect_calibration(m, [nchw(x)])
                quantize.int8_quantize_(m, calib)
        assert channel_pad.padding(net.decoder.dec_7) == (192, 64)
        got, want = net.state_dict(), ref.state_dict()
        assert sorted(got) == sorted(want) and not any("padded" in k for k in got)
        for k, v in want.items():
            assert torch.equal(got[k], v), k
        tree, ref_tree = flat(state_dict_to_flax(got)), flat(state_dict_to_flax(want))
        assert sorted(tree) == sorted(ref_tree)
        for k, v in ref_tree.items():
            np.testing.assert_array_equal(np.asarray(tree[k]), np.asarray(v), err_msg="/".join(k))
        paths = [str(tmp_path / f"{q}_{i}.ckpt.tar") for i in range(2)]
        for path, m in zip(paths, (net, ref)):
            save_checkpoint(path, {"NETWORK_PARAMS": state_dict_to_flax(m.state_dict())})
        saved = [flat(load_checkpoint(p)["NETWORK_PARAMS"]) for p in paths]
        assert sorted(saved[0]) == sorted(saved[1])
        for k, v in saved[1].items():
            np.testing.assert_array_equal(np.asarray(saved[0][k]), np.asarray(v))
    train_form = TrackNet(HALF)
    assert train_form.decoder.dec_7.pad_channels == (192, 64)
    assert channel_pad.padding(train_form.decoder.dec_7) is None
    assert channel_pad.in_channels(train_form.encoder.enc_0, 9) == 9


@pytest.mark.parametrize("q", [None, "int8"])
def test_padded_serve_follows_later_loads(tn, q):
    """A padded serve net that has run, then loaded with other weights
    (load_state_dict; in int8 load_int8_state_ on a net the loader built),
    serves the new weights: equal to the unpadded form of them."""
    ckpt, state, x, _ = tn
    other = deploy_transform(port_tracknet(HALF, seed=72).state_dict(), fuse_repvgg=False)
    net = load_tracknet_model(ckpt, HALF, device="cpu", quantize=q)
    ref = unpadded_tracknet(other)
    if q:
        quantize.int8_quantize_(ref, quantize.collect_calibration(ref, [nchw(x)]))
    with torch.no_grad():
        net(nchw(x))
        if q:
            quantize.load_int8_state_(net, ref.state_dict())
        else:
            net.load_state_dict(other)
        got, want = net(nchw(x)), ref(nchw(x))
    assert torch.equal(got, want)


# -------------------------------------------------------------- routing
def element_calls(monkeypatch):
    """Spy on the conv3x3 and s8 conv wrappers: the list of (name, Cin,
    Cin narrow?) of every call, narrow being not a multiple of the values
    in 16 bytes (the element path's channel condition)."""
    calls = []

    def spy(name, fn, values):
        def wrapped(x, w, *args):
            calls.append((name, x.shape[-1], x.shape[-1] % values != 0))
            return fn(x, w, *args)
        return wrapped

    monkeypatch.setattr(blocks, "conv3x3_bias_act",
                        spy("conv3x3", conv3x3.conv3x3_bias_act_plain, 8))
    monkeypatch.setattr(blocks, "conv3x3_s8_bias_act",
                        spy("conv3x3_s8", int8.conv3x3_s8_bias_act_plain, 16))
    return calls


def routed_net(name, pad, q):
    """(deploy-form net, input): TrackNet base at full width, or the
    csp_s2d detector; padded or not, float or int8."""
    if name == "tracknet":
        train_form = port_tracknet(FULL, seed=68)
        net = TrackNet(FULL, folded=True)
        net.load_state_dict(deploy_transform(train_form.state_dict(), fuse_repvgg=False))
        x, kw = nchw(frames(1, seed=69, hw=(16, 32))), {}
    else:
        config = NETS["csp_s2d"]
        train_form = seeded(DetectionNet(NUM_CLASSES, config, anchors=ANCHORS), seed=70)
        net = DetectionNet(NUM_CLASSES, config, anchors=ANCHORS, deploy=True, folded=True)
        net.load_state_dict(deploy_transform(train_form.state_dict()))
        x, kw = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(71)), dict(
            inference=True)
    net = net.eval() if pad else unpadded(net).eval()
    if q:
        quantize.int8_quantize_(net, quantize.collect_calibration(net, [x], **kw))
    return net, x, kw


@pytest.mark.parametrize("q", [None, "int8"])
@pytest.mark.parametrize("name", ["tracknet", "csp_s2d"])
def test_padded_deploy_forms_take_no_element_path(monkeypatch, name, q):
    calls = element_calls(monkeypatch)
    route = "conv3x3_s8" if q else "conv3x3"
    seen = {}
    for pad in (False, True):
        net, x, kw = routed_net(name, pad, q)
        calls.clear()
        with torch.no_grad():
            net(x, **kw)
        seen[pad] = [c for c in calls if c[0] == route]
    narrow = {"tracknet": {9, 126}, "csp_s2d": {12}}[name]
    assert {c[1] for c in seen[False] if c[2]} == narrow
    assert seen[True] and not any(c[2] for c in seen[True])
    assert len(seen[True]) == len(seen[False])
