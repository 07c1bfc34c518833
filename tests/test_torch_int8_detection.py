"""The int8 serve form of the PyTorch port's detection and segmentation
nets against the JAX package's int8 PTQ (nn/quantize.py), whole nets in
f32 on the CPU, at the small test configs (width 0.25, depth 0.2, 64x64;
seg: 8 masks, ProtoSeg c_h 32).

Both packages start from the same f32 deploy weights (the port's
deploy_transform of a seeded net, bridged with `weights.state_dict_to_flax`;
the JAX net is applied, never initialised) and calibrate on the same numpy
batch. Checked:
- the set of quantized convs: equal (every folded ConvBNorm and fused
  RepVGG conv; the head's conf/cls/bbox/masks 1x1 layers stay float);
- calibration absmax and x_s within 1e-5 relative (f32 rounding of two
  forwards that sum in other orders), q_kernel, q_wscale and q_bias from
  the same f32 kernels bit for bit;
- every int8 conv of the net, with the JAX package's own q parameters
  bridged into the port and fed the JAX net's own input at that conv:
  x_q equal and the output within 1e-6 of its largest magnitude (the int
  sums are exact on both sides);
- the whole net run free, with the JAX package's q parameters: the share
  of x_q that differ from the JAX net's is reported and the outputs are
  held within 2e-2 of their largest magnitude, JAX's own int8-vs-f32
  tolerance. Each side quantizes its own f32 activations, which differ in
  the last bits, so an x_q at a rounding tie may flip; a flipped x_q
  moves its conv's outputs by about one weight step times x_s, and the
  layers after it flip a few per cent of their x_q in turn (the seg net
  here: one tie in backbone/c3_2, then about 1% of all x_q), while the
  outputs stay within int8 noise;
- the port's int8 against its own f32 deploy form within the JAX
  package's 2e-2 relative (tests/test_quantize.py);
- the int8 weight bridge: port int8 state -> flax tree equals the JAX
  package's int8 variables, and back.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vision_conglomerate_tpu.models import DetectionNet as JaxDetectionNet
from vision_conglomerate_tpu.models import SegmentationNet as JaxSegmentationNet
from vision_conglomerate_tpu.nn import quantize as jax_quantize
from vision_conglomerate_tpu.nn.blocks import bn_folding

from vision_conglomerate_torch.models import DetectionNet, SegmentationNet
from vision_conglomerate_torch.nn import quantize
from vision_conglomerate_torch.nn.blocks import _nhwc
from vision_conglomerate_torch.nn.reparam import deploy_transform
from vision_conglomerate_torch.ops.int8 import quantize_activation
from vision_conglomerate_torch.weights import _flax_path, flax_to_state_dict, state_dict_to_flax

from tests.test_torch_seg_model import SEG_CONFIG, port_seg_net
from tests.test_torch_weights import (ANCHORS, CONFIG, NUM_CLASSES, flat, port_detection_net,
                                      to_numpy)

LAYER_REL = 1e-6
OUT_REL = 2e-2
SCALE_REL = 1e-5
F32_REL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flax_key(port_path: str) -> str:
    return "/".join(_flax_path(port_path.split(".")))


def run_jax_int8(model, variables, x: np.ndarray, **apply_kw):
    """The JAX package's int8 pipeline: collect_calibration on x (with
    inference=True, as its runners call it), int8_quantize_params, and the
    int8 forward under bn_folding() + int8_serving(), jitted, with each
    quantized conv's input, x_q and output sown from inside its own
    quantized_conv. Returns (absmax {path: float}, int8 variables (numpy),
    outputs, {path: {"x_in", "x_q", "y"}})."""
    absmax = jax_quantize.collect_calibration(model, variables, [jnp.asarray(x)],
                                              inference=True)
    qvars = dict(variables)
    # eagerly, as the JAX runners call it: jitted, XLA may turn the
    # divisions by 127 into multiplications and move the scales
    qvars["params"] = jax_quantize.int8_quantize_params(variables["params"], absmax)
    conv = jax_quantize.quantized_conv

    def sowing(x_in, module, conv_fn, act, dtype):
        def recorded(x_q, w_q):
            module.sow("intermediates", "x_q", x_q)
            return conv_fn(x_q, w_q)
        module.sow("intermediates", "x_in", x_in)
        y = conv(x_in, module, recorded, act, dtype)
        module.sow("intermediates", "y", y)
        return y

    def forward(v, xs):
        with bn_folding(), jax_quantize.int8_serving():
            return model.apply(v, xs, train=False, mutable=["intermediates"], **apply_kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_quantize, "quantized_conv", sowing)
        out, inter = jax.jit(forward)(qvars, jnp.asarray(x))
    absmax = {"/".join(k[:-1]): float(np.asarray(v).reshape(())) for k, v in
              flat(to_numpy(absmax)).items()}
    convs = {}
    for k, v in flat(to_numpy(inter["intermediates"])).items():
        convs.setdefault("/".join(k[:-1]), {})[k[-1]] = np.asarray(v)[0]  # sow keeps a tuple
    outs = [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]
    return absmax, to_numpy(qvars), outs, convs


def port_outputs(net, x: np.ndarray, **kw):
    """The port's outputs and the x_q of every int8 conv ({flax path: NHWC
    int8})."""
    seen, handles = {}, []
    for path, m in quantize.quantizable_modules(net).items():
        if hasattr(m, "q_kernel"):
            handles.append(m.register_forward_pre_hook(
                lambda mod, inp, p=path: seen.__setitem__(
                    flax_key(p), quantize_activation(_nhwc(inp[0]), mod.q_xscale).numpy())))
    with torch.no_grad():
        out = net(torch.from_numpy(x).permute(0, 3, 1, 2), **kw)
    for h in handles:
        h.remove()
    outs = list(out) if isinstance(out, tuple) else [out]
    return [o.numpy() for o in outs], seen


class Case:
    """A net's deploy weights through both packages' int8 pipelines."""

    def __init__(self, name, make_port, jax_model, deploy_state, x, nchw_outputs=(),
                 **forward_kw):
        self.name, self.make_port, self.x, self.kw = name, make_port, x, forward_kw
        self.deploy_state = deploy_state
        self.nchw_outputs = nchw_outputs  # output indices the port gives NCHW
        variables = state_dict_to_flax(deploy_state)
        self.absmax, self.jax_q, self.jax_out, self.jax_convs = run_jax_int8(
            jax_model, variables, x, **forward_kw)

    def float_net(self):
        net = self.make_port()
        net.load_state_dict(self.deploy_state)
        return net.eval()

    def own_int8_net(self):
        net = self.float_net()
        absmax = quantize.collect_calibration(
            net, [torch.from_numpy(self.x).permute(0, 3, 1, 2)], inference=True)
        quantize.int8_quantize_(net, absmax)
        return net, absmax

    def bridged_int8_net(self):
        net = self.make_port().eval()
        return quantize.load_int8_state_(net, flax_to_state_dict(self.jax_q))

    def outputs(self, net):
        outs, seen = port_outputs(net, self.x, **self.kw)
        outs = [o.transpose(0, 2, 3, 1) if i in self.nchw_outputs else o
                for i, o in enumerate(outs)]
        return outs, seen


def detection_case():
    train_form = port_detection_net(CONFIG, seed=31)
    x = np.random.default_rng(32).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    return Case("detection",
                lambda: DetectionNet(NUM_CLASSES, CONFIG, anchors=ANCHORS, deploy=True,
                                     folded=True, device="cpu"),
                JaxDetectionNet(num_classes=NUM_CLASSES, config=CONFIG, anchors=ANCHORS,
                                deploy=True),
                deploy_transform(train_form.state_dict()), x, inference=True)


def segmentation_case():
    train_form = port_seg_net(seed=33)
    x = np.random.default_rng(34).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    return Case("segmentation",
                lambda: SegmentationNet(NUM_CLASSES, SEG_CONFIG, anchors=ANCHORS, deploy=True,
                                        folded=True, device="cpu"),
                JaxSegmentationNet(num_classes=NUM_CLASSES, config=SEG_CONFIG, anchors=ANCHORS,
                                   deploy=True),
                deploy_transform(train_form.state_dict()), x, nchw_outputs=(1,),
                inference=True)


CASES = {"detection": detection_case, "segmentation": segmentation_case}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return CASES[request.param]()


def assert_quantized_sets_match(case):
    net, absmax = case.own_int8_net()
    jax_q = {"/".join(k[:-1]) for k in flat(case.jax_q["params"]) if k[-1] == "q_kernel"}
    port_q = {flax_key(p) for p, m in quantize.quantizable_modules(net).items()
              if hasattr(m, "q_kernel")}
    assert port_q == jax_q == set(case.absmax) == {flax_key(p) for p in absmax}
    assert len(port_q) >= 17  # TrackNet base: all 18 convs but dec_13
    assert not any(n in p for p in port_q for n in ("conf_layer", "cls_layer", "bbox_layer",
                                                    "masks_layer", "conv_transpose"))
    return net, absmax


def assert_scales_match(case):
    net, absmax = case.own_int8_net()
    got = {flax_key(p): v.item() for p, v in absmax.items()}
    for path, want in case.absmax.items():
        assert abs(got[path] - want) <= SCALE_REL * want, path
    jq = flat(case.jax_q["params"])
    state = net.state_dict()
    for path in quantize.quantizable_modules(net):
        fk = tuple(_flax_path(path.split(".")))
        np.testing.assert_array_equal(state[f"{path}.q_kernel"].numpy().transpose(2, 3, 1, 0),
                                      jq[fk + ("q_kernel",)], err_msg=path)
        np.testing.assert_array_equal(state[f"{path}.q_wscale"].numpy(), jq[fk + ("q_wscale",)])
        np.testing.assert_array_equal(state[f"{path}.q_bias"].numpy(), jq[fk + ("q_bias",)])
        x_s, want_xs = state[f"{path}.q_xscale"].item(), float(jq[fk + ("q_xscale",)])
        assert abs(x_s - want_xs) <= SCALE_REL * want_xs, path


def assert_layers_match(case):
    net = case.bridged_int8_net()
    convs = {flax_key(p): m for p, m in quantize.quantizable_modules(net).items()}
    assert sorted(convs) == sorted(case.jax_convs)
    for path, m in convs.items():
        want = case.jax_convs[path]
        x = torch.from_numpy(want["x_in"])
        np.testing.assert_array_equal(quantize_activation(x, m.q_xscale).numpy(), want["x_q"],
                                      err_msg=path)
        with torch.no_grad():
            got = m(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        assert np.abs(got - want["y"]).max() <= LAYER_REL * np.abs(want["y"]).max(), path


def assert_forward_matches(case):
    outs, seen = case.outputs(case.bridged_int8_net())
    assert sorted(seen) == sorted(case.jax_convs)
    differ = sum(int((seen[p] != case.jax_convs[p]["x_q"]).sum()) for p in seen)
    total = sum(v.size for v in seen.values())
    print(f"{case.name}: x_q differs at {differ} of {total} elements "
          f"({differ / total:.2e}) over {len(seen)} int8 convs")
    assert len(outs) == len(case.jax_out)
    for got, want in zip(outs, case.jax_out):
        assert got.shape == want.shape
        rel = np.abs(got - want).max() / np.abs(want).max()
        print(f"{case.name}: output max |d| / max |ref| {rel:.3e} (limit {OUT_REL})")
        assert rel <= OUT_REL


def assert_near_f32(case):
    int8_outs, _ = case.outputs(case.own_int8_net()[0])
    f32_outs, _ = case.outputs(case.float_net())
    for got, ref in zip(int8_outs, f32_outs):
        rel = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)
        assert rel < F32_REL, rel


def assert_bridge_roundtrips(case):
    net = case.bridged_int8_net()
    tree = state_dict_to_flax(net.state_dict())
    got, want = flat(tree), flat(case.jax_q)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg="/".join(k))
    again = case.make_port().eval()
    quantize.load_int8_state_(again, flax_to_state_dict(tree))
    for k, v in net.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def test_quantized_convs_are_the_jax_packages(case):
    assert_quantized_sets_match(case)


def test_calibration_and_scales_match_jax(case):
    assert_scales_match(case)


def test_every_int8_conv_matches_jax_on_its_input(case):
    assert_layers_match(case)


def test_int8_forward_with_jax_q_params_matches_jax(case):
    assert_forward_matches(case)


def test_int8_stays_within_jax_tolerance_of_f32_deploy(case):
    assert_near_f32(case)


def test_int8_weight_bridge_roundtrips(case):
    assert_bridge_roundtrips(case)
