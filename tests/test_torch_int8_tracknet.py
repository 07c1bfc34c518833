"""The int8 serve form of the PyTorch port's TrackNet, base and advanced
architectures, against the JAX package's int8 PTQ, whole nets in f32 on
the CPU, at the small test configs (base: width 0.25; advanced: widths
0.25, depths 0.2, canonical RepVGG blocks; 32x64, 9 channels), with the
checks and tolerances of tests/test_torch_int8_detection.py on the logits.

The base net's `dec_13` and the advanced net's `deconv4` (convs without
BatchNorm) and its transpose convs stay float in both packages.
"""
import numpy as np
import pytest

import torch

from vision_conglomerate_tpu.models import TrackNet as JaxTrackNet

from vision_conglomerate_torch.models import TrackNet
from vision_conglomerate_torch.nn import quantize
from vision_conglomerate_torch.nn.reparam import deploy_transform

from tests.test_torch_int8_detection import (Case, assert_bridge_roundtrips, assert_forward_matches,
                                             assert_layers_match, assert_near_f32,
                                             assert_quantized_sets_match, assert_scales_match)
from tests.test_torch_tracknet_adv_model import CANONICAL
from tests.test_torch_tracknet_adv_model import port_tracknet as port_adv_tracknet
from tests.test_torch_tracknet_model import CONFIG, frames, port_tracknet


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def base_case():
    train_form = port_tracknet(CONFIG, seed=41)
    return Case("tracknet_base", lambda: TrackNet(CONFIG, folded=True),
                JaxTrackNet(config=CONFIG), deploy_transform(train_form.state_dict()),
                frames(seed=42), nchw_outputs=(0,))


def advanced_case():
    train_form = port_adv_tracknet(CANONICAL, seed=43)
    return Case("tracknet_advanced", lambda: TrackNet(CANONICAL, folded=True, deploy=True),
                JaxTrackNet(config=CANONICAL, deploy=True),
                deploy_transform(train_form.state_dict(), fuse_repvgg=True),
                frames(seed=44), nchw_outputs=(0,))


CASES = {"base": base_case, "advanced": advanced_case}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return CASES[request.param]()


def test_quantized_convs_are_the_jax_packages(case):
    net, _ = assert_quantized_sets_match(case)
    float_convs = {p for p, m in quantize.quantizable_modules(net).items()
                   if not hasattr(m, "q_kernel")}
    assert not float_convs
    names = [n for n, m in net.named_modules() if getattr(m, "no_batchnorm", False)]
    assert names and all(hasattr(m, "conv") and not hasattr(m, "q_kernel")
                         for n, m in net.named_modules() if n in names)


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


def test_deploy_form_routes_int8_convs_to_the_s8_kernels(monkeypatch):
    """Which route each int8 conv of the base net takes: every quantized
    3x3/s1 conv on the s8 conv kernel's wrapper, and `dec_13` (float) on
    the bf16 conv kernel's; no conv on the library route."""
    from vision_conglomerate_torch.nn import blocks

    calls = {"s8": 0, "bf16": 0, "other": 0}
    for name, key in (("conv3x3_s8_bias_act", "s8"), ("conv3x3_bias_act", "bf16"),
                      ("conv_s8_bias_act", "other")):
        fn = getattr(blocks, name)
        monkeypatch.setattr(blocks, name, lambda *a, _fn=fn, _k=key, **kw: (
            calls.__setitem__(_k, calls[_k] + 1), _fn(*a, **kw))[1])
    net = TrackNet(CONFIG, folded=True).eval()
    net.load_state_dict(deploy_transform(port_tracknet(CONFIG, seed=45).state_dict()))
    x = torch.from_numpy(frames(seed=46)).permute(0, 3, 1, 2)
    quantize.int8_quantize_(net, quantize.collect_calibration(net, [x]))
    calls.update(s8=0, bf16=0, other=0)
    with torch.no_grad():
        net(x)
    assert calls == {"s8": 17, "bf16": 1, "other": 0}
    assert np.isfinite(net(x).detach().numpy()).all()
