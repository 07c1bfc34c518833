"""The PyTorch port's two kernel modules and the ops around them, against
the JAX package on the CPU.

On a CPU tensor each kernel wrapper computes its plain PyTorch version; it
is compared with the JAX Pallas kernel in interpret mode, in f32, at
tests/test_fused_matmul.py's and tests/test_conv_pallas.py's shapes,
within 1e-4 (f32 sums in another order). The CUDA kernels themselves run
only on the card (chip_smoke.py); here the host-side checks around them
are tested.
"""
import ctypes
import pathlib
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from vision_conglomerate_tpu.nn import blocks as jax_blocks
from vision_conglomerate_tpu.ops.conv_pallas import conv3x3_bias_act as jax_conv3x3
from vision_conglomerate_tpu.ops.fused_matmul import matmul_bias_act as jax_matmul
from vision_conglomerate_tpu.ops.fused_matmul import pointwise_conv_act as jax_pointwise
from vision_conglomerate_tpu.ops.preprocess import normalize_images as jax_normalize
from vision_conglomerate_tpu.ops.resize import resize_nhwc

from vision_conglomerate_torch.models.detection import DetectionNet
from vision_conglomerate_torch.nn import blocks
from vision_conglomerate_torch.ops import _cuda, conv3x3, fused_matmul
from vision_conglomerate_torch.ops.preprocess import normalize_images
from vision_conglomerate_torch.ops.resize import resize_nchw

ACTS = [None, "silu", "relu"]


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("m,k,n", [(256, 64, 32), (100, 16, 8), (1025, 128, 128), (64, 32, 16)])
def test_matmul_bias_act_matches_jax(m, k, n, activation):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    want = jax_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), activation, block_m=256)
    before = fused_matmul.matmul_bias_act.launches
    got = fused_matmul.matmul_bias_act(torch.from_numpy(x), torch.from_numpy(w),
                                       torch.from_numpy(b), activation)
    assert fused_matmul.matmul_bias_act.launches == before  # the CPU path launches nothing
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_pointwise_conv_act_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    kern = rng.normal(size=(1, 1, 16, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    want = jax_pointwise(jnp.asarray(x), jnp.asarray(kern), jnp.asarray(b), "silu")
    got = fused_matmul.pointwise_conv_act(torch.from_numpy(x), torch.from_numpy(kern),
                                          torch.from_numpy(b), "silu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("shape", [(2, 16, 16, 8, 16), (1, 8, 8, 8, 8), (2, 48, 24, 16, 8)])
def test_conv3x3_bias_act_matches_jax(shape, activation):
    n, h, w_, cin, cout = shape
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, h, w_, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    want = jax_conv3x3(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), activation=activation,
                       interpret=True)
    before = conv3x3.conv3x3_bias_act.launches
    got = conv3x3.conv3x3_bias_act(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(b), activation)
    assert conv3x3.conv3x3_bias_act.launches == before
    assert got.shape == (n, h, w_, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_launch_checks_raise_before_any_launch():
    """What the CUDA kernels cannot take raises in the wrapper, before the
    library is built or a launch is made."""
    x = torch.zeros(4, 8, dtype=torch.bfloat16)
    w = torch.zeros(8, 3, dtype=torch.bfloat16)
    b = torch.zeros(3)
    with pytest.raises(TypeError):
        fused_matmul._launch(x.float(), w, b, "silu")
    with pytest.raises(ValueError):
        fused_matmul._launch(x, w[:4], b, "silu")
    with pytest.raises(ValueError):
        fused_matmul._launch(x.t(), w, b, "silu")  # (8, 4) @ (8, 3) does not chain
    with pytest.raises(ValueError):
        fused_matmul._launch(x, w, b, "gelu")
    xc = torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16)
    wc = torch.zeros(3, 3, 8, 5, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        conv3x3._launch(xc, wc[:, :, :4], torch.zeros(5), None)
    with pytest.raises(TypeError):
        conv3x3._launch(xc, wc.float(), torch.zeros(5), None)
    with pytest.raises(ValueError):
        fused_matmul.matmul_bias_act(x.to("meta"), w.to("meta"), b.to("meta"))


def _bad_operands(kernel: str, fault: str):
    """Operands of one kernel's launch with one fault in them."""
    bf16 = torch.bfloat16
    if kernel == "matmul":
        x, w, b = torch.zeros(4, 8, dtype=bf16), torch.zeros(8, 3, dtype=bf16), torch.zeros(3)
        big = (torch.empty(2 ** 28, 8, dtype=bf16, device="meta"),  # M*K = 2^31
               torch.empty(8, 3, dtype=bf16, device="meta"), torch.empty(3, device="meta"))
    else:
        x, w, b = (torch.zeros(1, 4, 4, 8, dtype=bf16), torch.zeros(3, 3, 8, 5, dtype=bf16),
                   torch.zeros(5))
        # M = B*H*W = 2^31 pixel rows (the conv's 32-bit index)
        big = (torch.empty(8, 2 ** 14, 2 ** 14, 8, dtype=bf16, device="meta"),
               torch.empty(3, 3, 8, 5, dtype=bf16, device="meta"), torch.empty(5, device="meta"))
    if fault == "device":
        b = b.to("meta")
    elif fault == "strides":
        x = x.transpose(0, 1).contiguous().transpose(0, 1) if kernel == "matmul" else (
            x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1))
    elif fault == "int32":
        x, w, b = big
    return x, w, b


@pytest.mark.parametrize("fault,match", [("device", "one device"), ("strides", "contiguous"),
                                         ("int32", "32-bit")])
@pytest.mark.parametrize("kernel", ["matmul", "conv3x3"])
def test_launch_rejects_operands(kernel, fault, match):
    """Both wrappers share one operand check; each fault raises before the
    library is built or a launch is made."""
    launch = fused_matmul._launch if kernel == "matmul" else conv3x3._launch
    with pytest.raises(ValueError, match=match):
        launch(*_bad_operands(kernel, fault), "silu")


def test_library_path_follows_source_and_headers(monkeypatch, tmp_path):
    """An edit to a kernel's source or to a shared header names a new
    library, so a stale build is never loaded."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, csrc)
    monkeypatch.setattr(_cuda, "CSRC", str(csrc))
    before = {k: _cuda.library_path(k) for k in ("matmul_bias_act", "conv3x3_bias_act")}
    (csrc / "conv3x3_bias_act.cu").write_text((csrc / "conv3x3_bias_act.cu").read_text() + "\n")
    assert _cuda.library_path("conv3x3_bias_act") != before["conv3x3_bias_act"]
    assert _cuda.library_path("matmul_bias_act") == before["matmul_bias_act"]
    mid = _cuda.library_path("conv3x3_bias_act")
    (csrc / "common.cuh").write_text((csrc / "common.cuh").read_text() + "\n")
    assert _cuda.library_path("matmul_bias_act") != before["matmul_bias_act"]
    assert _cuda.library_path("conv3x3_bias_act") != mid


def test_nvcc_missing_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda._nvcc()


@pytest.mark.parametrize("scale,shape", [(2.0, (2, 5, 7, 3)), (0.5, (2, 8, 6, 3)),
                                         (0.5, (1, 7, 5, 2))])
def test_nearest_resize_matches_jax(scale, shape):
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    want = np.asarray(resize_nhwc(jnp.asarray(x), scale=scale))
    got = resize_nchw(torch.from_numpy(x).permute(0, 3, 1, 2), scale).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [3, 5])
def test_max_pool_same_matches_flax(k):
    """SAME max pool padded with -inf (all-negative inputs would show a
    zero pad)."""
    x = -np.abs(np.random.default_rng(5).normal(size=(2, 9, 7, 4))).astype(np.float32) - 1
    want = np.asarray(jax_blocks._max_pool_same(jnp.asarray(x), k))
    got = blocks.max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_normalize_images_matches_jax():
    x = np.random.default_rng(6).integers(0, 256, size=(2, 4, 5, 3), dtype=np.uint8)
    np.testing.assert_allclose(normalize_images(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_normalize(jnp.asarray(x))), rtol=0, atol=1e-7)


def test_deploy_form_routes_stride1_convs_to_kernels(monkeypatch):
    """Every BN-folded 1x1/s1 conv goes to the matmul kernel and every
    folded stride-1 3x3 conv and conv_reparam to the conv3x3 kernel; the
    stem, the stride-2 convs and the head's plain 1x1 layers do not."""
    from tests.test_torch_weights import CONFIG

    calls = {"matmul": 0, "conv3x3": 0}

    def counting(route, fn):
        def wrapped(*args, **kwargs):
            calls[route] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(blocks, "pointwise_conv_act",
                        counting("matmul", fused_matmul.pointwise_conv_act))
    monkeypatch.setattr(blocks, "conv3x3_bias_act",
                        counting("conv3x3", conv3x3.conv3x3_bias_act))
    net = DetectionNet(2, CONFIG, deploy=True, folded=True, device="cpu").eval()
    want = {"matmul": 0, "conv3x3": 0}
    for m in net.modules():
        conv = None
        if isinstance(m, blocks.ConvBNorm) and m.folded:
            conv = m.conv
        elif isinstance(m, blocks.RepVGGBlock):
            conv = m.conv_reparam
        if conv is not None and conv.stride == (1, 1):
            want["matmul" if conv.kernel_size == (1, 1) else "conv3x3"] += 1
    with torch.no_grad():
        net(torch.rand(1, 3, 64, 64), inference=True)
    assert calls == want and want["matmul"] > 0 and want["conv3x3"] > 0
    assert blocks.kernel_route(net.backbone.conv0.conv, "silu") is None  # 6x6/s2 stem
    assert blocks.kernel_route(net.backbone.conv1.conv, "silu") is None  # 3x3/s2


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
            "int*": ctypes.POINTER(ctypes.c_int)}


@pytest.mark.parametrize("name,module", [("matmul_bias_act", fused_matmul),
                                         ("conv3x3_bias_act", conv3x3)])
def test_argtypes_match_c_entry_points(name, module):
    """Each ctypes signature a wrapper declares is the C entry point's, so no
    pointer is cut to 32 bits and no argument shifts (only the card would
    show either)."""
    source = (pathlib.Path(_cuda.CSRC) / f"{name}.cu").read_text()
    for fn, argtypes in module._ARGTYPES.items():
        found = re.search(rf"\bint {fn}\(([^)]*)\)", source)
        assert found, fn
        types = [re.sub(r"\s*\w+$", "", p.strip()).replace(" *", "*")  # drop the name
                 for p in found.group(1).split(",")]
        assert [_C_TYPES[t] for t in types] == argtypes, fn
