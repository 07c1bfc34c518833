"""The int8 convs of the PyTorch port against the JAX package's
nn/quantize.py, layer by layer, on the CPU; the weight and activation
scales; the plain versions' exact arithmetic; and the s8 wrappers'
refusals (the whole nets and the int8 weight bridge:
tests/test_torch_int8_detection.py and tests/test_torch_int8_tracknet.py).

Layer tests: for each quantizable conv kind the JAX package serves in int8
(BN-folded ConvBNorm 1x1 and 3x3/s1, the 6x6/s2 stem, a 3x3/s2
downsample, a fused RepVGG `conv_reparam`, TrackNet's Cin 9 and Cin 126
3x3s), the same numpy x and the same q parameters (the JAX package's own
`int8_quantize_params` of a seeded folded kernel, calibrated on x) go
through the JAX module under bn_folding() + int8_serving() and through the
port's module in its int8 form (`nn.blocks.set_int8_`, the kernels' plain
versions). x_q must be equal (JAX's is taken inside its own
quantized_conv) and the output within 1e-6 of the JAX output's largest
magnitude: the int sums are exact on both sides, and only the f32
dequantize and activation (SiLU's exp) may round differently.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from vision_conglomerate_tpu.nn import blocks as jax_blocks
from vision_conglomerate_tpu.nn import quantize as jax_quantize
from vision_conglomerate_tpu.nn.blocks import bn_folding

from vision_conglomerate_torch.nn import blocks
from vision_conglomerate_torch.nn.quantize import activation_scale, quantize_weights
from vision_conglomerate_torch.ops import int8

REL = 1e-6

# name: (Cin, Cout, kernel, stride, activation, H = W, RepVGG block)
LAYERS = {
    "conv1x1": (32, 48, 1, 1, "silu", 12, False),
    "conv1x1_cin24": (24, 40, 1, 1, "silu", 12, False),
    "conv3x3": (32, 32, 3, 1, "silu", 12, False),
    "stem6x6s2": (3, 16, 6, 2, "silu", 32, False),
    "down3x3s2": (16, 32, 3, 2, "silu", 16, False),
    "repvgg_reparam": (32, 32, 3, 1, "silu", 12, True),
    "tracknet_cin9": (9, 16, 3, 1, "relu", 12, False),
    "tracknet_cin126": (126, 128, 3, 1, "relu", 8, False),
}


def _jax_q_params(kernel_hwio: np.ndarray, bias: np.ndarray, absmax: float, key: str):
    """The JAX package's int8 parameters of one folded conv node."""
    node = {key: {"kernel": jnp.asarray(kernel_hwio), "bias": jnp.asarray(bias)}}
    q = jax_quantize.int8_quantize_params(node, {"act_absmax": (jnp.float32(absmax),)})
    return {k: np.asarray(v) for k, v in q.items()}


class _Node:
    """What quantized_conv reads of a flax module: its params."""

    def __init__(self, params):
        self.params = params

    def get_variable(self, col, name):
        assert col == "params"
        return jnp.asarray(self.params[name])


def _jax_x_q(x: np.ndarray, q) -> np.ndarray:
    """x_q as the JAX package's own quantized_conv computes it."""
    seen = []

    def conv_fn(x_q, w_q):
        seen.append(np.asarray(x_q))
        return jnp.zeros((1,), jnp.int32)

    jax_quantize.quantized_conv(jnp.asarray(x), _Node(q), conv_fn, lambda v: v, jnp.float32)
    return seen[0]


def _port_int8_module(cin, cout, k, stride, act, repvgg, q):
    if repvgg:
        m = blocks.RepVGGBlock(cin, cout, branch_activation=None, deploy=True)
    else:
        m = blocks.ConvBNorm(cin, cout, k, stride, activation=act, folded=True)
    return blocks.set_int8_(m, torch.from_numpy(q["q_kernel"].transpose(3, 2, 0, 1).copy()),
                            *(torch.from_numpy(np.array(q[n])) for n in
                              ("q_wscale", "q_xscale", "q_bias"))).eval()


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax_quantized_conv(name):
    cin, cout, k, stride, act, hw, repvgg = LAYERS[name]
    rng = np.random.default_rng(sorted(LAYERS).index(name))
    x = rng.normal(size=(2, hw, hw, cin)).astype(np.float32)
    kernel = (rng.normal(size=(k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    bias = rng.normal(0, 0.1, size=cout).astype(np.float32)
    key = "conv_reparam" if repvgg else "conv"
    q = _jax_q_params(kernel, bias, float(np.abs(x).max()), key)
    if repvgg:
        jax_mod = jax_blocks.RepVGGBlock(cin, cout, branch_activation=None, deploy=True)
    else:
        jax_mod = jax_blocks.ConvBNorm(cout, k, stride, activation=act)
    with bn_folding(), jax_quantize.int8_serving():
        want = np.asarray(jax_mod.apply({"params": q}, jnp.asarray(x)))

    port = _port_int8_module(cin, cout, k, stride, act, repvgg, q)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got_xq = int8.quantize_activation(torch.from_numpy(x), port.q_xscale).numpy()
    np.testing.assert_array_equal(got_xq, _jax_x_q(x, q))
    with torch.no_grad():
        got = port(xt).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weight_and_activation_scales_match_jax(seed):
    """w_q, w_s and x_s bit for bit from the same f32 kernel and absmax,
    a dead output channel (all-zero kernel: w_s = 1e-12) included."""
    rng = np.random.default_rng(seed)
    kernel = (rng.normal(size=(3, 3, 8, 16)) * 10.0 ** rng.uniform(-3, 1)).astype(np.float32)
    kernel[..., 5] = 0.0
    absmax = float(rng.uniform(0.1, 20.0))
    q = _jax_q_params(kernel, np.zeros(16, np.float32), absmax, "conv")
    w_q, w_s = quantize_weights(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
    np.testing.assert_array_equal(w_q.numpy().transpose(2, 3, 1, 0), q["q_kernel"])
    np.testing.assert_array_equal(w_s.numpy(), q["q_wscale"])
    assert w_s[5].item() == np.float32(1e-12)
    np.testing.assert_array_equal(activation_scale(torch.tensor(absmax)).numpy(), q["q_xscale"])


def test_activation_quantize_rounds_half_to_even_after_a_true_division():
    """Ties at k + 0.5 go to the even integer, the clip is at +-127, and
    the division is a true one (x / 3 vs x * (1/3) differ on some x)."""
    x_s = torch.tensor(1.0 / 3.0)
    ties = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 300.0, -300.0]) * x_s
    want = np.clip(np.round(ties.numpy().astype(np.float32) / np.float32(x_s)), -127, 127)
    np.testing.assert_array_equal(int8.quantize_activation(ties, x_s).numpy(), want)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=4096).astype(np.float32) * 20)
    jax_xq = np.asarray(jnp.clip(jnp.round(jnp.asarray(x.numpy()) / jnp.float32(x_s)), -127, 127))
    np.testing.assert_array_equal(int8.quantize_activation(x, x_s).numpy(), jax_xq)


def _int_conv(x_q, w_q, stride, padding):
    """Exact int64 conv of NHWC x_q and HWIO w_q (numpy)."""
    x = np.pad(x_q.astype(np.int64), ((0, 0), padding[:1] * 2, padding[1:] * 2, (0, 0)))
    kh, kw = w_q.shape[:2]
    ho = (x.shape[1] - kh) // stride[0] + 1
    wo = (x.shape[2] - kw) // stride[1] + 1
    out = np.zeros((x.shape[0], ho, wo, w_q.shape[3]), np.int64)
    for dy in range(kh):
        for dx in range(kw):
            patch = x[:, dy:dy + stride[0] * ho:stride[0], dx:dx + stride[1] * wo:stride[1]]
            out += patch @ w_q[dy, dx].astype(np.int64)
    return out


@pytest.mark.parametrize("route", ["matmul", "conv3x3", "stem", "im2col"])
def test_plain_versions_are_exact(route):
    """Every sum exact, also at a depth where f32 is not (K = 2304, |x_q
    w_q| up to 127^2: the sums pass 2^24), then the f32 epilogue in JAX's
    order; the card's im2col route (K padded to a multiple of 16, then the
    s8 matmul) gives the same sums and outputs."""
    rng = np.random.default_rng(4)
    cin = {"matmul": 2304, "conv3x3": 256, "stem": 3, "im2col": 40}[route]
    k, stride, pad = {"matmul": (1, 1, 0), "conv3x3": (3, 1, 1), "stem": (6, 2, 2),
                      "im2col": (3, 2, 1)}[route]
    x_q = np.full((1, 6, 6, cin), 127, np.int8)
    x_q[0, 0] = rng.integers(-127, 128, (6, cin))
    w_q = np.full((k, k, cin, 8), 127, np.int8)
    w_q[..., 1] = rng.integers(-127, 128, (k, k, cin))
    scale = rng.uniform(1e-6, 1e-5, 8).astype(np.float32)
    bias = rng.normal(size=8).astype(np.float32)
    acc = _int_conv(x_q, w_q, (stride, stride), (pad, pad))
    want = np.float32(acc).astype(np.float32) * scale + bias
    args = (torch.from_numpy(x_q), torch.from_numpy(w_q), torch.from_numpy(scale),
            torch.from_numpy(bias))
    if route == "matmul":
        got = int8.matmul_s8_bias_act(args[0].reshape(36, cin), args[1].reshape(cin, 8),
                                      *args[2:], None, torch.float32).reshape(1, 6, 6, 8)
    elif route == "conv3x3":
        got = int8.conv3x3_s8_bias_act(*args, None, torch.float32)
    else:
        got = int8.conv_s8_bias_act(*args, (stride, stride), (pad, pad), None, torch.float32)
        cols = int8.im2col_s8(args[0], (k, k), (stride, stride), (pad, pad))
        assert cols.shape[1] % 16 == 0 and cols.dtype == torch.int8
        wmat = int8.im2col_weights(args[1], cols.shape[1])
        np.testing.assert_array_equal(
            cols.numpy().astype(np.int64) @ wmat.numpy().astype(np.int64), acc.reshape(-1, 8))
        got_mm = int8.matmul_s8_bias_act(cols, wmat, *args[2:], None, torch.float32)
        np.testing.assert_array_equal(got_mm.reshape(got.shape).numpy(), want)
    assert acc.max() > (2 ** 24 if cin * k * k >= 2304 else 0)
    np.testing.assert_array_equal(got.numpy(), want)


def _s8_args(m=40, k=32, n=16):
    return (torch.zeros(m, k, dtype=torch.int8), torch.zeros(k, n, dtype=torch.int8),
            torch.ones(n), torch.zeros(n))


@pytest.mark.parametrize("case", ["bf16_x", "f32_out", "strided_x", "shapes", "activation",
                                  "device"])
def test_s8_wrappers_refuse_what_they_do_not_take(case):
    """A CUDA tensor launches the kernel or raises, never dequantizes to a
    float path: the launch checks run before any CUDA call, so they show
    here on CPU tensors handed to the launch functions."""
    x, w, s, b = _s8_args()
    if case == "bf16_x":
        with pytest.raises(TypeError, match="int8"):
            int8._launch_matmul(x.bfloat16(), w, s, b, "silu", torch.bfloat16)
    elif case == "f32_out":
        with pytest.raises(TypeError, match="bf16"):
            int8._launch_matmul(x, w, s, b, "silu", torch.float32)
    elif case == "strided_x":
        xs = torch.zeros(2, 6, 6, 64, dtype=torch.int8)[..., ::2]
        with pytest.raises(ValueError, match="contiguous"):
            int8._launch_conv(xs, torch.zeros(3, 3, 32, 16, dtype=torch.int8), s, b, "relu",
                              torch.bfloat16)
    elif case == "shapes":
        with pytest.raises(ValueError, match="shapes"):
            int8._launch_conv(torch.zeros(1, 4, 4, 8, dtype=torch.int8),
                              torch.zeros(1, 1, 8, 16, dtype=torch.int8), s, b, "relu",
                              torch.bfloat16)
    elif case == "activation":
        with pytest.raises(ValueError, match="activation"):
            int8._launch_matmul(x, w, s, b, "gelu", torch.bfloat16)
    else:
        meta = [t.to("meta") for t in (x, w, s, b)]
        for fn in (int8.matmul_s8_bias_act, int8.conv3x3_s8_bias_act):
            with pytest.raises(ValueError, match="device"):
                fn(*meta)
