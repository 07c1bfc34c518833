"""int8 convs of the post-training-quantized serve form: the activation
quantize pass, the two s8 kernels and the route for every other conv.

The JAX package's nn/quantize.py:quantized_conv computes, for a conv with
int8 weights w_q, per-output-channel weight scales w_s, a per-tensor
activation scale x_s and an f32 bias:

    x_q = clip(round(x_f32 / x_s), -127, 127) as int8   (half to even,
          after a true division)
    acc = conv(x_q, w_q) with int32 accumulation
    y   = act(float(acc) * (w_s * x_s) + bias) in f32, cast to the module dtype

as XLA ops; it reaches no Pallas kernel. The port computes it so:

- `quantize_activation`: the x -> x_q pass, plain torch ops on every
  device (IEEE division and torch.round, which rounds half to even);
- `matmul_s8_bias_act` (1x1, stride 1) and `conv3x3_s8_bias_act` (3x3,
  stride 1, pad 1): hand-written CUDA kernels for sm_90a, the int8
  instantiations of the port's Hopper mainloop (csrc/igemm_sm90.cuh) in
  csrc/matmul_s8_bias_act.cu and csrc/conv3x3_s8_bias_act.cu. The sum is
  exact in int32; the epilogue multiplies by scale[n] = w_s[n] * x_s and
  adds the bias in f32, applies the activation and stores bf16 once;
- `conv_s8_bias_act`: every other conv (the 6x6/s2 stem, the 3x3/s2
  downsamples). On the card an im2col of the int8 map (strided views of
  the zero-padded map, K zero-padded to a multiple of 16) goes to the s8
  matmul kernel, with its fused epilogue. The JAX package runs these
  convs outside any Pallas kernel too. (cuBLAS's int8 GEMM behind
  `torch._int_mm` refuses some of these shapes on the H100 with
  CUBLAS_STATUS_NOT_SUPPORTED, e.g. M 300, K 24, N 40; chip_smoke.py
  times it as the yardstick only.)

Plain versions (the CPU path and the card's reference) accumulate exactly:
an f64 conv or matmul of the integer-valued tensors (every sum is below
2^53; f32 is not enough, since 127^2 * 2304 > 2^24), then the f32
epilogue in JAX's order.

On a CPU tensor each wrapper computes its plain version; on a CUDA tensor
it launches its kernel or raises: nothing quietly dequantizes to bf16.
The kernels store bf16 only, so on the card the module dtype is bf16.
`matmul_s8_bias_act.launches` and `conv3x3_s8_bias_act.launches` count
kernel launches (the im2col convs' included); `conv_s8_bias_act.calls`
counts the im2col route's calls on the card.
"""
import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _cuda
from .fused_matmul import ACTIVATIONS, apply_activation

_MATMUL_ARGTYPES = {"matmul_s8_bias_act_s8": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                    + [ctypes.c_void_p], "matmul_s8_bias_act_tile": _cuda.TILE_ARGTYPES}
_CONV_ARGTYPES = {"conv3x3_s8_bias_act_s8": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                  + [ctypes.c_void_p], "conv3x3_s8_bias_act_tile": _cuda.TILE_ARGTYPES}


def quantize_activation(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """x -> int8 x_q = clamp(round(x_f32 / x_scale), -127, 127), in x's
    layout. The division is a true one (not a multiply by 1/x_scale) and
    round is half to even, as jnp.round."""
    return torch.clamp(torch.round(x.float() / x_scale.float()), -127, 127).to(torch.int8)


def int8_scale(w_scale: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """The epilogue's (Cout,) f32 factor w_s * x_s, in that order."""
    return (w_scale.float() * x_scale.float()).contiguous()


def dequantize(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               activation: Optional[str], dtype: torch.dtype) -> torch.Tensor:
    """act(float(acc) * scale + bias) in f32, cast to dtype; acc holds the
    exact sums (int32, int64 or integer-valued f64) with channels last."""
    y = acc.float() * scale.float() + bias.float()
    return apply_activation(y, activation).to(dtype)


def _check_s8(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              activation: Optional[str], out_dtype: torch.dtype, numels) -> None:
    """What the s8 kernels take, checked before a launch: int8 x and w, f32
    (N,) scale and bias, bf16 output, one device, contiguous x, and every
    count in `numels` (what the kernel indexes with 32-bit ints) below 2^31."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unsupported activation {activation!r}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"the s8 kernels take int8 x and w, got {x.dtype} and {w.dtype}")
    if out_dtype != torch.bfloat16:
        raise TypeError(f"the s8 kernels store bf16, not {out_dtype}")
    if any(t.device != x.device for t in (w, scale, bias)):
        raise ValueError("x, w, scale and bias must be on one device")
    if not x.is_contiguous():
        raise ValueError(f"x must be contiguous, got strides {x.stride()}")
    if max(numels) >= 2 ** 31:
        raise ValueError("the kernel indexes with 32-bit ints; split the call")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


# ------------------------------------------------------------------ matmul

def matmul_s8_bias_act_plain(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor, activation: Optional[str] = "silu",
                             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch: an exact f64 matmul of the
    int8 values, then the f32 epilogue. x_q (M, K), w_q (K, N)."""
    return dequantize(x_q.double() @ w_q.double(), scale, bias, activation, out_dtype)


def _launch_matmul(x_q, w_q, scale, bias, activation, out_dtype):
    if (x_q.dim() != 2 or w_q.dim() != 2 or w_q.shape[0] != x_q.shape[1]
            or scale.shape != (w_q.shape[1],) or bias.shape != (w_q.shape[1],)):
        raise ValueError(f"shapes x {tuple(x_q.shape)}, w {tuple(w_q.shape)}, "
                         f"scale {tuple(scale.shape)}, b {tuple(bias.shape)} do not make "
                         "(M, K) @ (K, N) with (N,) scale and bias")
    m, k = x_q.shape
    n = w_q.shape[1]
    _check_s8(x_q, w_q, scale, bias, activation, out_dtype, (m * k, m * n, k * n))
    wt = w_q.t().contiguous()  # (N, K); free for the transposed view the convs pass
    scale, bias = _f32(scale), _f32(bias)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x_q.device)
    if m == 0 or n == 0:
        return y
    with torch.cuda.device(x_q.device):
        lib = _cuda.load("matmul_s8_bias_act", _MATMUL_ARGTYPES, x_q.device.index)
        code = lib.matmul_s8_bias_act_s8(
            x_q.data_ptr(), wt.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            m, n, k, ACTIVATIONS[activation],
            torch.cuda.get_device_properties(x_q.device).multi_processor_count,
            torch.cuda.current_stream().cuda_stream)
    _cuda.check(lib, "matmul_s8_bias_act", code)
    matmul_s8_bias_act.launches += 1
    return y


def matmul_s8_bias_act(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, activation: Optional[str] = "silu",
                       out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """act(float(x_q @ w_q) * scale + bias); x_q (M, K) int8, w_q (K, N)
    int8, scale and bias (N,) f32; returns (M, N) in out_dtype (bf16 on
    the card)."""
    if x_q.device.type == "cpu":
        return matmul_s8_bias_act_plain(x_q, w_q, scale, bias, activation, out_dtype)
    if x_q.device.type == "cuda":
        return _launch_matmul(x_q, w_q, scale, bias, activation, out_dtype)
    raise ValueError(f"no matmul_s8_bias_act for device {x_q.device}")


matmul_s8_bias_act.launches = 0


# ----------------------------------------------------------------- conv3x3

def conv3x3_s8_bias_act_plain(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor, activation: Optional[str] = "silu",
                              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch: an exact f64 conv of the
    int8 values (stride 1, pad 1), then the f32 epilogue. x_q NHWC, w_q
    HWIO; returns NHWC."""
    acc = F.conv2d(x_q.permute(0, 3, 1, 2).double(), w_q.permute(3, 2, 0, 1).double(),
                   padding=1)
    return dequantize(acc.permute(0, 2, 3, 1), scale, bias, activation, out_dtype)


def _launch_conv(x_q, w_q, scale, bias, activation, out_dtype):
    if (x_q.dim() != 4 or w_q.shape[:3] != (3, 3, x_q.shape[3])
            or scale.shape != (w_q.shape[3],) or bias.shape != (w_q.shape[3],)):
        raise ValueError(f"shapes x {tuple(x_q.shape)}, w {tuple(w_q.shape)}, "
                         f"scale {tuple(scale.shape)}, b {tuple(bias.shape)} are not NHWC x, "
                         "(3, 3, Cin, Cout) w, (Cout,) scale and bias")
    n, h, w_dim, cin = x_q.shape
    cout = w_q.shape[3]
    # M = B*H*W is rounded up to whole 128-row tiles in int arithmetic;
    # offsets into x and y are 64-bit
    _check_s8(x_q, w_q, scale, bias, activation, out_dtype,
              (n * h * w_dim + 127, 9 * cin * cout))
    wk = w_q.permute(3, 0, 1, 2).contiguous()  # (Cout, 3, 3, Cin); free for channels_last OIHW
    scale, bias = _f32(scale), _f32(bias)
    y = torch.empty((n, h, w_dim, cout), dtype=torch.bfloat16, device=x_q.device)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x_q.device):
        lib = _cuda.load("conv3x3_s8_bias_act", _CONV_ARGTYPES, x_q.device.index)
        code = lib.conv3x3_s8_bias_act_s8(
            x_q.data_ptr(), wk.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            n, h, w_dim, cin, cout, ACTIVATIONS[activation],
            torch.cuda.get_device_properties(x_q.device).multi_processor_count,
            torch.cuda.current_stream().cuda_stream)
    _cuda.check(lib, "conv3x3_s8_bias_act", code)
    conv3x3_s8_bias_act.launches += 1
    return y


def conv3x3_s8_bias_act(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, activation: Optional[str] = "silu",
                        out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """act(float(conv3x3(x_q, w_q; stride 1, pad 1)) * scale + bias);
    x_q (B, H, W, Cin) int8 NHWC, w_q (3, 3, Cin, Cout) int8 HWIO, scale
    and bias (Cout,) f32; returns (B, H, W, Cout) in out_dtype (bf16 on
    the card)."""
    if x_q.device.type == "cpu":
        return conv3x3_s8_bias_act_plain(x_q, w_q, scale, bias, activation, out_dtype)
    if x_q.device.type == "cuda":
        return _launch_conv(x_q, w_q, scale, bias, activation, out_dtype)
    raise ValueError(f"no conv3x3_s8_bias_act for device {x_q.device}")


conv3x3_s8_bias_act.launches = 0


# ---------------------------------------------------- every other int8 conv

def conv_s8_bias_act_plain(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, stride: Tuple[int, int],
                           padding: Tuple[int, int], activation: Optional[str] = "silu",
                           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Any int8 conv in plain PyTorch: an exact f64 conv, then the f32
    epilogue. x_q NHWC, w_q HWIO; returns NHWC."""
    acc = F.conv2d(x_q.permute(0, 3, 1, 2).double(), w_q.permute(3, 2, 0, 1).double(),
                   stride=stride, padding=padding)
    return dequantize(acc.permute(0, 2, 3, 1), scale, bias, activation, out_dtype)


def im2col_s8(x_q: torch.Tensor, kernel_hw: Tuple[int, int], stride: Tuple[int, int],
              padding: Tuple[int, int], k_multiple: int = 16) -> torch.Tensor:
    """(B*Ho*Wo, K) int8 patches of an NHWC int8 map, K = kh*kw*Cin in the
    (ky, kx, c) order of an HWIO kernel, zero-padded on the right to a
    multiple of `k_multiple`: strided views of the zero-padded map, one
    copy."""
    (kh, kw), (sh, sw), (ph, pw) = kernel_hw, stride, padding
    xp = F.pad(x_q, (0, 0, pw, pw, ph, ph))
    cols = xp.unfold(1, kh, sh).unfold(2, kw, sw)  # (B, Ho, Wo, C, kh, kw)
    b, ho, wo = cols.shape[:3]
    cols = cols.permute(0, 1, 2, 4, 5, 3).reshape(b * ho * wo, -1)
    pad = -cols.shape[1] % k_multiple
    return F.pad(cols, (0, pad)) if pad else cols


def im2col_weights(w_q: torch.Tensor, k: int) -> torch.Tensor:
    """(k, Cout) int8 matrix of an HWIO kernel in im2col_s8's row order,
    zero rows past kh*kw*Cin."""
    kh, kw, cin, cout = w_q.shape
    return F.pad(w_q.reshape(kh * kw * cin, cout), (0, 0, 0, k - kh * kw * cin))


def _im2col_conv(x_q, w_q, scale, bias, stride, padding, activation):
    """The card's route: im2col (K zero-padded to a multiple of 16, the s8
    kernel's vector path) and the s8 matmul kernel; the zero rows leave
    every sum as it is."""
    kh, kw, _, cout = w_q.shape
    b, h, w_dim, _ = x_q.shape
    ho = (h + 2 * padding[0] - kh) // stride[0] + 1
    wo = (w_dim + 2 * padding[1] - kw) // stride[1] + 1
    cols = im2col_s8(x_q, (kh, kw), stride, padding)
    y = matmul_s8_bias_act(cols, im2col_weights(w_q, cols.shape[1]), scale, bias, activation)
    conv_s8_bias_act.calls += 1
    return y.reshape(b, ho, wo, cout)


def conv_s8_bias_act(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, stride: Tuple[int, int], padding: Tuple[int, int],
                     activation: Optional[str] = "silu",
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """act(float(conv(x_q, w_q; stride, padding)) * scale + bias) for any
    kernel size; x_q NHWC int8, w_q HWIO int8; returns NHWC in out_dtype."""
    if x_q.device.type == "cpu":
        return conv_s8_bias_act_plain(x_q, w_q, scale, bias, stride, padding, activation,
                                      out_dtype)
    if x_q.device.type == "cuda":
        if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
            raise TypeError(f"int8 x and w expected, got {x_q.dtype} and {w_q.dtype}")
        if out_dtype != torch.bfloat16:
            raise TypeError(f"the s8 kernels store bf16, not {out_dtype}")
        return _im2col_conv(x_q, w_q, scale, bias, stride, padding, activation)
    raise ValueError(f"no conv_s8_bias_act for device {x_q.device}")


conv_s8_bias_act.calls = 0
