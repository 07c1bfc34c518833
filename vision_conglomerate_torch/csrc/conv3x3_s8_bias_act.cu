// int8 3x3 conv (stride 1, pad 1) with a dequantizing epilogue for Hopper
// (sm_90a): y = act(float(sum x_q * w_q) * scale + bias), int8 NHWC input,
// exact int32 accumulation, one bf16 store.
//
// The port's int8 post-training-quantized serve form (nn/quantize.py) runs
// every quantized 3x3/stride-1 conv here: the BN-folded ConvBNorm 3x3s and
// the fused RepVGG `conv_reparam`s. The JAX package computes the same
// function as an XLA int8 conv with int32 accumulation
// (vision_conglomerate_tpu/nn/quantize.py:quantized_conv); it reaches no
// Pallas kernel, so this kernel replaces none. scale[n] = q_wscale[n] *
// q_xscale, computed in f32 by the wrapper, as the JAX package does.
//
// Bound on the H100: the int8 tensor cores (1979 TOP/s dense) at the deep
// convs, bytes (3.35 TB/s) at the shallow ones; int8 halves the operand
// bytes of the bf16 kernel and doubles its tensor-core rate.
//
// Design: the bf16 conv3x3 kernel's implicit GEMM (igemm_sm90.cuh, TAPS =
// 9) instantiated for int8 operands. A stage row stays 128 bytes, so it
// holds 128 values of K; its A tile is gathered with 16-byte cp.async
// copies (16 channels of one tap: Cin % 16 == 0), the weight tile comes by
// TMA (uint8 boxes of 128 columns), and four wgmma m64nNk32 s8 -> s32 run
// a stage. Cin not a multiple of 16 takes synchronous element loads into
// the same ring; the serve form pads TrackNet's enc_0 (Cin 9), dec_8 (126)
// and the s2d stem (12) to 16 at their producers (the quantize pass writes
// the padded map), so no serve launch takes it. The epilogue reads the
// block's scales beside its biases. The tile choice is the bf16 kernel's.

#include "igemm_sm90.cuh"

extern "C" {

// Once per device, before the first launch there: allow each tile's
// dynamic shared memory (above the 48 KiB default).
int conv3x3_s8_bias_act_init() { return igemm::init<9, int8_t>(); }

// The tile (BM x BN) a launch with B*H*W = M, Cout = N and 9*Cin = K takes
// on a card of `sms` SMs.
int conv3x3_s8_bias_act_tile(int M, int N, int K, int sms, int* bm, int* bn) {
  const igemm::Tile t = igemm::choose_tile(M, N, K, sms);
  *bm = t.bm;
  *bn = t.bn;
  return 0;
}

// x int8 (B, H, W, Cin), w int8 (Cout, 3, 3, Cin), scale and bias f32
// (Cout,), y bf16 (B, H, W, Cout). act: 0 none, 1 silu, 2 relu. sms: the
// device's SM count. Launches on `stream`, which must belong to the
// current device. Returns cudaGetLastError() after the launch.
int conv3x3_s8_bias_act_s8(const void* x, const void* w, const void* scale, const void* bias,
                           void* y, int B, int H, int W, int Cin, int Cout, int act, int sms,
                           void* stream) {
  return igemm::launch<9, int8_t>(x, w, bias, y, B * H * W, Cout, 9 * Cin, H, W, Cin, act, sms,
                                  stream, scale);
}

// 1 where a launch on x and w (Cout, 3, 3, Cin) takes the vector path (W
// by TMA, A by 16-byte cp.async), 0 where it takes the element path.
int conv3x3_s8_bias_act_vector(const void* x, const void* w, int Cin) {
  return igemm::vector_path<int8_t>(x, w, 9 * Cin, Cin);
}

const char* conv3x3_s8_bias_act_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
