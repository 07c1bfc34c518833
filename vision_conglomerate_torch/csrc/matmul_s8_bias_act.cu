// int8 matmul with a dequantizing epilogue for Hopper (sm_90a):
// y = act(float(x_q @ w_q) * scale + bias), exact int32 accumulation, one
// bf16 store.
//
// The port's int8 post-training-quantized serve form (nn/quantize.py) runs
// every quantized 1x1/stride-1 conv here, with x_q the channels_last int8
// activation viewed as (B*H*W, Cin). The JAX package computes the same
// function as an XLA int8 conv with int32 accumulation
// (vision_conglomerate_tpu/nn/quantize.py:quantized_conv); it reaches no
// Pallas kernel, so this kernel replaces none. scale[n] = q_wscale[n] *
// q_xscale, computed in f32 by the wrapper, as the JAX package does.
//
// Bound on the H100: bytes (3.35 TB/s), as the bf16 matmul's 1x1 convs
// are; int8 moves half of x's bytes and writes the same bf16 y.
//
// Design: the bf16 matmul kernel's GEMM (igemm_sm90.cuh, TAPS = 1)
// instantiated for int8 operands: TMA brings x and w tiles of 128 int8
// values of K a row (uint8 boxes, 128-byte swizzle), four wgmma m64nNk32
// s8 -> s32 run a stage, and the epilogue reads the block's scales beside
// its biases. K not a multiple of 16 takes element loads into the same
// ring. The tile choice is the bf16 kernel's.

#include "igemm_sm90.cuh"

extern "C" {

// Once per device: allow each tile's dynamic shared memory.
int matmul_s8_bias_act_init() { return igemm::init<1, int8_t>(); }

// The tile (BM x BN) an M x N x K launch takes on a card of `sms` SMs.
int matmul_s8_bias_act_tile(int M, int N, int K, int sms, int* bm, int* bn) {
  const igemm::Tile t = igemm::choose_tile(M, N, K, sms);
  *bm = t.bm;
  *bn = t.bn;
  return 0;
}

// x int8 (M, K), w int8 (N, K), scale and bias f32 (N,), y bf16 (M, N).
// act: 0 none, 1 silu, 2 relu. sms: the device's SM count. Launches on
// `stream`, which must belong to the current device. Returns
// cudaGetLastError() after the launch.
int matmul_s8_bias_act_s8(const void* x, const void* w, const void* scale, const void* bias,
                          void* y, int M, int N, int K, int act, int sms, void* stream) {
  return igemm::launch<1, int8_t>(x, w, bias, y, M, N, K, 1, 1, K, act, sms, stream, scale);
}

const char* matmul_s8_bias_act_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
