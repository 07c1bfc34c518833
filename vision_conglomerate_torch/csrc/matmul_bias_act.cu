// Fused matmul + bias + activation for Hopper (sm_90a), bf16 in and out.
//
// Replaces vision_conglomerate_tpu/ops/fused_matmul.py:matmul_bias_act (the
// Pallas kernel `_kernel`): y = act(x @ w + b) with f32 accumulation and an
// f32 epilogue, one bf16 store. The serve path calls it for every BN-folded
// 1x1/stride-1 conv, with x the channels_last activation viewed as
// (B*H*W, Cin).
//
// Bound on the H100: at the detector's serve shapes K and N are 32..1024
// and 32..512, so FLOPs per byte are K*N / (K + N) <= ~340 and mostly far
// below the ~295 FLOP/byte ridge: the 26 launches of a batch move 172 MB
// and are bound by bytes (0.0515 ms at 3.35 TB/s). Ten of them have
// M = 1600 (20^2 maps), where filling 132 SMs matters more than peak rate.
//
// Design: the GEMM of igemm_sm90.cuh with TAPS = 1. TMA brings the x and
// w tiles (zero-filled past M, N and K) into a ring of stages in the
// 128-byte-swizzled layout that wgmma reads from shared memory; three
// stages and three blocks per SM at the K <= 128 layers, where a block has
// one or two K tiles. Bias and activation run on the accumulators in
// registers before 16-byte bf16 stores, so x is read once per N tile and y
// written once, with no padding copy. K not a multiple of 8 takes element
// loads into the same ring. The launcher picks the tile per shape (64 x 64
// at the 20^2 and 40^2 maps, so those launches give 100-200 blocks).

#include "igemm_sm90.cuh"

extern "C" {

// Once per device: allow each tile's dynamic shared memory.
int matmul_bias_act_init() { return igemm::init<1>(); }

// The tile (BM x BN) an M x N x K launch takes on a card of `sms` SMs.
int matmul_bias_act_tile(int M, int N, int K, int sms, int* bm, int* bn) {
  const igemm::Tile t = igemm::choose_tile(M, N, K, sms);
  *bm = t.bm;
  *bn = t.bn;
  return 0;
}

// x (M, K), w (N, K), bias f32 (N,), y (M, N). act: 0 none, 1 silu,
// 2 relu. sms: the device's SM count. Launches on `stream`, which must
// belong to the current device. Returns cudaGetLastError() after the
// launch.
int matmul_bias_act_bf16(const void* x, const void* w, const void* bias, void* y, int M, int N,
                         int K, int act, int sms, void* stream) {
  return igemm::launch<1>(x, w, bias, y, M, N, K, 1, 1, K, act, sms, stream);
}

const char* matmul_bias_act_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
