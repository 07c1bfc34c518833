// Fused 3x3 conv (stride 1, pad 1) + bias + activation for Hopper (sm_90a),
// bf16 in and out, NHWC activations.
//
// Replaces vision_conglomerate_tpu/ops/conv_pallas.py:conv3x3_bias_act (the
// Pallas kernel `_conv3x3_kernel`): y = act(conv3x3(x, w) + b) with f32
// accumulation over the 9 taps and an f32 epilogue, one bf16 store. The
// serve paths call it for every BN-folded stride-1 3x3 conv and every fused
// RepVGG `conv_reparam`: all 18 convs of TrackNet (ReLU), the detector's
// and the seg net's 3x3s (SiLU).
//
// Bound on the H100: at the detector's serve shapes (batch 4, 160^2..20^2,
// Cin 32..768, Cout 32..512) FLOPs per byte run from ~144 at 32 channels to
// ~2800 at 768->512; the 105.7 GFLOP of a batch are bound by the tensor
// cores (about 0.11 ms at 989 TFLOP/s), most of them at the 20^2 and 40^2
// maps.
//
// Design: the implicit GEMM of igemm_sm90.cuh with TAPS = 9. M = B*H*W
// output pixels as one flat index (only the last tile of the batch is
// ragged), K = 9*Cin walked 64 at a time in the weights' (tap, channel)
// order, N = Cout. Each stage's A tile is gathered with 16-byte cp.async
// copies from (y+ky-1, x+kx-1), zero outside the image, into the
// 128-byte-swizzled layout that wgmma reads; the weight tile comes by TMA;
// two or more K tiles are in flight while wgmma runs. The epilogue adds
// the bias and applies the activation in registers and stores bf16 with
// 16-byte stores. The launcher takes 64 x 128 tiles for the deep convs (K >= 2048)
// and 64 x 64 at the 20^2 and 40^2 maps otherwise. Cin not a multiple of 8
// takes synchronous element loads into the same ring; the serve form pads
// TrackNet's enc_0 (Cin 9), dec_7 -> dec_8 (126) and the s2d stem (12) to
// multiples of 16 at their producers, so no serve launch takes it.

#include "igemm_sm90.cuh"

extern "C" {

// Once per device, before the first launch there: allow each tile's
// dynamic shared memory (above the 48 KiB default).
int conv3x3_bias_act_init() { return igemm::init<9>(); }

// The tile (BM x BN) a launch with B*H*W = M, Cout = N and 9*Cin = K takes
// on a card of `sms` SMs.
int conv3x3_bias_act_tile(int M, int N, int K, int sms, int* bm, int* bn) {
  const igemm::Tile t = igemm::choose_tile(M, N, K, sms);
  *bm = t.bm;
  *bn = t.bn;
  return 0;
}

// x (B, H, W, Cin), w (Cout, 3, 3, Cin), bias f32 (Cout,), y (B, H, W, Cout).
// act: 0 none, 1 silu, 2 relu. sms: the device's SM count. Launches on
// `stream`, which must belong to the current device. Returns
// cudaGetLastError() after the launch.
int conv3x3_bias_act_bf16(const void* x, const void* w, const void* bias, void* y, int B, int H,
                          int W, int Cin, int Cout, int act, int sms, void* stream) {
  return igemm::launch<9>(x, w, bias, y, B * H * W, Cout, 9 * Cin, H, W, Cin, act, sms, stream);
}

// 1 where a launch on x and w (Cout, 3, 3, Cin) takes the vector path (W
// by TMA, A by 16-byte cp.async), 0 where it takes the element path.
int conv3x3_bias_act_vector(const void* x, const void* w, int Cin) {
  return igemm::vector_path<__nv_bfloat16>(x, w, 9 * Cin, Cin);
}

const char* conv3x3_bias_act_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
