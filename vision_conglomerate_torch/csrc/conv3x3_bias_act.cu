// Fused 3x3 conv (stride 1, pad 1) + bias + activation for Hopper (sm_90a),
// bf16 in and out, NHWC activations.
//
// Replaces vision_conglomerate_tpu/ops/conv_pallas.py:conv3x3_bias_act (the
// Pallas kernel `_conv3x3_kernel`): y = act(conv3x3(x, w) + b) with f32
// accumulation over the 9 taps and an f32 epilogue, one bf16 store. The
// serve path calls it for every BN-folded stride-1 3x3 conv and every fused
// RepVGG `conv_reparam`.
//
// It is an implicit GEMM, M = B*H*W output pixels, K = 9*Cin, N = Cout.
// Bound on the H100: at the detector's shapes (H*W 160^2..20^2, Cin
// 32..768, Cout 32..512) FLOPs per byte are about 9*Cin*Cout/(Cin + Cout),
// from ~144 at 32 channels to ~2800 at 768->512: the narrow high-resolution
// convs are bound by bytes, the deep ones by the tensor cores.
//
// Design. A block owns TH output rows x TW output columns of one image
// (TW the width rounded up to 16, at most 256; TH as many rows as fit 256
// pixels) and 64 output channels. For
// each chunk of 32 input channels it copies a (TH+2) x (TW+2) pixel slab,
// the rows plus a one-row and one-column halo, into shared memory, with
// zeros outside the image; then the weights of all 9 taps for the chunk.
// Each tap's A operand is then a plain strided matrix inside the slab (16
// consecutive pixels of one row are 16 consecutive slab entries), so WMMA
// loads it directly: every input element is read from device memory once
// per block, not once per tap. Bias and activation run on the f32
// accumulators in shared memory before the single bf16 store; ragged
// rows, columns, Cin and Cout are masked. wgmma/TMA pipelining is left to a
// later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BN = 64;          // output channels per block
constexpr int BK = 32;          // input channels per slab chunk
constexpr int LDS = BK + 16;    // bf16 stride per pixel / weight row: 96 bytes keeps WMMA pointers 32-byte aligned
constexpr int LDC = BN + 4;     // f32 stride of the epilogue tile
constexpr int MAX_PIX = 256;    // TH * TW
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MF_PER_WARP = MAX_PIX / 16 / WARPS;  // 16-pixel fragments per warp
constexpr int NF = BN / 16;                        // 16-channel fragments per block

// Dynamic shared memory of a TH x TW tile: the slab and the 9 taps' weights
// during the K loop, then the f32 epilogue tile in the same bytes.
constexpr int smem_bytes(int TH, int TW) {
  const int slab = (TH + 2) * (TW + 2) * LDS * 2 + 9 * BN * LDS * 2;
  const int epi = TH * TW * LDC * 4;
  return slab > epi ? slab : epi;
}

// The most any tile takes: for each TW, the tallest tile.
constexpr int max_smem_bytes() {
  int most = 0;
  for (int tw = 16; tw <= MAX_PIX; tw += 16) {
    const int s = smem_bytes(MAX_PIX / tw, tw);
    most = s > most ? s : most;
  }
  return most;
}

__global__ void __launch_bounds__(THREADS)
conv3x3_bias_act_kernel(const __nv_bfloat16* __restrict__ x,  // (B, H, W, Cin)
                        const __nv_bfloat16* __restrict__ w,  // (Cout, 3, 3, Cin)
                        const float* __restrict__ bias,       // (Cout,)
                        __nv_bfloat16* __restrict__ y,        // (B, H, W, Cout)
                        int H, int W, int Cin, int Cout, int TH, int TW,
                        int tiles_h, int tiles_w, int act, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int slab_cols = TW + 2;
  const int slab_pixels = (TH + 2) * slab_cols;
  __nv_bfloat16* slab = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wt = slab + slab_pixels * LDS;  // [9][BN][LDS]
  float* c_tile = reinterpret_cast<float*>(smem);  // [TH*TW][LDC], after the K loop

  int t = blockIdx.x;
  const int tc = t % tiles_w;
  t /= tiles_w;
  const int tr = t % tiles_h;
  const int b = t / tiles_h;
  const int r0 = tr * TH, q0 = tc * TW;
  const int c0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32;
  const int m_frags = TH * TW / 16;
  const __nv_bfloat16* xb = x + (size_t)b * H * W * Cin;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MF_PER_WARP][NF];
#pragma unroll
  for (int i = 0; i < MF_PER_WARP; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  bool n_live[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) n_live[j] = c0 + j * 16 < Cout;

  for (int ci0 = 0; ci0 < Cin; ci0 += BK) {
    // slab: (TH+2) x (TW+2) pixels x BK channels, zero outside the image
    for (int i = threadIdx.x; i < slab_pixels * (BK / 8); i += THREADS) {
      const int p = i / (BK / 8), v = i % (BK / 8);
      const int r = r0 - 1 + p / slab_cols, q = q0 - 1 + p % slab_cols;
      const int ci = ci0 + v * 8;
      const bool inside = r >= 0 && r < H && q >= 0 && q < W;
      const int valid = inside ? min(8, Cin - ci) : 0;
      const __nv_bfloat16* src = inside ? xb + ((size_t)r * W + q) * Cin + ci : xb;
      load8(slab + p * LDS + v * 8, src, valid, vec);
    }
    // weights of the 9 taps: [tap][co][ci]
    for (int i = threadIdx.x; i < 9 * BN * (BK / 8); i += THREADS) {
      const int v = i % (BK / 8);
      const int co = (i / (BK / 8)) % BN;
      const int tap = i / (BK / 8) / BN;
      const int ci = ci0 + v * 8;
      const int valid = (c0 + co < Cout) ? min(8, Cin - ci) : 0;
      load8(wt + (tap * BN + co) * LDS + v * 8,
            w + ((size_t)(c0 + co) * 9 + tap) * Cin + ci, valid, vec);
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf[NF];
#pragma unroll
        for (int j = 0; j < NF; ++j)
          if (n_live[j])
            wmma::load_matrix_sync(bf[j], wt + (tap * BN + j * 16) * LDS + kk, LDS);
#pragma unroll
        for (int i = 0; i < MF_PER_WARP; ++i) {
          const int mf = warp + i * WARPS;
          if (mf < m_frags) {
            const int pix = mf * 16;
            const int pr = pix / TW, pc = pix % TW;  // 16 pixels of one row
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
            wmma::load_matrix_sync(af, slab + ((pr + ky) * slab_cols + pc + kx) * LDS + kk, LDS);
#pragma unroll
            for (int j = 0; j < NF; ++j)
              if (n_live[j]) wmma::mma_sync(acc[i][j], af, bf[j], acc[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: accumulators -> smem (the slab is dead after the last sync)
#pragma unroll
  for (int i = 0; i < MF_PER_WARP; ++i) {
    const int mf = warp + i * WARPS;
    if (mf < m_frags) {
#pragma unroll
      for (int j = 0; j < NF; ++j)
        if (n_live[j])
          wmma::store_matrix_sync(c_tile + mf * 16 * LDC + j * 16, acc[i][j], LDC,
                                  wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TH * TW * BN; i += THREADS) {
    const int p = i / BN, co = i % BN;
    const int r = r0 + p / TW, q = q0 + p % TW, c = c0 + co;
    if (r < H && q < W && c < Cout)
      y[(((size_t)b * H + r) * W + q) * Cout + c] =
          __float2bfloat16(activate(c_tile[p * LDC + co] + bias[c], act));
  }
}

}  // namespace

extern "C" {

// Once per device, before the first launch there: allow the largest tile's
// dynamic shared memory (above the 48 KiB default).
int conv3x3_bias_act_init() {
  return (int)cudaFuncSetAttribute(conv3x3_bias_act_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   max_smem_bytes());
}

// x (B, H, W, Cin), w (Cout, 3, 3, Cin), bias f32 (Cout,), y (B, H, W, Cout).
// act: 0 none, 1 silu, 2 relu. vec: 1 when Cin % 8 == 0 and x, w are
// 16-byte aligned, else 0. Launches on `stream`, which must belong to the
// current device. Returns cudaGetLastError() after the launch.
int conv3x3_bias_act_bf16(const void* x, const void* w, const void* bias, void* y,
                          int B, int H, int W, int Cin, int Cout, int act, int vec,
                          void* stream) {
  const int w16 = (W + 15) / 16 * 16;
  const int TW = w16 < MAX_PIX ? w16 : MAX_PIX;
  const int rows = MAX_PIX / TW < H ? MAX_PIX / TW : H;
  const int TH = rows > 1 ? rows : 1;
  const int smem = smem_bytes(TH, TW);
  const int tiles_h = (H + TH - 1) / TH, tiles_w = (W + TW - 1) / TW;
  dim3 grid(B * tiles_h * tiles_w, (Cout + BN - 1) / BN);
  conv3x3_bias_act_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)bias,
      (__nv_bfloat16*)y, H, W, Cin, Cout, TH, TW, tiles_h, tiles_w, act, vec);
  return (int)cudaGetLastError();
}

const char* conv3x3_bias_act_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
