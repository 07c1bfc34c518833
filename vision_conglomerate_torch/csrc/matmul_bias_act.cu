// Fused matmul + bias + activation for Hopper (sm_90a), bf16 in and out.
//
// Replaces vision_conglomerate_tpu/ops/fused_matmul.py:matmul_bias_act (the
// Pallas kernel `_kernel`): y = act(x @ w + b) with f32 accumulation and an
// f32 epilogue, one bf16 store. The serve path calls it for every BN-folded
// 1x1/stride-1 conv, with x the channels_last activation viewed as
// (B*H*W, Cin).
//
// Bound on the H100: at the detector's shapes K and N are 32..1024 and
// 32..512, so FLOPs per byte are 2*K*N / (2*(K + N)) <= ~340 and mostly far
// below the ~295 FLOP/byte ridge: the kernel is bound by bytes. The design
// reads each x tile once per N tile (N <= 64 needs one), keeps the weight
// tile in shared memory, applies bias and activation to the f32
// accumulators in shared memory and writes the output once, with no padding
// copy: ragged M, N and K edges are masked.
//
// Tiling: a 128x64 output tile per block of 8 warps (4 along M, 2 along
// N), each warp 32x32 = 2x2 WMMA 16x16x16 bf16 fragments with f32
// accumulators; K advances 32 at a time through shared memory. wgmma, TMA
// and multi-stage pipelining are left to a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int LDS = BK + 16;  // bf16 row stride of the smem tiles: 96 bytes keeps WMMA pointers 32-byte aligned
constexpr int LDC = BN + 4;   // f32 row stride of the epilogue tile
constexpr int THREADS = 256;

// shared memory: the x and w tiles during the K loop, then the f32 output
// tile of the epilogue in the same bytes
constexpr int TILE_BYTES = (BM + BN) * LDS * 2;
constexpr int EPI_BYTES = BM * LDC * 4;
constexpr int SMEM_BYTES = TILE_BYTES > EPI_BYTES ? TILE_BYTES : EPI_BYTES;

__global__ void __launch_bounds__(THREADS)
matmul_bias_act_kernel(const __nv_bfloat16* __restrict__ x,  // (M, K)
                       const __nv_bfloat16* __restrict__ w,  // (N, K)
                       const float* __restrict__ bias,       // (N,)
                       __nv_bfloat16* __restrict__ y,        // (M, N)
                       int M, int N, int K, int act, int vec) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* a_tile = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* b_tile = a_tile + BM * LDS;
  float* c_tile = reinterpret_cast<float*>(smem);
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32;
  const int wm = warp % 4;  // 32-row slice of the tile
  const int wn = warp / 4;  // 32-column slice of the tile

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // which of this warp's two 16-column fragments hold real output columns
  const bool n_live[2] = {n0 + wn * 32 < N, n0 + wn * 32 + 16 < N};
  const bool m_live[2] = {m0 + wm * 32 < M, m0 + wm * 32 + 16 < M};

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: BM rows x BK columns = 512 chunks of 8
    for (int i = threadIdx.x; i < BM * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), v = i % (BK / 8);
      const int m = m0 + r, k = k0 + v * 8;
      const int valid = (m < M) ? min(8, K - k) : 0;
      load8(a_tile + r * LDS + v * 8, x + (size_t)m * K + k, valid, vec);
    }
    // w tile: BN rows (output channels) x BK columns = 256 chunks of 8
    for (int i = threadIdx.x; i < BN * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), v = i % (BK / 8);
      const int n = n0 + r, k = k0 + v * 8;
      const int valid = (n < N) ? min(8, K - k) : 0;
      load8(b_tile + r * LDS + v * 8, w + (size_t)n * K + k, valid, vec);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (m_live[i])
          wmma::load_matrix_sync(af[i], a_tile + (wm * 32 + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (n_live[j])
          wmma::load_matrix_sync(bf[j], b_tile + (wn * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (m_live[i] && n_live[j]) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: accumulators -> smem (the tiles are dead after the last sync)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (m_live[i] && n_live[j])
        wmma::store_matrix_sync(c_tile + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                                acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N)
      y[(size_t)m * N + n] = __float2bfloat16(activate(c_tile[r * LDC + c] + bias[n], act));
  }
}

}  // namespace

extern "C" {

// act: 0 none, 1 silu, 2 relu. vec: 1 when K % 8 == 0 and x, w are 16-byte
// aligned (16-byte loads), else 0. Launches on `stream`, which must belong
// to the current device. Returns cudaGetLastError() after the launch.
int matmul_bias_act_bf16(const void* x, const void* w, const void* bias, void* y,
                         int M, int N, int K, int act, int vec, void* stream) {
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  matmul_bias_act_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)bias,
      (__nv_bfloat16*)y, M, N, K, act, vec);
  return (int)cudaGetLastError();
}

const char* matmul_bias_act_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
