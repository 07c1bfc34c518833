// Implicit-GEMM mainloop for Hopper (sm_90a) shared by the port's
// kernels: y = act(A @ W^T + bias) with one bf16 store, for bf16 operands
// (f32 accumulation) and for int8 operands (exact int32 accumulation, then
// y = act(float(acc) * scale + bias) in f32).
//
// Through its bf16 instantiations it replaces both TPU kernels of the JAX
// package:
//   TAPS = 9: vision_conglomerate_tpu/ops/conv_pallas.py:conv3x3_bias_act
//             (csrc/conv3x3_bias_act.cu). A row of A is one output pixel,
//             K = 9 * Cin walked tap by tap, gathered from the NHWC input.
//   TAPS = 1: vision_conglomerate_tpu/ops/fused_matmul.py:matmul_bias_act
//             (csrc/matmul_bias_act.cu). A is the plain (M, K) matrix.
// Its int8 instantiations (csrc/conv3x3_s8_bias_act.cu,
// csrc/matmul_s8_bias_act.cu) are the port's int8 post-training-quantized
// convs, which the JAX package runs as XLA int8 convs (nn/quantize.py).
// W is the (N, K) row-major weight matrix in all of them.
//
// What bounds it at the detector's serve shapes (batch 4, 640^2): the 3x3
// convs carry 105.7 GFLOP at 144..2800 FLOPs per byte and are bound by the
// tensor cores; the 1x1 convs move 172 MB for 11.3 GFLOP and are bound by
// bytes. What keeps a kernel off those bounds at these shapes: memory
// latency exposed on each K step, a tensor-core instruction below Hopper's
// rate, and too few blocks at the 20^2 and 40^2 maps (M = 1600 and 6400).
//
// Design.
// - Ring: shared-memory stages of one 128-byte row of K (BK = 64 bf16 or
//   128 int8 values) for A (BM rows) and W (BN rows), as many as fit
//   SMEM_BUDGET (3..8), so that two blocks share an SM; three stages and
//   three blocks for the matmul's K of at most two rows. The
//   copies of the next STAGES - 2 K tiles (two or more in the deep rings)
//   are in flight while wgmma runs on the current one and the one before
//   it drains; one __syncthreads per K tile.
// - Copies: W (and the matmul's A) by TMA, one thread per stage, completing
//   on the stage's mbarrier, zero-filled past N, M and K. The conv's A is
//   gathered with 16-byte cp.async copies from the pixel each row needs at
//   this tap, zero-filled (src-size 0) outside the image and past M; each
//   input element is re-read once per tap from L2. The block's biases (and
//   int8 scales) come with the first K tile.
// - Layout: each stage tile is K-major with the 128-byte swizzle (rows of
//   128 bytes, 16-byte chunk j of row r at j ^ (r % 8)): what TMA's
//   SWIZZLE_128B writes, what the gather writes by hand, and what wgmma's
//   shared-memory descriptor reads.
// - wgmma.mma_async m64nBNk16 (bf16 -> f32) or m64nBNk32 (s8 -> s32), four
//   a stage, A and W from shared memory; each warpgroup of the block owns
//   64 rows and all BN columns. The s32 accumulators have the f32 ones'
//   fragment layout.
// - Register epilogue: bias (int8: float(acc) * scale + bias, multiply and
//   add each rounded on its own, as the plain version computes them) and
//   SiLU/ReLU in f32, one rounding to bf16, a bf16 staging tile in the
//   freed ring, then 16-byte coalesced stores masked at the ragged M and N
//   edges.
// - Tiles: chosen per launch by choose_tile (see there).
// - Where K or Cin is not a multiple of the values in 16 bytes (8 bf16, 16
//   int8), or a pointer is not 16-byte aligned, neither TMA nor 16-byte
//   copies apply: the same ring is filled with element loads and shared
//   stores.
// - Indexing: the pixel row m, M, N, K and the TMA coordinates are 32-bit;
//   element offsets into x and y are 64-bit, so the conv's input and
//   output may hold 2^31 elements or more (TrackNet's full-resolution
//   256-channel conv at batch 64 writes 3.7e9).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace igemm {

constexpr int ROW_BYTES = 128;  // a stage row: one 128-byte swizzle row of K
constexpr int SMEM_BUDGET = 100 * 1024;  // ring bytes a block may take: two blocks per SM

// The ring of a BM x BN tile: as many stages as fit the budget (3..MAX).
// LOOKAHEAD tiles are copied ahead; one more stage is still read by wgmma.
// Past the ring: one mbarrier per stage, then the block's BN biases and
// (int8) BN scales.
template <int BM, int BN, int MAX>
struct Ring {
  static constexpr int STAGE_BYTES = (BM + BN) * ROW_BYTES;
  static constexpr int FIT = SMEM_BUDGET / STAGE_BYTES;
  static constexpr int STAGES = FIT < 3 ? 3 : FIT > MAX ? MAX : FIT;
  static constexpr int LOOKAHEAD = STAGES - 2;
  static constexpr int BARS = STAGES * STAGE_BYTES;
  static constexpr int BIAS = BARS + 8 * STAGES;
  static constexpr int SCALE = BIAS + 4 * BN;
  static constexpr int SMEM = SCALE + 4 * BN + 1024;  // + slack to align the ring to 1024
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk j of row r in a K-major tile with the
// 128-byte swizzle.
__device__ __forceinline__ uint32_t swizzle128(int r, int j) {
  return r * ROW_BYTES + ((j ^ (r & 7)) << 4);
}

// 16 bytes global -> shared, bypassing L1; zeros when !ok (src-size 0
// reads nothing).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

// 4 bytes global -> shared; zero when !ok.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

// Shared-memory writes of this thread (cp.async or st.shared) become
// visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait for the completion of the mbarrier's phase of this parity. A copy
// that never lands traps (a launch error) after about 10 s instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

// TMA: the box at (column c0, row c1) of the 2D tensor `map` into shared
// memory at dst, completing `bytes` on mbarrier bar.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major, 128-byte-swizzled tile at `addr` (groups
// of 8 rows 1024-byte aligned; +32 bytes steps K by 16 inside the row).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)        // start address, 16-byte units
         | (uint64_t)1 << 16                        // leading byte offset: unused when K-major and swizzled
         | (uint64_t)(8 * ROW_BYTES >> 4) << 32     // stride byte offset: 8 rows of 128 bytes
         | (uint64_t)1 << 62;                       // layout: 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma.
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// What a 16-byte chunk of each operand type holds and how wgmma takes it.
template <typename T>
struct Operand;

template <>
struct Operand<__nv_bfloat16> {
  using Acc = float;
  static constexpr int VALS = 8;  // values in 16 bytes
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  using Bits = unsigned short;
  __device__ __forceinline__ static __nv_bfloat16 zero() { return __float2bfloat16(0.0f); }
  __device__ __forceinline__ static Bits bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
};

template <>
struct Operand<int8_t> {
  using Acc = int;
  static constexpr int VALS = 16;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  using Bits = unsigned char;
  __device__ __forceinline__ static int8_t zero() { return 0; }
  __device__ __forceinline__ static Bits bits(int8_t v) { return (unsigned char)v; }
};

// The f32 value the epilogue activates: the bf16 path's accumulator plus
// the bias; the int8 path's exact sum times the scale, plus the bias, each
// rounded on its own (no fused multiply-add), as the plain version does.
__device__ __forceinline__ float dequant(float acc, float, float b) { return acc + b; }
__device__ __forceinline__ float dequant(int acc, float s, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
}

#define IGEMM_F8(i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define IGEMM_I8(i)                                                                   \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),         \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define IGEMM_R16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define IGEMM_R32 IGEMM_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define IGEMM_R64 IGEMM_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63"

// d (64 x N, N / 2 registers a thread) += A (64 x 32 bytes of K) *
// B (32 bytes of K x N), both K-major in shared memory: k16 for bf16 into
// f32, k32 for s8 into s32.
template <typename T, int N>
struct Wgmma;

template <>
struct Wgmma<__nv_bfloat16, 32> {
  __device__ __forceinline__ static void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" IGEMM_R16
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : IGEMM_F8(0), IGEMM_F8(8)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<__nv_bfloat16, 64> {
  __device__ __forceinline__ static void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" IGEMM_R32
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : IGEMM_F8(0), IGEMM_F8(8), IGEMM_F8(16), IGEMM_F8(24)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<__nv_bfloat16, 128> {
  __device__ __forceinline__ static void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" IGEMM_R64
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : IGEMM_F8(0), IGEMM_F8(8), IGEMM_F8(16), IGEMM_F8(24),
          IGEMM_F8(32), IGEMM_F8(40), IGEMM_F8(48), IGEMM_F8(56)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<int8_t, 32> {
  __device__ __forceinline__ static void mma(int* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {" IGEMM_R16
        "}, %16, %17, p;\n}\n"
        : IGEMM_I8(0), IGEMM_I8(8)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<int8_t, 64> {
  __device__ __forceinline__ static void mma(int* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {" IGEMM_R32
        "}, %32, %33, p;\n}\n"
        : IGEMM_I8(0), IGEMM_I8(8), IGEMM_I8(16), IGEMM_I8(24)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<int8_t, 128> {
  __device__ __forceinline__ static void mma(int* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" IGEMM_R64
        "}, %64, %65, p;\n}\n"
        : IGEMM_I8(0), IGEMM_I8(8), IGEMM_I8(16), IGEMM_I8(24),
          IGEMM_I8(32), IGEMM_I8(40), IGEMM_I8(48), IGEMM_I8(56)
        : "l"(a), "l"(b), "r"(1));
  }
};

#undef IGEMM_F8
#undef IGEMM_I8
#undef IGEMM_R16
#undef IGEMM_R32
#undef IGEMM_R64

// One launch's operands, T the operand type (bf16 or int8).
// x: TAPS 9, the NHWC input (B, H, W, C) with M = B*H*W and K = 9*C;
//    TAPS 1, the (M, K) matrix, with H = W = 1 and C = K.
// w (N, K) row-major, bias f32 (N,), scale f32 (N,) (int8 only: the
// dequantizing factor of each output channel), y bf16 (M, N).
// act: 0 none, 1 silu, 2 relu.
// vec: K and C multiples of the values in 16 bytes and x, w 16-byte
//      aligned, so W (and the matmul's A) come by TMA and the conv's A by
//      16-byte copies.
// vec_out: N a multiple of 8 and y 16-byte aligned (16-byte stores).
template <typename T>
struct Params {
  const T* x;
  const T* w;
  const float* bias;
  const float* scale;
  __nv_bfloat16* y;
  int M, N, K, H, W, C, act, vec, vec_out;
};

// w_map: W in boxes of BN rows x 128 bytes; x_map (TAPS 1): A in boxes of
// BM rows x 128 bytes; both with the 128-byte swizzle. Unused unless vec.
// MAX: the most ring stages. SHALLOW (3) serves K of at most two stage
// rows, where one or two K tiles leave a block little to overlap: three
// blocks then share an SM.
constexpr int DEEP = 8, SHALLOW = 3;

template <typename T, int TAPS, int BM, int BN, int MAX>
__global__ void __launch_bounds__(2 * BM, MAX == SHALLOW ? 3 : 1)
bias_act_kernel(const Params<T> p, const __grid_constant__ CUtensorMap w_map,
                const __grid_constant__ CUtensorMap x_map) {
  using Acc = typename Operand<T>::Acc;
  constexpr int VALS = Operand<T>::VALS;   // values of K in a 16-byte chunk
  constexpr int BK = 8 * VALS;             // values of K in a stage row
  constexpr int THREADS = 2 * BM;            // BM / 64 warpgroups
  constexpr int ROW_STEP = THREADS / 8;      // rows one pass of the block copies (8 chunks a row)
  constexpr int A_ROWS = BM / ROW_STEP;      // A rows each thread copies (4)
  constexpr int B_ROWS = BN / ROW_STEP;      // W rows each thread copies (element path)
  constexpr int A_BYTES = BM * ROW_BYTES;
  constexpr int STAGE_BYTES = Ring<BM, BN, MAX>::STAGE_BYTES;
  constexpr int STAGES = Ring<BM, BN, MAX>::STAGES;
  constexpr int LOOKAHEAD = Ring<BM, BN, MAX>::LOOKAHEAD;
  constexpr int TMA_BYTES = (TAPS == 1 ? A_BYTES : 0) + BN * ROW_BYTES;
  constexpr bool INT8 = VALS == 16;
  static_assert(BM % 64 == 0 && BN % ROW_STEP == 0, "tile");

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // swizzle atoms are 1024-byte aligned
  const uint32_t bars = ring + Ring<BM, BN, MAX>::BARS;
  unsigned char* smem = smem_raw + (ring - raw);
  const float* bias = reinterpret_cast<const float*>(smem + Ring<BM, BN, MAX>::BIAS);
  const float* scale = reinterpret_cast<const float*>(smem + Ring<BM, BN, MAX>::SCALE);

  const T* __restrict__ x = p.x;
  const T* __restrict__ w = p.w;
  const int M = p.M, N = p.N, K = p.K, H = p.H, W = p.W, C = p.C;
  const int tid = threadIdx.x, j = tid & 7, r0 = tid >> 3, wg = tid >> 7;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const T zero = Operand<T>::zero();

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (p.vec) {
      asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&w_map)) : "memory");
      if constexpr (TAPS == 1)
        asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&x_map)) : "memory");
    }
  }
  // The biases (and scales) ride with K tile 0's copies, off the
  // epilogue's path.
  if (tid < BN) {
    const bool ok = n0 + tid < N;
    cp_async4(smem_addr(bias + tid), p.bias + (ok ? n0 + tid : 0), ok);
    if constexpr (INT8) cp_async4(smem_addr(scale + tid), p.scale + (ok ? n0 + tid : 0), ok);
  }
  __syncthreads();

  // This thread's A rows: flat pixel index and its (row, column) in the image.
  int pix[A_ROWS], py[A_ROWS], px[A_ROWS];
#pragma unroll
  for (int i = 0; i < A_ROWS; ++i) {
    const int m = m0 + r0 + i * ROW_STEP;
    const int hw = TAPS == 1 ? 0 : m % (H * W);
    pix[i] = m < M ? m : 0;
    py[i] = m < M ? hw / W : -H - 2;  // a row past M is outside the image at every tap
    px[i] = TAPS == 1 ? 0 : hw % W;
  }

  // Element (row i, k) of A, zero outside the image and past K.
  auto a_elem = [&](int i, int k) -> T {
    if (k >= K) return zero;
    int dy = 0, dx = 0, c = k;
    if constexpr (TAPS == 9) {
      const int tap = k / C;
      c = k - tap * C;
      dy = tap / 3 - 1;
      dx = tap % 3 - 1;
    }
    if ((unsigned)(py[i] + dy) >= (unsigned)H || (unsigned)(px[i] + dx) >= (unsigned)W) return zero;
    return x[((long long)pix[i] + dy * W + dx) * C + c];
  };

  // Copy K tile kt of A and W into ring stage `stage`.
  auto load_tile = [&](int kt, int stage) {
    const uint32_t sa = ring + stage * STAGE_BYTES, sb = sa + A_BYTES;
    const int k = kt * BK + VALS * j;
    if (p.vec) {
      if (tid == 0) {
        mbar_expect_tx(bars + 8 * stage, TMA_BYTES);
        tma_load_2d(sb, &w_map, kt * BK, n0, bars + 8 * stage);
        if constexpr (TAPS == 1) tma_load_2d(sa, &x_map, kt * BK, m0, bars + 8 * stage);
      }
      if constexpr (TAPS == 9) {  // C % VALS == 0: the values of a chunk share one tap
        const int tap = k / C, c = k - tap * C;
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
        const int shift = (dy * W + dx) * C + c;
#pragma unroll
        for (int i = 0; i < A_ROWS; ++i) {
          const bool ok = k < K && (unsigned)(py[i] + dy) < (unsigned)H &&
                          (unsigned)(px[i] + dx) < (unsigned)W;
          cp_async16(sa + swizzle128(r0 + i * ROW_STEP, j),
                     x + (ok ? (long long)pix[i] * C + shift : 0), ok);
        }
      }
    } else {
      union { uint4 u; typename Operand<T>::Bits h[VALS]; } v;
#pragma unroll
      for (int i = 0; i < A_ROWS; ++i) {
#pragma unroll
        for (int q = 0; q < VALS; ++q) v.h[q] = Operand<T>::bits(a_elem(i, k + q));
        st_shared16(sa + swizzle128(r0 + i * ROW_STEP, j), v.u);
      }
#pragma unroll
      for (int i = 0; i < B_ROWS; ++i) {
        const int n = n0 + r0 + i * ROW_STEP;
#pragma unroll
        for (int q = 0; q < VALS; ++q)
          v.h[q] = Operand<T>::bits(n < N && k + q < K ? w[(size_t)n * K + k + q] : zero);
        st_shared16(sb + swizzle128(r0 + i * ROW_STEP, j), v.u);
      }
    }
  };

  Acc acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  const int k_tiles = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < LOOKAHEAD; ++s) {
    if (s < k_tiles) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    // Tile kt's copies from this thread have landed; after the barrier,
    // everyone's have, and every warpgroup has retired wgmma kt - 2, whose
    // stage is refilled next. The TMA part lands on the stage's mbarrier.
    const int stage = kt % STAGES;
    cp_async_wait<LOOKAHEAD - 1>();
    fence_async_shared();
    __syncthreads();
    if (kt + LOOKAHEAD < k_tiles) load_tile(kt + LOOKAHEAD, (kt + LOOKAHEAD) % STAGES);
    cp_async_commit();
    if (p.vec) mbar_wait(bars + 8 * stage, (kt / STAGES) & 1);

    const uint32_t sa = ring + stage * STAGE_BYTES + wg * 64 * ROW_BYTES;
    const uint32_t sb = ring + stage * STAGE_BYTES + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 32 bytes of K each
      Wgmma<T, BN>::mma(acc, sw128_desc(sa + 32 * kk), sw128_desc(sb + 32 * kk));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs<BN / 2>(acc);
  }
  wgmma_wait<0>();
  fence_regs<BN / 2>(acc);
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the bf16 staging tile reuses it

  // Accumulator layout of m64nNk16 (and of m64nNk32 for s8): lane l of
  // warp q (of its warpgroup) holds rows 16q + l/4 and that + 8, columns
  // 8i + 2(l%4) and + 1.
  constexpr int LDT = BN + 8;  // bf16 row stride: +16 bytes spreads the rows over the banks
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
  const int lane = tid & 31;
  const int row = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = 8 * i + 2 * (lane & 3);
    const float b0 = bias[col], b1 = bias[col + 1];
    const float s0 = INT8 ? scale[col] : 1.0f, s1 = INT8 ? scale[col + 1] : 1.0f;
    *reinterpret_cast<__nv_bfloat162*>(tile + row * LDT + col) = __floats2bfloat162_rn(
        activate(dequant(acc[4 * i], s0, b0), p.act),
        activate(dequant(acc[4 * i + 1], s1, b1), p.act));
    *reinterpret_cast<__nv_bfloat162*>(tile + (row + 8) * LDT + col) = __floats2bfloat162_rn(
        activate(dequant(acc[4 * i + 2], s0, b0), p.act),
        activate(dequant(acc[4 * i + 3], s1, b1), p.act));
  }
  __syncthreads();
  constexpr int CHUNKS = BN / 8;
  for (int idx = tid; idx < BM * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS, c8 = (idx % CHUNKS) * 8;
    const int m = m0 + r, n = n0 + c8;
    if (m >= M || n >= N) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(tile + r * LDT + c8);
    __nv_bfloat16* dst = p.y + (size_t)m * N + n;
    if (p.vec_out && n + 8 <= N) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
      for (int q = 0; q < 8 && n + q < N; ++q) dst[q] = e[q];
    }
  }
}

struct Tile {
  int bm, bn;
};

// The output tile of an M x N x K launch on a card of `sms` SMs (K in
// values; the int8 kernels take the bf16 choice as it is).
// - Deep K (>= 2048, the 3x3 convs from 256 input channels): 64 x 128 when
//   that gives at least 3/4 of a block per SM. One warpgroup on the widest
//   wgmma here, two blocks per SM, did best at 20^2..80^2 (PERF.md).
// - Else 128 x BN when that gives every SM a block, with BN = 32 for
//   N <= 32 and 64 above (a 128-row A tile re-read per 64 columns costs
//   the bytes-bound 1x1 convs less than narrow rows do), and otherwise
//   64 x BN, the most blocks: at batch 4, the 20^2 and 40^2 maps (M = 1600
//   and 6400) fill the card only so.
inline Tile choose_tile(int M, int N, int K, int sms) {
  const auto blocks = [&](Tile t) {
    return (long long)((M + t.bm - 1) / t.bm) * ((N + t.bn - 1) / t.bn);
  };
  if (N > 64 && K >= 2048 && 4 * blocks({64, 128}) >= 3LL * sms) return {64, 128};
  const int bn = N <= 32 ? 32 : 64;
  return blocks({128, bn}) >= sms ? Tile{128, bn} : Tile{64, bn};
}

inline PFN_cuTensorMapEncodeTiled encode_tiled = nullptr;

template <typename T, int TAPS, int BM, int BN, int MAX>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(bias_act_kernel<T, TAPS, BM, BN, MAX>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<BM, BN, MAX>::SMEM);
}

// Once per device: find the driver's tensor-map encoder (through the
// runtime, so the build links no driver library) and allow each tile's
// dynamic shared memory.
template <int TAPS, typename T = __nv_bfloat16>
int init() {
  if (encode_tiled == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return (int)e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorSymbolNotFound;
    encode_tiled = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }
  const cudaError_t deep[] = {
      set_smem<T, TAPS, 64, 128, DEEP>(), set_smem<T, TAPS, 128, 64, DEEP>(),
      set_smem<T, TAPS, 64, 64, DEEP>(), set_smem<T, TAPS, 128, 32, DEEP>(),
      set_smem<T, TAPS, 64, 32, DEEP>()};
  for (cudaError_t e : deep)
    if (e != cudaSuccess) return (int)e;
  if constexpr (TAPS == 1) {
    const cudaError_t shallow[] = {
        set_smem<T, 1, 128, 64, SHALLOW>(), set_smem<T, 1, 64, 64, SHALLOW>(),
        set_smem<T, 1, 128, 32, SHALLOW>(), set_smem<T, 1, 64, 32, SHALLOW>()};
    for (cudaError_t e : shallow)
      if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// The (rows, cols) row-major matrix of T at ptr in boxes of box_rows x
// 128 bytes with the 128-byte swizzle; zero fill outside.
template <typename T>
inline bool encode(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(ROW_BYTES / sizeof(T)), (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode_tiled(map, Operand<T>::TMA_TYPE, 2, const_cast<void*>(ptr), dims,
                      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int TAPS, int BM, int BN, int MAX>
int launch_tile(const Params<T>& p, cudaStream_t stream) {
  CUtensorMap w_map{}, x_map{};
  if (p.vec && (!encode<T>(&w_map, p.w, p.N, p.K, BN) ||
                (TAPS == 1 && !encode<T>(&x_map, p.x, p.M, p.K, BM))))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN);
  bias_act_kernel<T, TAPS, BM, BN, MAX><<<grid, 2 * BM, Ring<BM, BN, MAX>::SMEM, stream>>>(
      p, w_map, x_map);
  return (int)cudaGetLastError();
}

// The shallow ring serves the matmul's launches with at most two stage
// rows of K (64 x 128 tiles come only with K >= 2048); every 3x3 conv on
// the serve path has K >= 288.
template <typename T, int TAPS, int BM, int BN>
int launch_ring(const Params<T>& p, cudaStream_t stream) {
  constexpr int BK = 8 * Operand<T>::VALS;
  if constexpr (TAPS == 1 && !(BM == 64 && BN == 128))
    if (p.K <= 2 * BK) return launch_tile<T, TAPS, BM, BN, SHALLOW>(p, stream);
  return launch_tile<T, TAPS, BM, BN, DEEP>(p, stream);
}

inline bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

// Launch on `stream` (of the current device); returns a CUDA error code:
// cudaGetLastError() after the launch, or cudaErrorInvalidValue if a
// tensor map could not be made. `scale` is read by the int8 kernels only.
template <int TAPS, typename T = __nv_bfloat16>
int launch(const void* x, const void* w, const void* bias, void* y, int M, int N, int K, int H,
           int W, int C, int act, int sms, void* stream, const void* scale = nullptr) {
  constexpr int VALS = Operand<T>::VALS;
  const Params<T> p{static_cast<const T*>(x), static_cast<const T*>(w),
                    static_cast<const float*>(bias), static_cast<const float*>(scale),
                    static_cast<__nv_bfloat16*>(y), M, N, K, H, W, C, act,
                    K % VALS == 0 && C % VALS == 0 && aligned16(x) && aligned16(w),
                    N % 8 == 0 && aligned16(y)};
  const auto s = static_cast<cudaStream_t>(stream);
  const Tile t = choose_tile(M, N, K, sms);
  if (t.bm == 64 && t.bn == 128) return launch_ring<T, TAPS, 64, 128>(p, s);
  if (t.bm == 128 && t.bn == 64) return launch_ring<T, TAPS, 128, 64>(p, s);
  if (t.bm == 64 && t.bn == 64) return launch_ring<T, TAPS, 64, 64>(p, s);
  if (t.bm == 128) return launch_ring<T, TAPS, 128, 32>(p, s);
  return launch_ring<T, TAPS, 64, 32>(p, s);
}

}  // namespace igemm
