// Device helpers shared by the port's kernels.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

// act: 0 none, 1 silu, 2 relu (the wrappers' ACTIVATIONS codes).
__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return v / (1.0f + __expf(-v));  // silu
  if (act == 2) return fmaxf(v, 0.0f);           // relu
  return v;
}

// Copy 8 consecutive bf16 (16 bytes); elements past `valid` are zero.
// `vec` allows one 16-byte load when all 8 are valid.
__device__ __forceinline__ void load8(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                      int valid, bool vec) {
  if (valid >= 8 && vec) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.0f);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[e] = e < valid ? src[e] : zero;
  }
}
