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
