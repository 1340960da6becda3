// Shared helpers of the svinet_torch kernels: warp reductions and the
// grid-stride warp layout every kernel here uses (one warp per row or per
// edge, 64-bit indices throughout).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace svt {

constexpr int kWarp = 32;
constexpr int kBlockThreads = 256;            // 8 warps per block
constexpr int kWarpsPerBlock = kBlockThreads / kWarp;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Global warp index and warp count of a grid-stride loop.
__device__ __forceinline__ int64_t warp_id() {
  return (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
}
__device__ __forceinline__ int64_t warp_count() {
  return static_cast<int64_t>(gridDim.x) * blockDim.x / kWarp;
}

// Blocks for `items` warp-sized work items: one warp each, capped so the
// grid stays a small multiple of what 132 SMs hold resident (the loops
// stride over the rest).
inline unsigned grid_for(int64_t items) {
  const int64_t cap = 132 * 64;
  int64_t blocks = (items + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks < cap ? blocks : cap);
}

}  // namespace svt
