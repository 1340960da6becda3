// The grid-stride warp layout of the first-version kernels kept in this
// directory for side-by-side timing (one warp per row or per edge).
#pragma once

#include "../common.cuh"

namespace svt {

constexpr int kWarpsPerBlock = kBlockThreads / kWarp;

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
