// Shared helpers of the svinet_torch kernels: the row-in-registers layout
// both kernels use for K <= 512, its dispatch on K, and warp reductions.
//
// Row layout <VEC, G, N>. A row of K floats is owned by a group of G lanes
// (G a power of two up to 32; 32/G rows share a warp, so a narrow row
// does not leave most of a warp idle). The row is cut into units of VEC
// floats: VEC = 4 (one 16-byte load or store) when K % 4 == 0, else
// VEC = 1. Lane g of the group holds units g, g+G, ..., g+(N-1)G, i.e.
// columns (g + jG)*VEC .. +VEC-1, so the G lanes of one j touch G*VEC
// consecutive floats. N is the next power of two that covers the row:
// G*N*VEC >= K. Units past the row are filled with a neutral value and
// never stored. 64-bit offsets throughout: n*K passes 2^31 elements for
// n above 4.3M at K=500.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace svt {

constexpr int kWarp = 32;
constexpr int kBlockThreads = 256;  // 8 warps per block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRegMaxK = 512;       // widest row held in registers

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The lanes of this lane's group of G, as a shuffle mask. Groups of one
// warp may sit in different loop iterations, so each shuffles under its
// own mask.
template <int G>
__device__ __forceinline__ unsigned group_mask(int lane) {
  if constexpr (G == kWarp) return kFull;
  return ((1u << (G % kWarp)) - 1u) << (lane & ~(G - 1));
}

template <int G>
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off);
  return v;
}

template <int G>
__device__ __forceinline__ float group_max(float v, unsigned mask) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(mask, v, off));
  return v;
}

template <int VEC>
__device__ __forceinline__ void load_unit(const float* src, float* dst) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(src));
    dst[0] = t.x;
    dst[1] = t.y;
    dst[2] = t.z;
    dst[3] = t.w;
  } else {
    dst[0] = __ldg(src);
  }
}

template <int VEC>
__device__ __forceinline__ void store_unit(float* dst, const float* src) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(dst) =
        make_float4(src[0], src[1], src[2], src[3]);
  else
    dst[0] = src[0];
}

// This lane's part of `row` (K floats) into registers; `g` is the lane's
// index in its group. Units past the row get `fill`.
template <int VEC, int G, int N>
__device__ __forceinline__ void load_row(const float* row, int k, int g,
                                         float fill, float (&dst)[VEC * N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = (g + j * G) * VEC;
    if (c < k) {
      load_unit<VEC>(row + c, dst + j * VEC);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) dst[j * VEC + v] = fill;
    }
  }
}

template <int VEC, int G, int N>
__device__ __forceinline__ void store_row(float* row, int k, int g,
                                          const float (&src)[VEC * N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = (g + j * G) * VEC;
    if (c < k) store_unit<VEC>(row + c, src + j * VEC);
  }
}

// Blocks of kBlockThreads for `items` rows at G lanes each.
inline unsigned blocks_for(int64_t items, int g) {
  const int64_t per_block = kBlockThreads / g;
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

// Call f(VEC, G, N) as integral constants for the layout of a K-float row,
// 1 <= K <= kRegMaxK. `aligned` says whether every row starts on a
// 16-byte boundary (the base pointers do and K % 4 == 0).
template <class F>
inline void dispatch_row(int k, bool aligned, F&& f) {
  using std::integral_constant;
#define SVT_ROW(VEC, G, N)                                   \
  f(integral_constant<int, VEC>{}, integral_constant<int, G>{}, \
    integral_constant<int, N>{})
  const int units = aligned ? k / 4 : k;
  if (aligned) {
    if (units <= 1) SVT_ROW(4, 1, 1);
    else if (units <= 2) SVT_ROW(4, 2, 1);
    else if (units <= 4) SVT_ROW(4, 4, 1);
    else if (units <= 8) SVT_ROW(4, 8, 1);
    else if (units <= 16) SVT_ROW(4, 16, 1);
    else if (units <= 32) SVT_ROW(4, 32, 1);
    else if (units <= 64) SVT_ROW(4, 32, 2);
    else SVT_ROW(4, 32, 4);
  } else {
    if (units <= 1) SVT_ROW(1, 1, 1);
    else if (units <= 2) SVT_ROW(1, 2, 1);
    else if (units <= 4) SVT_ROW(1, 4, 1);
    else if (units <= 8) SVT_ROW(1, 8, 1);
    else if (units <= 16) SVT_ROW(1, 16, 1);
    else if (units <= 32) SVT_ROW(1, 32, 1);
    else if (units <= 64) SVT_ROW(1, 32, 2);
    else if (units <= 128) SVT_ROW(1, 32, 4);
    else if (units <= 256) SVT_ROW(1, 32, 8);
    else SVT_ROW(1, 32, 16);
  }
#undef SVT_ROW
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace svt
