// NOT PART OF THE LIBRARY. The top-W form of kernel 1 as first designed
// (W rounds of a group arg-max over 64-bit keys, four sorted keys a lane,
// refilled when used up), kept so that
// svinet_torch/tools/bench_kernels.py --only sparse can time it beside the
// present form in csrc/dirichlet_expectation.cu in one run on one card.
// It writes Elogpi as a contiguous (rows, K) array and no topm; the
// digamma is the library's (csrc/dirichlet_expectation.cu).
#include <climits>

#include "../common.cuh"

namespace {

// rcp.approx.ftz.f32: at most one ulp of relative error, one instruction
__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// psi(x) + 1/x: every term of digamma but the unbounded one.
__device__ __forceinline__ float digamma_bounded(float x) {
  const float p12 = fmaf(2.0f, x, 3.0f) *
                    rcp_approx(fmaf(x, x + 3.0f, 2.0f));
  const float p34 = fmaf(2.0f, x, 7.0f) *
                    rcp_approx(fmaf(x, x + 7.0f, 12.0f));
  const float y = x + 5.0f;
  const float inv = rcp_approx(y);
  const float inv2 = inv * inv;
  const float series =
      logf(y) - 0.5f * inv -
      inv2 * (1.0f / 12.0f - inv2 * (1.0f / 120.0f - inv2 * (1.0f / 252.0f)));
  return series - (p12 + p34);
}

__device__ __forceinline__ float digamma_f(float x) {
  return digamma_bounded(x) - __frcp_rn(x);
}

// psi(x) - ds with the bounded terms first and 1/x last, so that only one
// rounding happens at the magnitude of the result (217 at x = 5e-3).
__device__ __forceinline__ float expectation_f(float x, float ds) {
  return (digamma_bounded(x) - ds) - __frcp_rn(x);
}

// The top-W selection. A column's key is its gamma's bits above the
// column's complement: gamma > 0, so keys order as (value first, lower
// column first among equal values), jax.lax.top_k's order, and no two
// keys are equal. Each lane keeps, sorted, the kBuf largest of its own
// keys below its last pick; a round takes the group's largest head, and
// only the lane that held it pops its buffer (and scans its columns again
// once the buffer is empty).
constexpr int kBuf = 4;

__device__ __forceinline__ uint64_t column_key(float v, int c) {
  return (static_cast<uint64_t>(__float_as_uint(v)) << 32) |
         (0xffffffffu - static_cast<uint32_t>(c));
}

// Offer `key` to the sorted buffer (largest first); 0 is an empty slot.
__device__ __forceinline__ void buffer_insert(uint64_t (&buf)[kBuf],
                                              uint64_t key) {
  if (key <= buf[kBuf - 1]) return;
#pragma unroll
  for (int i = kBuf - 1; i > 0; --i)
    buf[i] = key > buf[i - 1] ? buf[i - 1] : (key > buf[i] ? key : buf[i]);
  buf[0] = key > buf[0] ? key : buf[0];
}

__device__ __forceinline__ void buffer_pop(uint64_t (&buf)[kBuf]) {
#pragma unroll
  for (int i = 0; i + 1 < kBuf; ++i) buf[i] = buf[i + 1];
  buf[kBuf - 1] = 0;
}

template <int G>
__device__ __forceinline__ uint64_t group_max_key(uint64_t key,
                                                  unsigned mask) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const uint64_t other = __shfl_xor_sync(mask, key, off);
    key = other > key ? other : key;
  }
  return key;
}

// W rounds over the group's buffers; `refill(below)` fills this lane's
// empty buffer with its largest keys below `below`. Lane 0 of the group
// writes the picked columns to id_row.
template <int G, class Refill>
__device__ __forceinline__ void select_top(uint64_t (&buf)[kBuf], int w,
                                           unsigned mask, int g,
                                           int32_t* id_row, Refill refill) {
  for (int t = 0; t < w; ++t) {
    const uint64_t best = group_max_key<G>(buf[0], mask);
    if (g == 0)
      id_row[t] = static_cast<int32_t>(0xffffffffu -
                                       static_cast<uint32_t>(best));
    if (buf[0] == best) {
      buffer_pop(buf);
      if (buf[0] == 0) refill(best);
    }
  }
}

// The values at the picked columns, read back from the Elogpi row the
// group wrote (plain loads: __syncwarp orders the group's stores before
// them).
__device__ __forceinline__ void gather_picked(const float* orow,
                                              const int32_t* id_row,
                                              float* val_row, int w, int g,
                                              int group, unsigned mask) {
  __syncwarp(mask);
  for (int t = g; t < w; t += group) val_row[t] = orow[id_row[t]];
}

// The top-W form of dirichlet_rows_kernel (f32 out, rest = 0): Elogpi,
// then ids (rows, w) int32 and topvals (rows, w) f32.
template <int VEC, int G, int N>
__global__ void __launch_bounds__(svt::kBlockThreads)
dirichlet_topw_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int32_t* __restrict__ ids, float* __restrict__ topvals,
                      int64_t rows, int k, int w) {
  constexpr int L = VEC * N;
  const int lane = threadIdx.x % svt::kWarp;
  const int g = lane % G;
  const unsigned mask = svt::group_mask<G>(lane);
  const int64_t r =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  if (r >= rows) return;  // the whole group leaves together
  float v[L], e[L];
  svt::load_row<VEC, G, N>(x + r * k, k, g, 0.0f, v);
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < L; ++i) s += v[i];
  const float ds = digamma_f(svt::group_sum<G>(s, mask));
#pragma unroll
  for (int i = 0; i < L; ++i) e[i] = expectation_f(v[i], ds);
  float* orow = out + r * k;
  svt::store_row<VEC, G, N>(orow, k, g, e);

  uint64_t buf[kBuf];
  auto refill = [&](uint64_t below) {
#pragma unroll
    for (int i = 0; i < kBuf; ++i) buf[i] = 0;
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        const int c = (g + j * G) * VEC + u;
        const uint64_t key = column_key(v[j * VEC + u], c);
        if (c < k && key < below) buffer_insert(buf, key);
      }
  };
  refill(~uint64_t{0});
  int32_t* id_row = ids + r * w;
  select_top<G>(buf, w, mask, g, id_row, refill);
  gather_picked(orow, id_row, topvals + r * w, w, g, G, mask);
}

// K > 512: one warp per row, the row read again from the L1 for each scan.
__global__ void __launch_bounds__(svt::kBlockThreads)
dirichlet_topw_wide_kernel(const float* __restrict__ x,
                           float* __restrict__ out, int32_t* __restrict__ ids,
                           float* __restrict__ topvals, int64_t rows, int k,
                           int w) {
  const int lane = threadIdx.x % svt::kWarp;
  const int64_t r =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) /
      svt::kWarp;
  if (r >= rows) return;
  const float* xr = x + r * k;
  float s = 0.0f;
  for (int c = lane; c < k; c += svt::kWarp) s += xr[c];
  const float ds = digamma_f(svt::warp_sum(s));
  float* orow = out + r * k;
  for (int c = lane; c < k; c += svt::kWarp)
    orow[c] = expectation_f(xr[c], ds);

  uint64_t buf[kBuf];
  auto refill = [&](uint64_t below) {
#pragma unroll
    for (int i = 0; i < kBuf; ++i) buf[i] = 0;
    for (int c = lane; c < k; c += svt::kWarp) {
      const uint64_t key = column_key(xr[c], c);
      if (key < below) buffer_insert(buf, key);
    }
  };
  refill(~uint64_t{0});
  int32_t* id_row = ids + r * w;
  select_top<svt::kWarp>(buf, w, svt::kFull, lane, id_row, refill);
  gather_picked(orow, id_row, topvals + r * w, w, lane, svt::kWarp,
                svt::kFull);
}
}  // namespace

// out (rows, k) f32, ids (rows, w) int32, topvals (rows, w) f32;
// 1 <= w <= k.
extern "C" int svt_dirichlet_topw_v1(const float* x, float* out, int32_t* ids,
                                     float* topvals, int64_t rows, int k,
                                     int w, cudaStream_t stream) {
  if (rows <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  if (w < 1 || w > k) return static_cast<int>(cudaErrorInvalidValue);
  if (k > svt::kRegMaxK) {
    dirichlet_topw_wide_kernel<<<svt::blocks_for(rows, svt::kWarp),
                                 svt::kBlockThreads, 0, stream>>>(
        x, out, ids, topvals, rows, k, w);
    return static_cast<int>(cudaGetLastError());
  }
  const bool aligned = k % 4 == 0 && svt::aligned16(x) && svt::aligned16(out);
  svt::dispatch_row(k, aligned, [&](auto vec, auto grp, auto cnt) {
    constexpr int VEC = decltype(vec)::value;
    constexpr int G = decltype(grp)::value;
    constexpr int N = decltype(cnt)::value;
    dirichlet_topw_kernel<VEC, G, N><<<svt::blocks_for(rows, G),
                                       svt::kBlockThreads, 0, stream>>>(
        x, out, ids, topvals, rows, k, w);
  });
  return static_cast<int>(cudaGetLastError());
}

