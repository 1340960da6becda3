// Kernel 1: Dirichlet expectation E[log p] = psi(x) - psi(sum_row x).
//
// Replaces the TPU kernel svinet_tpu/ops/pallas_digamma.py:68-102
// (pallas_digamma, body _digamma_kernel, arithmetic _digamma_expr), which
// ran elementwise over flattened (256,128) tiles and needed a second pass
// (and a padded copy) for the row sums. The same entry point serves gamma
// (n,K) and lambda (K,2).
//
// What bounds it on an H100: bytes, if the arithmetic is kept short. The
// function must read 4 bytes and write 4 per element; at (1M, 500) that
// is 4 GB. A digamma with nine IEEE divisions and a logf per element is
// about forty instructions and several special-function-unit operations
// per element, which costs more than the memory traffic does.
//
// What the design does about it:
//  - one read of the row: the group of lanes that owns it (layout
//    <VEC, G, N> of common.cuh) keeps it in registers between the row sum
//    and the write, with 16-byte loads and stores when K % 4 == 0;
//  - small K: several rows to a warp, so lambda's two columns and K = 20
//    fill the lanes;
//  - a cheaper digamma, below: one correctly rounded reciprocal, three
//    approximate ones and a logf per element;
//  - K above 512 takes dirichlet_wide_kernel: one warp per row, the row
//    read twice (the second read hits L1/L2).
//
// digamma(x), x > 0: psi(x) = psi(x+5) - sum_{i<5} 1/(x+i), then the
// asymptotic series at y = x + 5 >= 5, whose first omitted term is
// 1/(240 y^8) < 1.1e-8. The lift's terms are paired,
//   1/(x+1) + 1/(x+2) = (2x+3) / (x^2+3x+2),
//   1/(x+3) + 1/(x+4) = (2x+7) / (x^2+7x+12),
// so four reciprocals become two; each pair is at most 1.5, so the
// approximate reciprocal's one ulp of relative error is far below the
// bar. 1/x itself is unbounded as x -> 0 (200 at x = 5e-3) and takes the
// correctly rounded reciprocal, subtracted last. Quadratic denominators stay finite up to
// x ~ 1e19; beyond that they reach inf, the reciprocal is 0 and the pair
// (then below 1e-18) drops out without a NaN. Absolute error against
// float64 stays below 5e-5 over [5e-3, 1e6].

#include "common.cuh"

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

template <int VEC, int G, int N>
__global__ void __launch_bounds__(svt::kBlockThreads)
dirichlet_rows_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int64_t rows, int k) {
  constexpr int L = VEC * N;
  const int lane = threadIdx.x % svt::kWarp;
  const int g = lane % G;
  const unsigned mask = svt::group_mask<G>(lane);
  const int64_t r =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  if (r >= rows) return;  // the whole group leaves together
  float v[L];
  svt::load_row<VEC, G, N>(x + r * k, k, g, 0.0f, v);
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < L; ++i) s += v[i];
  const float ds = digamma_f(svt::group_sum<G>(s, mask));
  // units past the row hold 0, where digamma is -inf; they are not stored
#pragma unroll
  for (int i = 0; i < L; ++i) v[i] = expectation_f(v[i], ds);
  svt::store_row<VEC, G, N>(out + r * k, k, g, v);
}

__global__ void __launch_bounds__(svt::kBlockThreads)
dirichlet_wide_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int64_t rows, int k) {
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
  for (int c = lane; c < k; c += svt::kWarp) orow[c] = expectation_f(xr[c], ds);
}

}  // namespace

extern "C" int svt_dirichlet_expectation(const float* x, float* out,
                                         int64_t rows, int k,
                                         cudaStream_t stream) {
  if (rows <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  if (k > svt::kRegMaxK) {
    dirichlet_wide_kernel<<<svt::blocks_for(rows, svt::kWarp),
                            svt::kBlockThreads, 0, stream>>>(x, out, rows, k);
  } else {
    const bool aligned =
        k % 4 == 0 && svt::aligned16(x) && svt::aligned16(out);
    svt::dispatch_row(k, aligned, [&](auto vec, auto grp, auto cnt) {
      constexpr int VEC = decltype(vec)::value;
      constexpr int G = decltype(grp)::value;
      constexpr int N = decltype(cnt)::value;
      dirichlet_rows_kernel<VEC, G, N><<<svt::blocks_for(rows, G),
                                         svt::kBlockThreads, 0, stream>>>(
          x, out, rows, k);
    });
  }
  return static_cast<int>(cudaGetLastError());
}
