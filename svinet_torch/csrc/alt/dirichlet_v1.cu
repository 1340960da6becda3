// NOT PART OF THE LIBRARY. The first version of kernel 1, kept so that
// svinet_torch/tools/bench_kernels.py can time it beside the present
// csrc/dirichlet_expectation.cu in one run on one card.
//
// Kernel 1: Dirichlet expectation E[log p] = psi(x) - psi(sum_row x).
//
// Replaces the TPU kernel svinet_tpu/ops/pallas_digamma.py:68-102
// (pallas_digamma, body _digamma_kernel, arithmetic _digamma_expr), which
// ran elementwise over flattened (256,128) tiles and needed a second pass
// (and a padded copy) for the row sums. Here one warp owns one row: it
// reduces the row sum with shuffles, takes psi(row sum) once, and writes
// psi(x) - psi(row sum) in the same pass over the (rows, k) f32 input.
// The same entry point serves gamma (n,K) and lambda (K,2).
//
// What bounds it on an H100: per element it reads 4 bytes (the second
// read of a row hits L1/L2) and writes 4, and it computes eight IEEE
// divisions, one more for the series and a logf: roughly 30-40 f32
// instructions per element. At (1M, 500) that is 4 GB of memory traffic
// and ~2e10 instructions, two costs of the same order, so neither limit
// dominates; the divisions are what a faster version would cut. A warp
// per row keeps loads coalesced for K >= 32; for small K (lambda's 2
// columns, K=20) lanes idle, which costs little at those sizes.
//
// digamma(x): psi(x) = psi(x + 8) - sum_{i<8} 1/(x+i), then the
// asymptotic series at y = x + 8 >= 8. Branch-free, valid for x > 0, the
// same arithmetic as the TPU kernel (absolute error < 5e-5 over
// [5e-3, 40] against float64 scipy).

#include "grid_stride.cuh"

namespace {

__device__ __forceinline__ float digamma_f(float x) {
  float acc = 0.0f;
  float y = x;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc += 1.0f / y;
    y += 1.0f;
  }
  const float inv = 1.0f / y;
  const float inv2 = inv * inv;
  const float series =
      logf(y) - 0.5f * inv -
      inv2 * (1.0f / 12.0f - inv2 * (1.0f / 120.0f - inv2 / 252.0f));
  return series - acc;
}

__global__ void __launch_bounds__(svt::kBlockThreads)
dirichlet_expectation_kernel(const float* __restrict__ x,
                             float* __restrict__ out, int64_t rows, int k) {
  const int lane = threadIdx.x % svt::kWarp;
  const int64_t stride = svt::warp_count();
  // the loop bound is uniform across a warp, so every lane reaches the
  // shuffles of warp_sum together
  for (int64_t r = svt::warp_id(); r < rows; r += stride) {
    const float* xr = x + r * static_cast<int64_t>(k);
    float s = 0.0f;
    for (int c = lane; c < k; c += svt::kWarp) s += xr[c];
    const float ds = digamma_f(svt::warp_sum(s));
    float* orow = out + r * static_cast<int64_t>(k);
    for (int c = lane; c < k; c += svt::kWarp) orow[c] = digamma_f(xr[c]) - ds;
  }
}

}  // namespace

extern "C" int svt_dirichlet_expectation_v1(const float* x, float* out,
                                         int64_t rows, int k,
                                         cudaStream_t stream) {
  if (rows > 0 && k > 0)
    dirichlet_expectation_kernel<<<svt::grid_for(rows), svt::kBlockThreads, 0,
                                   stream>>>(x, out, rows, k);
  return static_cast<int>(cudaGetLastError());
}
