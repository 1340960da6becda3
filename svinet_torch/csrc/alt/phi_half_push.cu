// NOT PART OF THE LIBRARY. The design weighed against the pull kernel of
// csrc/phi_pass.cu, kept so that svinet_torch/tools/bench_kernels.py can
// time the two in one run on one card.
//
// Half push: the links arrive as a forward adjacency (node p lists only
// its neighbours q > p), so phi of a link is computed once. The owner of
// p sums phi in registers and adds its row into gacc[p] at the end; each
// phi is also pushed into gacc[q] with 16-byte atomicAdd. gacc must be
// zero-filled first, and the sum order varies from run to run. Per link
// it reads one 2 KB row and read-modify-writes another, against two row
// reads for the pull kernel. Only K % 4 == 0, K <= 512; no hub handling.

#include <math.h>

#include "../common.cuh"

namespace {

template <int N>
__global__ void __launch_bounds__(svt::kBlockThreads)
phi_half_push_kernel(const float* __restrict__ elogpi,
                     const float* __restrict__ elb0,
                     const int32_t* __restrict__ rowptr,
                     const int32_t* __restrict__ nbr, float* gacc, int64_t n,
                     int k) {
  constexpr int G = svt::kWarp;
  constexpr int L = 4 * N;
  const int g = threadIdx.x % G;
  const int64_t p =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  if (p >= n) return;
  const int begin = rowptr[p];
  const int end = rowptr[p + 1];
  if (begin == end) return;

  float base[L], acc[L], cur[L];
  svt::load_row<4, G, N>(elogpi + p * k, k, g, -INFINITY, base);
  svt::load_row<4, G, N>(elb0, k, g, 0.0f, cur);
#pragma unroll
  for (int i = 0; i < L; ++i) {
    base[i] += cur[i];
    acc[i] = 0.0f;
  }
  for (int i = begin; i < end; ++i) {
    const int64_t q = nbr[i];
    svt::load_row<4, G, N>(elogpi + q * k, k, g, 0.0f, cur);
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < L; ++c) {
      cur[c] += base[c];
      m = fmaxf(m, cur[c]);
    }
    m = svt::group_max<G>(m, svt::kFull);
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < L; ++c) {
      cur[c] = expf(cur[c] - m);
      s += cur[c];
    }
    const float inv = 1.0f / svt::group_sum<G>(s, svt::kFull);
    float* gq = gacc + q * k;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int c = (g + j * G) * 4;
      float4 phi = make_float4(cur[4 * j] * inv, cur[4 * j + 1] * inv,
                               cur[4 * j + 2] * inv, cur[4 * j + 3] * inv);
      acc[4 * j] += phi.x;
      acc[4 * j + 1] += phi.y;
      acc[4 * j + 2] += phi.z;
      acc[4 * j + 3] += phi.w;
      if (c < k) atomicAdd(reinterpret_cast<float4*>(gq + c), phi);
    }
  }
  float* gp = gacc + p * k;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = (g + j * G) * 4;
    if (c < k)
      atomicAdd(reinterpret_cast<float4*>(gp + c),
                make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                            acc[4 * j + 3]));
  }
}

}  // namespace

extern "C" int svt_phi_half_push(const float* elogpi, const float* elb0,
                                 const int32_t* rowptr, const int32_t* nbr,
                                 float* gacc, int64_t n, int k,
                                 cudaStream_t stream) {
  if (k % 4 != 0 || k > svt::kRegMaxK || k <= 0) return cudaErrorInvalidValue;
  const unsigned blocks = svt::blocks_for(n, svt::kWarp);
  const int units = k / 4;
  if (units <= 32)
    phi_half_push_kernel<1><<<blocks, svt::kBlockThreads, 0, stream>>>(
        elogpi, elb0, rowptr, nbr, gacc, n, k);
  else if (units <= 64)
    phi_half_push_kernel<2><<<blocks, svt::kBlockThreads, 0, stream>>>(
        elogpi, elb0, rowptr, nbr, gacc, n, k);
  else
    phi_half_push_kernel<4><<<blocks, svt::kBlockThreads, 0, stream>>>(
        elogpi, elb0, rowptr, nbr, gacc, n, k);
  return static_cast<int>(cudaGetLastError());
}
