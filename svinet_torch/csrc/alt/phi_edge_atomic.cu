// NOT PART OF THE LIBRARY. The first version of kernel 2 (push: one warp
// per edge, phi added into both endpoint rows with atomicAdd), kept so
// that svinet_torch/tools/bench_kernels.py can time it beside the present
// csrc/phi_pass.cu in one run on one card.
//
// Kernel 2: the link-sampling phi pass over the training edges.
//
// For each edge e = (p, q) with mask w_e:
//   phi_e = softmax_k(Elogpi[p,k] + Elogpi[q,k] + Elogbeta0[k]) * w_e
//   gacc[p] += phi_e,  gacc[q] += phi_e
// (svinet_tpu/svi/sweep_math.py:46-87, phi_pass with conv=None). The
// gather+softmax half of it is the TPU prototype
// tools/pallas_gather_bench.py:69-183 (pallas_gather_softmax), which had
// to DMA 8-row panels and pick rows with a one-hot matmul because Mosaic
// could not slice a single row; on Hopper a warp simply reads the two
// rows. The scatter half was an XLA scatter-add on the TPU.
//
// Layout: one warp per edge in a grid-stride loop. Pass 1 walks the two
// gathered rows in chunks of 32 columns and keeps an online softmax
// (running max m and running sum s, rescaled when m grows), then merges
// the 32 lanes' (m, s) pairs with shuffles; that works for any K with no
// register cap. Pass 2 recomputes each logit (the rows are in L1/L2 by
// then), scales exp(logit - m) by w_e / s and adds it into gacc[p] and
// gacc[q] with atomicAdd. Masked (padding) edges are skipped. Offsets are
// 64-bit: n*K passes 2^31 elements for n above 4.3M at K=500.
//
// What bounds it on an H100: per edge it reads two K-rows (8K bytes) and
// performs 2K f32 atomics, each a read-modify-write of a 32-byte L2
// sector of gacc; at K=500 and random endpoints gacc (2 GB at n=1M) does
// not fit in L2, so the atomics' DRAM traffic is the bound. Atomic order
// varies from run to run, so results agree with the plain version to
// f32 rounding (1e-4), never bitwise.

#include <math.h>

#include "grid_stride.cuh"

namespace {

__global__ void __launch_bounds__(svt::kBlockThreads)
phi_pass_kernel(const float* __restrict__ elogpi,
                const float* __restrict__ elb0,
                const int32_t* __restrict__ edges,
                const float* __restrict__ mask, float* __restrict__ gacc,
                int64_t n_edges, int k) {
  const int lane = threadIdx.x % svt::kWarp;
  const int64_t stride = svt::warp_count();
  for (int64_t e = svt::warp_id(); e < n_edges; e += stride) {
    const float w = mask[e];
    if (w == 0.0f) continue;  // uniform across the warp
    const int64_t p = edges[2 * e];
    const int64_t q = edges[2 * e + 1];
    const float* rp = elogpi + p * k;
    const float* rq = elogpi + q * k;

    // pass 1: per-lane online softmax over columns lane, lane+32, ...
    float m = -INFINITY;
    float s = 0.0f;
    for (int c = lane; c < k; c += svt::kWarp) {
      const float v = rp[c] + rq[c] + elb0[c];
      if (v > m) {
        s = s * expf(m - v) + 1.0f;  // expf(-inf) = 0 on the first column
        m = v;
      } else {
        s += expf(v - m);
      }
    }
#pragma unroll
    for (int off = svt::kWarp / 2; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(svt::kFull, m, off);
      const float so = __shfl_xor_sync(svt::kFull, s, off);
      const float mn = fmaxf(m, mo);
      // two lanes without columns (K < 32) both hold -inf: keep s = 0
      // instead of evaluating expf(-inf - -inf) = NaN
      s = (mn == -INFINITY) ? 0.0f : s * expf(m - mn) + so * expf(mo - mn);
      m = mn;
    }

    // pass 2: phi, scaled by the mask, scattered into both endpoints
    const float scale = w / s;
    float* gp = gacc + p * k;
    float* gq = gacc + q * k;
    for (int c = lane; c < k; c += svt::kWarp) {
      const float phi = expf(rp[c] + rq[c] + elb0[c] - m) * scale;
      atomicAdd(gp + c, phi);
      atomicAdd(gq + c, phi);
    }
  }
}

}  // namespace

extern "C" int svt_phi_pass_edge_atomic(const float* elogpi, const float* elb0,
                            const int32_t* edges, const float* mask,
                            float* gacc, int64_t n_edges, int k,
                            cudaStream_t stream) {
  if (n_edges > 0 && k > 0)
    phi_pass_kernel<<<svt::grid_for(n_edges), svt::kBlockThreads, 0,
                      stream>>>(elogpi, elb0, edges, mask, gacc, n_edges, k);
  return static_cast<int>(cudaGetLastError());
}
