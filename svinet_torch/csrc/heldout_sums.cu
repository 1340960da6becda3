// Kernel 6: the six held-out sums, the tail of every sweep step and the
// body of every report's validation, test and training-sample rows
// (svinet_tpu/evals/likelihood.py:85-128, heldout_sums_blocked over
// heldout_sums_from_pi; reference LinkSampling::edge_likelihood,
// src/linksampling.hh:258-292). For every pair (p, q) with label y and
// weight w, with pi = gamma / rowsum(gamma) and beta = lam0 / (lam0 + lam1):
//   inner = sum_k pi_p pi_q,  one = sum_k pi_p pi_q beta,
//   zero  = sum_k pi_p pi_q (1 - beta) + (1 - inner)(1 - eps)
//   ll = log(max(y == 1 ? one : zero, 1e-30)) * w
// and the sums of ll and w over all pairs, over the non-links and over the
// links. On the TPU this was part of the XLA step program; in plain PyTorch
// it normalises the whole (n,K) gamma (a row sum, a division and a 2 GB pi
// at n=1M, K=500) to use the rows of the held-out pairs, 800,000 of them.
//
// What bounds it on an H100: bytes, and few of them: the two gamma rows of
// each pair (random rows, 2 KB each at K=500, from DRAM) and the pairs.
//
// What the design does about it: one pass over the pairs and nothing of size
// (n,K). A group of lanes (layout <VEC, G, N> of common.cuh) gathers
// gamma[p] and gamma[q] as they are, sums each row in registers, divides its
// values by the row's sum as the plain version does (so that the
// cancellation in 1 - inner meets the same quotients) and forms the three
// dot products; beta (K values, made by the wrapper) waits in registers. A
// padding pair has weight 0: it adds exactly 0 to every sum in the plain
// version, and is skipped here. Each group keeps its six running sums; a
// block adds its groups' in group order, and colsum_partials_kernel the
// blocks' in block order: no atomics, the same bits from every launch.
//
// K above 512 does not fit the register layout: one warp per pair walks the
// two rows twice, first for their sums and then for the products (the
// second read finds the rows in the L1).

#include "common.cuh"

namespace {

struct HoArgs {
  const float* gamma;    // (n, k)
  const float* beta;     // (k,)
  const int32_t* pairs;  // (n_pairs, 2)
  const int32_t* y;      // (n_pairs,)
  const float* w;        // (n_pairs,)
  float* partial;        // (blocks, 6)
  int64_t n_pairs;
  int k;
  float one_minus_eps;
};

// the pair's log-likelihood into the group's six sums
__device__ __forceinline__ void add_pair(float (&sums)[6], float inner,
                                         float one, float zero, int y, float w,
                                         float one_minus_eps) {
  const float s = y == 1 ? one : zero + (1.0f - inner) * one_minus_eps;
  const float ll = logf(fmaxf(s, 1e-30f)) * w;
  sums[0] += ll;
  sums[1] += w;
  if (y == 1) {
    sums[4] += ll;
    sums[5] += w;
  } else {
    sums[2] += ll;
    sums[3] += w;
  }
}

// The groups' sums (in the lane g == 0 of each) added in group order into
// this block's row of the scratch.
template <int G>
__device__ __forceinline__ void block_six(const float (&sums)[6], float* smem,
                                          float* dst) {
  if (threadIdx.x % G == 0) {
#pragma unroll
    for (int j = 0; j < 6; ++j) smem[(threadIdx.x / G) * 6 + j] = sums[j];
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    float s = 0.0f;
    for (int r = 0; r < svt::kBlockThreads / G; ++r)
      s += smem[r * 6 + threadIdx.x];
    dst[threadIdx.x] = s;
  }
}

template <int VEC, int G, int N>
__global__ void __launch_bounds__(svt::kBlockThreads)
heldout_sums_kernel(const HoArgs a) {
  constexpr int L = VEC * N;
  __shared__ float smem[(svt::kBlockThreads / G) * 6];
  const int lane = threadIdx.x % svt::kWarp;
  const int g = lane % G;
  const unsigned mask = svt::group_mask<G>(lane);
  const int k = a.k;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x / G;

  float bet[L], gp[L], gq[L], sums[6];
  svt::load_row<VEC, G, N>(a.beta, k, g, 0.0f, bet);
#pragma unroll
  for (int j = 0; j < 6; ++j) sums[j] = 0.0f;
  // item and w are the same in every lane of a group
  for (int64_t item = first; item < a.n_pairs; item += step) {
    const float w = a.w[item];
    if (w == 0.0f) continue;
    const int64_t p = a.pairs[2 * item];
    const int64_t q = a.pairs[2 * item + 1];
    svt::load_row<VEC, G, N>(a.gamma + p * k, k, g, 0.0f, gp);
    svt::load_row<VEC, G, N>(a.gamma + q * k, k, g, 0.0f, gq);
    float sp = 0.0f, sq = 0.0f;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      sp += gp[i];
      sq += gq[i];
    }
    sp = svt::group_sum<G>(sp, mask);
    sq = svt::group_sum<G>(sq, mask);
    float inner = 0.0f, one = 0.0f, zero = 0.0f;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const float prod = (gp[i] / sp) * (gq[i] / sq);
      inner += prod;
      one += prod * bet[i];
      zero += prod * (1.0f - bet[i]);
    }
    inner = svt::group_sum<G>(inner, mask);
    one = svt::group_sum<G>(one, mask);
    zero = svt::group_sum<G>(zero, mask);
    add_pair(sums, inner, one, zero, a.y[item], w, a.one_minus_eps);
  }
  block_six<G>(sums, smem, a.partial + static_cast<int64_t>(blockIdx.x) * 6);
}

// any K: one warp per pair, the rows read twice
__global__ void __launch_bounds__(svt::kBlockThreads)
heldout_sums_wide_kernel(const HoArgs a) {
  constexpr int G = svt::kWarp;
  __shared__ float smem[(svt::kBlockThreads / G) * 6];
  const int lane = threadIdx.x % G;
  const int k = a.k;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x / G;
  float sums[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) sums[j] = 0.0f;
  for (int64_t item = first; item < a.n_pairs; item += step) {
    const float w = a.w[item];
    if (w == 0.0f) continue;
    const float* rp = a.gamma + static_cast<int64_t>(a.pairs[2 * item]) * k;
    const float* rq = a.gamma + static_cast<int64_t>(a.pairs[2 * item + 1]) * k;
    float sp = 0.0f, sq = 0.0f;
    for (int c = lane; c < k; c += G) {
      sp += __ldg(rp + c);
      sq += __ldg(rq + c);
    }
    sp = svt::warp_sum(sp);
    sq = svt::warp_sum(sq);
    float inner = 0.0f, one = 0.0f, zero = 0.0f;
    for (int c = lane; c < k; c += G) {
      const float b = __ldg(a.beta + c);
      const float prod = (__ldg(rp + c) / sp) * (__ldg(rq + c) / sq);
      inner += prod;
      one += prod * b;
      zero += prod * (1.0f - b);
    }
    inner = svt::warp_sum(inner);
    one = svt::warp_sum(one);
    zero = svt::warp_sum(zero);
    add_pair(sums, inner, one, zero, a.y[item], w, a.one_minus_eps);
  }
  block_six<G>(sums, smem, a.partial + static_cast<int64_t>(blockIdx.x) * 6);
}

}  // namespace

// out (6,) is written: the sums of ll and w over all pairs, over the
// non-links, over the links. partial is scratch of svt::kReduceBlocks rows
// of 6. gamma (n,k) and beta (k,) are f32; pairs (n_pairs,2) and y
// (n_pairs,) int32; w (n_pairs,) f32, 0 on padding.
extern "C" int svt_heldout_sums(const float* gamma, const float* beta,
                                const int32_t* pairs, const int32_t* y,
                                const float* w, float* partial, float* out,
                                int64_t n_pairs, int k, float one_minus_eps,
                                cudaStream_t stream) {
  if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const HoArgs a{gamma, beta, pairs, y, w, partial, n_pairs, k, one_minus_eps};
  unsigned blocks = 0;
  if (n_pairs > 0 && k > svt::kRegMaxK) {
    blocks = svt::reduce_blocks_for(n_pairs, svt::kWarp);
    heldout_sums_wide_kernel<<<blocks, svt::kBlockThreads, 0, stream>>>(a);
  } else if (n_pairs > 0) {
    const bool aligned =
        k % 4 == 0 && svt::aligned16(gamma) && svt::aligned16(beta);
    svt::dispatch_row(k, aligned, [&](auto vec, auto grp, auto cnt) {
      constexpr int VEC = decltype(vec)::value;
      constexpr int G = decltype(grp)::value;
      constexpr int N = decltype(cnt)::value;
      blocks = svt::reduce_blocks_for(n_pairs, G);
      heldout_sums_kernel<VEC, G, N>
          <<<blocks, svt::kBlockThreads, 0, stream>>>(a);
    });
  }
  svt::launch_colsum_partials(partial, static_cast<int>(blocks), 6, 6, out,
                              stream);
  return static_cast<int>(cudaGetLastError());
}
