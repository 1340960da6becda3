// NOT PART OF THE LIBRARY. Kernel 8 as first designed (a group of lanes
// per pair, both K-rows and both phi in registers, K <= 512), kept so that
// svinet_torch/tools/bench_kernels.py --only fixedpoint can time it beside
// the present design in csrc/phi_fixed_point.cu in one run on one card.
// Its entry point takes the arguments the library's took while this design
// was on the path; svt_phi_fixed_point_v1_info reports what its two
// kernels get of an SM.
//
// Kernel 8: the per-pair phi fixed point of the MMSB local step and the
// sufficient statistics it feeds, the body of every MMSBInfer step
// (svinet_tpu/ops/phicomp.py:33 phi_fixed_point inside
// svinet_tpu/svi/mmsb.py:49 pair_block_stats; reference PhiComp,
// src/mmsbinfer.hh:105-199), and its ELBO form for -logl
// (svinet_tpu/evals/elbo.py:30 approx_elbo). For a pair (p, q) with label y
// and weight w, from phi1 = phi2 = 1/K, Jacobi rounds
//   phi1' = softmax(Elogpi[p] + Elogf phi2 + [y=1] (1 - phi2) log eps)
//   phi2' = softmax(Elogpi[q] + Elogf phi1 + [y=1] (1 - phi1) log eps)
// (Elogf = Elogbeta[:, 0] for a link, [:, 1] for a nonlink) until the
// larger mean absolute change of a round is below thresh, or max_iters
// rounds: the reference's per-pair exit. On the TPU the pairs ran in
// blocks of 2048 that iterated until every pair had converged.
//
// What bounds it on an H100: the exponentials and the arithmetic of the
// rounds, 2K expf and some 20K f32 operations a round, against two
// gathered K-rows a pair and the outputs. At K=500 and ~10 rounds that is
// ~200 f32 operations a byte moved, above the card's 20 for f32.
//
// What the design does about it: a group of G lanes (layout <VEC, G, N> of
// common.cuh) owns a pair and keeps Elogpi[p], Elogpi[q], Elogf, phi1 and
// phi2 in registers across all its rounds; nothing of size (B, K) is
// written while it iterates. A round costs the group four reductions of
// one value (the two softmax maxima and sums) and one of the two changes.
// A pair of weight 0 takes no round.
//
// No atomics. The training form writes w phi1 and w phi2 into a staging
// buffer (2B, K): slot 2i and 2i + 1 for pair i. A second launch walks the
// CSR of the pairs' endpoints (ops/edges.py:owner_csr; for each node
// its slots in slot order, a node with more than seg_len slots cut into
// segments) and writes each node's row of gacc once; a hub's segment sums
// are combined in segment order, in double, so that thousands of nearly
// equal sums do not drift. lacc's two columns are per-group running rows
// in shared memory, added per block in group order and over blocks in
// block order; the ELBO form adds its per-pair terms the same way. The
// memory this costs: the staging buffer, 2 B K floats (4 GB for -rnode's
// 999,999 pairs at K=500, 2 GB for 500,000 random pairs).

#include <math.h>

#include "../common.cuh"

namespace {

struct FpArgs {
  const float* elogpi;   // (n, k)
  const float* elogf;    // (2, k): row 0 for links, row 1 for nonlinks
  const int32_t* pairs;  // (n_pairs, 2)
  const int32_t* y;      // (n_pairs,)
  const float* w;        // (n_pairs,)
  float* staged;         // (2 n_pairs, k) training form; null for ELBO
  int32_t* rounds;       // (n_pairs,)
  float* partial;        // (blocks, 2k) training form, (blocks, 1) ELBO
  int64_t n_pairs;
  int k;
  int max_iters;
  float log_eps;
  float thresh;
};

// The column of register i of lane g in layout <VEC, G, N>.
template <int VEC, int G>
__device__ __forceinline__ int column_of(int i, int g) {
  return (g + (i / VEC) * G) * VEC + i % VEC;
}

// out = softmax over the row of (e + f * other + [link] (1 - other) log_eps),
// pad columns 0; returns the group's sum of |out - cur|.
template <int VEC, int G, int N>
__device__ __forceinline__ float softmax_round(
    const float (&e)[VEC * N], const float (&f)[VEC * N],
    const float (&other)[VEC * N], const float (&cur)[VEC * N],
    float (&out)[VEC * N], bool link, float log_eps, int k, int g,
    unsigned mask) {
  constexpr int L = VEC * N;
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    float x = e[i] + f[i] * other[i];
    if (link) x += (1.0f - other[i]) * log_eps;
    out[i] = column_of<VEC, G>(i, g) < k ? x : -INFINITY;
    mx = fmaxf(mx, out[i]);
  }
  mx = svt::group_max<G>(mx, mask);
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    out[i] = expf(out[i] - mx);
    s += out[i];
  }
  s = svt::group_sum<G>(s, mask);
  float d = 0.0f;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    out[i] = out[i] / s;
    d += fabsf(out[i] - cur[i]);
  }
  return svt::group_sum<G>(d, mask);
}

// ELBO = false: the training form; true: the per-pair ELBO terms.
template <int VEC, int G, int N, bool ELBO>
__global__ void __launch_bounds__(svt::kBlockThreads)
fixed_point_kernel(const FpArgs a) {
  constexpr int L = VEC * N;
  constexpr int W = G * L;  // a group's row in smem, padded
  constexpr int GROUPS = svt::kBlockThreads / G;
  // training: the groups' running rows of lacc, links then nonlinks;
  // ELBO: one running sum a group
  __shared__ float smem[ELBO ? GROUPS : 2 * GROUPS * W];
  const int lane = threadIdx.x % svt::kWarp;
  const int g = lane % G;
  const int grp = threadIdx.x / G;
  const unsigned mask = svt::group_mask<G>(lane);
  const int k = a.k;
  const float inv_k = 1.0f / static_cast<float>(k);
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x / G;

  float* lam1 = smem;
  float* lam0 = smem + (ELBO ? 0 : GROUPS * W);
  float esum = 0.0f;
  if constexpr (!ELBO) {
    svt::smem_row_zero<VEC, G, N>(lam1);
    svt::smem_row_zero<VEC, G, N>(lam0);
  }

  float ep[L], eq[L], f[L], phi1[L], phi2[L], n1[L], n2[L];
  for (int64_t item = first; item < a.n_pairs; item += step) {
    const float w = a.w[item];
    if (w == 0.0f) {
      if (g == 0) a.rounds[item] = 0;
      if constexpr (!ELBO) {
#pragma unroll
        for (int i = 0; i < L; ++i) n1[i] = 0.0f;
        svt::store_row<VEC, G, N>(a.staged + 2 * item * k, k, g, n1);
        svt::store_row<VEC, G, N>(a.staged + (2 * item + 1) * k, k, g, n1);
      }
      continue;
    }
    const int64_t p = a.pairs[2 * item];
    const int64_t q = a.pairs[2 * item + 1];
    const bool link = a.y[item] == 1;
    svt::load_row<VEC, G, N>(a.elogpi + p * k, k, g, 0.0f, ep);
    svt::load_row<VEC, G, N>(a.elogpi + q * k, k, g, 0.0f, eq);
    svt::load_row<VEC, G, N>(a.elogf + (link ? 0 : k), k, g, 0.0f, f);
#pragma unroll
    for (int i = 0; i < L; ++i) {
      phi1[i] = column_of<VEC, G>(i, g) < k ? inv_k : 0.0f;
      phi2[i] = phi1[i];
    }
    int r = 0;
    while (r < a.max_iters) {
      // both read the other's phi of the round before (Jacobi)
      const float d1 = softmax_round<VEC, G, N>(ep, f, phi2, phi1, n1, link,
                                                a.log_eps, k, g, mask);
      const float d2 = softmax_round<VEC, G, N>(eq, f, phi1, phi2, n2, link,
                                                a.log_eps, k, g, mask);
#pragma unroll
      for (int i = 0; i < L; ++i) {
        phi1[i] = n1[i];
        phi2[i] = n2[i];
      }
      ++r;
      const float change = fmaxf(d1 / static_cast<float>(k),
                                 d2 / static_cast<float>(k));
      if (!(change >= a.thresh)) break;
    }
    if (g == 0) a.rounds[item] = r;
    if constexpr (ELBO) {
      float t = 0.0f, inner = 0.0f, ent = 0.0f;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const float pp = phi1[i] * phi2[i];
        inner += pp;
        t += pp * f[i] + phi1[i] * ep[i] + phi2[i] * eq[i];
        ent -= phi1[i] * logf(fmaxf(phi1[i], 1e-30f)) +
               phi2[i] * logf(fmaxf(phi2[i], 1e-30f));
      }
      t = svt::group_sum<G>(t, mask);
      inner = svt::group_sum<G>(inner, mask);
      ent = svt::group_sum<G>(ent, mask);
      if (link) t += (1.0f - inner) * a.log_eps;
      esum += (t + ent) * w;
    } else {
#pragma unroll
      for (int i = 0; i < L; ++i) {
        n1[i] = w * phi1[i];
        n2[i] = w * phi2[i];
        phi1[i] = phi1[i] * phi2[i] * w;
      }
      svt::store_row<VEC, G, N>(a.staged + 2 * item * k, k, g, n1);
      svt::store_row<VEC, G, N>(a.staged + (2 * item + 1) * k, k, g, n2);
      svt::smem_row_add<VEC, G, N>(phi1, link ? lam1 : lam0);
    }
  }
  float* dst =
      a.partial + static_cast<int64_t>(blockIdx.x) * (ELBO ? 1 : 2 * k);
  if constexpr (ELBO) {
    if (g == 0) smem[grp] = esum;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.0f;
      for (int r = 0; r < GROUPS; ++r) s += smem[r];
      dst[0] = s;
    }
  } else {
    svt::smem_colsum_write<VEC, G, N>(k, lam1, dst);
    svt::smem_colsum_write<VEC, G, N>(k, lam0, dst + k);
  }
}

// gacc[p] (or a hub segment's scratch row) = the sum of p's staged rows,
// in the CSR's slot order.
template <int VEC, int G, int N>
__global__ void __launch_bounds__(svt::kBlockThreads)
staged_pull_kernel(const svt::AdjItems items, const float* staged,
                   float* out, int k) {
  constexpr int L = VEC * N;
  const int lane = threadIdx.x % svt::kWarp;
  const int g = lane % G;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x / G;
  float acc[L], row[L];
  for (int64_t item = first; item < items.n_items; item += step) {
    int64_t p;
    int begin, end;
    if (!svt::adj_item(items, item, &p, &begin, &end)) continue;
#pragma unroll
    for (int i = 0; i < L; ++i) acc[i] = 0.0f;
    for (int j = begin; j < end; ++j) {
      svt::load_row<VEC, G, N>(
          staged + static_cast<int64_t>(items.nbr[j]) * k, k, g, 0.0f, row);
#pragma unroll
      for (int i = 0; i < L; ++i) acc[i] += row[i];
    }
    float* dst = out + (items.seg_node != nullptr ? item : p) * k;
    svt::store_row<VEC, G, N>(dst, k, g, acc);
  }
}

// gacc[hub_node[h]] = the sum of hub h's segment rows, in segment order,
// accumulated in double: the sampled node of an -rnode minibatch at n=1M
// has 3,906 segments of nearly equal sums, and adding them in f32 drifts
// by 2e-4 of the row (each addition rounds the same way)
__global__ void __launch_bounds__(svt::kBlockThreads)
combine_segments_f64_kernel(const float* __restrict__ partial,
                            const int32_t* __restrict__ hub_node,
                            const int32_t* __restrict__ hub_segptr,
                            float* __restrict__ out, int k) {
  const int64_t h = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= k) return;
  double s = 0.0;
  for (int64_t r = hub_segptr[h]; r < hub_segptr[h + 1]; ++r)
    s += static_cast<double>(partial[r * k + c]);
  out[static_cast<int64_t>(hub_node[h]) * k + c] = static_cast<float>(s);
}

}  // namespace

// Training form (elbo = 0): gacc (n, k) and sums (2k: lacc's link column,
// then its nonlink column) are written; staged (2 n_pairs, k) and
// seg_partial (n_segs, k) are scratch; the CSR arrays are
// ops/edges.py:owner_csr's of the pairs' ends. ELBO form (elbo = 1): sums (1,) is
// written; staged, the CSR, seg_partial and gacc are unused. Both write
// rounds (n_pairs,) and use partial, svt::kReduceBlocks rows of the sums'
// width. k <= svt::kRegMaxK.
extern "C" int svt_phi_fixed_point_v1(
    const float* elogpi, const float* elogf, const int32_t* pairs,
    const int32_t* y, const float* w, float* staged, int32_t* rounds,
    float* partial, float* sums, const int32_t* rowptr, const int32_t* nbr,
    const int32_t* hub_node, const int32_t* hub_segptr,
    const int32_t* seg_node, const int32_t* seg_begin,
    const int32_t* seg_end, float* seg_partial, float* gacc, int64_t n,
    int64_t n_pairs, int64_t n_hubs, int64_t n_segs, int k, int seg_len,
    int max_iters, float log_eps, float thresh, int elbo,
    cudaStream_t stream) {
  if (k <= 0 || k > svt::kRegMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  const FpArgs a{elogpi, elogf,   pairs, y,         w,       staged, rounds,
                 partial, n_pairs, k,     max_iters, log_eps, thresh};
  const bool aligned = k % 4 == 0 && svt::aligned16(elogpi) &&
                       svt::aligned16(elogf) &&
                       (elbo || svt::aligned16(staged)) &&
                       (elbo || svt::aligned16(gacc));
  unsigned blocks = 0;
  svt::dispatch_row(k, aligned, [&](auto vec, auto grp, auto cnt) {
    constexpr int VEC = decltype(vec)::value;
    constexpr int G = decltype(grp)::value;
    constexpr int N = decltype(cnt)::value;
    if (n_pairs > 0) {
      blocks = svt::reduce_blocks_for(n_pairs, G);
      if (elbo)
        fixed_point_kernel<VEC, G, N, true>
            <<<blocks, svt::kBlockThreads, 0, stream>>>(a);
      else
        fixed_point_kernel<VEC, G, N, false>
            <<<blocks, svt::kBlockThreads, 0, stream>>>(a);
    }
    if (elbo) return;
    // every node, then the hubs' segments into their scratch rows
    const svt::AdjItems nodes{rowptr,  nbr, nullptr, nullptr, nullptr,
                              n,       seg_len};
    staged_pull_kernel<VEC, G, N>
        <<<svt::blocks_for(n, G), svt::kBlockThreads, 0, stream>>>(
            nodes, staged, gacc, k);
    if (n_segs > 0) {
      const svt::AdjItems segs{rowptr,    nbr,     seg_node, seg_begin,
                               seg_end,   n_segs,  seg_len};
      staged_pull_kernel<VEC, G, N>
          <<<svt::blocks_for(n_segs, G), svt::kBlockThreads, 0, stream>>>(
              segs, staged, seg_partial, k);
      const dim3 grid(static_cast<unsigned>(n_hubs),
                      (k + svt::kBlockThreads - 1) / svt::kBlockThreads);
      combine_segments_f64_kernel<<<grid, svt::kBlockThreads, 0, stream>>>(
          seg_partial, hub_node, hub_segptr, gacc, k);
    }
  });
  const int width = elbo ? 1 : 2 * k;
  if (blocks > 0) {
    svt::launch_colsum_partials(partial, static_cast<int>(blocks), width,
                                width, sums, stream);
  } else {
    cudaMemsetAsync(sums, 0, sizeof(float) * width, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// What the launch at K = 500 gets of an SM: info[0] registers a thread,
// info[1] bytes of local memory a thread, info[2] warps an SM, for the
// training form <4,32,4>, then info[3..5] for the ELBO form at K = 20
// <4,8,1>.
extern "C" int svt_phi_fixed_point_v1_info(int* info) {
  const void* kernels[2] = {
      reinterpret_cast<const void*>(fixed_point_kernel<4, 32, 4, false>),
      reinterpret_cast<const void*>(fixed_point_kernel<4, 8, 1, true>)};
  for (int i = 0; i < 2; ++i) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernels[i]);
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernels[i], svt::kBlockThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    info[3 * i] = attr.numRegs;
    info[3 * i + 1] = static_cast<int>(attr.localSizeBytes);
    info[3 * i + 2] = per_sm * svt::kBlockThreads / svt::kWarp;
  }
  return 0;
}
