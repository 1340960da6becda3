// Kernel 11: the two closed-form passes over union slots on the sparse
// top-W gamma state (-infset -fastqueue W), a group of G lanes a pair
// (csrc/sparse_slots.cuh), one launch over all pairs.
//
// Scores form (svinet_tpu/ops/sparse_gamma.py:212-243,
// sparse_pair_scores), the held-out rows' link probabilities: with pi at
// a slot its gamma value over the row's total (the tail value rest / (K -
// W), with no floor) and beta = lambda[:, 0] / (lambda[:, 0] +
// lambda[:, 1]),
//   s_one = sum over live slots of pi_p pi_q beta + tail_p tail_q (sum beta
//           - beta over the live slots)
//   inner = sum over live slots of pi_p pi_q + tail_p tail_q (K - live)
// (tail_x = rest_x / (K - W) / total_x).
//
// Assignments form (svinet_tpu/ops/sparse_gamma.py:246-270,
// sparse_edge_assignments), the community extraction over every training
// link once a report: phi = softmax over the slots of psi(g_p) - psi(tot_p)
// + psi(g_q) - psi(tot_q) + Elogbeta[c, 0], -1e30 on a dead slot; the
// first slot of the largest phi gives the link's community, and its phi.
// The JAX function cuts the links into chunks of 8,192 for its (E, 2W, W)
// match tensor; here a pair's two rows are copied into its group's shared
// memory and its slots matched through a table there
// (csrc/sparse_slots.cuh, match_slots), so one launch takes them all.
// Above W = 64 the wide form gives a pair a block of one warp, its slots'
// facts and logits in a region of shared memory (device scratch past the
// card's shared memory; match_slots_wide), the same arithmetic slot by
// slot.
//
// What bounds it on an H100: each pair gathers two rows of W ids and
// values and a rest (2 * (8W + 4) bytes) and writes 8; at stretch's 19.9M
// links and W = 16 that is about 5.3 GB, 1.6 ms at 3.35 TB/s, and the
// rows of random links come from device memory in whole sectors.

#include <math.h>

#include "sparse_slots.cuh"

namespace {

constexpr int kThreads = 256;

struct ScoreArgs {
  const int32_t* ids;     // (n, W)
  const float* vals;      // (n, W)
  const float* rest;      // (n,)
  const float* table;     // scores: beta (K,); assignments: Elogbeta (K, 2)
  const float* beta_sum;  // () scores: sum of beta
  const int32_t* pairs;   // (n_pairs, 2)
  float* out0;            // scores: s_one; assignments: the largest phi
  float* out1;            // scores: inner
  int32_t* cid;           // assignments: the community
  int64_t n_pairs;
  int k;
  int w_top;
};

template <int G, int NS>
__device__ void scores_pair(const ScoreArgs& a, const svt::SlotMatch<NS>& m,
                            int g, unsigned mask, int64_t item) {
  const int w = a.w_top;
  const float kw = static_cast<float>(a.k - w > 1 ? a.k - w : 1);
  const float tv_p = m.rest_p / kw, tv_q = m.rest_q / kw;
  float s_one = 0.0f, inner = 0.0f, n_union = 0.0f, beta_union = 0.0f;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    if (!m.first[j]) continue;
    const int c = m.id[j];
    const float pip = svt::value_at(m.vals, m.at_p[j], tv_p) / m.tot_p;
    const float piq = svt::value_at(m.vals, m.at_q[j], tv_q) / m.tot_q;
    const float bs = __ldg(a.table + (c < 0 ? 0 : (c >= a.k ? a.k - 1 : c)));
    const float pp = __fmul_rn(pip, piq);
    s_one += __fmul_rn(pp, bs);
    inner += pp;
    n_union += 1.0f;
    beta_union += bs;
  }
  s_one = svt::group_sum<G>(s_one, mask);
  inner = svt::group_sum<G>(inner, mask);
  n_union = svt::group_sum<G>(n_union, mask);
  beta_union = svt::group_sum<G>(beta_union, mask);
  if (g == 0) {
    const float cross = __fmul_rn(tv_p / m.tot_p, tv_q / m.tot_q);
    a.out0[item] = __fadd_rn(
        s_one, __fmul_rn(cross, __fsub_rn(*a.beta_sum, beta_union)));
    a.out1[item] = __fadd_rn(
        inner, __fmul_rn(cross, __fsub_rn(static_cast<float>(a.k), n_union)));
  }
}

template <int G, int NS>
__device__ void assign_pair(const ScoreArgs& a, const svt::SlotMatch<NS>& m,
                            int g, unsigned mask, int64_t item) {
  const int w = a.w_top;
  const float kw = static_cast<float>(a.k - w > 1 ? a.k - w : 1);
  const float tv_p = m.rest_p / kw, tv_q = m.rest_q / kw;
  const float dp = svt::digamma_f(m.tot_p), dq = svt::digamma_f(m.tot_q);
  float x[NS];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    x[j] = -INFINITY;
    if (!m.in[j]) continue;
    if (!m.first[j]) {
      x[j] = svt::kDeadLogit;
    } else {
      const int c = m.id[j];
      const int cc = c < 0 ? 0 : (c >= a.k ? a.k - 1 : c);
      const float gp = svt::digamma_f(svt::value_at(m.vals, m.at_p[j], tv_p));
      const float gq = svt::digamma_f(svt::value_at(m.vals, m.at_q[j], tv_q));
      x[j] = __fadd_rn(__fsub_rn(__fadd_rn(__fsub_rn(gp, dp), gq), dq),
                       __ldg(a.table + 2 * cc));
    }
    mx = fmaxf(mx, x[j]);
  }
  mx = svt::group_max<G>(mx, mask);
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    x[j] = m.in[j] ? expf(x[j] - mx) : 0.0f;
    s += x[j];
  }
  s = svt::group_sum<G>(s, mask);
  // the first slot of the largest phi: this lane's (its slots ascend),
  // then the group's, the lower slot among equals
  float best = -1.0f;
  int at = 2 * w;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    if (!m.in[j]) continue;
    const float phi = __fdiv_rn(x[j], s);
    if (phi > best) {
      best = phi;
      at = g + j * G;
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(mask, best, off);
    const int oa = __shfl_xor_sync(mask, at, off);
    if (ob > best || (ob == best && oa < at)) {
      best = ob;
      at = oa;
    }
  }
  if (g == 0) {
    a.out0[item] = best;
    a.cid[item] = m.slots[at];
  }
}

template <int G, int NS, bool ASSIGN>
__global__ void __launch_bounds__(kThreads) sparse_scores_kernel(
    const ScoreArgs a) {
  extern __shared__ float smem[];
  float* const rows =
      smem + threadIdx.x / G * svt::pair_rows_words(a.w_top);
  const int g = threadIdx.x % G;
  const unsigned mask = svt::group_mask<G>(threadIdx.x % svt::kWarp);
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x / G;
  for (int64_t item = first; item < a.n_pairs; item += step) {
    const svt::SlotMatch<NS> m = svt::match_slots<G, NS>(
        a.ids, a.vals, a.rest, a.pairs[2 * item], a.pairs[2 * item + 1],
        a.w_top, g, mask, rows);
    if constexpr (ASSIGN)
      assign_pair<G, NS>(a, m, g, mask, item);
    else
      scores_pair<G, NS>(a, m, g, mask, item);
  }
}

// The wide form (W > 64): a block of one warp a pair, lane g its slots g,
// g + 32, ..., the assignments' logits in the region after the facts
// (kWideExtra words a slot); the same sums and picks as the forms above.
constexpr int kWideExtra = 1;

__device__ void scores_pair_wide(const ScoreArgs& a, const svt::WideMatch& m,
                                 int lane, int64_t item) {
  const int w = a.w_top;
  const float kw = static_cast<float>(a.k - w > 1 ? a.k - w : 1);
  const float tv_p = m.rest_p / kw, tv_q = m.rest_q / kw;
  float s_one = 0.0f, inner = 0.0f, n_union = 0.0f, beta_union = 0.0f;
  for (int i = lane; i < 2 * w; i += svt::kWarp) {
    if (!m.first[i]) continue;
    const int c = m.slots[i];
    const float pip = svt::value_at(m.vals, m.at_p[i], tv_p) / m.tot_p;
    const float piq = svt::value_at(m.vals, m.at_q[i], tv_q) / m.tot_q;
    const float bs = __ldg(a.table + (c < 0 ? 0 : (c >= a.k ? a.k - 1 : c)));
    const float pp = __fmul_rn(pip, piq);
    s_one += __fmul_rn(pp, bs);
    inner += pp;
    n_union += 1.0f;
    beta_union += bs;
  }
  s_one = svt::warp_sum(s_one);
  inner = svt::warp_sum(inner);
  n_union = svt::warp_sum(n_union);
  beta_union = svt::warp_sum(beta_union);
  if (lane == 0) {
    const float cross = __fmul_rn(tv_p / m.tot_p, tv_q / m.tot_q);
    a.out0[item] = __fadd_rn(
        s_one, __fmul_rn(cross, __fsub_rn(*a.beta_sum, beta_union)));
    a.out1[item] = __fadd_rn(
        inner, __fmul_rn(cross, __fsub_rn(static_cast<float>(a.k), n_union)));
  }
}

__device__ void assign_pair_wide(const ScoreArgs& a, const svt::WideMatch& m,
                                 int lane, int64_t item) {
  const int w = a.w_top;
  const float kw = static_cast<float>(a.k - w > 1 ? a.k - w : 1);
  const float tv_p = m.rest_p / kw, tv_q = m.rest_q / kw;
  const float dp = svt::digamma_f(m.tot_p), dq = svt::digamma_f(m.tot_q);
  float* const x = m.own;
  float mx = -INFINITY;
  for (int i = lane; i < 2 * w; i += svt::kWarp) {
    if (!m.first[i]) {
      x[i] = svt::kDeadLogit;
    } else {
      const int c = m.slots[i];
      const int cc = c < 0 ? 0 : (c >= a.k ? a.k - 1 : c);
      const float gp = svt::digamma_f(svt::value_at(m.vals, m.at_p[i], tv_p));
      const float gq = svt::digamma_f(svt::value_at(m.vals, m.at_q[i], tv_q));
      x[i] = __fadd_rn(__fsub_rn(__fadd_rn(__fsub_rn(gp, dp), gq), dq),
                       __ldg(a.table + 2 * cc));
    }
    mx = fmaxf(mx, x[i]);
  }
  mx = svt::group_max<svt::kWarp>(mx, svt::kFull);
  float s = 0.0f;
  for (int i = lane; i < 2 * w; i += svt::kWarp) {
    x[i] = expf(x[i] - mx);
    s += x[i];
  }
  s = svt::warp_sum(s);
  // the first slot of the largest phi: this lane's (its slots ascend),
  // then the warp's, the lower slot among equals
  float best = -1.0f;
  int at = 2 * w;
  for (int i = lane; i < 2 * w; i += svt::kWarp) {
    const float phi = __fdiv_rn(x[i], s);
    if (phi > best) {
      best = phi;
      at = i;
    }
  }
#pragma unroll
  for (int off = svt::kWarp / 2; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(svt::kFull, best, off);
    const int oa = __shfl_xor_sync(svt::kFull, at, off);
    if (ob > best || (ob == best && oa < at)) {
      best = ob;
      at = oa;
    }
  }
  if (lane == 0) {
    a.out0[item] = best;
    a.cid[item] = m.slots[at];
  }
}

template <bool ASSIGN>
__global__ void __launch_bounds__(svt::kWarp) sparse_scores_wide_kernel(
    const ScoreArgs a, float* scratch, int64_t region_words) {
  extern __shared__ float smem[];
  float* const region =
      scratch == nullptr ? smem : scratch + blockIdx.x * region_words;
  const int lane = threadIdx.x;
  for (int64_t item = blockIdx.x; item < a.n_pairs; item += gridDim.x) {
    const svt::WideMatch m = svt::match_slots_wide(
        a.ids, a.vals, a.rest, a.pairs[2 * item], a.pairs[2 * item + 1],
        a.w_top, lane, region);
    if constexpr (ASSIGN)
      assign_pair_wide(a, m, lane, item);
    else
      scores_pair_wide(a, m, lane, item);
  }
}

using Kernel = void (*)(ScoreArgs);

template <int G, int NS>
Kernel kernel_gn(bool assign) {
  return assign ? sparse_scores_kernel<G, NS, true>
                : sparse_scores_kernel<G, NS, false>;
}

Kernel pick(int g, int ns, bool assign) {
  if (g == 32) {
    if (ns == 4) return kernel_gn<32, 4>(assign);
    if (ns == 3) return kernel_gn<32, 3>(assign);
    if (ns == 2) return kernel_gn<32, 2>(assign);
    return kernel_gn<32, 1>(assign);
  }
  if (g == 16) return kernel_gn<16, 1>(assign);
  if (g == 8) return kernel_gn<8, 1>(assign);
  if (g == 4) return kernel_gn<4, 1>(assign);
  return kernel_gn<2, 1>(assign);
}

}  // namespace

// form 0 (scores): table = beta (K,), beta_sum its sum (a device scalar);
// out0 = s_one, out1 = inner (n_pairs,). form 1 (assignments): table =
// Elogbeta (K, 2); out0 = the largest phi, cid its slot's community. Above
// W = 64 (the wide form), wide_scratch holds the regions of
// svt::wide_scratch_regions where a region outgrows the card's shared
// memory (svt_sparse_scores_scratch's floats; null otherwise).
extern "C" int svt_sparse_scores(const int32_t* ids, const float* vals,
                                 const float* rest, const float* table,
                                 const float* beta_sum, const int32_t* pairs,
                                 float* out0, float* out1, int32_t* cid,
                                 int64_t n_pairs, int k, int w_top, int form,
                                 float* wide_scratch, cudaStream_t stream) {
  const int g = svt::slot_lanes(w_top);
  const int ns = svt::slots_per_lane(w_top);
  if (k <= 0 || w_top < 1 || w_top >= k || form < 0 || form > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs == 0) return 0;
  const ScoreArgs a{ids,  vals, rest, table,   beta_sum, pairs,
                    out0, out1, cid,  n_pairs, k,        w_top};
  if (w_top > svt::kNarrowMaxW) {
    const int64_t region = svt::wide_words(w_top, kWideExtra);
    int64_t regions = 0;
    cudaError_t err = svt::wide_scratch_regions(w_top, kWideExtra, &regions);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool in_smem = regions == 0;
    if (!in_smem && wide_scratch == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const int64_t cap = in_smem ? int64_t{32} * svt::sm_count() : regions;
    const int64_t blocks = n_pairs < cap ? n_pairs : cap;
    const size_t smem = in_smem ? sizeof(float) * region : 0;
    const auto kern = form == 1 ? sparse_scores_wide_kernel<true>
                                : sparse_scores_wide_kernel<false>;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kern,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kern<<<static_cast<unsigned>(blocks), svt::kWarp, smem, stream>>>(
        a, in_smem ? nullptr : wide_scratch, region);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t per_block = kThreads / g;
  int64_t blocks = (n_pairs + per_block - 1) / per_block;
  const int64_t card = int64_t{16} * svt::sm_count();
  blocks = blocks < card ? blocks : card;
  const size_t bytes =
      sizeof(float) * per_block * svt::pair_rows_words(w_top);
  pick(g, ns, form == 1)<<<static_cast<unsigned>(blocks), kThreads, bytes,
                           stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Floats of device scratch svt_sparse_scores takes at top width w_top on
// the current device (0: none) into *words. No launch.
extern "C" int svt_sparse_scores_scratch(int w_top, int64_t* words) {
  if (w_top < 1) return static_cast<int>(cudaErrorInvalidValue);
  int64_t regions = 0;
  const cudaError_t err =
      svt::wide_scratch_regions(w_top, kWideExtra, &regions);
  *words = regions * svt::wide_words(w_top, kWideExtra);
  return static_cast<int>(err);
}
