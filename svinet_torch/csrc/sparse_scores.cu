// Kernel 11: the two closed-form passes over union slots on the sparse
// top-W gamma state (-infset -fastqueue W), one launch over all pairs.
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
// match tensor; here one launch takes them all.
//
// What bounds it on an H100: each pair gathers two rows of W ids and
// values and a rest and writes 8 bytes; the rows of random links come
// from device memory in whole sectors, and a row is read by ~2E/n links
// (40 on stretch). The first design was bound by issue slots and latency
// instead: a pair's rows staged in shared memory and matched through a
// hashed table there (atomics and three warp barriers a pair), four
// digammas a lane, a ten-shuffle argmax. So:
//
// - The node pass (assignments, W <= 64): once a call, each row's
//   psi(tot), psi(tail) and psi of its W values go into a buffer the
//   caller keeps (tot = sum of the values + rest, tail = rest / max(K - W,
//   1)): the same digamma_f of the same floats a pair took, so the pair
//   pass takes no digamma. It runs over all n rows, so it runs where the
//   links read each row at least once on average (2E >= n, every report's
//   assignments of the training links); below that each pair takes its
//   own digammas (a held-out set's worth of links on a large graph).
// - W <= 16, slots in registers: a pair's group of G lanes (G the next
//   power of two of 2W up to 32) is two halves of H = G / 2 lanes; lane h
//   of the low half holds p's slot h, lane h of the high half q's slot h.
//   A row's ids are distinct (the columns of its W largest values), so
//   every p slot is its community's first, and a q slot is first unless
//   its community is in p's list. One __match_any_sync over the group
//   finds the lane of the other row that holds a lane's community, and
//   one shuffle brings its value; idle lanes (h >= W) carry a sentinel of
//   their own lane, never an id. A group issues its next pair's gathers,
//   and the pair after that's ids, before this pair's arithmetic (as
//   volatile loads, which the compiler keeps where they stand).
// - 16 < W <= 64: the first design's match through the shared-memory
//   table (sparse_slots.cuh, match_slots), which beat a register match
//   over all pairs of slot registers at W = 40 and 64 on the H100 and
//   tied it at 32 (PERF.md has the readings).
// - The argmax by a ballot: phi = x / s with x = exp(logit - max), and the
//   largest x is exp(0) = 1, so the largest phi is 1 / s rounded. The first
//   slot of it (the JAX argmax's rule, ties after the division included)
//   is the lowest slot whose x / s equals it, found by one ballot a slot
//   register; only a slot with x within 2^-21 of 1 can round to it. A row
//   whose sum is NaN (every logit -inf: psi(0) of two disjoint rows whose
//   rests are 0) has no such slot and names its first, as torch's and
//   jnp's argmax name a NaN row's first.
//
// No float atomics: two launches give the same bits. Above W = 64 the
// wide form gives a pair a block of one warp, its slots' facts and logits
// in a region of shared memory (device scratch past the card's shared
// memory; match_slots_wide), the digammas in the pair pass.

#include <climits>
#include <math.h>

#include "sparse_slots.cuh"

namespace {

constexpr int kThreads = 256;
// an x below this cannot round, over the sum, to the largest phi
constexpr float kTieFloor = 1.0f - 0x1p-21f;

struct ScoreArgs {
  const int32_t* ids;     // (n, W)
  const float* vals;      // (n, W); narrow assignments: their digammas
  const float* rest;      // (n,)
  const float2* ends;     // narrow assignments: (psi(tot), psi(tail)) a row
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

__device__ __forceinline__ int clip_k(int c, int k) {
  return c < 0 ? 0 : (c >= k ? k - 1 : c);
}

// Loads through the read-only path that the compiler issues where they
// stand (a load ahead of its use stays ahead of the work between).
__device__ __forceinline__ int ld_ahead(const int32_t* p) {
  int v;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float ld_ahead(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float2 ld_ahead(const float2* p) {
  float2 v;
  asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "l"(p));
  return v;
}

// Largest of the group's floats in one reduction (ordered as ints).
__device__ __forceinline__ float group_max_redux(float v, unsigned mask) {
  int i = __float_as_int(v);
  i = __reduce_max_sync(mask, i >= 0 ? i : i ^ 0x7fffffff);
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// The node pass: a block a tile of `rows` rows, their values read once and
// coalesced, psi of each written back and the values kept in shared
// memory (rows W + 1 floats apart, so that a thread a row reads them
// without bank conflicts); then a thread a row sums its values in order
// and writes (psi(tot), psi(tail)). A thread's elements step by kThreads,
// its (row, column) by (kThreads / W, kThreads % W) with a carry.
__global__ void __launch_bounds__(kThreads) node_pass_kernel(
    const float* vals, const float* rest, float* psi, float2* ends,
    int64_t n, int w, int rows, float kw) {
  extern __shared__ float tile[];
  const int dr = kThreads / w, dc = kThreads % w;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * rows; base < n;
       base += static_cast<int64_t>(gridDim.x) * rows) {
    const int here = n - base < rows ? static_cast<int>(n - base) : rows;
    const float* const src = vals + base * w;
    float* const dst = psi + base * w;
    int r = threadIdx.x / w, c = threadIdx.x % w;
#pragma unroll 4
    for (int e = threadIdx.x; e < here * w; e += kThreads) {
      const float v = __ldg(src + e);
      dst[e] = svt::digamma_f(v);
      tile[r * (w + 1) + c] = v;
      r += dr;
      c += dc;
      if (c >= w) {
        c -= w;
        ++r;
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < here; t += kThreads) {
      const float* const row = tile + t * (w + 1);
      float sum = 0.0f;
      for (int i = 0; i < w; ++i) sum += row[i];
      const float rs = __ldg(rest + base + t);
      ends[base + t] =
          make_float2(svt::digamma_f(sum + rs), svt::digamma_f(rs / kw));
    }
    __syncthreads();
  }
}

// This lane's place in its pair's group of G: the half it is in (low: p's
// slots), its slot h of its half's row, the group's lanes and the low
// half's.
template <int G>
struct Lanes {
  static constexpr int H = G / 2;
  int lane, h;
  bool low;
  unsigned group, low_half;
  __device__ explicit Lanes(int thread) {
    lane = thread % svt::kWarp;
    const int g = lane % G;
    low = g < H;
    h = low ? g : g - H;
    group = svt::group_mask<G>(lane);
    low_half = ((1u << H) - 1u) << (lane - g);
  }
  // whether the lane holds a slot of its row (h < W)
  __device__ bool in(int w) const { return h < w; }
};

// A pair's ends and this lane's slot of its own row: its id (a sentinel on
// an idle lane) and value; with the node pass's rows (ENDS) the value's
// digamma and p's and q's (psi(tot), psi(tail)), else the value and the
// rests in .x.
struct Slot {
  int id;
  float v;
  float2 end_p, end_q;
};

// pair `item`'s ends; (the first pair's) past the last pair
__device__ __forceinline__ int2 load_pair(const ScoreArgs& a, int64_t item) {
  const int64_t at = item < a.n_pairs ? 2 * item : 0;
  return make_int2(ld_ahead(a.pairs + at), ld_ahead(a.pairs + at + 1));
}

template <int G, bool ENDS>
__device__ __forceinline__ Slot load_slot(const ScoreArgs& a, int2 pq,
                                          const Lanes<G>& ln) {
  Slot s;
  const int w = a.w_top;
  // an idle lane loads its row's first slot (a valid address) and drops it
  const bool in = ln.in(w);
  const int64_t at =
      static_cast<int64_t>(ln.low ? pq.x : pq.y) * w + (in ? ln.h : 0);
  const int id = ld_ahead(a.ids + at);
  const float v = ld_ahead(a.vals + at);
  s.id = in ? id : INT_MIN + ln.lane;
  s.v = in ? v : 0.0f;
  if constexpr (ENDS) {
    s.end_p = ld_ahead(a.ends + pq.x);
    s.end_q = ld_ahead(a.ends + pq.y);
  } else {
    s.end_p = make_float2(ld_ahead(a.rest + pq.x), 0.0f);
    s.end_q = make_float2(ld_ahead(a.rest + pq.y), 0.0f);
  }
  return s;
}

// The other row's value at this lane's community into *oth: the value
// where that row holds it (returns true), else `tail`, the other row's
// tail value. One __match_any_sync over the group, one shuffle.
template <int G>
__device__ __forceinline__ bool match_slot(const Slot& s, const Lanes<G>& ln,
                                           float tail, float* oth) {
  const unsigned other =
      __match_any_sync(ln.group, s.id) & ln.group & ~(1u << ln.lane);
  const float got =
      __shfl_sync(ln.group, s.v, other ? __ffs(other) - 1 : ln.lane);
  *oth = other ? got : tail;
  return other != 0;
}

template <int G>
__device__ __forceinline__ void scores_pair(const ScoreArgs& a, const Slot& s,
                                            const Lanes<G>& ln,
                                            int64_t item) {
  constexpr int H = Lanes<G>::H;
  const int w = a.w_top;
  const float kw = static_cast<float>(a.k - w > 1 ? a.k - w : 1);
  const float tv_p = s.end_p.x / kw, tv_q = s.end_q.x / kw;
  const float bs = ld_ahead(a.table + clip_k(s.id, a.k));
  float oth;
  const bool hit = match_slot<G>(s, ln, ln.low ? tv_q : tv_p, &oth);
  // each row's total: its half's values summed, the other half's by one
  // exchange
  float own = s.v;
#pragma unroll
  for (int off = H / 2; off > 0; off >>= 1)
    own += __shfl_xor_sync(ln.group, own, off);
  const float other = __shfl_xor_sync(ln.group, own, H);
  const float tot_p = (ln.low ? own : other) + s.end_p.x;
  const float tot_q = (ln.low ? other : own) + s.end_q.x;
  float s_one = 0.0f, inner = 0.0f, n_union = 0.0f, beta_union = 0.0f;
  if (ln.in(w) && (ln.low || !hit)) {
    const float pip = (ln.low ? s.v : oth) / tot_p;
    const float piq = (ln.low ? oth : s.v) / tot_q;
    const float pp = __fmul_rn(pip, piq);
    s_one = __fmul_rn(pp, bs);
    inner = pp;
    n_union = 1.0f;
    beta_union = bs;
  }
  s_one = svt::group_sum<G>(s_one, ln.group);
  inner = svt::group_sum<G>(inner, ln.group);
  n_union = svt::group_sum<G>(n_union, ln.group);
  beta_union = svt::group_sum<G>(beta_union, ln.group);
  if (ln.lane % G == 0) {
    const float cross = __fmul_rn(tv_p / tot_p, tv_q / tot_q);
    a.out0[item] = __fadd_rn(
        s_one, __fmul_rn(cross, __fsub_rn(*a.beta_sum, beta_union)));
    a.out1[item] = __fadd_rn(
        inner, __fmul_rn(cross, __fsub_rn(static_cast<float>(a.k), n_union)));
  }
}

// A pair's slot as the node pass would have left it, where it was
// skipped: each half sums its row (a shuffle tree) and takes psi(tot) and
// psi(tail) of it, the halves swap theirs, and each lane takes psi of its
// value.
template <int G>
__device__ __forceinline__ void pair_digammas(const ScoreArgs& a, Slot& s,
                                              const Lanes<G>& ln) {
  constexpr int H = Lanes<G>::H;
  const int w = a.w_top;
  const float kw = static_cast<float>(a.k - w > 1 ? a.k - w : 1);
  float own = s.v;
#pragma unroll
  for (int off = H / 2; off > 0; off >>= 1)
    own += __shfl_xor_sync(ln.group, own, off);
  const float rest = ln.low ? s.end_p.x : s.end_q.x;
  const float2 mine = make_float2(svt::digamma_f(own + rest),
                                  svt::digamma_f(rest / kw));
  const float2 theirs = make_float2(__shfl_xor_sync(ln.group, mine.x, H),
                                    __shfl_xor_sync(ln.group, mine.y, H));
  s.end_p = ln.low ? mine : theirs;
  s.end_q = ln.low ? theirs : mine;
  s.v = ln.in(w) ? svt::digamma_f(s.v) : 0.0f;
}

template <int G, bool NODE>
__device__ __forceinline__ void assign_pair(const ScoreArgs& a, Slot s,
                                            const Lanes<G>& ln,
                                            int64_t item) {
  const int w = a.w_top;
  // the digammas: psi(tot) and psi(tail) of each end, psi of each value
  if constexpr (!NODE) pair_digammas<G>(a, s, ln);
  const float dp = s.end_p.x, dq = s.end_q.x;
  const float eb = ld_ahead(a.table + 2 * clip_k(s.id, a.k));
  float oth;
  const bool hit =
      match_slot<G>(s, ln, ln.low ? s.end_q.y : s.end_p.y, &oth);
  float x = -INFINITY;
  float mx = -INFINITY;
  if (ln.in(w)) {
    if (!ln.low && hit) {
      x = svt::kDeadLogit;
    } else {
      const float gp = ln.low ? s.v : oth;
      const float gq = ln.low ? oth : s.v;
      x = __fadd_rn(__fsub_rn(__fadd_rn(__fsub_rn(gp, dp), gq), dq), eb);
    }
    mx = fmaxf(mx, x);
  }
  mx = group_max_redux(mx, ln.group);
  float sum = 0.0f;
  x = ln.in(w) ? expf(x - mx) : 0.0f;
  sum += x;
  sum = svt::group_sum<G>(sum, ln.group);
  // the largest phi, x = 1 over the sum; its first slot: the lowest p
  // slot whose phi it is, else the lowest q slot, else (a NaN row) p's
  // slot 0, the group's first lane
  const float best = __fdiv_rn(1.0f, sum);
  const unsigned ballot =
      __ballot_sync(ln.group,
                    x >= kTieFloor && __fdiv_rn(x, sum) == best) &
      ln.group;
  int at = -1;
  if (ballot & ln.low_half) at = __ffs(ballot & ln.low_half) - 1;
  if (at < 0 && ballot) at = __ffs(ballot) - 1;
  if (at < 0) at = ln.lane & ~(G - 1);
  if (ln.lane == at) {
    a.out0[item] = best;
    a.cid[item] = s.id;
  }
}

// W <= 16: a group of G lanes a pair, the pairs strided over the grid,
// each group's next pair loaded while it works on this one. NODE: the
// assignments over the node pass's rows.
template <int G, bool ASSIGN, bool NODE>
__global__ void __launch_bounds__(kThreads) sparse_scores_kernel(
    const ScoreArgs a) {
  const Lanes<G> ln(threadIdx.x);
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x / G;
  int64_t item =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  if (item >= a.n_pairs) return;
  Slot cur = load_slot<G, NODE>(a, load_pair(a, item), ln);
  int2 next = load_pair(a, item + step);
  for (; item < a.n_pairs; item += step) {
    const Slot ahead = load_slot<G, NODE>(a, next, ln);
    next = load_pair(a, item + 2 * step);
    if constexpr (ASSIGN)
      assign_pair<G, NODE>(a, cur, ln, item);
    else
      scores_pair<G>(a, cur, ln, item);
    cur = ahead;
  }
}

// 16 < W <= 64: the first design's pair of the scores form over the
// shared-memory table's facts (a warp a pair, lane g its slots g, g + 32,
// ...)
template <int NS>
__device__ void scores_pair_table(const ScoreArgs& a,
                                  const svt::SlotMatch<NS>& m, int g,
                                  int64_t item) {
  const int w = a.w_top;
  const float kw = static_cast<float>(a.k - w > 1 ? a.k - w : 1);
  const float tv_p = m.rest_p / kw, tv_q = m.rest_q / kw;
  float s_one = 0.0f, inner = 0.0f, n_union = 0.0f, beta_union = 0.0f;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    if (!m.first[j]) continue;
    const float pip = svt::value_at(m.vals, m.at_p[j], tv_p) / m.tot_p;
    const float piq = svt::value_at(m.vals, m.at_q[j], tv_q) / m.tot_q;
    const float bs = __ldg(a.table + clip_k(m.id[j], a.k));
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
  if (g == 0) {
    const float cross = __fmul_rn(tv_p / m.tot_p, tv_q / m.tot_q);
    a.out0[item] = __fadd_rn(
        s_one, __fmul_rn(cross, __fsub_rn(*a.beta_sum, beta_union)));
    a.out1[item] = __fadd_rn(
        inner, __fmul_rn(cross, __fsub_rn(static_cast<float>(a.k), n_union)));
  }
}

// The assignments over the table's facts; with the node pass's rows
// (NODE) the rows in the table's copies are its digammas (their totals
// unused) and each end's (psi(tot), psi(tail)) its, else the digammas are
// taken here as the first design took them. The argmax by a ballot a slot
// register (slots g + 32 j ascend with j, then g).
template <int NS, bool NODE>
__device__ void assign_pair_table(const ScoreArgs& a,
                                  const svt::SlotMatch<NS>& m, int g,
                                  int64_t p, int64_t q, int64_t item) {
  float2 end_p, end_q;
  if constexpr (NODE) {
    end_p = __ldg(a.ends + p);
    end_q = __ldg(a.ends + q);
  } else {
    const int w = a.w_top;
    const float kw = static_cast<float>(a.k - w > 1 ? a.k - w : 1);
    end_p = make_float2(svt::digamma_f(m.tot_p), m.rest_p / kw);
    end_q = make_float2(svt::digamma_f(m.tot_q), m.rest_q / kw);
  }
  float x[NS];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    x[j] = -INFINITY;
    if (!m.in[j]) continue;
    if (!m.first[j]) {
      x[j] = svt::kDeadLogit;
    } else {
      float gp = svt::value_at(m.vals, m.at_p[j], end_p.y);
      float gq = svt::value_at(m.vals, m.at_q[j], end_q.y);
      if constexpr (!NODE) {
        gp = svt::digamma_f(gp);
        gq = svt::digamma_f(gq);
      }
      x[j] = __fadd_rn(
          __fsub_rn(__fadd_rn(__fsub_rn(gp, end_p.x), gq), end_q.x),
          __ldg(a.table + 2 * clip_k(m.id[j], a.k)));
    }
    mx = fmaxf(mx, x[j]);
  }
  mx = group_max_redux(mx, svt::kFull);
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    x[j] = m.in[j] ? expf(x[j] - mx) : 0.0f;
    sum += x[j];
  }
  sum = svt::warp_sum(sum);
  const float best = __fdiv_rn(1.0f, sum);
  int at = -1;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const unsigned b = __ballot_sync(
        svt::kFull, x[j] >= kTieFloor && __fdiv_rn(x[j], sum) == best);
    if (at < 0 && b) at = j * svt::kWarp + __ffs(b) - 1;
  }
  if (g == 0) {
    a.out0[item] = best;
    a.cid[item] = m.slots[at < 0 ? 0 : at];  // a NaN row: its first slot
  }
}

template <int NS, bool ASSIGN, bool NODE>
__global__ void __launch_bounds__(kThreads) sparse_scores_table_kernel(
    const ScoreArgs a) {
  extern __shared__ float smem[];
  float* const rows =
      smem + threadIdx.x / svt::kWarp * svt::pair_rows_words(a.w_top);
  const int g = threadIdx.x % svt::kWarp;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) /
      svt::kWarp;
  const int64_t step =
      static_cast<int64_t>(gridDim.x) * blockDim.x / svt::kWarp;
  for (int64_t item = first; item < a.n_pairs; item += step) {
    const int64_t p = a.pairs[2 * item], q = a.pairs[2 * item + 1];
    const svt::SlotMatch<NS> m = svt::match_slots<svt::kWarp, NS>(
        a.ids, a.vals, a.rest, p, q, a.w_top, g, svt::kFull, rows);
    if constexpr (ASSIGN)
      assign_pair_table<NS, NODE>(a, m, g, p, q, item);
    else
      scores_pair_table<NS>(a, m, g, item);
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
  // no phi above -1 (a NaN row): its first slot, as torch's argmax
  if (lane == 0) {
    a.out0[item] = at < 2 * w ? best : __fdiv_rn(x[0], s);
    a.cid[item] = m.slots[at < 2 * w ? at : 0];
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

// the scores, or the assignments over the node pass's rows (node) or not
template <int G>
Kernel registers_kernel(bool assign, bool node) {
  if (!assign) return sparse_scores_kernel<G, false, false>;
  return node ? sparse_scores_kernel<G, true, true>
              : sparse_scores_kernel<G, true, false>;
}

template <int NS>
Kernel table_kernel(bool assign, bool node) {
  if (!assign) return sparse_scores_table_kernel<NS, false, false>;
  return node ? sparse_scores_table_kernel<NS, true, true>
              : sparse_scores_table_kernel<NS, true, false>;
}

Kernel pick(int g, int ns, bool assign, bool node) {
  if (ns == 4) return table_kernel<4>(assign, node);
  if (ns == 3) return table_kernel<3>(assign, node);
  if (ns == 2) return table_kernel<2>(assign, node);
  if (g == 32) return registers_kernel<32>(assign, node);
  if (g == 16) return registers_kernel<16>(assign, node);
  if (g == 8) return registers_kernel<8>(assign, node);
  if (g == 4) return registers_kernel<4>(assign, node);
  return registers_kernel<2>(assign, node);
}

int64_t grid(int64_t items, int64_t per_block) {
  const int64_t blocks = (items + per_block - 1) / per_block;
  const int64_t card = int64_t{16} * svt::sm_count();
  return blocks < card ? blocks : card;
}

}  // namespace

// form 0 (scores): table = beta (K,); out0 = s_one, out1 = inner
// (n_pairs,). form 1 (assignments): table = Elogbeta (K, 2); out0 = the
// largest phi, cid its slot's community. `node`, the caller's buffer: the
// sum of beta (scores, 1 float, written by the caller), or the node pass's (psi(tot), psi(tail))
// of each of the n rows then psi of their values (narrow assignments,
// n * (W + 2) floats, written where 2 n_pairs >= n). Above W = 64 (the
// wide form), wide_scratch holds the regions of svt::wide_scratch_regions
// where a region outgrows the card's shared memory
// (svt_sparse_scores_scratch's floats; null otherwise).
extern "C" int svt_sparse_scores(const int32_t* ids, const float* vals,
                                 const float* rest, const float* table,
                                 const int32_t* pairs, float* out0,
                                 float* out1, int32_t* cid, float* node,
                                 float* wide_scratch, int64_t n,
                                 int64_t n_pairs, int k, int w_top, int form,
                                 cudaStream_t stream) {
  const int g = svt::slot_lanes(w_top);
  const int ns = svt::slots_per_lane(w_top);
  if (k <= 0 || n <= 0 || w_top < 1 || w_top >= k || form < 0 || form > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs == 0) return 0;
  const bool assign = form == 1;
  ScoreArgs a{ids,  vals, rest, nullptr, table,   node, pairs,
              out0, out1, cid,  n_pairs, k,       w_top};
  cudaError_t err = cudaSuccess;
  if (w_top > svt::kNarrowMaxW) {
    const int64_t region = svt::wide_words(w_top, kWideExtra);
    int64_t regions = 0;
    err = svt::wide_scratch_regions(w_top, kWideExtra, &regions);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool in_smem = regions == 0;
    if (!in_smem && wide_scratch == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const int64_t cap = in_smem ? int64_t{32} * svt::sm_count() : regions;
    const int64_t blocks = n_pairs < cap ? n_pairs : cap;
    const size_t smem = in_smem ? sizeof(float) * region : 0;
    const auto kern = assign ? sparse_scores_wide_kernel<true>
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
  // the node pass where the links read each row at least once on average
  // (2E >= n); below that a pair takes its own digammas
  const bool node_pass = assign && 2 * n_pairs >= n;
  if (node_pass) {
    const float kw = static_cast<float>(k - w_top > 1 ? k - w_top : 1);
    // a tile of 256 rows within the 48 KB of shared memory, else 128
    const int rows = (w_top + 1) * kThreads * 4 <= 48 * 1024 ? kThreads
                                                             : kThreads / 2;
    float2* const ends = reinterpret_cast<float2*>(node);
    float* const psi = node + 2 * n;
    node_pass_kernel<<<static_cast<unsigned>(grid(n, rows)), kThreads,
                       sizeof(float) * rows * (w_top + 1), stream>>>(
        vals, rest, psi, ends, n, w_top, rows, kw);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    a.vals = psi;
    a.ends = ends;
  }
  const size_t bytes =
      ns > 1 ? sizeof(float) * (kThreads / g) * svt::pair_rows_words(w_top)
             : 0;
  pick(g, ns, assign, node_pass)<<<
      static_cast<unsigned>(grid(n_pairs, kThreads / g)), kThreads, bytes,
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
