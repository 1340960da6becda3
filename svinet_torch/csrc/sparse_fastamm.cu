// Kernel 10: FastAMM's local step on the sparse top-W gamma state
// (-infset -fastqueue W): the coupled phi fixed point over the 2W union
// slots of each pair (svinet_tpu/ops/sparse_gamma.py:74-129,
// sparse_phi_fixed_point) and its sums, gamma_hat over the step's touched
// rows and lambda_hat (svinet_tpu/ops/sparse_gamma.py:153-166, inside
// sparse_fastamm_step). For a pair (p, q) with label y, over its slots
// (csrc/sparse_slots.cuh), from phi = 1/(live slots) on the live slots,
// Jacobi rounds
//   phi1' = softmax(Elogpi_p + Elogf phi2 + [y=1] (1 - phi2) log eps + dead)
//   phi2' = softmax(Elogpi_q + Elogf phi1 + [y=1] (1 - phi1) log eps + dead)
// where Elogpi_p at a slot is psi(p's value there) - psi(sum of p's row),
// the value a top value or the tail max(rest / (K - W), 1e-10), Elogf the
// slot's community's Elogbeta column of the label, and dead -1e30 on a
// dead slot, 0 elsewhere. The whole minibatch is one block of the JAX
// exit rule (svinet_tpu/svi/fastamm.py pads it to its fixed length with
// pairs (0, 0) of y = 0, w = 0): it runs until the largest change of a
// round over all pairs, padding included, is below thresh, or max_iters;
// a pair's change is the larger mean |phi' - phi| over its 2W slots, dead
// ones included. The padding is one virtual pair (0, 0) here, as in
// kernel 8.
//
// Kernel 8's exact scheme (csrc/phi_fixed_point.cu): pass 1 runs every
// pair to its bit-stable round (a round is a pure function of the two
// phis), recording a bit a round for a change below thresh, and writes its
// phis; one warp ANDs the masks into R (svt::block_rounds_kernel); pass 2
// runs again, for exactly R rounds, the pairs whose phis came after more
// than R. Then two passes without atomics: gamma_hat's rows, a block a
// touched row (or a segment of a hub's list), each adding w phi of the
// row's pair ends in slot order into a row in shared memory; and
// lambda_hat, a block a chunk of pairs adding w phi1 phi2 into its own
// (2, K) rows in pair order, the chunks added in chunk order. Both hold
// at most kTileCols columns a block, a wider K taking a grid row a tile,
// so that any K runs. Two launches give the same bits.
//
// What bounds it on an H100: a pair reads 2W ids and values of each end
// and runs a few rounds of 4W exponentials; at B = 256 pairs the step is
// a handful of launches, each far from any rate of the card, and the
// (T, K) gamma_hat rows it writes (T the touched rows, 8.4 MB at T = 264
// and K = 8,000) are the bytes. A group of G lanes owns a pair (2W up to
// a warp, then a warp with up to 4 slots a lane: W <= 64), its two rows
// copied into shared memory at once and its slots matched through a table
// there (csrc/sparse_slots.cuh, match_slots), its slots' inputs in
// registers. Above W = 64 the wide form gives a pair a block of one warp
// and keeps each slot's inputs and phis in its region of shared memory
// (device scratch past the card's shared memory; match_slots_wide), the
// same arithmetic slot by slot.

#include <math.h>

#include "sparse_slots.cuh"

namespace {

constexpr int kPairThreads = 128;
constexpr int kRowThreads = 128;
// columns of gamma_hat and lambda_hat a block of the sum passes holds in
// shared memory (32 KB and 64 KB): a wider K takes more tiles, a grid row
// each, so that K has no limit
constexpr int kTileCols = 8192;

struct SparseArgs {
  const int32_t* ids;      // (n, W)
  const float* vals;       // (n, W)
  const float* rest;       // (n,)
  const float* elogbeta;   // (K, 2)
  const int32_t* pairs;    // (n_pairs, 2) global node ids
  const int32_t* y;        // (n_pairs,)
  const float* w;          // (n_pairs,)
  float* staged;           // (2 n_pairs, 2W): phi1 of pair i in row 2i,
                           // phi2 in row 2i + 1
  int32_t* slots;          // (n_pairs, 2W): a live slot's community, -1
                           // on a dead slot
  uint64_t* masks;         // (n_pairs + pad, words)
  int32_t* stop;           // (n_pairs + pad,) rounds that made pass 1's phis
  const int32_t* block_rounds;  // (1,) R
  int32_t* rounds;         // (n_pairs,) R
  int64_t n_pairs;
  int k;
  int w_top;               // W
  int max_iters;
  int words;
  int pad;                 // 1: the virtual pair (0, 0) at n_pairs
  float log_eps;
  float thresh;
};

// A pair's slots, lane by lane: community, Elogpi of both ends, Elogf,
// whether it lies within the 2W slots and whether it is live.
template <int NS>
struct Slots {
  int id[NS];
  float ep[NS], eq[NS], f[NS];
  bool in[NS], live[NS];
};

template <int NS>
__device__ __forceinline__ void load_slots(const SparseArgs& a,
                                           const svt::SlotMatch<NS>& m,
                                           bool link, Slots<NS>& s) {
  const int w = a.w_top;
  const float kw = static_cast<float>(a.k - w > 1 ? a.k - w : 1);
  const float tail_p = fmaxf(m.rest_p / kw, 1e-10f);
  const float tail_q = fmaxf(m.rest_q / kw, 1e-10f);
  const float dp = svt::digamma_f(m.tot_p), dq = svt::digamma_f(m.tot_q);
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    s.in[j] = m.in[j];
    s.id[j] = m.id[j];
    s.live[j] = m.first[j];
    if (!s.in[j]) {
      s.ep[j] = s.eq[j] = s.f[j] = 0.0f;
      continue;
    }
    s.ep[j] = svt::digamma_f(svt::value_at(m.vals, m.at_p[j], tail_p)) - dp;
    s.eq[j] = svt::digamma_f(svt::value_at(m.vals, m.at_q[j], tail_q)) - dq;
    const int c = m.id[j];
    const int cc = c < 0 ? 0 : (c >= a.k ? a.k - 1 : c);
    s.f[j] = __ldg(a.elogbeta + 2 * cc + (link ? 0 : 1));
  }
}

// ((Elogpi + Elogf phi) + [link] (1 - phi) log eps) + dead, each operation
// rounded as svinet_tpu/ops/sparse_gamma.py:115-118 forms it (no fma)
template <bool LINK>
__device__ __forceinline__ float logit(float f, float p, float e, float le,
                                       bool live) {
  float x = __fadd_rn(e, __fmul_rn(f, p));
  if constexpr (LINK) x = __fadd_rn(x, __fmul_rn(__fsub_rn(1.0f, p), le));
  return live ? x : __fadd_rn(x, svt::kDeadLogit);
}

// phi = 1/(live slots) on the live slots, 0 elsewhere: the softmax of 0
// and -1e30 (svinet_tpu/ops/sparse_gamma.py:111-113)
template <int G, int NS>
__device__ __forceinline__ void start_phi(const Slots<NS>& s, unsigned mask,
                                          float (&p1)[NS], float (&p2)[NS]) {
  float n = 0.0f;
#pragma unroll
  for (int j = 0; j < NS; ++j) n += s.live[j] ? 1.0f : 0.0f;
  n = svt::group_sum<G>(n, mask);
  const float v = __fdiv_rn(1.0f, n);
#pragma unroll
  for (int j = 0; j < NS; ++j) p1[j] = p2[j] = s.live[j] ? v : 0.0f;
}

// The rounds of one pair. RECORD (pass 1): until its bit-stable round or
// `limit`, lane 0 writing the mask of the rounds whose change is below
// thresh (every bit from the bit-stable round on set); returns the rounds
// that made the final phis. Else exactly `limit` rounds.
template <int G, int NS, bool LINK, bool RECORD>
__device__ int run_rounds(const SparseArgs& a, const Slots<NS>& s,
                          float (&p1)[NS], float (&p2)[NS], int g,
                          unsigned mask, int limit, uint64_t* mask_out) {
  const float le = a.log_eps;
  const float n_slots = static_cast<float>(2 * a.w_top);
  int r = 0;
  bool stable = false;
  uint64_t word = 0;
  while (r < limit) {
    float l1[NS], l2[NS];
    float m1 = -INFINITY, m2 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      l1[j] = logit<LINK>(s.f[j], p2[j], s.ep[j], le, s.live[j]);
      l2[j] = logit<LINK>(s.f[j], p1[j], s.eq[j], le, s.live[j]);
      if (s.in[j]) {
        m1 = fmaxf(m1, l1[j]);
        m2 = fmaxf(m2, l2[j]);
      }
    }
    m1 = svt::group_max<G>(m1, mask);
    m2 = svt::group_max<G>(m2, mask);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      l1[j] = s.in[j] ? expf(l1[j] - m1) : 0.0f;
      l2[j] = s.in[j] ? expf(l2[j] - m2) : 0.0f;
      s1 += l1[j];
      s2 += l2[j];
    }
    s1 = svt::group_sum<G>(s1, mask);
    s2 = svt::group_sum<G>(s2, mask);
    float d1 = 0.0f, d2 = 0.0f;
    bool same = true;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float n1 = __fdiv_rn(l1[j], s1), n2 = __fdiv_rn(l2[j], s2);
      if constexpr (RECORD) {
        d1 += fabsf(n1 - p1[j]);
        d2 += fabsf(n2 - p2[j]);
        same = same && __float_as_uint(n1) == __float_as_uint(p1[j]) &&
               __float_as_uint(n2) == __float_as_uint(p2[j]);
      }
      p1[j] = n1;
      p2[j] = n2;
    }
    ++r;
    if constexpr (RECORD) {
      d1 = svt::group_sum<G>(d1, mask);
      d2 = svt::group_sum<G>(d2, mask);
      if (!(fmaxf(d1 / n_slots, d2 / n_slots) >= a.thresh))
        word |= uint64_t{1} << ((r - 1) & 63);
      stable = __ballot_sync(mask, !same) == 0u;
      if ((r & 63) == 0) {
        if (g == 0) mask_out[(r >> 6) - 1] = word;
        word = 0;
      }
      if (stable) break;
    }
  }
  if constexpr (RECORD) {
    if (stable) word |= ~uint64_t{0} << (r & 63);
    if (g == 0)
      for (int j = r >> 6; j < a.words; ++j)
        mask_out[j] = j == (r >> 6) ? word : (stable ? ~uint64_t{0} : 0);
    return stable ? r - 1 : r;
  }
  return r;
}

// Pass 1 (FINISH false): every pair and the virtual one to its bit-stable
// round, its mask and stop, and for a pair of nonzero weight its slots and
// phis into `slots` and `staged`. Pass 2: every pair's rounds = R, and
// the pairs of nonzero weight whose stop exceeds R run again for R rounds
// and are written again.
template <int G, int NS, bool FINISH>
__global__ void __launch_bounds__(kPairThreads)
sparse_pair_kernel(const SparseArgs a) {
  extern __shared__ float smem[];
  float* const rows =
      smem + threadIdx.x / G * svt::pair_rows_words(a.w_top);
  const int g = threadIdx.x % G;
  const unsigned mask = svt::group_mask<G>(threadIdx.x % svt::kWarp);
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x / G;
  const int slots_n = 2 * a.w_top;
  const int64_t n_items = a.n_pairs + (FINISH ? 0 : a.pad);
  for (int64_t item = first; item < n_items; item += step) {
    const bool real = item < a.n_pairs;
    const float w = real ? a.w[item] : 0.0f;
    int limit = a.max_iters;
    if constexpr (FINISH) {
      limit = a.block_rounds[0];
      if (g == 0) a.rounds[item] = limit;
      if (w == 0.0f || a.stop[item] <= limit) continue;
    }
    const bool link = real && a.y[item] == 1;
    const int64_t p = real ? a.pairs[2 * item] : 0;
    const int64_t q = real ? a.pairs[2 * item + 1] : 0;
    Slots<NS> s;
    load_slots<NS>(a,
                   svt::match_slots<G, NS>(a.ids, a.vals, a.rest, p, q,
                                           a.w_top, g, mask, rows),
                   link, s);
    float p1[NS], p2[NS];
    start_phi<G, NS>(s, mask, p1, p2);
    if constexpr (FINISH) {
      if (link)
        run_rounds<G, NS, true, false>(a, s, p1, p2, g, mask, limit,
                                       nullptr);
      else
        run_rounds<G, NS, false, false>(a, s, p1, p2, g, mask, limit,
                                        nullptr);
    } else {
      uint64_t* const mo = a.masks + item * a.words;
      const int r =
          link ? run_rounds<G, NS, true, true>(a, s, p1, p2, g, mask, limit,
                                               mo)
               : run_rounds<G, NS, false, true>(a, s, p1, p2, g, mask, limit,
                                                mo);
      if (g == 0) a.stop[item] = r;
      if (w == 0.0f) continue;
    }
    float* const s1 = a.staged + 2 * item * slots_n;
    float* const s2 = s1 + slots_n;
    int32_t* const sl = a.slots + item * slots_n;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (!s.in[j]) continue;
      const int i = g + j * G;
      s1[i] = p1[j];
      s2[i] = p2[j];
      if constexpr (!FINISH) sl[i] = s.live[j] ? s.id[j] : -1;
    }
  }
}

// gamma_hat's rows: work item `item` (a touched row, or a segment of a
// hub row's list) adds w phi of each of its pair ends, in slot order, into
// a row of columns [c0, c0 + kt) in shared memory (c0 = blockIdx.y
// kTileCols) and writes it to out[p] (or to its segment's scratch row); a
// pair's live slots are distinct communities, so the block's threads add
// a pair's slots at once. Each column takes its adds in the same order
// whatever the tiling, so the bits do not depend on it.
__global__ void __launch_bounds__(kRowThreads)
gacc_rows_kernel(const svt::AdjItems items, const float* __restrict__ staged,
                 const int32_t* __restrict__ slots,
                 const float* __restrict__ w, int slots_n, int k,
                 float* __restrict__ out) {
  extern __shared__ float acc[];
  const bool seg = items.seg_node != nullptr;
  const int c0 = blockIdx.y * kTileCols;
  const int kt = k - c0 < kTileCols ? k - c0 : kTileCols;
  for (int64_t item = blockIdx.x; item < items.n_items; item += gridDim.x) {
    int64_t p;
    int begin, end;
    if (!svt::adj_item(items, item, &p, &begin, &end)) continue;
    for (int c = threadIdx.x; c < kt; c += blockDim.x) acc[c] = 0.0f;
    __syncthreads();
    for (int j = begin; j < end; ++j) {
      const int64_t slot = items.nbr[j];
      const int64_t i = slot >> 1;
      const float ws = w[i];
      if (ws == 0.0f) continue;
      const float* phi = staged + slot * slots_n;
      for (int l = threadIdx.x; l < slots_n; l += blockDim.x) {
        const int c = slots[i * slots_n + l] - c0;
        if (c >= 0 && c < kt) acc[c] += __fmul_rn(ws, phi[l]);
      }
      __syncthreads();
    }
    float* dst = out + (seg ? item : p) * k + c0;
    for (int c = threadIdx.x; c < kt; c += blockDim.x) dst[c] = acc[c];
    __syncthreads();
  }
}

// lambda_hat's partial rows: block b adds w phi1 phi2 of pairs [b chunk,
// (b + 1) chunk), in pair order, into its rows of links and of nonlinks
// over columns [c0, c0 + kt) in shared memory, written to partial row b
// (2K values: the link row, then the nonlink row).
__global__ void __launch_bounds__(kRowThreads)
lam_chunks_kernel(const float* __restrict__ staged,
                  const int32_t* __restrict__ slots,
                  const int32_t* __restrict__ y, const float* __restrict__ w,
                  int64_t n_pairs, int chunk, int slots_n, int k,
                  float* __restrict__ partial) {
  extern __shared__ float acc[];
  const int c0 = blockIdx.y * kTileCols;
  const int kt = k - c0 < kTileCols ? k - c0 : kTileCols;
  for (int c = threadIdx.x; c < 2 * kt; c += blockDim.x) acc[c] = 0.0f;
  __syncthreads();
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t hi = lo + chunk < n_pairs ? lo + chunk : n_pairs;
  for (int64_t i = lo; i < hi; ++i) {
    const float ws = w[i];
    if (ws == 0.0f) continue;
    float* row = acc + (y[i] == 1 ? 0 : kt);
    const float* p1 = staged + 2 * i * slots_n;
    const float* p2 = p1 + slots_n;
    for (int l = threadIdx.x; l < slots_n; l += blockDim.x) {
      const int c = slots[i * slots_n + l] - c0;
      if (c >= 0 && c < kt)
        row[c] += __fmul_rn(__fmul_rn(p1[l], p2[l]), ws);
    }
    __syncthreads();
  }
  float* dst = partial + static_cast<int64_t>(blockIdx.x) * 2 * k + c0;
  for (int c = threadIdx.x; c < kt; c += blockDim.x) {
    dst[c] = acc[c];
    dst[k + c] = acc[kt + c];
  }
}

// The wide form (W > 64): a block of one warp a pair, each slot's inputs,
// phis and exponentials in the region after match_slots_wide's facts
// (kWideExtra words a slot), lane g owning slots g, g + 32, ...: the
// rounds of run_rounds, slot by slot.
constexpr int kWideExtra = 7;

struct WideSlots {
  float* ep;
  float* eq;
  float* f;
  float* p1;
  float* p2;
  float* x1;
  float* x2;
  const int* live;
  int n;   // 2W
};

__device__ __forceinline__ WideSlots load_slots_wide(
    const SparseArgs& a, const svt::WideMatch& m, bool link, int lane) {
  const int w = a.w_top;
  const int n = 2 * w;
  WideSlots s{m.own,         m.own + n,     m.own + 2 * n, m.own + 3 * n,
              m.own + 4 * n, m.own + 5 * n, m.own + 6 * n, m.first, n};
  const float kw = static_cast<float>(a.k - w > 1 ? a.k - w : 1);
  const float tail_p = fmaxf(m.rest_p / kw, 1e-10f);
  const float tail_q = fmaxf(m.rest_q / kw, 1e-10f);
  const float dp = svt::digamma_f(m.tot_p), dq = svt::digamma_f(m.tot_q);
  float live = 0.0f;
  for (int i = lane; i < n; i += svt::kWarp) {
    s.ep[i] = svt::digamma_f(svt::value_at(m.vals, m.at_p[i], tail_p)) - dp;
    s.eq[i] = svt::digamma_f(svt::value_at(m.vals, m.at_q[i], tail_q)) - dq;
    const int c = m.slots[i];
    const int cc = c < 0 ? 0 : (c >= a.k ? a.k - 1 : c);
    s.f[i] = __ldg(a.elogbeta + 2 * cc + (link ? 0 : 1));
    live += s.live[i] ? 1.0f : 0.0f;
  }
  // phi = 1/(live slots) on the live slots (start_phi)
  const float v = __fdiv_rn(1.0f, svt::warp_sum(live));
  for (int i = lane; i < n; i += svt::kWarp)
    s.p1[i] = s.p2[i] = s.live[i] ? v : 0.0f;
  return s;
}

template <bool LINK, bool RECORD>
__device__ int run_rounds_wide(const SparseArgs& a, const WideSlots& s,
                               int lane, int limit, uint64_t* mask_out) {
  const float le = a.log_eps;
  const float n_slots = static_cast<float>(s.n);
  int r = 0;
  bool stable = false;
  uint64_t word = 0;
  while (r < limit) {
    float m1 = -INFINITY, m2 = -INFINITY;
    for (int i = lane; i < s.n; i += svt::kWarp) {
      const bool live = s.live[i] != 0;
      s.x1[i] = logit<LINK>(s.f[i], s.p2[i], s.ep[i], le, live);
      s.x2[i] = logit<LINK>(s.f[i], s.p1[i], s.eq[i], le, live);
      m1 = fmaxf(m1, s.x1[i]);
      m2 = fmaxf(m2, s.x2[i]);
    }
    m1 = svt::group_max<svt::kWarp>(m1, svt::kFull);
    m2 = svt::group_max<svt::kWarp>(m2, svt::kFull);
    float s1 = 0.0f, s2 = 0.0f;
    for (int i = lane; i < s.n; i += svt::kWarp) {
      s.x1[i] = expf(s.x1[i] - m1);
      s.x2[i] = expf(s.x2[i] - m2);
      s1 += s.x1[i];
      s2 += s.x2[i];
    }
    s1 = svt::warp_sum(s1);
    s2 = svt::warp_sum(s2);
    float d1 = 0.0f, d2 = 0.0f;
    bool same = true;
    for (int i = lane; i < s.n; i += svt::kWarp) {
      const float n1 = __fdiv_rn(s.x1[i], s1), n2 = __fdiv_rn(s.x2[i], s2);
      if constexpr (RECORD) {
        d1 += fabsf(n1 - s.p1[i]);
        d2 += fabsf(n2 - s.p2[i]);
        same = same && __float_as_uint(n1) == __float_as_uint(s.p1[i]) &&
               __float_as_uint(n2) == __float_as_uint(s.p2[i]);
      }
      s.p1[i] = n1;
      s.p2[i] = n2;
    }
    ++r;
    if constexpr (RECORD) {
      d1 = svt::warp_sum(d1);
      d2 = svt::warp_sum(d2);
      if (!(fmaxf(d1 / n_slots, d2 / n_slots) >= a.thresh))
        word |= uint64_t{1} << ((r - 1) & 63);
      stable = __ballot_sync(svt::kFull, !same) == 0u;
      if ((r & 63) == 0) {
        if (lane == 0) mask_out[(r >> 6) - 1] = word;
        word = 0;
      }
      if (stable) break;
    }
  }
  if constexpr (RECORD) {
    if (stable) word |= ~uint64_t{0} << (r & 63);
    if (lane == 0)
      for (int j = r >> 6; j < a.words; ++j)
        mask_out[j] = j == (r >> 6) ? word : (stable ? ~uint64_t{0} : 0);
    return stable ? r - 1 : r;
  }
  return r;
}

// sparse_pair_kernel's wide form: a block of one warp a pair, its region
// in shared memory (scratch null) or scratch + blockIdx.x * region words
template <bool FINISH>
__global__ void __launch_bounds__(svt::kWarp)
sparse_pair_wide_kernel(const SparseArgs a, float* scratch,
                        int64_t region_words) {
  extern __shared__ float smem[];
  float* const region =
      scratch == nullptr ? smem : scratch + blockIdx.x * region_words;
  const int lane = threadIdx.x;
  const int slots_n = 2 * a.w_top;
  const int64_t n_items = a.n_pairs + (FINISH ? 0 : a.pad);
  for (int64_t item = blockIdx.x; item < n_items; item += gridDim.x) {
    const bool real = item < a.n_pairs;
    const float w = real ? a.w[item] : 0.0f;
    int limit = a.max_iters;
    if constexpr (FINISH) {
      limit = a.block_rounds[0];
      if (lane == 0) a.rounds[item] = limit;
      if (w == 0.0f || a.stop[item] <= limit) continue;
    }
    const bool link = real && a.y[item] == 1;
    const int64_t p = real ? a.pairs[2 * item] : 0;
    const int64_t q = real ? a.pairs[2 * item + 1] : 0;
    const svt::WideMatch m = svt::match_slots_wide(
        a.ids, a.vals, a.rest, p, q, a.w_top, lane, region);
    const WideSlots s = load_slots_wide(a, m, link, lane);
    if constexpr (FINISH) {
      if (link)
        run_rounds_wide<true, false>(a, s, lane, limit, nullptr);
      else
        run_rounds_wide<false, false>(a, s, lane, limit, nullptr);
    } else {
      uint64_t* const mo = a.masks + item * a.words;
      const int r = link
          ? run_rounds_wide<true, true>(a, s, lane, limit, mo)
          : run_rounds_wide<false, true>(a, s, lane, limit, mo);
      if (lane == 0) a.stop[item] = r;
      if (w == 0.0f) continue;
    }
    float* const s1 = a.staged + 2 * item * slots_n;
    float* const s2 = s1 + slots_n;
    int32_t* const sl = a.slots + item * slots_n;
    for (int i = lane; i < slots_n; i += svt::kWarp) {
      s1[i] = s.p1[i];
      s2[i] = s.p2[i];
      if constexpr (!FINISH) sl[i] = s.live[i] ? m.slots[i] : -1;
    }
  }
}

using PairKernel = void (*)(SparseArgs);

template <int G, int NS>
PairKernel pair_kernel_gn(bool finish) {
  return finish ? sparse_pair_kernel<G, NS, true>
                : sparse_pair_kernel<G, NS, false>;
}

PairKernel pair_kernel(int g, int ns, bool finish) {
  if (g == 32) {
    if (ns == 4) return pair_kernel_gn<32, 4>(finish);
    if (ns == 3) return pair_kernel_gn<32, 3>(finish);
    if (ns == 2) return pair_kernel_gn<32, 2>(finish);
    return pair_kernel_gn<32, 1>(finish);
  }
  if (g == 16) return pair_kernel_gn<16, 1>(finish);
  if (g == 8) return pair_kernel_gn<8, 1>(finish);
  if (g == 4) return pair_kernel_gn<4, 1>(finish);
  return pair_kernel_gn<2, 1>(finish);
}

// lets `kernel` take `bytes` of dynamic shared memory, past the default
// 48 KB up to the card's opt-in
cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// The step's sums on the sparse state. In: ids, vals, rest (the state),
// elogbeta (K, 2), pairs (n_pairs, 2) int32 global ids, y, w (n_pairs,);
// the CSR of the pairs' ends over the T touched rows (ops/edges.py
// owner_csr of [lp | lq] interleaved: slot 2i pair i's first end, 2i + 1
// its second), whose hub segments seg_partial (n_segs, K) holds. Out:
// gacc (T, K) gamma_hat, lam_sums (2K: lambda_hat's link column, then its
// nonlink column), rounds (n_pairs,) R. Scratch: staged (2 n_pairs, 2W),
// slots (n_pairs, 2W), masks ((n_pairs + pad) words u64), stop (n_pairs +
// pad), block_rounds (1), lam_partial (ceil(n_pairs / chunk), 2K). `block`
// is the minibatch's padded length: pad = 1 when n_pairs < block. Above W
// = 64 (the wide form), wide_scratch holds the regions of
// svt::wide_scratch_regions where a region outgrows the card's shared
// memory (svt_sparse_fastamm_scratch's floats; null otherwise).
extern "C" int svt_sparse_fastamm(
    const int32_t* ids, const float* vals, const float* rest,
    const float* elogbeta, const int32_t* pairs, const int32_t* y,
    const float* w, float* staged, int32_t* slots, uint64_t* masks,
    int32_t* stop, int32_t* block_rounds, int32_t* rounds,
    const int32_t* rowptr, const int32_t* nbr, const int32_t* hub_node,
    const int32_t* hub_segptr, const int32_t* seg_node,
    const int32_t* seg_begin, const int32_t* seg_end, float* seg_partial,
    float* lam_partial, float* lam_sums, float* gacc, int64_t n_pairs,
    int64_t n_rows, int64_t n_hubs, int64_t n_segs, int k, int w_top,
    int seg_len, int max_iters, float log_eps, float thresh, int block,
    int chunk, float* wide_scratch, cudaStream_t stream) {
  const int g = svt::slot_lanes(w_top);
  const int ns = svt::slots_per_lane(w_top);
  const bool wide = w_top > svt::kNarrowMaxW;
  if (k <= 0 || w_top < 1 || w_top >= k || n_pairs > block || chunk <= 0 ||
      max_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slots_n = 2 * w_top;
  const int words = max_iters > 64 ? (max_iters + 63) / 64 : 1;
  const int pad = n_pairs < block ? 1 : 0;
  const SparseArgs a{ids,        vals,  rest,    elogbeta,  pairs,
                     y,          w,     staged,  slots,     masks,
                     stop,       block_rounds,   rounds,    n_pairs,
                     k,          w_top, max_iters, words,   pad,
                     log_eps,    thresh};
  const int tiles = (k + kTileCols - 1) / kTileCols;
  const size_t row_bytes = sizeof(float) * (k < kTileCols ? k : kTileCols);
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(gacc_rows_kernel), row_bytes);
  if (err == cudaSuccess)
    err = allow_smem(reinterpret_cast<const void*>(lam_chunks_kernel),
                     2 * row_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t chunks = (n_pairs + chunk - 1) / chunk;
  if (n_pairs > 0 && wide) {
    // a block of one warp a pair, its region in shared memory where it
    // fits the card's opt-in, else in the caller's scratch (one region a
    // block in flight)
    const int64_t region = svt::wide_words(w_top, kWideExtra);
    int64_t regions = 0;
    err = svt::wide_scratch_regions(w_top, kWideExtra, &regions);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool in_smem = regions == 0;
    if (!in_smem && wide_scratch == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const int64_t cap = in_smem ? int64_t{32} * svt::sm_count() : regions;
    int64_t blocks = n_pairs + pad;
    blocks = blocks < cap ? blocks : cap;
    const size_t smem = in_smem ? sizeof(float) * region : 0;
    float* const scratch = in_smem ? nullptr : wide_scratch;
    err = allow_smem(
        reinterpret_cast<const void*>(sparse_pair_wide_kernel<false>), smem);
    if (err == cudaSuccess)
      err = allow_smem(
          reinterpret_cast<const void*>(sparse_pair_wide_kernel<true>), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sparse_pair_wide_kernel<false><<<static_cast<unsigned>(blocks),
                                     svt::kWarp, smem, stream>>>(a, scratch,
                                                                 region);
    svt::block_rounds_kernel<<<1, svt::kWarp, 0, stream>>>(
        masks, words, n_pairs, block, pad, max_iters, block_rounds, 1);
    sparse_pair_wide_kernel<true><<<static_cast<unsigned>(blocks),
                                    svt::kWarp, smem, stream>>>(a, scratch,
                                                                region);
  } else if (n_pairs > 0) {
    const int64_t per_block = kPairThreads / g;
    int64_t blocks = (n_pairs + pad + per_block - 1) / per_block;
    const int64_t card = int64_t{8} * svt::sm_count();
    blocks = blocks < card ? blocks : card;
    const size_t staged_bytes =
        sizeof(float) * per_block * svt::pair_rows_words(w_top);
    pair_kernel(g, ns, false)<<<static_cast<unsigned>(blocks), kPairThreads,
                                staged_bytes, stream>>>(a);
    svt::block_rounds_kernel<<<1, svt::kWarp, 0, stream>>>(
        masks, words, n_pairs, block, pad, max_iters, block_rounds, 1);
    pair_kernel(g, ns, true)<<<static_cast<unsigned>(blocks), kPairThreads,
                               staged_bytes, stream>>>(a);
  }
  if (n_pairs > 0) {
    const dim3 grid(static_cast<unsigned>(chunks), tiles);
    lam_chunks_kernel<<<grid, kRowThreads, 2 * row_bytes, stream>>>(
        staged, slots, y, w, n_pairs, chunk, slots_n, k, lam_partial);
    svt::launch_colsum_partials(lam_partial, static_cast<int>(chunks),
                                2 * k, 2 * k, lam_sums, stream);
  } else {
    cudaMemsetAsync(lam_sums, 0, sizeof(float) * 2 * k, stream);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // every touched row, then the hubs' segments into their scratch rows,
  // added in segment order
  const int64_t cap = int64_t{8} * svt::sm_count();
  const svt::AdjItems nodes{rowptr, nbr, nullptr, nullptr, nullptr, n_rows,
                            seg_len};
  if (n_rows > 0) {
    const dim3 grid(static_cast<unsigned>(n_rows < cap ? n_rows : cap),
                    tiles);
    gacc_rows_kernel<<<grid, kRowThreads, row_bytes, stream>>>(
        nodes, staged, slots, w, slots_n, k, gacc);
  }
  if (n_segs > 0) {
    const svt::AdjItems segs{rowptr,  nbr,    seg_node, seg_begin,
                             seg_end, n_segs, seg_len};
    const dim3 grid(static_cast<unsigned>(n_segs < cap ? n_segs : cap),
                    tiles);
    gacc_rows_kernel<<<grid, kRowThreads, row_bytes, stream>>>(
        segs, staged, slots, w, slots_n, k, seg_partial);
    svt::launch_combine_segments(seg_partial, hub_node, hub_segptr, gacc,
                                 n_hubs, k, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// Floats of device scratch svt_sparse_fastamm takes at top width w_top on
// the current device (0: none) into *words. No launch.
extern "C" int svt_sparse_fastamm_scratch(int w_top, int64_t* words) {
  if (w_top < 1) return static_cast<int>(cudaErrorInvalidValue);
  int64_t regions = 0;
  const cudaError_t err =
      svt::wide_scratch_regions(w_top, kWideExtra, &regions);
  *words = regions * svt::wide_words(w_top, kWideExtra);
  return static_cast<int>(err);
}
