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
// dead slot, 0 elsewhere.
//
// The exit rule. The whole minibatch is one block of the JAX rule
// (svinet_tpu/svi/fastamm.py pads it to its fixed length with pairs (0, 0)
// of y = 0, w = 0; one virtual pair (0, 0) here stands for all of them):
// every pair runs the same rounds, and the block ends after the first
// round whose largest change over its pairs is not >= thresh (a NaN ends
// it, as the while loop's cond does), or after max_iters. A pair's change
// is the larger mean |phi' - phi| over its 2W slots, dead ones included.
// R is that round, and the pairs' phis after round R are the result.
//
// The design: one launch a call, the rounds on chip. The padded minibatch
// runs its rounds in lockstep; the pairs' largest change of each round is
// reduced across the CTAs that hold them, and all of them take the
// same exit. Then, in the same launch after one barrier, the sums, each
// unit over a tile of 2,048 columns in shared memory (so that any K runs):
// gamma_hat's rows and its hubs' segments (the endpoint CSR's, of at most
// 32 entries in the engine's steps) a warp a unit of a row's tile, adding
// w phi of the pair ends in the CSR's entry order, while a warp writes a
// row of one pair end or none whole, zeros and then its end's values (a
// hub's minibatch is 16,000 such rows); lambda_hat's chunks of 256 pairs a
// CTA a unit, each warp adding w phi1 phi2 of a contiguous share of the
// pairs in pair order, the warps' rows then added in warp order. After a
// second barrier the hubs' rows and lambda_hat are sums of their partial
// rows in order. No float atomics and no memset: two launches give the
// same bits, and every output is written.
//
// Two forms, by the block's size:
// - Cluster form (W <= 128 and (pairs + 1) G <= 16 x 512, the engine's
//   minibatch of 256): a thread-block cluster of 16 CTAs (past the
//   portable 8; the H100 holds it), a group of G lanes a pair
//   (match_slots; a warp above W = 64, up to 8 slots a lane), the slots'
//   inputs and phis in registers (kernel 15's pattern,
//   csrc/orig_fixed_point.cu): each round's change, reduced in each CTA,
//   is stored in that CTA's shared memory, and after one cluster barrier
//   every CTA reads the 16 through distributed shared memory.
// - Grid form (a hub's minibatch of 16,384, or W > 128): one cooperative
//   grid (all its CTAs resident) whose groups step several pairs each,
//   every pair's inputs and two buffers of phis in its record in device
//   memory (a hub's state at W = 128 is 134 MB: more than the card's
//   registers and shared memory hold). Rounds go in windows of up to
//   kWindow: a pair's window runs in registers (W <= 128, the cluster
//   form's groups and arithmetic; past it a warp a pair in the record,
//   match_slots_wide, its exponentials in its region of shared memory or
//   of device scratch past the card's shared memory) from one buffer into
//   the other, keeping a bit a round for a change >= thresh and one for a
//   NaN; the bits are ORed over the grid at one grid barrier a window.
//   The first round of the window that ends the block is R, and each pair
//   runs again from the window's start up to R (unless the window's last
//   round was R and went into buffer 0). So a round costs no barrier and
//   no trip through device memory, and R costs up to a window's rounds
//   past it and as many again.
// The forms in registers run the same code on the same groups, so they
// give the same bits; over records a lane's slots g, g + 32, ... are
// summed in that order, then the warp's tree, as a warp a pair in
// registers sums them. The logits are rounded as the plain version forms
// them (logit<LINK>, no fma) and the softmax divides with __fdiv_rn, so R
// is the plain version's but at a tie within an f32 unit of thresh. If the card refuses a launch shape (no
// cluster of 16 fits, or the cooperative grid does not), the call fails.
//
// What bounds it on an H100: a pair reads 2W ids and values of each end
// and runs a few rounds of 4W exponentials; the (T, K) gamma_hat rows it
// writes (T the touched rows: 4.5 MB at T = 142 and K = 8,000, 512 MB for
// a hub's 16,001 rows) are the bytes. A minibatch of 256 pairs is far from
// any rate of the card: there the launch and the rounds' barriers are the
// time.

#include <math.h>

#include <cooperative_groups.h>

#include <map>
#include <mutex>
#include <set>
#include <tuple>

#include "sparse_slots.cuh"

namespace cg = cooperative_groups;

namespace {

// CTAs of the cluster form: 16, past the portable 8 (the H100 holds such
// clusters in its GPCs of 16 and 18 SMs), so that a CTA of 512 threads
// has 128 registers a thread and the sums 16 SMs
constexpr int kCluster = 16;
constexpr int kClusterThreads = 512;    // most threads a CTA of it
// widest W the cluster form holds in registers: 2W slots over a warp, 8
// a lane
constexpr int kClusterMaxW = 128;
constexpr int kGridThreads = 512;       // most threads a CTA of the grid form
// columns a sums unit holds: a unit walks its pair ends' slots once a
// tile, so a wider tile reads them fewer times (16 warps' tiles take 128 KB
// of shared memory)
constexpr int kTile = 2048;
constexpr int kLamChunk = 256;          // pairs a chunk of lambda_hat
// loads a lane has in flight in the sums: the CTAs that hold pairs in
// registers have 128 registers a thread (a CTA an SM), the grid form's
// over records 64 (two CTAs an SM)
constexpr int kClusterInFlight = 16;
constexpr int kGridInFlight = 8;
// most rounds the grid form runs between two grid barriers: a pair's
// rounds in a window cost no barrier and no trip through device memory,
// and R costs up to a window's rounds past it and again. A window costs
// about R / kWindow passes and kWindow rounds more than R, least near
// kWindow = sqrt(R x a pass / a round): 4 for a hub's minibatch at W =
// 64-128 (R 9-16, a pass through device memory about 1.5 rounds there)
constexpr int kWindow = 4;
// gamma_hat floats a CTA of the grid form is given to write, at least
constexpr int64_t kRowFloatsPerCta = 128 * 1024;
// shared memory kept from the card's opt-in for the static arrays
constexpr int kStaticReserve = 4 * 1024;

struct Args {
  const int32_t* ids;      // (n, W)
  const float* vals;       // (n, W)
  const float* rest;       // (n,)
  const float* elogbeta;   // (K, 2)
  const int32_t* pairs;    // (m, 2) global node ids
  const int32_t* y;        // (m,)
  const float* w;          // (m,)
  // the endpoint CSR over the T touched rows (ops/edges.py owner_csr of
  // [lp | lq] interleaved: entry slot 2i is pair i's first end, 2i + 1 its
  // second)
  const int32_t* rowptr;
  const int32_t* nbr;
  const int32_t* hub_node;
  const int32_t* hub_segptr;
  const int32_t* seg_node;
  const int32_t* seg_begin;
  const int32_t* seg_end;
  float* records;          // (m + 1, 16W): a pair's phi1, phi2, slots'
                           // communities (int, -1 dead), Elogpi_p,
                           // Elogpi_q (the grid form's: the dead logit on
                           // a dead slot), Elogf, and the grid form's
                           // second phi1, phi2, 2W each
  float* seg_partial;      // (n_segs, K)
  float* lam_partial;      // (chunks, 2K) where chunks > 1
  float* xch;              // grid form: (2, grid CTAs) changes
  float* regions;          // grid form: a warp's region in device memory,
                           // or null (in shared memory)
  float* gacc;             // (T, K)
  float* lam_sums;         // (2K): the link column, then the nonlink one
  int32_t* rounds;         // (m,) R
  int64_t m;
  int64_t items;           // pairs run: m + the virtual one, 0 when m = 0
  int64_t n_rows;          // T
  int64_t n_hubs;
  int64_t n_segs;
  int64_t region_words;    // grid form: a warp's region
  int k;
  int w_top;
  int seg_len;
  int max_iters;
  int chunks;              // ceil(m / kLamChunk)
  float log_eps;
  float thresh;
};

// NaN-propagating max, as jnp.maximum and .max() take it
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float warp_nan_max(float v) {
#pragma unroll
  for (int off = svt::kWarp / 2; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(svt::kFull, v, off));
  return v;
}

__device__ __forceinline__ float* record(const Args& a, int64_t item) {
  return a.records + item * (int64_t{16} * a.w_top);
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

// ---------------------------------------------------------------------
// The cluster form: a pair's slots, lane by lane, in registers.

template <int NS>
struct Slots {
  int id[NS];
  float ep[NS], eq[NS], f[NS];
  bool in[NS], live[NS];
};

template <int NS>
__device__ __forceinline__ void load_slots(const Args& a,
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

// One round of a pair in registers; returns its change in every lane of
// the group.
template <int G, int NS, bool LINK>
__device__ __forceinline__ float round_regs(const Slots<NS>& s,
                                            float (&p1)[NS], float (&p2)[NS],
                                            float le, float n_slots,
                                            unsigned mask) {
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
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    if (!s.in[j]) continue;
    const float n1 = __fdiv_rn(l1[j], s1), n2 = __fdiv_rn(l2[j], s2);
    d1 += fabsf(n1 - p1[j]);
    d2 += fabsf(n2 - p2[j]);
    p1[j] = n1;
    p2[j] = n2;
  }
  d1 = svt::group_sum<G>(d1, mask);
  d2 = svt::group_sum<G>(d2, mask);
  return nan_max(d1 / n_slots, d2 / n_slots);
}

// ---------------------------------------------------------------------
// The grid form past kClusterMaxW: a warp a pair, its slots g, g + 32,
// ... in its record.

// The pair's slot inputs and its starting phis into its record, from its
// match in the warp's region.
__device__ __forceinline__ void setup_record(const Args& a,
                                             const svt::WideMatch& m,
                                             bool link, float* rec,
                                             int lane) {
  const int w = a.w_top;
  const int n2 = 2 * w;
  int* const cols = reinterpret_cast<int*>(rec + 2 * n2);
  float* const ep = rec + 3 * n2;
  float* const eq = rec + 4 * n2;
  float* const f = rec + 5 * n2;
  const float kw = static_cast<float>(a.k - w > 1 ? a.k - w : 1);
  const float tail_p = fmaxf(m.rest_p / kw, 1e-10f);
  const float tail_q = fmaxf(m.rest_q / kw, 1e-10f);
  const float dp = svt::digamma_f(m.tot_p), dq = svt::digamma_f(m.tot_q);
  float live = 0.0f;
  for (int i = lane; i < n2; i += svt::kWarp) {
    // a dead slot's Elogpi is the dead logit itself: -1e30 plus anything
    // a round adds to it is -1e30, as the plain version's x + (-1e30) is
    const float vp = svt::value_at(m.vals, m.at_p[i], tail_p);
    const float vq = svt::value_at(m.vals, m.at_q[i], tail_q);
    ep[i] = m.first[i] ? svt::digamma_f(vp) - dp : svt::kDeadLogit;
    eq[i] = m.first[i] ? svt::digamma_f(vq) - dq : svt::kDeadLogit;
    const int c = m.slots[i];
    const int cc = c < 0 ? 0 : (c >= a.k ? a.k - 1 : c);
    f[i] = __ldg(a.elogbeta + 2 * cc + (link ? 0 : 1));
    cols[i] = m.first[i] ? c : -1;
    live += m.first[i] ? 1.0f : 0.0f;
  }
  // phi = 1/(live slots) on the live slots (svinet_tpu/ops/sparse_gamma.py:
  // 111-113, the softmax of 0 and -1e30)
  const float v = __fdiv_rn(1.0f, svt::warp_sum(live));
  for (int i = lane; i < n2; i += svt::kWarp)
    rec[i] = rec[n2 + i] = m.first[i] ? v : 0.0f;
}

// One round of the pair in rec from the phis at src into those at dst
// (src == dst: in place), the warp's scratch in x (8W floats, its own):
// one pass over the record (its loads four slots deep; a dead slot's
// Elogpi is the dead logit) puts each slot's logits and old phis in x, the
// softmax runs there, and the new phis go to dst. Returns the pair's
// change in every lane.
template <bool LINK>
__device__ float round_record(const float* rec, const float* src,
                              float* dst, float* x, int n2, float le,
                              int lane) {
  const float* const ep = rec + 3 * n2;
  const float* const eq = rec + 4 * n2;
  const float* const f = rec + 5 * n2;
  float* const x1 = x;
  float* const x2 = x + n2;
  float* const o1 = x + 2 * n2;
  float* const o2 = x + 3 * n2;
  float m1 = -INFINITY, m2 = -INFINITY;
#pragma unroll 4
  for (int i = lane; i < n2; i += svt::kWarp) {
    const float a1 = src[i], a2 = src[n2 + i];
    const float v1 = logit<LINK>(f[i], a2, ep[i], le, true);
    const float v2 = logit<LINK>(f[i], a1, eq[i], le, true);
    x1[i] = v1;
    x2[i] = v2;
    o1[i] = a1;
    o2[i] = a2;
    m1 = fmaxf(m1, v1);
    m2 = fmaxf(m2, v2);
  }
  m1 = svt::group_max<svt::kWarp>(m1, svt::kFull);
  m2 = svt::group_max<svt::kWarp>(m2, svt::kFull);
  float s1 = 0.0f, s2 = 0.0f;
  for (int i = lane; i < n2; i += svt::kWarp) {
    x1[i] = expf(x1[i] - m1);
    x2[i] = expf(x2[i] - m2);
    s1 += x1[i];
    s2 += x2[i];
  }
  s1 = svt::warp_sum(s1);
  s2 = svt::warp_sum(s2);
  float d1 = 0.0f, d2 = 0.0f;
  for (int i = lane; i < n2; i += svt::kWarp) {
    const float n1 = __fdiv_rn(x1[i], s1), n2v = __fdiv_rn(x2[i], s2);
    d1 += fabsf(n1 - o1[i]);
    d2 += fabsf(n2v - o2[i]);
    dst[i] = n1;
    dst[n2 + i] = n2v;
  }
  d1 = svt::warp_sum(d1);
  d2 = svt::warp_sum(d2);
  const float ns = static_cast<float>(n2);
  return nan_max(d1 / ns, d2 / ns);
}

// A round's bits in a window's word: bit i, a pair's change at the
// window's round i is >= thresh; bit kNanBit + i, it is NaN
constexpr int kNanBit = 16;
static_assert(kWindow <= kNanBit, "a window's bits share a word");

__device__ __forceinline__ unsigned round_bits(float d, float thresh,
                                               int i) {
  return (d >= thresh ? 1u << i : 0u) | (d != d ? 1u << (kNanBit + i) : 0u);
}

// n rounds of the pair in rec from the phis at offset src into those at
// dst, its slots in registers (G lanes, NS slots a lane, as the cluster
// form holds them: the same arithmetic, so the same bits); returns the
// rounds' bits in every lane of the group.
template <int G, int NS, bool LINK>
__device__ unsigned window_regs(const Args& a, float* rec, int64_t src,
                                int64_t dst, int n, int g, unsigned mask) {
  const int n2 = 2 * a.w_top;
  Slots<NS> s;
  float p1[NS], p2[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int i = g + j * G;
    s.in[j] = i < n2;
    // a dead slot's Elogpi is the dead logit, which gives the cluster
    // form's -1e30 (x + -1e30 there, -1e30 + x here)
    s.live[j] = true;
    s.ep[j] = s.in[j] ? rec[3 * n2 + i] : 0.0f;
    s.eq[j] = s.in[j] ? rec[4 * n2 + i] : 0.0f;
    s.f[j] = s.in[j] ? rec[5 * n2 + i] : 0.0f;
    p1[j] = s.in[j] ? rec[src + i] : 0.0f;
    p2[j] = s.in[j] ? rec[src + n2 + i] : 0.0f;
  }
  const float n_slots = static_cast<float>(n2);
  unsigned word = 0;
  for (int i = 0; i < n; ++i)
    word |= round_bits(
        round_regs<G, NS, LINK>(s, p1, p2, a.log_eps, n_slots, mask),
        a.thresh, i);
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    if (!s.in[j]) continue;
    rec[dst + g + j * G] = p1[j];
    rec[dst + n2 + g + j * G] = p2[j];
  }
  return word;
}

// The same in the record (W past the registers' reach): the first round
// from src into dst, the others in place at dst.
template <bool LINK>
__device__ unsigned window_record(const Args& a, float* rec, float* x,
                                  int64_t src, int64_t dst, int n,
                                  int lane) {
  const int n2 = 2 * a.w_top;
  unsigned word = 0;
  for (int i = 0; i < n; ++i) {
    word |= round_bits(
        round_record<LINK>(rec, rec + (i == 0 ? src : dst), rec + dst, x,
                           n2, a.log_eps, lane),
        a.thresh, i);
    __syncwarp();   // x is read before the next round writes it
  }
  return word;
}

// ---------------------------------------------------------------------
// The sums, a warp a unit, each unit's tile of kTile floats its own.

__device__ __forceinline__ void zero_tile(float* tile, int kt, int lane) {
  for (int c = 4 * lane; c < kt; c += 4 * svt::kWarp)
    *reinterpret_cast<float4*>(tile + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();
}

// dst[0, kt) = tile (null: zeros), in 16-byte stores where dst allows
__device__ __forceinline__ void write_tile(float* dst, const float* tile,
                                           int kt, int lane) {
  __syncwarp();
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && (kt & 3) == 0) {
    for (int c = 4 * lane; c < kt; c += 4 * svt::kWarp)
      *reinterpret_cast<float4*>(dst + c) =
          tile ? *reinterpret_cast<const float4*>(tile + c)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int c = lane; c < kt; c += svt::kWarp) dst[c] = tile ? tile[c] : 0.0f;
  }
  __syncwarp();
}

// tile[c - c0] += w phi at each live slot of the CSR entries [begin, end)
// whose community c lies in [c0, c0 + kt), entry after entry: a pair's
// live slots are distinct communities, so one entry's adds never meet;
// the lanes load kInFlight (entry, 32-slot block) items ahead, and the
// adds of an entry end with a warp barrier. Entries of weight 0 add
// nothing. Each column takes its adds in entry order.
template <int kInFlight>
__device__ void add_entries(const Args& a, float* tile, int begin, int end,
                            int c0, int kt, int lane) {
  const int n2 = 2 * a.w_top;
  const int nb = (n2 + svt::kWarp - 1) / svt::kWarp;
  for (int j0 = begin; j0 < end; j0 += svt::kWarp) {
    const int cnt = end - j0 < svt::kWarp ? end - j0 : svt::kWarp;
    int slot_l = 0;
    float ws_l = 0.0f;
    if (lane < cnt) {
      slot_l = __ldg(a.nbr + j0 + lane);
      ws_l = __ldg(a.w + (slot_l >> 1));
    }
    const int total = cnt * nb;
    for (int f0 = 0; f0 < total; f0 += kInFlight) {
      int col[kInFlight];
      float val[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int f = f0 + u;
        const int e = f / nb;
        const int l = (f - e * nb) * svt::kWarp + lane;
        const int slot = __shfl_sync(svt::kFull, slot_l, e & 31);
        const float ws = __shfl_sync(svt::kFull, ws_l, e & 31);
        col[u] = -1;
        val[u] = 0.0f;
        if (f < total && ws != 0.0f && l < n2) {
          const float* rec = record(a, slot >> 1);
          col[u] = __ldcg(reinterpret_cast<const int*>(rec + 2 * n2) + l);
          val[u] = __ldcg(rec + (slot & 1) * n2 + l);
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int f = f0 + u;
        const int e = f / nb;
        const float ws = __shfl_sync(svt::kFull, ws_l, e & 31);
        const int c = col[u] - c0;
        if (col[u] >= 0 && c >= 0 && c < kt) tile[c] += __fmul_rn(ws, val[u]);
        if (f < total && f - e * nb == nb - 1) __syncwarp();
      }
    }
  }
}

// A row unit: out[c0, c0 + kt) of the row whose entries are [begin, end)
template <int kInFlight>
__device__ void row_unit(const Args& a, float* tile, int begin, int end,
                         int c0, float* out, int lane) {
  const int kt = a.k - c0 < kTile ? a.k - c0 : kTile;
  zero_tile(tile, kt, lane);
  add_entries<kInFlight>(a, tile, begin, end, c0, kt, lane);
  write_tile(out + c0, tile, kt, lane);
}

// A whole row of one entry or none, out[0, K): zeros, then the entry's
// values at its live slots (0 + w phi, as a sum from zero makes it; the
// warp barrier orders the stores). One chain of loads a row, where a
// tile a unit would take one a tile.
__device__ void lone_row(const Args& a, int begin, int end, float* out,
                         int lane) {
  write_tile(out, nullptr, a.k, lane);
  if (begin == end) return;
  const int slot = __ldg(a.nbr + begin);
  const float ws = __ldg(a.w + (slot >> 1));
  if (ws == 0.0f) return;
  const int n2 = 2 * a.w_top;
  const float* const rec = record(a, slot >> 1);
  for (int l = lane; l < n2; l += svt::kWarp) {
    const int c = __ldcg(reinterpret_cast<const int*>(rec + 2 * n2) + l);
    if (c >= 0) out[c] = __fmul_rn(ws, __ldcg(rec + (slot & 1) * n2 + l));
  }
}

// t1[c - c0] (a link) or t0[c - c0] (a nonlink) += w phi1 phi2 at each
// live slot of the pairs [lo, hi) whose community c lies in [c0, c0 +
// kt), pair after pair, as add_entries goes.
template <int kInFlight>
__device__ void add_pairs(const Args& a, float* t1, float* t0, int64_t lo,
                          int64_t hi, int c0, int kt, int lane) {
  const int n2 = 2 * a.w_top;
  const int nb = (n2 + svt::kWarp - 1) / svt::kWarp;
  for (int64_t i0 = lo; i0 < hi; i0 += svt::kWarp) {
    const int cnt =
        static_cast<int>(hi - i0 < svt::kWarp ? hi - i0 : svt::kWarp);
    float ws_l = 0.0f;
    int link_l = 0;
    if (lane < cnt) {
      ws_l = __ldg(a.w + i0 + lane);
      link_l = __ldg(a.y + i0 + lane) == 1;
    }
    const int total = cnt * nb;
    for (int f0 = 0; f0 < total; f0 += kInFlight) {
      int col[kInFlight];
      float v1[kInFlight], v2[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int f = f0 + u;
        const int e = f / nb;
        const int l = (f - e * nb) * svt::kWarp + lane;
        const float ws = __shfl_sync(svt::kFull, ws_l, e & 31);
        col[u] = -1;
        v1[u] = v2[u] = 0.0f;
        if (f < total && ws != 0.0f && l < n2) {
          const float* rec = record(a, i0 + e);
          col[u] = __ldcg(reinterpret_cast<const int*>(rec + 2 * n2) + l);
          v1[u] = __ldcg(rec + l);
          v2[u] = __ldcg(rec + n2 + l);
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int f = f0 + u;
        const int e = f / nb;
        const float ws = __shfl_sync(svt::kFull, ws_l, e & 31);
        const bool lk = __shfl_sync(svt::kFull, link_l, e & 31) != 0;
        const int c = col[u] - c0;
        if (col[u] >= 0 && c >= 0 && c < kt)
          (lk ? t1 : t0)[c] += __fmul_rn(__fmul_rn(v1[u], v2[u]), ws);
        if (f < total && f - e * nb == nb - 1) __syncwarp();
      }
    }
  }
}

// A unit over the whole CTA (every thread calls it): its items [lo, hi)
// (CSR entries, or with lam pairs of lambda_hat) cut into a contiguous
// range a warp, each warp adding its range in order into its own tile
// (tiles + warp * stride), then the warps' tiles added in warp order into
// dst[c0, c0 + kt) (with lam, the link row there and the nonlink row at
// dst + K). A long walk so takes a warp's share of the time.
template <int kInFlight>
__device__ void cta_unit(const Args& a, float* tiles, int64_t stride,
                         bool lam, int64_t lo, int64_t hi, int c0,
                         float* dst, int warp, int warps, int lane) {
  const int half = lam ? kTile / 2 : kTile;
  const int kt = a.k - c0 < half ? a.k - c0 : half;
  float* const t = tiles + warp * stride;
  zero_tile(t, kTile, lane);
  const int64_t len = (hi - lo + warps - 1) / warps;
  const int64_t b = lo + warp * len;
  const int64_t e = b + len < hi ? b + len : hi;
  if (b < e) {
    if (lam)
      add_pairs<kInFlight>(a, t, t + half, b, e, c0, kt, lane);
    else
      add_entries<kInFlight>(a, t, static_cast<int>(b), static_cast<int>(e),
                             c0, kt, lane);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < kt; c += blockDim.x) {
    float s1 = 0.0f, s0 = 0.0f;
    for (int w = 0; w < warps; ++w) {
      s1 += tiles[w * stride + c];
      if (lam) s0 += tiles[w * stride + half + c];
    }
    dst[c0 + c] = s1;
    if (lam) dst[a.k + c0 + c] = s0;
  }
  __syncthreads();   // the tiles are read before the next unit zeroes them
}

// Every unit of the sums. Over CTAs (CTA `cta` of n_cta taking units cta,
// cta + n_cta, ...): lambda_hat's chunks, each a cta_unit. Over warps
// (warp `warp` of each CTA): the hubs' segments, a row_unit a tile, then
// the rows, a row a warp: a lone_row, or a row_unit a tile, a hub row
// left to its segments. The
// CSR's segment length bounds a warp's walk (the engine cuts at
// ops/sparse_gamma.py's K10_SEG_LEN).
template <int kInFlight>
__device__ void sums_phase(const Args& a, float* tiles, int64_t stride,
                           int cta, int n_cta, int warp, int warps,
                           int lane) {
  const int k = a.k;
  const int half = kTile / 2;
  const int64_t tiles_n = (k + kTile - 1) / kTile;
  const int64_t lam_tiles = (k + half - 1) / half;
  const int64_t lam_units = int64_t{a.chunks > 1 ? a.chunks : 1} * lam_tiles;
  for (int64_t u = cta; u < lam_units; u += n_cta) {
    const int64_t chunk = u / lam_tiles;
    const int64_t lo = chunk * kLamChunk;
    const int64_t hi = lo + kLamChunk < a.m ? lo + kLamChunk : a.m;
    cta_unit<kInFlight>(a, tiles, stride, true, lo, hi,
             static_cast<int>(u % lam_tiles) * half,
             a.chunks > 1 ? a.lam_partial + chunk * 2 * int64_t{k}
                          : a.lam_sums,
             warp, warps, lane);
  }
  float* const tile = tiles + warp * stride;
  const int64_t seg_units = a.n_segs * tiles_n;
  for (int64_t u = int64_t{cta} * warps + warp; u < seg_units + a.n_rows;
       u += int64_t{n_cta} * warps) {
    if (u < seg_units) {
      const int64_t v = u / tiles_n;
      row_unit<kInFlight>(a, tile, a.seg_begin[v], a.seg_end[v],
                          static_cast<int>(u % tiles_n) * kTile,
                          a.seg_partial + v * k, lane);
      continue;
    }
    const int64_t v = u - seg_units;
    const int begin = a.rowptr[v], end = a.rowptr[v + 1];
    if (end - begin > a.seg_len) continue;
    if (end - begin <= 1) {
      lone_row(a, begin, end, a.gacc + v * k, lane);
      continue;
    }
    for (int c0 = 0; c0 < k; c0 += kTile)
      row_unit<kInFlight>(a, tile, begin, end, c0, a.gacc + v * k, lane);
  }
}

// sum += rows[r * stride] for r in [lo, hi), in that order, kInFlight
// loads at a time
template <int kInFlight>
__device__ __forceinline__ float sum_rows(const float* rows, int64_t stride,
                                          int64_t lo, int64_t hi) {
  float s = 0.0f;
  for (int64_t r0 = lo; r0 < hi; r0 += kInFlight) {
    float v[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j)
      v[j] = r0 + j < hi ? __ldcg(rows + (r0 + j) * stride) : 0.0f;
#pragma unroll
    for (int j = 0; j < kInFlight; ++j)
      if (r0 + j < hi) s += v[j];
  }
  return s;
}

// After the sums' barrier: each hub's row is its segments' rows added in
// segment order, and lambda_hat its chunks' rows added in chunk order
// (more than one chunk), a value a thread.
__device__ void finish_phase(const Args& a, int64_t tid, int64_t n_t) {
  const int64_t k = a.k;
  const int64_t hub_cols = a.n_hubs * k;
  const int64_t lam_cols = a.chunks > 1 ? 2 * k : 0;
  for (int64_t t = tid; t < hub_cols + lam_cols; t += n_t) {
    if (t < hub_cols) {
      const int64_t h = t / k, c = t % k;
      a.gacc[int64_t{a.hub_node[h]} * k + c] = sum_rows<16>(
          a.seg_partial + c, k, a.hub_segptr[h], a.hub_segptr[h + 1]);
    } else {
      const int64_t c = t - hub_cols;
      a.lam_sums[c] = sum_rows<16>(a.lam_partial + c, 2 * k, 0, a.chunks);
    }
  }
}

// ---------------------------------------------------------------------
// The kernels.

// floats between two warps' regions in the grid form's shared memory: the
// region or the sum tile, whichever is larger, on a 16-byte boundary
__host__ __device__ inline int64_t region_stride(int64_t region_words) {
  return ((region_words > kTile ? region_words : kTile) + 3) / 4 * 4;
}

// The cluster form: CTA r of the cluster holds pairs [r groups, (r + 1)
// groups), a group of G lanes each; the dynamic shared memory holds the
// groups' match tables, then the warps' sum tiles. A round ends with the
// CTA's change (its warps' through shared memory) stored into its own
// xch and one cluster barrier, after which every warp reduces the
// cluster's 16 copies.
template <int G, int NS>
__global__ void __launch_bounds__(kClusterThreads, 1)
fastamm_cluster_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kClusterThreads / svt::kWarp];
  // the CTA's change of the round, read by every CTA of the cluster after
  // the round's barrier; two, so that a round's store cannot meet the
  // previous round's reads (a CTA stores again only after the next
  // barrier, which every CTA reaches after its reads)
  __shared__ float xch[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_rank = static_cast<int>(cluster.num_blocks());
  const int lane = threadIdx.x % svt::kWarp;
  const int warp = threadIdx.x / svt::kWarp;
  const int warps = blockDim.x / svt::kWarp;
  const int g = threadIdx.x % G;
  const unsigned mask = svt::group_mask<G>(lane);
  const int gi = threadIdx.x / G;
  const int64_t item = int64_t{rank} * (blockDim.x / G) + gi;
  const bool have = item < a.items;
  const bool real = item < a.m;
  const int n2 = 2 * a.w_top;
  Slots<NS> s;
  float p1[NS], p2[NS];
  bool link = false;
  float* const rec = record(a, real ? item : 0);
  if (have) {
    link = real && a.y[item] == 1;
    const int64_t p = real ? a.pairs[2 * item] : 0;
    const int64_t q = real ? a.pairs[2 * item + 1] : 0;
    load_slots<NS>(a,
                   svt::match_slots<G, NS>(
                       a.ids, a.vals, a.rest, p, q, a.w_top, g, mask,
                       smem + gi * svt::pair_rows_words(a.w_top)),
                   link, s);
    float live = 0.0f;
#pragma unroll
    for (int j = 0; j < NS; ++j) live += s.live[j] ? 1.0f : 0.0f;
    const float v = __fdiv_rn(1.0f, svt::group_sum<G>(live, mask));
#pragma unroll
    for (int j = 0; j < NS; ++j) p1[j] = p2[j] = s.live[j] ? v : 0.0f;
    if (real) {
      int* const cols = reinterpret_cast<int*>(rec + 2 * n2);
#pragma unroll
      for (int j = 0; j < NS; ++j)
        if (s.in[j]) cols[g + j * G] = s.live[j] ? s.id[j] : -1;
    }
  }
  const float n_slots = static_cast<float>(n2);
  int rounds = 0;
  for (int r = 1; r <= a.max_iters && a.items > 0; ++r) {
    float d = -INFINITY;
    if (have)
      d = link ? round_regs<G, NS, true>(s, p1, p2, a.log_eps, n_slots, mask)
               : round_regs<G, NS, false>(s, p1, p2, a.log_eps, n_slots,
                                          mask);
    d = warp_nan_max(d);
    if (lane == 0) red[warp] = d;
    __syncthreads();
    if (warp == 0) {
      const float v = warp_nan_max(lane < warps ? red[lane] : -INFINITY);
      if (lane == 0) xch[r & 1] = v;
    }
    // every CTA's change stored in its own shared memory, and every CTA
    // of the cluster running, before any reads another's
    cluster.sync();
    const float all = warp_nan_max(
        lane < n_rank ? *cluster.map_shared_rank(&xch[r & 1], lane)
                      : -INFINITY);
    rounds = r;
    if (!(all >= a.thresh)) break;
  }
  if (have && real) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (!s.in[j]) continue;
      rec[g + j * G] = p1[j];
      rec[n2 + g + j * G] = p2[j];
    }
  }
  const int64_t tid = int64_t{rank} * blockDim.x + threadIdx.x;
  const int64_t n_t = int64_t{n_rank} * blockDim.x;
  for (int64_t i = tid; i < a.m; i += n_t) a.rounds[i] = rounds;
  __threadfence();
  cluster.sync();   // every record written; no CTA writes xch any more
  sums_phase<kClusterInFlight>(a, smem, kTile, rank, n_rank, warp, warps,
                               lane);
  __threadfence();
  cluster.sync();
  finish_phase(a, tid, n_t);
}

// A pair's inputs and starting phis into its record, from its match in
// registers (the grid form at W <= kClusterMaxW: G lanes, NS slots a lane,
// its match table at `table`).
template <int G, int NS>
__device__ void setup_regs(const Args& a, int64_t item, float* table, int g,
                           unsigned mask) {
  const bool real = item < a.m;
  const bool link = real && a.y[item] == 1;
  const int64_t p = real ? a.pairs[2 * item] : 0;
  const int64_t q = real ? a.pairs[2 * item + 1] : 0;
  Slots<NS> s;
  load_slots<NS>(a,
                 svt::match_slots<G, NS>(a.ids, a.vals, a.rest, p, q,
                                         a.w_top, g, mask, table),
                 link, s);
  float live = 0.0f;
#pragma unroll
  for (int j = 0; j < NS; ++j) live += s.live[j] ? 1.0f : 0.0f;
  const float v = __fdiv_rn(1.0f, svt::group_sum<G>(live, mask));
  const int n2 = 2 * a.w_top;
  float* const rec = record(a, item);
  int* const cols = reinterpret_cast<int*>(rec + 2 * n2);
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    if (!s.in[j]) continue;
    const int i = g + j * G;
    rec[i] = rec[n2 + i] = s.live[j] ? v : 0.0f;
    cols[i] = s.live[j] ? s.id[j] : -1;
    rec[3 * n2 + i] = s.live[j] ? s.ep[j] : svt::kDeadLogit;
    rec[4 * n2 + i] = s.live[j] ? s.eq[j] : svt::kDeadLogit;
    rec[5 * n2 + i] = s.f[j];
  }
}

// n rounds of pair `item` from the phis at offset src of its record into
// those at dst: in registers (NS > 0) or in the record, x the warp's
// region (NS = 0). Returns the rounds' bits in every lane of the group.
template <int G, int NS>
__device__ unsigned run_window(const Args& a, int64_t item, float* x,
                               int64_t src, int64_t dst, int n, int g,
                               unsigned mask, int lane) {
  const bool link = item < a.m && a.y[item] == 1;
  float* const rec = record(a, item);
  if constexpr (NS > 0) {
    return link ? window_regs<G, NS, true>(a, rec, src, dst, n, g, mask)
                : window_regs<G, NS, false>(a, rec, src, dst, n, g, mask);
  } else {
    return link ? window_record<true>(a, rec, x, src, dst, n, lane)
                : window_record<false>(a, rec, x, src, dst, n, lane);
  }
}

// The grid form: group gg of the grid (G lanes a pair, NS slots a lane in
// registers; NS = 0: a warp a pair, its slots in its record, its region
// (match table, then logits) in shared memory or at regions + its warp's
// region_words) holds pairs gg, gg + groups, ... Set-up puts each pair's
// inputs and starting phis into its record (buffer 0 of its two buffers
// of phis). Then windows of up to kWindow rounds: each pair runs them from
// buffer cur into the other, the rounds' bits ORed over the grid through
// device memory at one grid barrier. The first of the window's rounds
// whose bits end the block (no change >= thresh, or a NaN), or max_iters,
// is R; each pair then runs again from buffer cur into buffer 0 up to
// round R, unless the window's last round into buffer 0 was R.
template <int G, int NS>
__global__ void __launch_bounds__(kGridThreads, NS > 0 ? 1 : 2)
fastamm_grid_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned red[kGridThreads / svt::kWarp];
  __shared__ unsigned all_s;
  constexpr int kG = NS > 0 ? G : svt::kWarp;
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x % svt::kWarp;
  const int warp = threadIdx.x / svt::kWarp;
  const int warps = blockDim.x / svt::kWarp;
  const int g = threadIdx.x % kG;
  const unsigned mask = svt::group_mask<kG>(lane);
  const int64_t gg = (int64_t{blockIdx.x} * blockDim.x + threadIdx.x) / kG;
  const int64_t n_gg = int64_t{gridDim.x} * blockDim.x / kG;
  const int64_t own = region_stride(a.region_words);
  float* const region =
      a.regions != nullptr
          ? a.regions + (int64_t{blockIdx.x} * warps + warp) * a.region_words
          : smem + warp * own;
  for (int64_t item = gg; item < a.items; item += n_gg) {
    if constexpr (NS > 0) {
      setup_regs<G, NS>(a, item, smem + threadIdx.x / G *
                                            svt::pair_rows_words(a.w_top),
                        g, mask);
    } else {
      const bool real = item < a.m;
      setup_record(a,
                   svt::match_slots_wide(a.ids, a.vals, a.rest,
                                         real ? a.pairs[2 * item] : 0,
                                         real ? a.pairs[2 * item + 1] : 0,
                                         a.w_top, lane, region),
                   real && a.y[item] == 1, record(a, item), lane);
      __syncwarp();   // the region is read before the next pair's match
    }
  }
  const int64_t second = int64_t{12} * a.w_top;   // buffer 1's offset
  int rounds = 0;
  if (a.items > 0 && a.max_iters > 0) {
    int cur = 0, done = 0;
    for (int win = 0;; ++win) {
      const int n = a.max_iters - done < kWindow ? a.max_iters - done
                                                 : kWindow;
      unsigned word = 0;
      for (int64_t item = gg; item < a.items; item += n_gg)
        word |= run_window<G, NS>(a, item, region, cur * second,
                                  (1 - cur) * second, n, g, mask, lane);
      word = __reduce_or_sync(svt::kFull, word);
      if (lane == 0) red[warp] = word;
      __syncthreads();
      unsigned* const xr =
          reinterpret_cast<unsigned*>(a.xch) + (win & 1) * int64_t{gridDim.x};
      if (threadIdx.x == 0) {
        unsigned v = 0;
        for (int w = 0; w < warps; ++w) v |= red[w];
        xr[blockIdx.x] = v;
      }
      grid.sync();
      if (warp == 0) {
        unsigned v = 0;
        for (int b = lane; b < static_cast<int>(gridDim.x); b += svt::kWarp)
          v |= __ldcg(xr + b);
        v = __reduce_or_sync(svt::kFull, v);
        if (lane == 0) all_s = v;
      }
      __syncthreads();
      const unsigned all = all_s;
      int stop = -1;
      for (int i = 0; i < n && stop < 0; ++i)
        if (!((all >> i) & 1u) || ((all >> (kNanBit + i)) & 1u)) stop = i;
      if (stop < 0 && done + n == a.max_iters) stop = n - 1;
      if (stop >= 0) {
        rounds = done + stop + 1;
        if (cur == 0 || stop < n - 1)
          for (int64_t item = gg; item < a.items; item += n_gg)
            run_window<G, NS>(a, item, region, cur * second, 0, stop + 1, g,
                              mask, lane);
        break;
      }
      done += n;
      cur = 1 - cur;
    }
  }
  const int64_t tid = int64_t{blockIdx.x} * blockDim.x + threadIdx.x;
  const int64_t n_t = int64_t{gridDim.x} * blockDim.x;
  for (int64_t i = tid; i < a.m; i += n_t) a.rounds[i] = rounds;
  grid.sync();   // every record written
  sums_phase<(NS > 0 ? kClusterInFlight : kGridInFlight)>(
      a, smem, NS > 0 || a.regions != nullptr ? kTile : own, blockIdx.x,
      gridDim.x, warp, warps, lane);
  grid.sync();
  finish_phase(a, tid, n_t);
}

using Kernel = void (*)(Args);

template <int G, int NS>
Kernel form_kernel(bool grid) {
  return grid ? fastamm_grid_kernel<G, NS> : fastamm_cluster_kernel<G, NS>;
}

// lanes a pair in registers: match_slots's groups up to W = 64
// (csrc/sparse_slots.cuh), a warp above
int reg_lanes(int w) { return w <= svt::kNarrowMaxW ? svt::slot_lanes(w)
                                                   : svt::kWarp; }

// The kernel of a form at top width w: g = reg_lanes(w) lanes a pair and
// ns slots a lane (2, 3 take 2, 4; 5-7 take 8: a slot past 2W is idle),
// or, past kClusterMaxW, the grid form over records.
Kernel pick_kernel(int w, bool grid) {
  if (w > kClusterMaxW) return fastamm_grid_kernel<svt::kWarp, 0>;
  const int g = reg_lanes(w);
  const int ns = (2 * w + g - 1) / g;
  if (g == 32) {
    if (ns > 4) return form_kernel<32, 8>(grid);
    if (ns > 2) return form_kernel<32, 4>(grid);
    if (ns == 2) return form_kernel<32, 2>(grid);
    return form_kernel<32, 1>(grid);
  }
  if (g == 16) return form_kernel<16, 1>(grid);
  if (g == 8) return form_kernel<8, 1>(grid);
  if (g == 4) return form_kernel<4, 1>(grid);
  return form_kernel<2, 1>(grid);
}

// What the launches need of the card, each asked once a process: the
// shared memory opt-in (set on each kernel once), the clusters the card
// holds of a cluster form's shape, and the grid form's plan at each W.
struct GridPlan {
  Kernel fn;
  int lanes;              // a pair's
  int warps;              // a CTA's
  int ctas;               // the grid's
  int64_t region_words;   // over records: a warp's region
  int in_scratch;         // the regions in device memory
  size_t smem;
};

std::mutex g_lock;

cudaError_t card_optin(int* dev, int* optin) {
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  static std::map<int, int> cache;
  std::lock_guard<std::mutex> hold(g_lock);
  const auto hit = cache.find(*dev);
  if (hit != cache.end()) {
    *optin = hit->second;
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               *dev);
  if (err == cudaSuccess) cache[*dev] = *optin;
  return err;
}

// lets `fn` take the card's opt-in of dynamic shared memory and (cluster)
// clusters of kCluster CTAs, once
cudaError_t allow_smem(const void* fn, int dev, int optin,
                       bool cluster = false) {
  static std::set<std::pair<const void*, int>> done;
  std::lock_guard<std::mutex> hold(g_lock);
  if (done.count({fn, dev})) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      optin - kStaticReserve);
  if (err == cudaSuccess && cluster)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done.insert({fn, dev});
  return err;
}

cudaError_t grid_plan(int w, GridPlan* out) {
  int dev = 0, optin = 0;
  cudaError_t err = card_optin(&dev, &optin);
  if (err != cudaSuccess) return err;
  static std::map<std::pair<int, int>, GridPlan> cache;
  {
    std::lock_guard<std::mutex> hold(g_lock);
    const auto hit = cache.find({w, dev});
    if (hit != cache.end()) {
      *out = hit->second;
      return cudaSuccess;
    }
  }
  GridPlan pl{};
  pl.fn = pick_kernel(w, true);
  err = allow_smem(reinterpret_cast<const void*>(pl.fn), dev, optin);
  if (err != cudaSuccess) return err;
  const int64_t room = optin - kStaticReserve;
  if (w <= kClusterMaxW) {
    // in registers: a CTA of kGridThreads an SM, the groups' match tables
    // or the warps' sum tiles in shared memory
    pl.lanes = reg_lanes(w);
    pl.warps = kGridThreads / svt::kWarp;
    const int64_t tables =
        int64_t{kGridThreads / pl.lanes} * svt::pair_rows_words(w);
    const int64_t tiles = int64_t{pl.warps} * kTile;
    pl.smem = sizeof(float) * (tables > tiles ? tables : tiles);
    if (static_cast<int64_t>(pl.smem) > room)
      return cudaErrorInvalidConfiguration;
  } else {
    pl.lanes = svt::kWarp;
    pl.region_words = svt::wide_words(w, 0);
    const int64_t own = sizeof(float) * region_stride(pl.region_words);
    pl.in_scratch = own > room ? 1 : 0;
    if (pl.in_scratch) {
      // regions in device memory: two warps a CTA, a CTA an SM
      pl.warps = 2;
      pl.smem = sizeof(float) * kTile * pl.warps;
    } else {
      const int64_t fit = room / own;
      pl.warps = static_cast<int>(fit < kGridThreads / svt::kWarp
                                      ? fit : kGridThreads / svt::kWarp);
      pl.smem = static_cast<size_t>(own) * pl.warps;
    }
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pl.fn, pl.warps * svt::kWarp, pl.smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  per_sm = pl.in_scratch ? 1 : (per_sm < 2 ? per_sm : 2);
  pl.ctas = per_sm * svt::sm_count();
  std::lock_guard<std::mutex> hold(g_lock);
  cache[{w, dev}] = pl;
  *out = pl;
  return cudaSuccess;
}

// Floats of the device part of the workspace under plan pl: the grid
// form's changes (2 a CTA) and, where they outgrow shared memory, its
// regions.
int64_t device_words(const GridPlan& pl) {
  return 2 * int64_t{pl.ctas} +
         (pl.in_scratch ? int64_t{pl.ctas} * pl.warps * pl.region_words : 0);
}

// whether the card holds a cluster of kCluster CTAs of this shape, asked
// once a shape
cudaError_t cluster_fits(Kernel fn, int threads, size_t smem,
                         int dev) {
  static std::set<std::tuple<const void*, int, size_t, int>> ok;
  const auto key = std::make_tuple(reinterpret_cast<const void*>(fn),
                                   threads, smem, dev);
  {
    std::lock_guard<std::mutex> hold(g_lock);
    if (ok.count(key)) return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  std::lock_guard<std::mutex> hold(g_lock);
  ok.insert(key);
  return cudaSuccess;
}

}  // namespace

// The step's sums on the sparse state, in one launch. In: ids, vals, rest
// (the state), elogbeta (K, 2), pairs (n_pairs, 2) int32 global ids, y, w
// (n_pairs,); the endpoint CSR of the pairs' ends over the T = n_rows
// touched rows (ops/edges.py owner_csr of [lp | lq] interleaved). Out:
// gacc (T, K) gamma_hat, lam_sums (2K: lambda_hat's link column, then its
// nonlink column), rounds (n_pairs,) R. `work` (work_words floats) holds
// the pairs' records, the hub segments' and lambda_hat's partial rows,
// then the device part of svt_sparse_fastamm_scratch; the call fails when
// it is smaller than that. `block` is the minibatch's padded length: the
// virtual pair runs when n_pairs < block.
extern "C" int svt_sparse_fastamm(
    const int32_t* ids, const float* vals, const float* rest,
    const float* elogbeta, const int32_t* pairs, const int32_t* y,
    const float* w, const int32_t* rowptr, const int32_t* nbr,
    const int32_t* hub_node, const int32_t* hub_segptr,
    const int32_t* seg_node, const int32_t* seg_begin,
    const int32_t* seg_end, float* work, int64_t work_words, float* gacc,
    float* lam_sums, int32_t* rounds, int64_t n_pairs, int64_t n_rows,
    int64_t n_hubs, int64_t n_segs, int k, int w_top, int seg_len,
    int max_iters, float log_eps, float thresh, int block,
    cudaStream_t stream) {
  if (k <= 0 || w_top < 1 || w_top >= k || n_pairs < 0 || n_pairs > block ||
      max_iters < 0 || n_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t err = card_optin(&dev, &optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  GridPlan gp;
  err = grid_plan(w_top, &gp);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t chunks = (n_pairs + kLamChunk - 1) / kLamChunk;
  const int64_t rec_words = (n_pairs + 1) * int64_t{16} * w_top;
  const int64_t seg_words = n_segs * int64_t{k};
  const int64_t lam_words = chunks > 1 ? chunks * 2 * int64_t{k} : 0;
  if (work_words < rec_words + seg_words + lam_words + device_words(gp))
    return static_cast<int>(cudaErrorInvalidValue);
  float* const xch = work + rec_words + seg_words + lam_words;
  const Args a{ids,
               vals,
               rest,
               elogbeta,
               pairs,
               y,
               w,
               rowptr,
               nbr,
               hub_node,
               hub_segptr,
               seg_node,
               seg_begin,
               seg_end,
               work,
               work + rec_words,
               work + rec_words + seg_words,
               xch,
               gp.in_scratch ? xch + 2 * int64_t{gp.ctas} : nullptr,
               gacc,
               lam_sums,
               rounds,
               n_pairs,
               n_pairs > 0 ? n_pairs + (n_pairs < block ? 1 : 0) : 0,
               n_rows,
               n_hubs,
               n_segs,
               gp.region_words,
               k,
               w_top,
               seg_len,
               max_iters,
               static_cast<int>(chunks),
               log_eps,
               thresh};
  const int g = reg_lanes(w_top);
  if (w_top <= kClusterMaxW &&
      a.items * g <= int64_t{kCluster} * kClusterThreads) {
    // a group a pair over the cluster's CTAs; as many warps as the pairs
    // or the sums' units (two a warp: a segment's tile, a row) want, up to
    // kClusterThreads
    const int64_t units = n_segs * ((k + kTile - 1) / kTile) + n_rows +
                          2 * (chunks > 1 ? chunks : 1);
    int64_t per = (a.items * g + kCluster - 1) / kCluster;
    const int64_t by_units = (units + 2 * kCluster - 1) / (2 * kCluster) *
                             svt::kWarp;
    per = per > by_units ? per : by_units;
    per = (per + svt::kWarp - 1) / svt::kWarp * svt::kWarp;
    const int threads = static_cast<int>(
        per < svt::kWarp ? svt::kWarp
                         : (per > kClusterThreads ? kClusterThreads : per));
    const int64_t tables =
        int64_t{threads / g} * svt::pair_rows_words(w_top);
    const int64_t tiles = int64_t{threads / svt::kWarp} * kTile;
    const size_t smem = sizeof(float) * (tables > tiles ? tables : tiles);
    const Kernel fn = pick_kernel(w_top, false);
    err = allow_smem(reinterpret_cast<const void*>(fn), dev, optin, true);
    if (err == cudaSuccess) err = cluster_fits(fn, threads, smem, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(kCluster);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, fn, a);
  } else {
    // as many CTAs as the pairs (a group each) and the rows' bytes want,
    // up to the plan's: a grid barrier costs more the more CTAs meet at it
    const int64_t per_cta = int64_t{gp.warps} * svt::kWarp / gp.lanes;
    const int64_t by_pairs = (a.items + per_cta - 1) / per_cta;
    const int64_t by_rows = (n_rows * k + kRowFloatsPerCta - 1) /
                            kRowFloatsPerCta;
    int64_t ctas = by_pairs > by_rows ? by_pairs : by_rows;
    ctas = ctas < 1 ? 1 : (ctas > gp.ctas ? gp.ctas : ctas);
    void* params[] = {const_cast<Args*>(&a)};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(gp.fn),
        dim3(static_cast<unsigned>(ctas)), dim3(gp.warps * svt::kWarp),
        params, gp.smem, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The workspace's device part at top width w_top on the current device:
// its floats into words[0] (the workspace is the pairs' records, (n_pairs +
// 1) 16 W floats, the hub segments' rows, n_segs K, lambda_hat's chunk rows
// where there is more than one chunk of 256 pairs, ceil(n_pairs / 256) 2K,
// then this part), and into words[1] 1 where the grid form's regions sit
// in device memory, 0 where in shared memory. No launch.
extern "C" int svt_sparse_fastamm_scratch(int w_top, int64_t* words) {
  if (w_top < 1) return static_cast<int>(cudaErrorInvalidValue);
  GridPlan pl;
  const cudaError_t err = grid_plan(w_top, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  words[0] = device_words(pl);
  words[1] = pl.in_scratch;
  return 0;
}
