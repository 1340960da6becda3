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
//    read twice (the second read hits L1/L2);
//  - under -bf16 the result is stored as bf16 by the same pass (6 bytes an
//    element, not 8 and then a cast's 6 more).
//
// The top-W form (-sparse-w; svinet_tpu/svi/sweep_math.py:241-245, which
// computes Elogpi, then jax.lax.top_k(gamma, W) and a gather of Elogpi at
// the W columns): the same pass also writes, per row, the W columns of
// the largest gamma in descending order, lower column first among equal
// values (jax.lax.top_k's order: columns left at exactly alpha tie, and a
// sparse sweep leaves many there), Elogpi at those columns (topvals) and
// the mean indicators of the sweep before at them (topm, which kernel 7
// then reads beside the ids, not at random). Elogpi goes into the even
// half of the (n, K, 2) rows of -sparse-w that kernel 7 gathers, whose odd
// half holds those mean indicators (element stride 2).
//
// The selection, with the row in registers (a group of G lanes, W <= G):
//  1. the W-th largest of the G lanes' own largest gamma, `lo`, by one
//     bitonic sort of G 32-bit values across the group (gamma > 0, so its
//     bits order as its values); above W = G/2, of the lanes' two largest
//     each (2G values). At least W values are >= lo, so every pick is;
//  2. the values above lo are picks; when fewer than W, lo is the W-th
//     largest value itself, and the ties at lo fill the rest in column
//     order (a prefix count over the lanes, unit by unit);
//  3. the picks (at most 2G; W of them when ties were taken), as 64-bit
//     keys (gamma's bits, then the column's complement: no two equal),
//     go through the group's slots in shared memory into one bitonic
//     sort, largest first: jax.lax.top_k's order.
// The first design's W rounds of a group arg-max over 64-bit keys (kept
// in csrc/alt/topw_v1.cu) took about 40
// instructions a round plus a rescan of 16 keys whenever a lane's four
// buffered keys ran out: 3.37 ms at (1M, 500), W=16, 4.81 at W=32,
// against 1.34 for kernel 1 alone. This selection into the pairs takes
// 3.7 and 3.9 ms on the stretch engine state, where the pairs' bytes, 10
// GB a pass, take 3.0 at the card's rate (H100 80GB HBM3, 700 W,
// tools/bench_kernels.py --only sparse). Those rounds stay as the
// general path: W above 2G, or more than 2G values above lo (at W = 64
// and K = 500, most rows). Above 512 columns one warp per row takes them,
// scanning its row from the L1.
//
// The digamma it takes is svt::digamma_f (common.cuh), shared with the
// kernels of the sparse top-W state.

#include <climits>

#include "common.cuh"

namespace {

using svt::digamma_bounded;
using svt::digamma_f;
using svt::expectation_f;

// OutT: Elogpi leaves as f32, or straight as bf16 (-bf16 gathers it at
// half the bytes), rounded to nearest even in the store: one pass, not an
// f32 write and a cast. `rest` is added to the row sum before psi: the
// Dirichlet mass of the columns a compacted gamma (-prune) leaves out
// (svinet_tpu/svi/sweep_math.py:289-299, compact_elogpi); 0 otherwise.
template <int VEC, int G, int N, class OutT>
__global__ void __launch_bounds__(svt::kBlockThreads)
dirichlet_rows_kernel(const float* __restrict__ x, OutT* __restrict__ out,
                      int64_t rows, int k, float rest) {
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
  const float ds = digamma_f(svt::group_sum<G>(s, mask) + rest);
  // units past the row hold 0, where digamma is -inf; they are not stored
#pragma unroll
  for (int i = 0; i < L; ++i) v[i] = expectation_f(v[i], ds);
  svt::store_row<VEC, G, N>(out + r * k, k, g, v);
}

template <class OutT>
__global__ void __launch_bounds__(svt::kBlockThreads)
dirichlet_wide_kernel(const float* __restrict__ x, OutT* __restrict__ out,
                      int64_t rows, int k, float rest) {
  const int lane = threadIdx.x % svt::kWarp;
  const int64_t r =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) /
      svt::kWarp;
  if (r >= rows) return;
  const float* xr = x + r * k;
  float s = 0.0f;
  for (int c = lane; c < k; c += svt::kWarp) s += xr[c];
  const float ds = digamma_f(svt::warp_sum(s) + rest);
  OutT* orow = out + r * k;
  for (int c = lane; c < k; c += svt::kWarp)
    svt::store_scalar(orow + c, expectation_f(xr[c], ds));
}

// The top-W selection's general path. A column's key is its gamma's bits
// above the column's complement: gamma > 0, so keys order as (value
// first, lower column first among equal values), jax.lax.top_k's order,
// and no two keys are equal. Each lane keeps, sorted, the kBuf largest of
// its own keys below its last pick; a round takes the group's largest
// head, and only the lane that held it pops its buffer (and scans its
// columns again once the buffer is empty).
constexpr int kBuf = 4;

__device__ __forceinline__ uint64_t column_key(float v, int c) {
  return (static_cast<uint64_t>(__float_as_uint(v)) << 32) |
         (0xffffffffu - static_cast<uint32_t>(c));
}

__device__ __forceinline__ int key_column(uint64_t key) {
  return static_cast<int>(0xffffffffu - static_cast<uint32_t>(key));
}

// Offer `key` to the sorted buffer (largest first); 0 is an empty slot.
__device__ __forceinline__ void buffer_insert(uint64_t (&buf)[kBuf],
                                              uint64_t key) {
  if (key <= buf[kBuf - 1]) return;
#pragma unroll
  for (int i = kBuf - 1; i > 0; --i)
    buf[i] = key > buf[i - 1] ? buf[i - 1] : (key > buf[i] ? key : buf[i]);
  buf[0] = key > buf[0] ? key : buf[0];
}

__device__ __forceinline__ void buffer_pop(uint64_t (&buf)[kBuf]) {
#pragma unroll
  for (int i = 0; i + 1 < kBuf; ++i) buf[i] = buf[i + 1];
  buf[kBuf - 1] = 0;
}

template <int G>
__device__ __forceinline__ uint64_t group_max_key(uint64_t key,
                                                  unsigned mask) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const uint64_t other = __shfl_xor_sync(mask, key, off);
    key = other > key ? other : key;
  }
  return key;
}

// W rounds over the group's buffers; `refill(below)` fills this lane's
// empty buffer with its largest keys below `below`. Lane 0 of the group
// writes the picked columns to id_row.
template <int G, class Refill>
__device__ __forceinline__ void select_top(uint64_t (&buf)[kBuf], int w,
                                           unsigned mask, int g,
                                           int32_t* id_row, Refill refill) {
  for (int t = 0; t < w; ++t) {
    const uint64_t best = group_max_key<G>(buf[0], mask);
    if (g == 0) id_row[t] = key_column(best);
    if (buf[0] == best) {
      buffer_pop(buf);
      if (buf[0] == 0) refill(best);
    }
  }
}

// Where the form writes. `pairs` is the (n, K, 2) rows of -sparse-w:
// Elogpi goes into the even half, and the odd half holds the mean
// indicators of the sweep before, which topm takes at the picks.
struct TopwOut {
  float* pairs;         // (rows, k, 2)
  int32_t* ids;         // (rows, w)
  float* topvals;       // (rows, w)
  float* topm;          // (rows, w)
};

// Row r's topvals and topm at the picks in id_row, read back from the
// pairs the group wrote (plain loads: __syncwarp orders the group's stores
// before them).
__device__ __forceinline__ void gather_picked(const TopwOut& o, int64_t r,
                                              int k, int w, int g, int group,
                                              unsigned mask) {
  __syncwarp(mask);
  const int32_t* id_row = o.ids + r * w;
  const float* prow = o.pairs + r * k * 2;
  for (int t = g; t < w; t += group) {
    const int c = id_row[t];
    o.topvals[r * w + t] = prow[2 * c];
    o.topm[r * w + t] = prow[2 * c + 1];
  }
}

// Bitonic sort, largest first, of the R * G keys that a group of G lanes
// holds R to a lane (element i = reg * G + lane). Partners closer than G
// are other lanes (a shuffle); farther ones are another register of the
// same lane.
template <int G, int R, class Key>
__device__ __forceinline__ void group_sort_desc(Key (&key)[R], int g,
                                                unsigned mask) {
#pragma unroll
  for (int size = 2; size <= R * G; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      if (stride >= G) {
        const int rs = stride / G;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if ((r & rs) == 0) {
            const bool desc = ((r * G + g) & size) == 0;
            // (r + rs) % R is r + rs here; the modulus keeps a branch
            // that is dead for R = 1 inside the array
            const Key a = key[r], b = key[(r + rs) % R];
            const bool swap = desc ? a < b : a > b;
            key[r] = swap ? b : a;
            key[(r + rs) % R] = swap ? a : b;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const Key other = __shfl_xor_sync(mask, key[r], stride);
          const int i = r * G + g;
          // the lower element of a pair keeps the larger key in a
          // descending run, the smaller in an ascending one
          const bool take_max = ((i & stride) == 0) == ((i & size) == 0);
          key[r] = take_max ? (other > key[r] ? other : key[r])
                            : (other < key[r] ? other : key[r]);
        }
      }
    }
  }
}

template <int G>
__device__ __forceinline__ int group_sum_int(int v, unsigned mask) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off);
  return v;
}

// The sum of v over the lanes of the group below this one.
template <int G>
__device__ __forceinline__ int group_scan_excl(int v, int g, unsigned mask) {
  int x = v;
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    const int y = __shfl_up_sync(mask, x, off, G);
    if (g >= off) x += y;
  }
  return x - v;
}

// Slots a group of G lanes has in shared memory for its picks.
__host__ __device__ constexpr int pick_slots(int g) { return 2 * g; }

// Steps 1-3 of the selection (see the top of the file) for row r, whose
// gamma this lane holds in v (layout <VEC, G, N>; units past the row hold
// 0). `slots` are the group's pick_slots(G) keys of shared memory.
// Writes ids, topvals and topm and returns true, or returns false (the
// same in every lane of the group) when W > 2G or more than 2G values lie
// above lo: the general path's work.
template <int VEC, int G, int N>
__device__ __forceinline__ bool select_by_threshold(
    const float (&v)[VEC * N], int64_t r, int k, int w, int g, unsigned mask,
    uint64_t* slots, const TopwOut& o) {
  constexpr int L = VEC * N;
  if (w > 2 * G) return false;
  uint32_t lo;
  if (2 * w <= G) {
    uint32_t lane_max[1] = {0u};
#pragma unroll
    for (int i = 0; i < L; ++i)
      lane_max[0] = max(lane_max[0], __float_as_uint(v[i]));
    group_sort_desc<G, 1>(lane_max, g, mask);
    lo = __shfl_sync(mask, lane_max[0], w - 1, G);
  } else {
    // W above G/2: the lanes' largest alone leave too many values above
    // the W-th of them (about 110 at W = G = 32, K = 500); their two
    // largest leave about 35
    uint32_t top2[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const uint32_t b = __float_as_uint(v[i]);
      top2[1] = max(top2[1], min(top2[0], b));
      top2[0] = max(top2[0], b);
    }
    group_sort_desc<G, 2>(top2, g, mask);
    lo = __shfl_sync(mask, w <= G ? top2[0] : top2[1], (w - 1) % G, G);
  }

  unsigned above = 0u, tie = 0u;  // bit i: slot i of this lane
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint32_t b = __float_as_uint(v[i]);
    const int c = (g + (i / VEC) * G) * VEC + i % VEC;
    above |= static_cast<unsigned>(b > lo) << i;
    tie |= static_cast<unsigned>(b == lo && c < k) << i;
  }
  const int n_above = group_sum_int<G>(__popc(above), mask);
  const int need = w - n_above;
  const int n_picks = need > 0 ? w : n_above;
  if (n_picks > pick_slots(G)) return false;
  unsigned pick = above;
  if (need > 0) {
    // the `need` lowest tied columns: columns run unit by unit (j), then
    // lane by lane, then within the unit
    int before = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const unsigned unit = (tie >> (j * VEC)) & ((1u << VEC) - 1u);
      const int mine = __popc(unit);
      int rank = before + group_scan_excl<G>(mine, g, mask);
      before += group_sum_int<G>(mine, mask);
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        if ((unit >> u) & 1u) {
          if (rank < need) pick |= 1u << (j * VEC + u);
          ++rank;
        }
      }
    }
  }
  int at = group_scan_excl<G>(__popc(pick), g, mask);
#pragma unroll
  for (int i = 0; i < L; ++i)
    if ((pick >> i) & 1u)
      slots[at++] = column_key(v[i], (g + (i / VEC) * G) * VEC + i % VEC);
  __syncwarp(mask);
  // after the sort lane t holds the t-th pick, and the (G + t)-th in its
  // second register; the Elogpi row was stored before the __syncwarp above
  uint64_t key[2] = {g < n_picks ? slots[g] : 0,
                     G + g < n_picks ? slots[G + g] : 0};
  if (n_picks <= G) {
    uint64_t one[1] = {key[0]};
    group_sort_desc<G, 1>(one, g, mask);
    key[0] = one[0];
  } else {
    group_sort_desc<G, 2>(key, g, mask);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = i * G + g;
    if (t < w) {
      const int c = key_column(key[i]);
      o.ids[r * w + t] = c;
      o.topvals[r * w + t] = o.pairs[(r * k + c) * 2];
      o.topm[r * w + t] = o.pairs[(r * k + c) * 2 + 1];
    }
  }
  return true;
}

// The top-W form of dirichlet_rows_kernel (rest = 0): Elogpi into the
// pairs, then ids, topvals and topm.
template <int VEC, int G, int N>
__global__ void __launch_bounds__(svt::kBlockThreads)
dirichlet_topw_kernel(const float* __restrict__ x, const TopwOut o,
                      int64_t rows, int k, int w) {
  constexpr int L = VEC * N;
  __shared__ uint64_t slots[svt::kBlockThreads / G * pick_slots(G)];
  const int lane = threadIdx.x % svt::kWarp;
  const int g = lane % G;
  const unsigned mask = svt::group_mask<G>(lane);
  const int64_t r =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  if (r >= rows) return;  // the whole group leaves together
  float v[L], e[L];
  svt::load_row<VEC, G, N>(x + r * k, k, g, 0.0f, v);
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < L; ++i) s += v[i];
  const float ds = digamma_f(svt::group_sum<G>(s, mask));
#pragma unroll
  for (int i = 0; i < L; ++i) e[i] = expectation_f(v[i], ds);
  // the (K, 2) row of pairs: its mean indicators read and stored back
  // beside Elogpi, whole pairs (a store of half a pair costs the L2 a
  // merge of the sector)
  float* prow = o.pairs + r * k * 2;
  float mprev[L];
  svt::load_pair_half<VEC, G, N>(prow, k, g, 1, mprev);
  svt::store_pairs<VEC, G, N>(prow, k, g, 0, e, mprev);
  if (select_by_threshold<VEC, G, N>(
          v, r, k, w, g, mask, slots + threadIdx.x / G * pick_slots(G), o))
    return;

  uint64_t buf[kBuf];
  auto refill = [&](uint64_t below) {
#pragma unroll
    for (int i = 0; i < kBuf; ++i) buf[i] = 0;
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        const int c = (g + j * G) * VEC + u;
        const uint64_t key = column_key(v[j * VEC + u], c);
        if (c < k && key < below) buffer_insert(buf, key);
      }
  };
  refill(~uint64_t{0});
  select_top<G>(buf, w, mask, g, o.ids + r * w, refill);
  gather_picked(o, r, k, w, g, G, mask);
}

// K > 512: one warp per row, the row read again from the L1 for each scan.
__global__ void __launch_bounds__(svt::kBlockThreads)
dirichlet_topw_wide_kernel(const float* __restrict__ x, const TopwOut o,
                           int64_t rows, int k, int w) {
  const int lane = threadIdx.x % svt::kWarp;
  const int64_t r =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) /
      svt::kWarp;
  if (r >= rows) return;
  const float* xr = x + r * k;
  float s = 0.0f;
  for (int c = lane; c < k; c += svt::kWarp) s += xr[c];
  const float ds = digamma_f(svt::warp_sum(s));
  // whole pairs, as the register kernel stores them
  float2* prow = reinterpret_cast<float2*>(o.pairs + r * k * 2);
  for (int c = lane; c < k; c += svt::kWarp)
    prow[c] = make_float2(expectation_f(xr[c], ds), prow[c].y);

  uint64_t buf[kBuf];
  auto refill = [&](uint64_t below) {
#pragma unroll
    for (int i = 0; i < kBuf; ++i) buf[i] = 0;
    for (int c = lane; c < k; c += svt::kWarp) {
      const uint64_t key = column_key(xr[c], c);
      if (key < below) buffer_insert(buf, key);
    }
  };
  refill(~uint64_t{0});
  select_top<svt::kWarp>(buf, w, svt::kFull, lane, o.ids + r * w, refill);
  gather_picked(o, r, k, w, lane, svt::kWarp, svt::kFull);
}

template <class OutT>
void launch_dirichlet(const float* x, OutT* out, int64_t rows, int k,
                      float rest, cudaStream_t stream) {
  if (k > svt::kRegMaxK) {
    dirichlet_wide_kernel<OutT><<<svt::blocks_for(rows, svt::kWarp),
                                  svt::kBlockThreads, 0, stream>>>(
        x, out, rows, k, rest);
    return;
  }
  const bool aligned =
      k % 4 == 0 && svt::aligned16(x) && svt::aligned_unit(out);
  svt::dispatch_row(k, aligned, [&](auto vec, auto grp, auto cnt) {
    constexpr int VEC = decltype(vec)::value;
    constexpr int G = decltype(grp)::value;
    constexpr int N = decltype(cnt)::value;
    dirichlet_rows_kernel<VEC, G, N, OutT><<<svt::blocks_for(rows, G),
                                             svt::kBlockThreads, 0, stream>>>(
        x, out, rows, k, rest);
  });
}

}  // namespace

// The top-W form: pairs (rows, k, 2) f32, whose even half takes Elogpi
// and whose odd half holds the mean indicators of the sweep before; ids
// (rows, w) int32, topvals (rows, w) f32 and topm (rows, w) f32, the odd
// half at the picks. 1 <= w <= k.
extern "C" int svt_dirichlet_topw(const float* x, float* pairs, int32_t* ids,
                                  float* topvals, float* topm, int64_t rows,
                                  int k, int w, cudaStream_t stream) {
  if (rows <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  if (w < 1 || w > k) return static_cast<int>(cudaErrorInvalidValue);
  const TopwOut o{pairs, ids, topvals, topm};
  if (k > svt::kRegMaxK) {
    dirichlet_topw_wide_kernel<<<svt::blocks_for(rows, svt::kWarp),
                                 svt::kBlockThreads, 0, stream>>>(x, o, rows,
                                                                  k, w);
    return static_cast<int>(cudaGetLastError());
  }
  auto launch = [&](auto vec, auto grp, auto cnt) {
    constexpr int VEC = decltype(vec)::value;
    constexpr int G = decltype(grp)::value;
    constexpr int N = decltype(cnt)::value;
    dirichlet_topw_kernel<VEC, G, N><<<svt::blocks_for(rows, G),
                                       svt::kBlockThreads, 0, stream>>>(
        x, o, rows, k, w);
  };
  // units of two columns, one 16-byte store of two pairs a lane
  svt::dispatch_pair_row(k, svt::aligned16(x) && svt::aligned16(pairs),
                         launch);
  return static_cast<int>(cudaGetLastError());
}

// out is (rows, k) f32, or bf16 when out_bf16 is set
extern "C" int svt_dirichlet_expectation(const float* x, void* out,
                                         int64_t rows, int k, float rest,
                                         int out_bf16, cudaStream_t stream) {
  if (rows <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  if (out_bf16)
    launch_dirichlet(x, static_cast<svt::bf16*>(out), rows, k, rest, stream);
  else
    launch_dirichlet(x, static_cast<float*>(out), rows, k, rest, stream);
  return static_cast<int>(cudaGetLastError());
}
