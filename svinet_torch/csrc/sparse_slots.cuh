// The union slots of a pair under the sparse top-W gamma state
// (svinet_tpu/ops/sparse_gamma.py:1-20): node p's row is its W largest
// entries (ids, vals) and the mass `rest` of the other K - W, taken as
// uniform. A pair (p, q) works over the 2W slots [ids_p | ids_q]; a slot
// whose community appeared at an earlier slot is dead (its logit is -1e30,
// its phi 0: svinet_tpu/ops/sparse_gamma.py:56-62). Kernels 10
// (csrc/sparse_fastamm.cu) and 11 (csrc/sparse_scores.cu) give a pair to a
// group of G lanes, lane g owning slots g, g + G, ... (NS of them, the
// last ones past 2W when 2W is not a multiple of G).
//
// A slot needs three facts: whether it is its community's first slot, and
// where that community sits in p's list and in q's, if anywhere (a row's
// ids are distinct: they are the columns of its W largest values). The
// group copies its pair's two rows into shared memory at once and enters
// every slot into a small open-addressing table there, keyed by the
// community, keeping the lowest and the highest slot of each (integer
// atomicMin / atomicMax: the result does not depend on their order). The
// lowest slot is the first, and lies in p's half when the community is in
// p's list; the highest lies in q's half when it is in q's list. A slot
// costs a few shared-memory operations where scans over both lists would
// cost 2W compares.
#pragma once

#include <climits>

#include "common.cuh"

namespace svt {

// most slots a lane owns in registers: 2W <= 4 * 32, W <= 64; a wider W
// takes the wide form
constexpr int kMaxSlotsPerLane = 4;
constexpr int kNarrowMaxW = kMaxSlotsPerLane * kWarp / 2;
constexpr float kDeadLogit = -1e30f;

// Lanes a pair and slots a lane for 2W slots: the next power of two of 2W
// up to a warp, then a warp with 2, 3 or 4 slots a lane. 0 when W is out
// of the registers' range (W > 64 takes the wide form).
inline int slot_lanes(int w) {
  if (w < 1 || w > kNarrowMaxW) return 0;
  int g = 2;
  while (g < 2 * w && g < kWarp) g *= 2;
  return g;
}

inline int slots_per_lane(int w) {
  const int g = slot_lanes(w);
  return g == 0 ? 0 : (2 * w + g - 1) / g;
}

// entries of a group's table: a power of two of at least 4W, so that it
// is at most half full
__host__ __device__ inline int slot_table_size(int w) {
  int t = 8;
  while (t < 4 * w) t *= 2;
  return t;
}

// 4-byte words of shared memory a group takes: the slots' communities and
// values (2W each), rest_p and rest_q, the table's keys, lowest and
// highest slots
__host__ __device__ inline int pair_rows_words(int w) {
  return 4 * w + 2 + 3 * slot_table_size(w);
}

// A pair's slots, lane by lane: the community, whether the slot lies
// within the 2W and is its community's first, the community's place in
// p's list and in q's (slot indices, -1 where absent), and the group's
// copies of the two rows (smem, [ids_p | ids_q] and [vals_p | vals_q])
// with their totals sum(vals) + rest.
template <int NS>
struct SlotMatch {
  int id[NS];
  bool in[NS], first[NS];
  int at_p[NS], at_q[NS];
  const int* slots;
  const float* vals;
  float rest_p, rest_q, tot_p, tot_q;
};

template <int G, int NS>
__device__ __forceinline__ SlotMatch<NS> match_slots(
    const int32_t* ids, const float* vals, const float* rest, int64_t p,
    int64_t q, int w, int g, unsigned mask, float* smem) {
  int* const sl = reinterpret_cast<int*>(smem);
  float* const sv = smem + 2 * w;
  const int tsize = slot_table_size(w);
  int* const key = reinterpret_cast<int*>(smem + 4 * w + 2);
  int* const lo = key + tsize;
  int* const hi = lo + tsize;
  __syncwarp(mask);   // the group's reads of its previous pair are done
  for (int i = g; i < 2 * w; i += G) {
    const int64_t at = i < w ? p * w + i : q * w + i - w;
    sl[i] = __ldg(ids + at);
    sv[i] = __ldg(vals + at);
  }
  for (int t = g; t < tsize; t += G) {
    key[t] = -1;
    lo[t] = INT_MAX;
    hi[t] = -1;
  }
  if (g == 0) {
    smem[4 * w] = __ldg(rest + p);
    smem[4 * w + 1] = __ldg(rest + q);
  }
  __syncwarp(mask);
  SlotMatch<NS> m;
  int h[NS];
  float sp = 0.0f, sq = 0.0f;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int i = g + j * G;
    m.in[j] = i < 2 * w;
    m.id[j] = m.in[j] ? sl[i] : -1;
    if (!m.in[j]) continue;
    if (i < w)
      sp += sv[i];
    else
      sq += sv[i];
    // the community's entry: claimed by the first lane to reach an empty
    // one, found by the others
    unsigned t = (static_cast<unsigned>(m.id[j]) * 2654435761u) &
                 static_cast<unsigned>(tsize - 1);
    while (true) {
      const int was = atomicCAS(key + t, -1, m.id[j]);
      if (was == -1 || was == m.id[j]) break;
      t = (t + 1) & static_cast<unsigned>(tsize - 1);
    }
    h[j] = static_cast<int>(t);
    atomicMin(lo + t, i);
    atomicMax(hi + t, i);
  }
  __syncwarp(mask);
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    m.first[j] = false;
    m.at_p[j] = m.at_q[j] = -1;
    if (!m.in[j]) continue;
    const int i = g + j * G;
    const int a = lo[h[j]], b = hi[h[j]];
    m.first[j] = a == i;
    m.at_p[j] = a < w ? a : -1;
    m.at_q[j] = b >= w ? b : -1;
  }
  m.slots = sl;
  m.vals = sv;
  m.rest_p = smem[4 * w];
  m.rest_q = smem[4 * w + 1];
  m.tot_p = group_sum<G>(sp, mask) + m.rest_p;
  m.tot_q = group_sum<G>(sq, mask) + m.rest_q;
  return m;
}

// The wide form's region: the pair's rows, rests and table
// (pair_rows_words), each slot's place in p's and q's lists and whether it
// is its community's first, then `extra` words a slot of the kernel's own
__host__ __device__ inline int64_t wide_words(int w, int extra) {
  return pair_rows_words(w) + int64_t{2} * w * (3 + extra);
}

// Where the wide form keeps a pair's region of wide_words(w, extra) floats
// on the current device: in shared memory where it fits the card's opt-in
// (*regions 0, and 0 for the narrow form), else in device scratch of
// *regions regions, two a multiprocessor (the blocks in flight at once,
// one region each). The launches and the scratch queries the wrappers
// size their scratch by (svt_sparse_fastamm_scratch,
// svt_sparse_scores_scratch) both take it from here.
inline cudaError_t wide_scratch_regions(int w, int extra, int64_t* regions) {
  *regions = 0;
  if (w <= kNarrowMaxW) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (sizeof(float) * wide_words(w, extra) > static_cast<size_t>(optin))
    *regions = int64_t{2} * sm_count();
  return cudaSuccess;
}

// The wide form's facts of a pair's slots, in its region: the rows
// ([ids_p | ids_q], [vals_p | vals_q]), for slot i at_p[i] and at_q[i]
// (the community's slot in p's and q's lists, -1 where absent) and
// first[i] (1 where slot i is its community's first), and the totals.
// `own` points at the region's first word past these, the kernel's
// `extra` words a slot.
struct WideMatch {
  const int* slots;
  const float* vals;
  const int* at_p;
  const int* at_q;
  const int* first;
  float* own;
  float rest_p, rest_q, tot_p, tot_q;
};

// match_slots for a block of one warp and any W: the same table, the
// same facts, each slot's written by the lane that owns it (slot i lane
// i % 32), so that only the table needs the warp's barriers.
__device__ __forceinline__ WideMatch match_slots_wide(
    const int32_t* ids, const float* vals, const float* rest, int64_t p,
    int64_t q, int w, int lane, float* region) {
  int* const sl = reinterpret_cast<int*>(region);
  float* const sv = region + 2 * w;
  const int tsize = slot_table_size(w);
  int* const key = reinterpret_cast<int*>(region + 4 * w + 2);
  int* const lo = key + tsize;
  int* const hi = lo + tsize;
  int* const at_p = hi + tsize;
  int* const at_q = at_p + 2 * w;
  int* const first = at_q + 2 * w;
  __syncwarp();   // the warp's reads of its previous pair are done
  for (int i = lane; i < 2 * w; i += kWarp) {
    const int64_t at = i < w ? p * w + i : q * w + i - w;
    sl[i] = __ldg(ids + at);
    sv[i] = __ldg(vals + at);
  }
  for (int t = lane; t < tsize; t += kWarp) {
    key[t] = -1;
    lo[t] = INT_MAX;
    hi[t] = -1;
  }
  if (lane == 0) {
    region[4 * w] = __ldg(rest + p);
    region[4 * w + 1] = __ldg(rest + q);
  }
  __syncwarp();
  float sp = 0.0f, sq = 0.0f;
  for (int i = lane; i < 2 * w; i += kWarp) {
    const int id = sl[i];
    if (i < w)
      sp += sv[i];
    else
      sq += sv[i];
    unsigned t = (static_cast<unsigned>(id) * 2654435761u) &
                 static_cast<unsigned>(tsize - 1);
    while (true) {
      const int was = atomicCAS(key + t, -1, id);
      if (was == -1 || was == id) break;
      t = (t + 1) & static_cast<unsigned>(tsize - 1);
    }
    first[i] = static_cast<int>(t);   // the slot's entry, for the pass below
    atomicMin(lo + t, i);
    atomicMax(hi + t, i);
  }
  __syncwarp();
  for (int i = lane; i < 2 * w; i += kWarp) {
    const int t = first[i];
    const int a = lo[t], b = hi[t];
    first[i] = a == i ? 1 : 0;
    at_p[i] = a < w ? a : -1;
    at_q[i] = b >= w ? b : -1;
  }
  WideMatch m;
  m.slots = sl;
  m.vals = sv;
  m.at_p = at_p;
  m.at_q = at_q;
  m.first = first;
  m.own = reinterpret_cast<float*>(first + 2 * w);
  m.rest_p = region[4 * w];
  m.rest_q = region[4 * w + 1];
  m.tot_p = warp_sum(sp) + m.rest_p;
  m.tot_q = warp_sum(sq) + m.rest_q;
  return m;
}

// A row's gamma value at a slot's community: its top value there, else
// `tail` (svinet_tpu/ops/sparse_gamma.py:53-62, _value_at_slots)
__device__ __forceinline__ float value_at(const float* vals, int at,
                                          float tail) {
  return at >= 0 ? vals[at] : tail;
}

}  // namespace svt
