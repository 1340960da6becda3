// Kernel 13: FastInit's overlap pass (svinet_tpu/svi/fastinit.py:104-149,
// _overlap_block and overlap_stats), over the held-out pairs at every
// report and over every training link in the community extraction. It
// replaces no TPU kernel: the JAX function forms a (B, w, w) product
// tensor per block of pairs in XLA.
//
// Per pair (p, q), over the two top-width lists (ids, pi): ssum, the sum
// of pi_p pi_q over the ids the two share (ids < n; the sentinel n marks
// an empty slot), the largest such product and p's id at it, the first in
// p's slot order among equal products; a pair with no shared id gives 0,
// 0 and ids_p[0], as the argmax of an all-zero block does. A row's real
// ids are distinct, so each shared id gives exactly one product.
//
// A pair takes a group of G lanes (the next power of two of the width, 4
// to 32) for width <= 64, a block of 256 threads above. The group enters
// q's real ids into an open-addressing table of slot_table_size(w) (>= 4w)
// entries in shared memory (id -> q's slot; integer atomicCAS, whose order
// does not change the table's content; above width 4,096 the table, 8
// bytes an entry, outgrows the card's shared memory and sits in device
// scratch, one table a resident block), then each of p's slots looks its
// id up (csrc/sparse_slots.cuh keys kernel 11's union slots the same
// way). Each lane adds its slots in slot order, and the group's sum is a
// fixed tree: two launches give the same bits.
//
// What bounds it on an H100: each pair gathers two rows of w ids and w
// values (16w bytes) and writes 12; at stretch's 19.9M links and w = 64
// that is about 20.6 GB, 6.1 ms at 3.35 TB/s, the rows of random links
// coming from device memory in whole sectors.

#include <climits>
#include <cstdint>

#include "sparse_slots.cuh"

namespace {

constexpr int kThreads = 256;
// largest table kept in shared memory: width 4,096, 16,384 entries
constexpr int kMaxTableSmem = 128 * 1024;

// Tables of device scratch at width w on the current device: 0 where a
// table fits kMaxTableSmem, else two a multiprocessor (the blocks in
// flight at once, a table each). The launch and svt_fastinit_overlap_scratch
// both take it from here.
int64_t scratch_tables(int w) {
  const size_t table = sizeof(int) * 2 * svt::slot_table_size(w);
  return w > 64 && table > static_cast<size_t>(kMaxTableSmem)
             ? int64_t{2} * svt::sm_count()
             : 0;
}

struct OverlapArgs {
  const int32_t* ids;    // (n, w)
  const float* pi;       // (n, w)
  const int32_t* pairs;  // (m, 2)
  float* ssum;           // (m,)
  float* maxv;           // (m,)
  int32_t* maxid;        // (m,)
  int64_t m;
  int64_t n;
  int w;
};

// the lanes of a group of G <= 32 share a warp; a group of a block
// synchronises the block
template <int G>
struct Group {
  unsigned mask;
  __device__ void sync() const {
    if constexpr (G <= svt::kWarp)
      __syncwarp(mask);
    else
      __syncthreads();
  }
};

// The group's sum of `s` and its (largest value, lowest slot), in a fixed
// order: shuffles within a warp, then (a block) the warps' values in warp
// order through `red` (the floats' bits).
template <int G>
__device__ __forceinline__ void group_reduce(float& s, float& best, int& at,
                                             unsigned mask, int* red) {
  constexpr int L = G < svt::kWarp ? G : svt::kWarp;
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    s += __shfl_xor_sync(mask, s, off);
    const float ob = __shfl_xor_sync(mask, best, off);
    const int oa = __shfl_xor_sync(mask, at, off);
    if (ob > best || (ob == best && oa < at)) {
      best = ob;
      at = oa;
    }
  }
  if constexpr (G > svt::kWarp) {
    constexpr int kWarps = G / svt::kWarp;
    const int wid = threadIdx.x / svt::kWarp;
    if (threadIdx.x % svt::kWarp == 0) {
      red[wid] = __float_as_int(s);
      red[kWarps + wid] = __float_as_int(best);
      red[2 * kWarps + wid] = at;
    }
    __syncthreads();
    s = 0.0f;
    best = -1.0f;
    at = INT_MAX;
    for (int i = 0; i < kWarps; ++i) {
      s += __int_as_float(red[i]);
      const float ob = __int_as_float(red[kWarps + i]);
      const int oa = red[2 * kWarps + i];
      if (ob > best || (ob == best && oa < at)) {
        best = ob;
        at = oa;
      }
    }
    __syncthreads();  // red may be written again
  }
}

template <int G>
__device__ void overlap_pair(const OverlapArgs& a, int64_t item, int g,
                             const Group<G>& grp, int* key, int* slot,
                             int* red) {
  const int w = a.w;
  const int tsize = svt::slot_table_size(w);
  const unsigned tmask = static_cast<unsigned>(tsize - 1);
  const int64_t p = a.pairs[2 * item], q = a.pairs[2 * item + 1];
  grp.sync();  // the group's lookups of its previous pair are done
  for (int t = g; t < tsize; t += G) key[t] = -1;
  grp.sync();
  for (int j = g; j < w; j += G) {
    const int id = __ldg(a.ids + q * w + j);
    if (id >= a.n) continue;
    unsigned t = (static_cast<unsigned>(id) * 2654435761u) & tmask;
    while (atomicCAS(key + t, -1, id) != -1) t = (t + 1) & tmask;
    slot[t] = j;
  }
  grp.sync();
  float s = 0.0f, best = -1.0f;
  int at = INT_MAX;
  for (int i = g; i < w; i += G) {
    const int id = __ldg(a.ids + p * w + i);
    if (id >= a.n) continue;
    unsigned t = (static_cast<unsigned>(id) * 2654435761u) & tmask;
    int k;
    while ((k = key[t]) != id && k != -1) t = (t + 1) & tmask;
    if (k == -1) continue;
    const float prod =
        __fmul_rn(__ldg(a.pi + p * w + i), __ldg(a.pi + q * w + slot[t]));
    s += prod;
    if (prod > best) {
      best = prod;
      at = i;
    }
  }
  group_reduce<G>(s, best, at, grp.mask, red);
  if (g == 0) {
    a.ssum[item] = s;
    const bool none = at == INT_MAX;
    a.maxv[item] = none ? 0.0f : best;
    a.maxid[item] = __ldg(a.ids + p * w + (none ? 0 : at));
  }
}

// groups of G <= 32 lanes, each its table in the block's dynamic shared
// memory; groups stride over the pairs
template <int G>
__global__ void __launch_bounds__(kThreads) overlap_group_kernel(
    const OverlapArgs a) {
  extern __shared__ int smem[];
  const int tsize = svt::slot_table_size(a.w);
  int* const key = smem + (threadIdx.x / G) * 2 * tsize;
  const int g = threadIdx.x % G;
  const Group<G> grp{svt::group_mask<G>(threadIdx.x % svt::kWarp)};
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / G;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads / G;
  for (int64_t item = first; item < a.m; item += step)
    overlap_pair<G>(a, item, g, grp, key, key + tsize, nullptr);
}

// a block of kThreads a pair, blocks striding over the pairs; the table in
// shared memory (scratch null) or at scratch + blockIdx.x * 2 tsize
__global__ void __launch_bounds__(kThreads) overlap_block_kernel(
    const OverlapArgs a, int* scratch) {
  extern __shared__ int smem[];
  __shared__ int red[3 * kThreads / svt::kWarp];
  const int tsize = svt::slot_table_size(a.w);
  int* const key = scratch == nullptr
                       ? smem
                       : scratch + static_cast<int64_t>(blockIdx.x) * 2 * tsize;
  const Group<kThreads> grp{svt::kFull};
  for (int64_t item = blockIdx.x; item < a.m; item += gridDim.x)
    overlap_pair<kThreads>(a, item, threadIdx.x, grp, key, key + tsize, red);
}

using Kernel = void (*)(OverlapArgs);

// lanes a pair (g) and the group kernel for width w <= 64
Kernel pick(int w, int* g) {
  if (w <= 4) {
    *g = 4;
    return overlap_group_kernel<4>;
  }
  if (w <= 8) {
    *g = 8;
    return overlap_group_kernel<8>;
  }
  if (w <= 16) {
    *g = 16;
    return overlap_group_kernel<16>;
  }
  *g = 32;
  return overlap_group_kernel<32>;
}

}  // namespace

// ids (n, w) int32, pi (n, w), pairs (m, 2) int32; out: ssum, maxv, maxid
// (m,). Any width: above 4,096 (a table of more than 16,384 entries, 128
// KB) the tables sit in scratch, scratch_tables(w) of 2 slot_table_size(w)
// ints (svt_fastinit_overlap_scratch's; null below).
extern "C" int svt_fastinit_overlap(const int32_t* ids, const float* pi,
                                    const int32_t* pairs, float* ssum,
                                    float* maxv, int32_t* maxid, int64_t m,
                                    int64_t n, int w, int* scratch,
                                    cudaStream_t stream) {
  if (w < 1 || n <= 0 || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const OverlapArgs a{ids, pi, pairs, ssum, maxv, maxid, m, n, w};
  const size_t table = sizeof(int) * 2 * svt::slot_table_size(w);
  const int64_t card = int64_t{16} * svt::sm_count();
  if (w > 64) {
    const int64_t tables = scratch_tables(w);
    const bool in_smem = tables == 0;
    if (!in_smem && scratch == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t bytes = in_smem ? table : 0;
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          overlap_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int64_t cap = in_smem ? card : tables;
    const int64_t blocks = m < cap ? m : cap;
    overlap_block_kernel<<<static_cast<unsigned>(blocks), kThreads, bytes,
                           stream>>>(a, in_smem ? nullptr : scratch);
    return static_cast<int>(cudaGetLastError());
  }
  int g = 0;
  const Kernel kernel = pick(w, &g);
  const int64_t per_block = kThreads / g;
  const size_t bytes = table * static_cast<size_t>(per_block);
  int64_t blocks = (m + per_block - 1) / per_block;
  blocks = blocks < card ? blocks : card;
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Ints of device scratch svt_fastinit_overlap takes at width w on the
// current device (0: none) into *words. No launch.
extern "C" int svt_fastinit_overlap_scratch(int w, int64_t* words) {
  if (w < 1) return static_cast<int>(cudaErrorInvalidValue);
  *words = scratch_tables(w) * 2 * svt::slot_table_size(w);
  return 0;
}
