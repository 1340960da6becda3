// Kernel 2: the link-sampling phi pass over the training links.
//
// For every link (p, q):
//   phi = softmax_k(Elogpi[p,k] + Elogpi[q,k] + Elogbeta0[k])
//   gacc[p] += phi,  gacc[q] += phi
// (svinet_tpu/svi/sweep_math.py:46-87, phi_pass with conv=None). The
// gather+softmax half of it is the TPU prototype
// tools/pallas_gather_bench.py:69-183 (pallas_gather_softmax), which had
// to DMA 8-row panels and pick rows with a one-hot matmul because Mosaic
// could not slice a single row; the scatter half was an XLA scatter-add.
//
// What bounds it on an H100: bytes. Elogpi and gacc are (n,K) f32, 2 GB
// each at n=1M, K=500, forty times the 50 MB L2, and the endpoints are
// random, so a gathered 2 KB row is never found in cache: the floor is
// one row from DRAM per gather. A scatter with atomicAdd costs three
// times that (each f32 atomic reads and writes a gacc sector that is not
// in L2), plus a zero-fill of gacc.
//
// What the design does about it: pull, not push. The input is the
// symmetric adjacency (CSR) of the links, so each link is met from both
// ends. The owner of node p keeps Elogpi[p] + Elogbeta0 and the running
// sum of phi in registers (layout <VEC, G, N> of common.cuh: 16-byte
// loads, a part of a warp per row when K is small), walks p's neighbours,
// reads each neighbour row once, keeps the logits in registers so the
// softmax costs one expf per element, and writes gacc[p] once with plain
// stores. Nobody else writes that row: no atomics, no zero-fill (a node
// without links gets zeros), and the result is the same from run to run.
// The price is that phi of a link is computed at both ends: twice the
// arithmetic for a third of the DRAM traffic. The neighbour row of the
// next iteration is loaded before the current one is reduced, so a warp
// keeps two gathers in flight.
//
// Hubs. A node with more than seg_len neighbours would serialise on one
// warp, so its list arrives cut into segments (ops/edges.py). The same
// kernel, launched over the segments, sums each into its own row of a
// scratch buffer, and phi_combine_kernel adds a hub's rows in segment
// order into gacc: still no atomics, still reproducible.
//
// K above 512 does not fit the register layout and takes
// phi_pull_wide_kernel: one warp per node, an online softmax over
// 32-column chunks (any K, no register array), a second read of the
// neighbour row to form phi, and the running sum kept in the owner's
// gacc row itself (read and written only by the lane that owns the
// column). It moves about twice the bytes of the register kernel.

#include <math.h>

#include "common.cuh"

namespace {

struct PhiArgs {
  const float* elogpi;
  const float* elb0;
  const int32_t* rowptr;
  const int32_t* nbr;
  // hub segments: non-null when the launch walks segments, not nodes
  const int32_t* seg_node;
  const int32_t* seg_begin;
  const int32_t* seg_end;
  float* out;        // gacc (n,K), or the scratch rows (n_segs,K)
  int64_t n_items;   // nodes, or segments
  int k;
  int seg_len;
};

// The node, its slice of nbr and its output row for work item `item`.
// Returns false for a hub met in the pass over nodes: its row is written
// by phi_combine_kernel.
__device__ __forceinline__ bool phi_item(const PhiArgs& a, int64_t item,
                                         int64_t* p, int* begin, int* end) {
  if (a.seg_node != nullptr) {
    *p = a.seg_node[item];
    *begin = a.seg_begin[item];
    *end = a.seg_end[item];
    return true;
  }
  *p = item;
  *begin = a.rowptr[item];
  *end = a.rowptr[item + 1];
  return *end - *begin <= a.seg_len;
}

template <int VEC, int G, int N>
__global__ void __launch_bounds__(svt::kBlockThreads)
phi_pull_kernel(const PhiArgs a) {
  constexpr int L = VEC * N;
  const int lane = threadIdx.x % svt::kWarp;
  const int g = lane % G;
  const unsigned mask = svt::group_mask<G>(lane);
  const int64_t item =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  if (item >= a.n_items) return;  // the whole group leaves together
  int64_t p;
  int begin, end;
  if (!phi_item(a, item, &p, &begin, &end)) return;
  const int k = a.k;

  // base = Elogpi[p] + Elogbeta0; columns past K hold -inf, so their
  // logits never win the max and their exp is 0
  float base[L], acc[L], cur[L], nxt[L];
  svt::load_row<VEC, G, N>(a.elogpi + p * k, k, g, -INFINITY, base);
  svt::load_row<VEC, G, N>(a.elb0, k, g, 0.0f, cur);
#pragma unroll
  for (int i = 0; i < L; ++i) {
    base[i] += cur[i];
    acc[i] = 0.0f;
  }

  // G neighbour ids at a time, one per lane, handed round by shuffle
  for (int chunk = begin; chunk < end; chunk += G) {
    const int cnt = min(G, end - chunk);
    const int mine = g < cnt ? a.nbr[chunk + g] : 0;
    int64_t q = __shfl_sync(mask, mine, 0, G);
    svt::load_row<VEC, G, N>(a.elogpi + q * k, k, g, 0.0f, cur);
    for (int j = 0; j < cnt; ++j) {
      if (j + 1 < cnt) {  // uniform across the group
        q = __shfl_sync(mask, mine, j + 1, G);
        svt::load_row<VEC, G, N>(a.elogpi + q * k, k, g, 0.0f, nxt);
      }
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        cur[i] += base[i];
        m = fmaxf(m, cur[i]);
      }
      m = svt::group_max<G>(m, mask);
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        cur[i] = expf(cur[i] - m);
        s += cur[i];
      }
      const float inv = 1.0f / svt::group_sum<G>(s, mask);
#pragma unroll
      for (int i = 0; i < L; ++i) {
        acc[i] = fmaf(cur[i], inv, acc[i]);
        cur[i] = nxt[i];
      }
    }
  }
  svt::store_row<VEC, G, N>(a.out + item * k, k, g, acc);
}

// Any K: one warp per item, nothing held per column.
__global__ void __launch_bounds__(svt::kBlockThreads)
phi_pull_wide_kernel(const PhiArgs a) {
  const int lane = threadIdx.x % svt::kWarp;
  const int64_t item =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) /
      svt::kWarp;
  if (item >= a.n_items) return;
  int64_t p;
  int begin, end;
  if (!phi_item(a, item, &p, &begin, &end)) return;
  const int k = a.k;
  const float* rp = a.elogpi + p * k;
  float* orow = a.out + item * k;
  if (begin == end)
    for (int c = lane; c < k; c += svt::kWarp) orow[c] = 0.0f;

  for (int i = begin; i < end; ++i) {
    const float* rq = a.elogpi + static_cast<int64_t>(a.nbr[i]) * k;
    // pass 1: per-lane online softmax over columns lane, lane+32, ...
    float m = -INFINITY;
    float s = 0.0f;
    for (int c = lane; c < k; c += svt::kWarp) {
      const float v = rp[c] + rq[c] + a.elb0[c];
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
      s = s * expf(m - mn) + so * expf(mo - mn);  // K > 512: no lane is empty
      m = mn;
    }
    // pass 2: phi into the owner's row; column c is always lane c % 32's
    const float inv = 1.0f / s;
    for (int c = lane; c < k; c += svt::kWarp) {
      const float phi = expf(rp[c] + rq[c] + a.elb0[c] - m) * inv;
      orow[c] = i == begin ? phi : orow[c] + phi;
    }
  }
}

// gacc[hub] = sum of the hub's scratch rows, in segment order.
__global__ void __launch_bounds__(svt::kBlockThreads)
phi_combine_kernel(const float* __restrict__ partial,
                   const int32_t* __restrict__ hub_node,
                   const int32_t* __restrict__ hub_segptr,
                   float* __restrict__ gacc, int k) {
  const int64_t h = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= k) return;
  float s = 0.0f;
  for (int64_t r = hub_segptr[h]; r < hub_segptr[h + 1]; ++r)
    s += partial[r * k + c];
  gacc[static_cast<int64_t>(hub_node[h]) * k + c] = s;
}

void launch_pull(const PhiArgs& a, cudaStream_t stream) {
  if (a.n_items == 0) return;
  if (a.k > svt::kRegMaxK) {
    phi_pull_wide_kernel<<<svt::blocks_for(a.n_items, svt::kWarp),
                           svt::kBlockThreads, 0, stream>>>(a);
    return;
  }
  const bool aligned = a.k % 4 == 0 && svt::aligned16(a.elogpi) &&
                       svt::aligned16(a.elb0) && svt::aligned16(a.out);
  svt::dispatch_row(a.k, aligned, [&](auto vec, auto grp, auto cnt) {
    constexpr int VEC = decltype(vec)::value;
    constexpr int G = decltype(grp)::value;
    constexpr int N = decltype(cnt)::value;
    phi_pull_kernel<VEC, G, N><<<svt::blocks_for(a.n_items, G),
                                 svt::kBlockThreads, 0, stream>>>(a);
  });
}

}  // namespace

extern "C" int svt_phi_pass(const float* elogpi, const float* elb0,
                            const int32_t* rowptr, const int32_t* nbr,
                            const int32_t* hub_node,
                            const int32_t* hub_segptr,
                            const int32_t* seg_node, const int32_t* seg_begin,
                            const int32_t* seg_end, float* partial,
                            float* gacc, int64_t n, int64_t n_hubs,
                            int64_t n_segs, int k, int seg_len,
                            cudaStream_t stream) {
  if (k <= 0) return static_cast<int>(cudaGetLastError());
  PhiArgs a{elogpi, elb0, rowptr, nbr, nullptr, nullptr, nullptr,
            gacc,   n,    k,      seg_len};
  launch_pull(a, stream);
  if (n_segs > 0) {
    a.seg_node = seg_node;
    a.seg_begin = seg_begin;
    a.seg_end = seg_end;
    a.out = partial;
    a.n_items = n_segs;
    launch_pull(a, stream);
    const dim3 grid(static_cast<unsigned>(n_hubs),
                    (k + svt::kBlockThreads - 1) / svt::kBlockThreads);
    phi_combine_kernel<<<grid, svt::kBlockThreads, 0, stream>>>(
        partial, hub_node, hub_segptr, gacc, k);
  }
  return static_cast<int>(cudaGetLastError());
}
