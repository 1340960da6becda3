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
//
// Kernel 5: the fused phi + s3 pass of -fuse-s3
// (svinet_tpu/svi/sweep_math.py:160-206, fused_phi_s3_pass). The same
// walk also sums the cross-moment of the mean indicators of the sweep
// before, s3[k] = sum over links of mphi[p,k] * mphi[q,k]. The TPU packed
// [Elogpi | mphi] into rows of 2K because a row twice as wide cost it
// little; here bytes bind, so the two arrays stay apart and mphi[q] is
// read only where q > p (the list is ascending), once per link: the
// gathers are 2E rows of Elogpi and E rows of mphi, the same rows that
// kernel 2 followed by kernel 4 (csrc/s3_pass.cu) would read. What the
// fusion saves is the second walk of the adjacency and its launches, not
// row traffic. Its price is registers: the owner's mphi row, the gathered
// one and the running s3 are three more rows in registers, and the groups
// stride over the nodes so that s3 is kept across them and summed across
// blocks by common.cuh's two steps (no atomics). It is a template flag on
// the register kernel; K above 512 has no fused form.

#include <math.h>

#include "common.cuh"

namespace {

struct PhiArgs {
  svt::AdjItems items;
  const float* elogpi;
  const float* elb0;
  float* out;          // gacc (n,K), or the scratch rows (n_segs,K)
  int k;
  // kernel 5 only
  const float* mphi;   // (n,K) mean indicators of the sweep before
  float* s3_partial;   // (blocks,K) scratch for the column sums of s3
};

// FUSED = false is kernel 2; FUSED = true is kernel 5, which also sums
// mphi[p] * mphi[q] over the links it meets from their lower end.
template <int VEC, int G, int N, bool FUSED>
__global__ void __launch_bounds__(svt::kBlockThreads)
phi_pull_kernel(const PhiArgs a) {
  constexpr int L = VEC * N;
  constexpr int LF = FUSED ? L : 1;
  const int lane = threadIdx.x % svt::kWarp;
  const int g = lane % G;
  const unsigned mask = svt::group_mask<G>(lane);
  const int k = a.k;
  const int32_t* nbr = a.items.nbr;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  // kernel 2 is launched with a group for every item, so its loop runs
  // once; kernel 5's groups stride over the items and keep s3 across them
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x / G;

  float base[L], acc[L], cur[L], nxt[L];
  float own[LF], other[LF], s3[LF];
#pragma unroll
  for (int i = 0; i < LF; ++i) s3[i] = 0.0f;

  // item, p, begin and end are the same in every lane of a group, so the
  // group takes each branch below together
  for (int64_t item = first; item < a.items.n_items; item += step) {
    int64_t p;
    int begin, end;
    if (!svt::adj_item(a.items, item, &p, &begin, &end)) continue;

    // base = Elogpi[p] + Elogbeta0; columns past K hold -inf, so their
    // logits never win the max and their exp is 0
    svt::load_row<VEC, G, N>(a.elogpi + p * k, k, g, -INFINITY, base);
    svt::load_row<VEC, G, N>(a.elb0, k, g, 0.0f, cur);
#pragma unroll
    for (int i = 0; i < L; ++i) {
      base[i] += cur[i];
      acc[i] = 0.0f;
    }
    if constexpr (FUSED)
      svt::load_row<VEC, G, N>(a.mphi + p * k, k, g, 0.0f, own);

    // G neighbour ids at a time, one per lane, handed round by shuffle
    for (int chunk = begin; chunk < end; chunk += G) {
      const int cnt = min(G, end - chunk);
      const int mine = g < cnt ? nbr[chunk + g] : 0;
      int64_t q = __shfl_sync(mask, mine, 0, G);
      svt::load_row<VEC, G, N>(a.elogpi + q * k, k, g, 0.0f, cur);
      for (int j = 0; j < cnt; ++j) {
        bool upper = false;  // q > p: the link's lower end is here
        if constexpr (FUSED) {
          upper = q > p;
          // in flight while the softmax below is computed
          if (upper) svt::load_row<VEC, G, N>(a.mphi + q * k, k, g, 0.0f,
                                              other);
        }
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
        if constexpr (FUSED) {
          if (upper) {
#pragma unroll
            for (int i = 0; i < L; ++i) s3[i] = fmaf(own[i], other[i], s3[i]);
          }
        }
      }
    }
    svt::store_row<VEC, G, N>(a.out + item * k, k, g, acc);
  }
  if constexpr (FUSED) {
    __shared__ float smem[svt::kBlockThreads * L];
    svt::block_colsum<VEC, G, N>(
        s3, k, smem, a.s3_partial + static_cast<int64_t>(blockIdx.x) * k);
  }
}

// Any K: one warp per item, nothing held per column.
__global__ void __launch_bounds__(svt::kBlockThreads)
phi_pull_wide_kernel(const PhiArgs a) {
  const int lane = threadIdx.x % svt::kWarp;
  const int64_t item =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) /
      svt::kWarp;
  if (item >= a.items.n_items) return;
  int64_t p;
  int begin, end;
  if (!svt::adj_item(a.items, item, &p, &begin, &end)) return;
  const int k = a.k;
  const float* rp = a.elogpi + p * k;
  float* orow = a.out + item * k;
  if (begin == end)
    for (int c = lane; c < k; c += svt::kWarp) orow[c] = 0.0f;

  for (int i = begin; i < end; ++i) {
    const float* rq = a.elogpi + static_cast<int64_t>(a.items.nbr[i]) * k;
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

// Launch over a.items; with `fused`, kernel 5 (K <= kRegMaxK only). Returns
// the number of blocks, which for kernel 5 is the number of s3 scratch rows
// written.
unsigned launch_pull(const PhiArgs& a, bool fused, cudaStream_t stream) {
  unsigned blocks = 0;
  if (a.items.n_items == 0) return blocks;
  if (a.k > svt::kRegMaxK) {
    blocks = svt::blocks_for(a.items.n_items, svt::kWarp);
    phi_pull_wide_kernel<<<blocks, svt::kBlockThreads, 0, stream>>>(a);
    return blocks;
  }
  const bool aligned = a.k % 4 == 0 && svt::aligned16(a.elogpi) &&
                       svt::aligned16(a.elb0) && svt::aligned16(a.out) &&
                       svt::aligned16(a.mphi);
  svt::dispatch_row(a.k, aligned, [&](auto vec, auto grp, auto cnt) {
    constexpr int VEC = decltype(vec)::value;
    constexpr int G = decltype(grp)::value;
    constexpr int N = decltype(cnt)::value;
    if (fused) {
      blocks = svt::reduce_blocks_for(a.items.n_items, G);
      phi_pull_kernel<VEC, G, N, true>
          <<<blocks, svt::kBlockThreads, 0, stream>>>(a);
    } else {
      blocks = svt::blocks_for(a.items.n_items, G);
      phi_pull_kernel<VEC, G, N, false>
          <<<blocks, svt::kBlockThreads, 0, stream>>>(a);
    }
  });
  return blocks;
}

// The pass over nodes, the pass over hub segments and the hubs' combine.
// Returns the number of s3 scratch rows written (kernel 5).
unsigned launch_phi(PhiArgs a, bool fused, const int32_t* hub_node,
                    const int32_t* hub_segptr, const int32_t* seg_node,
                    const int32_t* seg_begin, const int32_t* seg_end,
                    float* partial, int64_t n_hubs, int64_t n_segs,
                    cudaStream_t stream) {
  float* gacc = a.out;
  unsigned rows = launch_pull(a, fused, stream);
  if (n_segs > 0) {
    a.items.seg_node = seg_node;
    a.items.seg_begin = seg_begin;
    a.items.seg_end = seg_end;
    a.items.n_items = n_segs;
    a.out = partial;
    if (fused) a.s3_partial += static_cast<int64_t>(rows) * a.k;
    rows += launch_pull(a, fused, stream);
    const dim3 grid(static_cast<unsigned>(n_hubs),
                    (a.k + svt::kBlockThreads - 1) / svt::kBlockThreads);
    phi_combine_kernel<<<grid, svt::kBlockThreads, 0, stream>>>(
        partial, hub_node, hub_segptr, gacc, a.k);
  }
  return rows;
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
  const PhiArgs a{{rowptr, nbr, nullptr, nullptr, nullptr, n, seg_len},
                  elogpi, elb0, gacc, k, nullptr, nullptr};
  launch_phi(a, false, hub_node, hub_segptr, seg_node, seg_begin, seg_end,
             partial, n_hubs, n_segs, stream);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 5: svt_phi_pass, and s3 (K,) = sum over links of
// mphi[p] * mphi[q] from the same walk. K <= svt::kRegMaxK; s3_partial is
// scratch of 2 * svt::kReduceBlocks rows of K.
extern "C" int svt_phi_s3_pass(const float* elogpi, const float* mphi,
                               const float* elb0, const int32_t* rowptr,
                               const int32_t* nbr, const int32_t* hub_node,
                               const int32_t* hub_segptr,
                               const int32_t* seg_node,
                               const int32_t* seg_begin,
                               const int32_t* seg_end, float* partial,
                               float* gacc, float* s3_partial, float* s3,
                               int64_t n, int64_t n_hubs, int64_t n_segs,
                               int k, int seg_len, cudaStream_t stream) {
  if (k <= 0) return static_cast<int>(cudaGetLastError());
  if (k > svt::kRegMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const PhiArgs a{{rowptr, nbr, nullptr, nullptr, nullptr, n, seg_len},
                  elogpi, elb0, gacc, k, mphi, s3_partial};
  const unsigned rows =
      launch_phi(a, true, hub_node, hub_segptr, seg_node, seg_begin, seg_end,
                 partial, n_hubs, n_segs, stream);
  svt::launch_colsum_partials(s3_partial, static_cast<int>(rows), k, k, s3,
                              stream);
  return static_cast<int>(cudaGetLastError());
}
