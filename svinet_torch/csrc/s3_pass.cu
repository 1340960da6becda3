// Kernel 4: the s3 cross-moment of the link-sampling sweep,
//   s3[k] = sum over links (p, q) of mphi[p,k] * mphi[q,k]
// (svinet_tpu/svi/sweep_math.py:117-151, s3_pass with conv=None;
// reference src/linksampling.cc:731-749). On the TPU this was a blocked
// gather-multiply-sum inside the XLA sweep program; in plain PyTorch each
// block of links costs two (B,K) gathers, a product and a column sum.
//
// What bounds it on an H100: bytes. mphi is (n,K) f32, 2 GB at n=1M,
// K=500 against a 50 MB L2, and the endpoints are random, so each link
// costs at least one 2 KB row from DRAM.
//
// What the design does about it: the pull of kernel 2 over the same
// adjacency, met from one end only. The owner of node p holds mphi[p] in
// registers (layout <VEC, G, N> of common.cuh). A neighbour list is
// ascending, so the owner skips the entries q <= p and walks the rest:
// every link is met once, from its lower end, which is E row gathers and
// not 2E, and nothing is halved. Each gathered row goes straight into the
// group's running column sums with one fused multiply-add per element,
//   acc[k] += mphi[p,k] * mphi[q,k],
// and the next row is loaded before the current one is used. Groups
// stride over the nodes and keep acc across them; the sums across groups
// and blocks are common.cuh's two steps, without atomics, so two launches
// give the same bits. Hubs arrive cut into segments and are walked by a
// second launch of the same kernel, exactly as in kernel 2.
//
// The columns are independent, so K above 512 is run as column tiles of
// at most 512 with the row stride K.

#include <limits.h>

#include "common.cuh"

namespace {

struct S3Args {
  svt::AdjItems items;
  const float* mphi;  // (n, ld), offset to this tile's first column
  float* partial;     // (blocks, ld) scratch, offset likewise
  int ld;             // row stride, K
  int k;              // width of the column tile
};

template <int VEC, int G, int N>
__global__ void __launch_bounds__(svt::kBlockThreads)
s3_pull_kernel(const S3Args a) {
  constexpr int L = VEC * N;
  __shared__ float smem[svt::kBlockThreads * L];
  const int lane = threadIdx.x % svt::kWarp;
  const int g = lane % G;
  const unsigned mask = svt::group_mask<G>(lane);
  const int k = a.k;
  const int32_t* nbr = a.items.nbr;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x / G;

  float acc[L], own[L], cur[L], nxt[L];
#pragma unroll
  for (int i = 0; i < L; ++i) acc[i] = 0.0f;

  // item, p, begin and end are the same in every lane of a group, so the
  // group takes each branch below together
  for (int64_t item = first; item < a.items.n_items; item += step) {
    int64_t p;
    int begin, end;
    if (!svt::adj_item(a.items, item, &p, &begin, &end)) continue;
    // the list is ascending: count the entries q <= p and start past them
    int start = begin;
    for (int chunk = begin; chunk < end; chunk += G) {
      const int cnt = min(G, end - chunk);
      const int id = g < cnt ? nbr[chunk + g] : INT_MAX;
      const int low = __popc(__ballot_sync(mask, id <= p));
      start += low;
      if (low < cnt) break;
    }
    if (start >= end) continue;
    svt::load_row<VEC, G, N>(a.mphi + p * a.ld, k, g, 0.0f, own);

    // G neighbour ids at a time, one per lane, handed round by shuffle
    for (int chunk = start; chunk < end; chunk += G) {
      const int cnt = min(G, end - chunk);
      const int mine = g < cnt ? nbr[chunk + g] : 0;
      int64_t q = __shfl_sync(mask, mine, 0, G);
      svt::load_row<VEC, G, N>(a.mphi + q * a.ld, k, g, 0.0f, cur);
      for (int j = 0; j < cnt; ++j) {
        if (j + 1 < cnt) {
          q = __shfl_sync(mask, mine, j + 1, G);
          svt::load_row<VEC, G, N>(a.mphi + q * a.ld, k, g, 0.0f, nxt);
        }
#pragma unroll
        for (int i = 0; i < L; ++i) {
          acc[i] = fmaf(own[i], cur[i], acc[i]);
          cur[i] = nxt[i];
        }
      }
    }
  }
  svt::block_colsum<VEC, G, N>(
      acc, k, smem, a.partial + static_cast<int64_t>(blockIdx.x) * a.ld);
}

// Launch over a.items with `blocks` blocks, or, when that is 0, with as
// many as the items need; returns the number of blocks, which is the
// number of scratch rows written.
unsigned launch_s3(const S3Args& a, bool aligned, unsigned blocks,
                   cudaStream_t stream) {
  if (a.items.n_items == 0) return 0;
  svt::dispatch_row(a.k, aligned, [&](auto vec, auto grp, auto cnt) {
    constexpr int VEC = decltype(vec)::value;
    constexpr int G = decltype(grp)::value;
    constexpr int N = decltype(cnt)::value;
    if (blocks == 0) blocks = svt::reduce_blocks_for(a.items.n_items, G);
    s3_pull_kernel<VEC, G, N>
        <<<blocks, svt::kBlockThreads, 0, stream>>>(a);
  });
  return blocks;
}

}  // namespace

// s3 (K,) is written; partial is scratch of 2 * svt::kReduceBlocks rows of
// K (the pass over nodes, then the pass over hub segments).
extern "C" int svt_s3_pass(const float* mphi, const int32_t* rowptr,
                           const int32_t* nbr, const int32_t* seg_node,
                           const int32_t* seg_begin, const int32_t* seg_end,
                           float* partial, float* s3, int64_t n,
                           int64_t n_segs, int k, int seg_len,
                           cudaStream_t stream) {
  if (k <= 0) return static_cast<int>(cudaGetLastError());
  const bool aligned =
      k % 4 == 0 && svt::aligned16(mphi) && svt::aligned16(partial);
  // every column tile is launched with the first tile's blocks, so that
  // the scratch holds the same rows for all columns
  unsigned node_rows = 0;
  unsigned seg_rows = 0;
  for (int c0 = 0; c0 < k; c0 += svt::kRegMaxK) {
    const int kt = k - c0 < svt::kRegMaxK ? k - c0 : svt::kRegMaxK;
    S3Args a{{rowptr, nbr, nullptr, nullptr, nullptr, n, seg_len},
             mphi + c0, partial + c0, k, kt};
    node_rows = launch_s3(a, aligned, node_rows, stream);
    if (n_segs > 0) {
      a.items.seg_node = seg_node;
      a.items.seg_begin = seg_begin;
      a.items.seg_end = seg_end;
      a.items.n_items = n_segs;
      a.partial += static_cast<int64_t>(node_rows) * k;
      seg_rows = launch_s3(a, aligned, seg_rows, stream);
    }
  }
  const unsigned rows = node_rows + seg_rows;
  svt::launch_colsum_partials(partial, static_cast<int>(rows), k, k, s3,
                              stream);
  return static_cast<int>(cudaGetLastError());
}
