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
//
// Forms. T: mphi rows are f32 or, under -bf16, bf16 (half the gathered
// bytes; products and sums stay f32). CONV (-freeze,
// svinet_tpu/svi/sweep_math.py:117-151, s3_pass with conv): a link with
// exactly one frozen end adds, at the frozen column c = max(cp, cq) - 1,
// the other end's mphi[., c] and nothing else. That is one value, not a
// row, so no row is gathered for it:
//  - owner frozen, neighbour free: each lane reads mphi[q, c] of its own
//    neighbour of the chunk (one 32-byte sector, not a 2 KB row); the
//    lanes' sums are added across the group in shuffle order once the list
//    is walked, and the total goes to column c of the running sums;
//  - owner free, neighbour frozen: the value is the owner's own mphi[p, c],
//    already in registers, and c changes from neighbour to neighbour.
// Either way a value lands in a column of a register array that is only
// known at run time: svt::add_at_column offers it to every register of the
// one lane that holds the column, under a predicate. No shared memory, no
// atomics: the order of the additions is fixed by the adjacency, and two
// launches give the same bits.
//
// The design pass around the L2. The pull needs a whole row per link, but
// the columns of s3 are independent, so the pass can also run slab by slab
// over column slabs of 32 to 128 bytes a row that the 50 MB L2 holds, with
// a lane or two per link (csrc/alt/s3_slab.cu, with its wrapper, its plain
// version and its times in tools/s3_slab.py and tools/bench_kernels.py).
// Measured on an H100 80GB HBM3 at 700 W, K = 500, 20 links a node: the L2
// answers about 95 G random requests a second up to 64 bytes each, so rows
// of 32 bytes, all that fits at n = 1M, come at 3.0 TB/s, no faster than
// DRAM serves this kernel's 2 KB rows (15.2 against 14.4 ms), while rows of
// 64 bytes (n = 500k: 4.8 against 7.0 ms) and 128 (n = 250k: 2.1 against
// 3.4) win; with -freeze flags the slab form loses everywhere. None of the
// documented workloads (planted-20k, ca-AstroPh, the n = 1M stretch shape)
// lies where it wins, and its crossover at other K and degrees is not
// measured, so it is kept off the path and this kernel is the s3 pass at
// every shape.

#include <limits.h>

#include "common.cuh"

namespace {

template <class T>
struct S3Args {
  svt::AdjItems items;
  const T* mphi;      // (n, ld), offset to this tile's first column
  float* partial;     // (blocks, ld) scratch, offset likewise
  int ld;             // row stride, K
  int k;              // width of the column tile
  // CONV only
  const int32_t* conv;  // (n,) 0 = free, else frozen column + 1
  int col0;             // first column of this tile
};

template <int VEC, int G, int N, class T, bool CONV>
__global__ void __launch_bounds__(svt::kBlockThreads)
s3_pull_kernel(const S3Args<T> a) {
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

  float acc[L], own[L];
  // neighbour rows as loaded (see svt::RawRow): the current and the next
  svt::RawRow<VEC, N, T> cur, nxt = {};
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
    int cp = 0;
    float from_free = 0.0f;  // this lane's mphi[q, cp - 1] over free q
    if constexpr (CONV) cp = a.conv[p];
    // the owner's frozen column within this tile, or out of it
    const int own_col = cp - 1 - a.col0;
    const bool own_col_here = CONV && own_col >= 0 && own_col < k;

    // G neighbour ids at a time, one per lane, handed round by shuffle
    for (int chunk = start; chunk < end; chunk += G) {
      const int cnt = min(G, end - chunk);
      const int mine = g < cnt ? nbr[chunk + g] : 0;
      int mine_c = 0;
      if constexpr (CONV) {
        if (g < cnt) mine_c = a.conv[mine];
        if (own_col_here && g < cnt && mine_c == 0)
          from_free += svt::load_scalar(
              a.mphi + static_cast<int64_t>(mine) * a.ld + own_col);
      }
      int64_t q = __shfl_sync(mask, mine, 0, G);
      int cq = CONV ? __shfl_sync(mask, mine_c, 0, G) : 0;
      // both ends frozen or both free: the dense product of the two rows
      bool dense = (cp > 0) == (cq > 0);
      if (!CONV || dense)
        svt::load_raw<VEC, G, N>(a.mphi + q * a.ld, k, g, cur);
      for (int j = 0; j < cnt; ++j) {
        bool dense_n = false;
        int cq_n = 0;
        if (j + 1 < cnt) {
          q = __shfl_sync(mask, mine, j + 1, G);
          if constexpr (CONV) cq_n = __shfl_sync(mask, mine_c, j + 1, G);
          dense_n = (cp > 0) == (cq_n > 0);
          if (!CONV || dense_n)
            svt::load_raw<VEC, G, N>(a.mphi + q * a.ld, k, g, nxt);
        }
        if (!CONV || dense) {
#pragma unroll
          for (int i = 0; i < L; ++i)
            acc[i] = fmaf(own[i], cur.at(i), acc[i]);
        } else if (cq > 0) {
          // owner free, neighbour frozen to column cq - 1: the owner's own
          // value there
          const int c = cq - 1 - a.col0;
          if (c >= 0 && c < k) {
            int home, reg;
            svt::column_home<VEC, G>(c, &home, &reg);
            if (g == home) {
#pragma unroll
              for (int i = 0; i < L; ++i)
                if (i == reg) acc[i] += own[i];
            }
          }
        }  // owner frozen, neighbour free: in from_free already
        cur = nxt;
        dense = dense_n;
        cq = cq_n;
      }
    }
    if constexpr (CONV) {
      if (own_col_here)
        svt::add_at_column<VEC, G, N>(
            acc, own_col, g, svt::group_sum<G>(from_free, mask));
    }
  }
  svt::block_colsum<VEC, G, N>(
      acc, k, smem, a.partial + static_cast<int64_t>(blockIdx.x) * a.ld);
}

// Launch over a.items with `blocks` blocks, or, when that is 0, with as
// many as the items need; returns the number of blocks, which is the
// number of scratch rows written.
template <class T>
unsigned launch_s3(const S3Args<T>& a, bool aligned, unsigned blocks,
                   cudaStream_t stream) {
  if (a.items.n_items == 0) return 0;
  svt::dispatch_row(a.k, aligned, [&](auto vec, auto grp, auto cnt) {
    constexpr int VEC = decltype(vec)::value;
    constexpr int G = decltype(grp)::value;
    constexpr int N = decltype(cnt)::value;
    if (blocks == 0) blocks = svt::reduce_blocks_for(a.items.n_items, G);
    if (a.conv != nullptr)
      s3_pull_kernel<VEC, G, N, T, true>
          <<<blocks, svt::kBlockThreads, 0, stream>>>(a);
    else
      s3_pull_kernel<VEC, G, N, T, false>
          <<<blocks, svt::kBlockThreads, 0, stream>>>(a);
  });
  return blocks;
}

template <class T>
void s3_pass(const T* mphi, const int32_t* conv, const int32_t* rowptr,
             const int32_t* nbr, const int32_t* seg_node,
             const int32_t* seg_begin, const int32_t* seg_end, float* partial,
             float* s3, int64_t n, int64_t n_segs, int k, int seg_len,
             cudaStream_t stream) {
  const bool aligned =
      k % 4 == 0 && svt::aligned_unit(mphi) && svt::aligned16(partial);
  // every column tile is launched with the first tile's blocks, so that
  // the scratch holds the same rows for all columns
  unsigned node_rows = 0;
  unsigned seg_rows = 0;
  for (int c0 = 0; c0 < k; c0 += svt::kRegMaxK) {
    const int kt = k - c0 < svt::kRegMaxK ? k - c0 : svt::kRegMaxK;
    S3Args<T> a{{rowptr, nbr, nullptr, nullptr, nullptr, n, seg_len},
                mphi + c0, partial + c0, k, kt, conv, c0};
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
}

}  // namespace

// s3 (K,) is written; partial is scratch of 2 * svt::kReduceBlocks rows of
// K (the pass over nodes, then the pass over hub segments). mphi is (n,K)
// f32, or bf16 when rows_bf16 is set; conv is (n,) int32 or null.
extern "C" int svt_s3_pass(const void* mphi, int rows_bf16,
                           const int32_t* conv, const int32_t* rowptr,
                           const int32_t* nbr, const int32_t* seg_node,
                           const int32_t* seg_begin, const int32_t* seg_end,
                           float* partial, float* s3, int64_t n,
                           int64_t n_segs, int k, int seg_len,
                           cudaStream_t stream) {
  if (k <= 0) return static_cast<int>(cudaGetLastError());
  if (rows_bf16)
    s3_pass(static_cast<const svt::bf16*>(mphi), conv, rowptr, nbr, seg_node,
            seg_begin, seg_end, partial, s3, n, n_segs, k, seg_len, stream);
  else
    s3_pass(static_cast<const float*>(mphi), conv, rowptr, nbr, seg_node,
            seg_begin, seg_end, partial, s3, n, n_segs, k, seg_len, stream);
  return static_cast<int>(cudaGetLastError());
}
