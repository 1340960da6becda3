// Kernel 3: the mean-indicator update of the link-sampling sweep.
//
// From gacc (n,K), the phi sums of kernel 2, the training degree deg (n,)
// and sumk (K,):
//   mphi  = gacc / (2 deg)                       (0 on a row without links)
//   gnext = alpha + gacc + (n - 2 deg - 1) mphi  (alpha + gacc without links)
//   gnext *= ones / max(sumk, 1e-30)             (annealing, rows with links)
//   s1 = sum_rows mphi,  s2 = sum_rows mphi^2
// (svinet_tpu/svi/sweep_math.py:90-114, mean_indicator_update; reference
// src/linksampling.cc:526-545). On the TPU this was part of the XLA sweep
// program; in plain PyTorch it is about ten elementwise launches and two
// reductions, each over a 2 GB array at n=1M, K=500.
//
// What bounds it on an H100: bytes. It must read gacc once and write gnext
// and mphi once, 12 bytes per element; the arithmetic is a handful of
// operations per element.
//
// What the design does about it: one pass. A group of lanes owns a row
// (layout <VEC, G, N> of common.cuh, 16-byte loads and stores), writes
// gnext over gacc in place and mphi beside it, and keeps its share of the
// two column sums in registers while it strides over the rows. The column
// sums cross rows, so they end in the two steps of common.cuh's
// block_colsum and colsum_partials_kernel: no float atomics, the same bits
// from every launch. The per-row reciprocal 1 / (2 deg) replaces K
// divisions (one ulp of relative error against the plain version).
//
// Every column is independent of the others here, so K above 512 needs no
// kernel of its own: the launch is repeated over column tiles of at most
// 512, each with the row stride K.
//
// Under -sparse-w the f32 mphi goes into the odd half of the (n, K, 2)
// rows kernel 7 gathers (Elogpi and mphi side by side), whose even half,
// this sweep's Elogpi, is dead by then: the kernel stores whole pairs
// (0, mphi), a 16-byte store of two pairs a lane (units of VEC = 2, common.cuh
// dispatch_pair_row). Storing the odd half alone took 8.44 ms where the
// (n, K) form takes 2.45 at n=1M, K=500 (H100 80GB HBM3, 700 W,
// chip_smoke.py): the L2 merges each half-written sector.
//
// Forms. Under -bf16 the s3 pass gathers mphi as bf16 rows, so the kernel
// also (or only) stores mphi rounded to bf16: the default sweep then never
// writes the f32 mphi (10 bytes an element instead of 12), -fuse-s3 writes
// both, since the f32 one is carried state. Under -freeze (template flag
// CONV) the finished gnext row is still in registers, so the sticky
// converged flag of the row (svinet_tpu/svi/sweep_math.py:30-43,
// converged_of: exactly one column with gnext - alpha >= 1 freezes the
// node to it, any other count keeps the flag it had) is made here and
// costs no further read of (n,K). With column tiles the count and the
// first such column pass from tile to tile through an (n,2) scratch.

#include <limits.h>

#include "common.cuh"

namespace {

struct MeanArgs {
  float* gacc;        // (n, ld): gacc in, gnext out
  const float* deg;   // (n,)
  const float* sumk;  // this tile's columns
  float* mphi;        // (n, ld) out, (n, ld, 2) pairs (0, mphi), or null
  int m_pairs;        // whether mphi is the (n, ld, 2) pairs of -sparse-w
  svt::bf16* mphi_bf16;  // (n, ld) out, or null
  float* part1;       // (blocks, ld) scratch for s1
  float* part2;       // (blocks, ld) scratch for s2
  int64_t n;
  int ld;             // row stride, K
  int k;              // width of the column tile
  float alpha;
  float n_nodes;
  float ones;
  int annealing;
  // CONV only
  const int32_t* conv_prev;  // (n,) flags before this sweep
  int32_t* conv_out;         // (n,) flags after it
  int2* count_first;         // (n,) scratch between column tiles
  int col0;                  // first column of this tile
  int first_tile;
  int last_tile;
};

template <int VEC, int G, int N, bool CONV>
__global__ void __launch_bounds__(svt::kBlockThreads)
mean_indicator_kernel(const MeanArgs a) {
  constexpr int L = VEC * N;
  __shared__ float smem[svt::kBlockThreads * L];
  const int lane = threadIdx.x % svt::kWarp;
  const int g = threadIdx.x % G;
  const unsigned mask = svt::group_mask<G>(lane);
  const int k = a.k;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x / G;

  float scl[L], s1[L], s2[L], v[L], m[L];
  svt::load_row<VEC, G, N>(a.sumk, k, g, 1.0f, scl);
#pragma unroll
  for (int i = 0; i < L; ++i) {
    scl[i] = a.annealing ? a.ones / fmaxf(scl[i], 1e-30f) : 1.0f;
    s1[i] = 0.0f;
    s2[i] = 0.0f;
  }
  for (int64_t r = first; r < a.n; r += step) {
    float* grow = a.gacc + r * a.ld;
    svt::load_row<VEC, G, N, false>(grow, k, g, 0.0f, v);
    const float degc = 2.0f * a.deg[r];
    if (degc > 0.0f) {
      const float inv = 1.0f / degc;
      const float f = a.n_nodes - degc - 1.0f;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        m[i] = v[i] * inv;
        s1[i] += m[i];
        s2[i] = fmaf(m[i], m[i], s2[i]);
        v[i] = (v[i] + a.alpha + f * m[i]) * scl[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < L; ++i) {
        m[i] = 0.0f;
        v[i] += a.alpha;
      }
    }
    svt::store_row<VEC, G, N>(grow, k, g, v);
    if (a.mphi != nullptr && !a.m_pairs) {
      svt::store_row<VEC, G, N>(a.mphi + r * a.ld, k, g, m);
    } else if (a.mphi != nullptr) {
      float zero[L];
#pragma unroll
      for (int i = 0; i < L; ++i) zero[i] = 0.0f;
      svt::store_pairs<VEC, G, N>(a.mphi + 2 * r * a.ld, k, g, 1, m, zero);
    }
    if constexpr (VEC != 2) {  // bf16 rows are not written in pairs
      if (a.mphi_bf16 != nullptr)
        svt::store_row<VEC, G, N>(a.mphi_bf16 + r * a.ld, k, g, m);
    }
    if constexpr (CONV) {
      // columns of this row with gnext - alpha >= 1, and the first of
      // them; units past the tile hold no column and are left out
      int count = 0;
      int lowest = INT_MAX;
#pragma unroll
      for (int j = N - 1; j >= 0; --j)
#pragma unroll
        for (int u = VEC - 1; u >= 0; --u) {
          const int c = (g + j * G) * VEC + u;
          if (c < k && v[j * VEC + u] - a.alpha >= 1.0f) {
            ++count;
            lowest = c + a.col0;
          }
        }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) {
        count += __shfl_xor_sync(mask, count, off);
        lowest = min(lowest, __shfl_xor_sync(mask, lowest, off));
      }
      if (g == 0) {
        if (!a.first_tile) {
          const int2 before = a.count_first[r];
          count += before.x;
          lowest = min(lowest, before.y);
        }
        if (!a.last_tile)
          a.count_first[r] = make_int2(count, lowest);
        else
          a.conv_out[r] = count == 1 ? lowest + 1 : a.conv_prev[r];
      }
    }
  }
  // units past the tile held 0 throughout and are not written
  svt::block_colsum<VEC, G, N>(
      s1, k, smem, a.part1 + static_cast<int64_t>(blockIdx.x) * a.ld);
  svt::block_colsum<VEC, G, N>(
      s2, k, smem, a.part2 + static_cast<int64_t>(blockIdx.x) * a.ld);
}

}  // namespace

// gacc (n,K) becomes gnext in place; s12 (2,K) = [s1; s2] is written;
// partial is scratch of 2 * svt::kReduceBlocks rows of K. mphi (n,K) f32,
// or with m_pairs (n,K,2) f32 pairs (0, mphi), and mphi_bf16 (n,K) bf16
// are written where not null (mphi_bf16 not with m_pairs). With conv_prev
// (n,) int32, conv_out (n,) receives the sticky converged flags of gnext;
// count_first is (n,2) int32 scratch, needed only for K above 512.
extern "C" int svt_mean_indicator(float* gacc, const float* deg,
                                  const float* sumk, float* mphi, int m_pairs,
                                  void* mphi_bf16, float* partial, float* s12,
                                  const int32_t* conv_prev, int32_t* conv_out,
                                  void* count_first, int64_t n, int k,
                                  float alpha, float n_nodes, float ones,
                                  int annealing, cudaStream_t stream) {
  if (n <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  svt::bf16* mb = static_cast<svt::bf16*>(mphi_bf16);
  float* part1 = partial;
  float* part2 = partial + static_cast<int64_t>(svt::kReduceBlocks) * k;
  if (m_pairs && (mb != nullptr || conv_prev != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = k % 4 == 0 && svt::aligned16(gacc) &&
                       (m_pairs || svt::aligned16(mphi)) &&
                       svt::aligned_unit(mb) &&
                       svt::aligned16(sumk) && svt::aligned16(partial);
  const bool conv = conv_prev != nullptr;
  const bool aligned_pairs = svt::aligned16(gacc) && svt::aligned16(mphi) &&
                             svt::aligned16(sumk);
  unsigned blocks = 0;
  for (int c0 = 0; c0 < k; c0 += svt::kRegMaxK) {
    const int kt = k - c0 < svt::kRegMaxK ? k - c0 : svt::kRegMaxK;
    const MeanArgs a{gacc + c0,
                     deg,
                     sumk + c0,
                     mphi == nullptr ? nullptr
                                     : mphi + c0 * (m_pairs ? 2 : 1),
                     m_pairs,
                     mb == nullptr ? nullptr : mb + c0,
                     part1 + c0,
                     part2 + c0,
                     n,
                     k,
                     kt,
                     alpha,
                     n_nodes,
                     ones,
                     annealing,
                     conv_prev,
                     conv_out,
                     static_cast<int2*>(count_first),
                     c0,
                     c0 == 0,
                     c0 + kt == k};
    // every tile is launched with the first tile's blocks, so that the
    // scratch rows of all columns are the same in number
    if (m_pairs) {
      svt::dispatch_pair_row(kt, aligned_pairs, [&](auto vec, auto grp,
                                                    auto cnt) {
        constexpr int VEC = decltype(vec)::value;
        constexpr int G = decltype(grp)::value;
        constexpr int N = decltype(cnt)::value;
        if (blocks == 0) blocks = svt::reduce_blocks_for(n, G);
        mean_indicator_kernel<VEC, G, N, false>
            <<<blocks, svt::kBlockThreads, 0, stream>>>(a);
      });
      continue;
    }
    svt::dispatch_row(kt, aligned, [&](auto vec, auto grp, auto cnt) {
      constexpr int VEC = decltype(vec)::value;
      constexpr int G = decltype(grp)::value;
      constexpr int N = decltype(cnt)::value;
      if (blocks == 0) blocks = svt::reduce_blocks_for(n, G);
      if (conv)
        mean_indicator_kernel<VEC, G, N, true>
            <<<blocks, svt::kBlockThreads, 0, stream>>>(a);
      else
        mean_indicator_kernel<VEC, G, N, false>
            <<<blocks, svt::kBlockThreads, 0, stream>>>(a);
    });
  }
  svt::launch_colsum_partials(part1, static_cast<int>(blocks), k, k, s12,
                              stream);
  svt::launch_colsum_partials(part2, static_cast<int>(blocks), k, k, s12 + k,
                              stream);
  return static_cast<int>(cudaGetLastError());
}
