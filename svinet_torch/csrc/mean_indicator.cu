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

#include "common.cuh"

namespace {

struct MeanArgs {
  float* gacc;        // (n, ld): gacc in, gnext out
  const float* deg;   // (n,)
  const float* sumk;  // this tile's columns
  float* mphi;        // (n, ld) out
  float* part1;       // (blocks, ld) scratch for s1
  float* part2;       // (blocks, ld) scratch for s2
  int64_t n;
  int ld;             // row stride, K
  int k;              // width of the column tile
  float alpha;
  float n_nodes;
  float ones;
  int annealing;
};

template <int VEC, int G, int N>
__global__ void __launch_bounds__(svt::kBlockThreads)
mean_indicator_kernel(const MeanArgs a) {
  constexpr int L = VEC * N;
  __shared__ float smem[svt::kBlockThreads * L];
  const int g = threadIdx.x % G;
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
    svt::store_row<VEC, G, N>(a.mphi + r * a.ld, k, g, m);
  }
  // units past the tile held 0 throughout and are not written
  svt::block_colsum<VEC, G, N>(
      s1, k, smem, a.part1 + static_cast<int64_t>(blockIdx.x) * a.ld);
  svt::block_colsum<VEC, G, N>(
      s2, k, smem, a.part2 + static_cast<int64_t>(blockIdx.x) * a.ld);
}

}  // namespace

// gacc (n,K) becomes gnext in place; mphi (n,K) and s12 (2,K) = [s1; s2]
// are written; partial is scratch of 2 * svt::kReduceBlocks rows of K.
extern "C" int svt_mean_indicator(float* gacc, const float* deg,
                                  const float* sumk, float* mphi,
                                  float* partial, float* s12, int64_t n, int k,
                                  float alpha, float n_nodes, float ones,
                                  int annealing, cudaStream_t stream) {
  if (n <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  float* part1 = partial;
  float* part2 = partial + static_cast<int64_t>(svt::kReduceBlocks) * k;
  const bool aligned = k % 4 == 0 && svt::aligned16(gacc) &&
                       svt::aligned16(mphi) && svt::aligned16(sumk) &&
                       svt::aligned16(partial);
  unsigned blocks = 0;
  for (int c0 = 0; c0 < k; c0 += svt::kRegMaxK) {
    const int kt = k - c0 < svt::kRegMaxK ? k - c0 : svt::kRegMaxK;
    const MeanArgs a{gacc + c0,  deg,   sumk + c0, mphi + c0, part1 + c0,
                     part2 + c0, n,     k,         kt,        alpha,
                     n_nodes,    ones,  annealing};
    svt::dispatch_row(kt, aligned, [&](auto vec, auto grp, auto cnt) {
      constexpr int VEC = decltype(vec)::value;
      constexpr int G = decltype(grp)::value;
      constexpr int N = decltype(cnt)::value;
      // every tile is launched with the first tile's blocks, so that the
      // scratch rows of all columns are the same in number
      if (blocks == 0) blocks = svt::reduce_blocks_for(n, G);
      mean_indicator_kernel<VEC, G, N>
          <<<blocks, svt::kBlockThreads, 0, stream>>>(a);
    });
  }
  svt::launch_colsum_partials(part1, static_cast<int>(blocks), k, k, s12,
                              stream);
  svt::launch_colsum_partials(part2, static_cast<int>(blocks), k, k, s12 + k,
                              stream);
  return static_cast<int>(cudaGetLastError());
}
