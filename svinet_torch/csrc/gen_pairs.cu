// Kernel 16: the generator's dense pair draw (svinet_tpu/svi/gen.py:45
// _gen_rows inside :64 draw_network), used by -gen up to n = 65,536 and
// by every -ppc draw. It replaces no TPU kernel: the JAX function draws
// (rows, n) slabs of categorical samples in XLA.
//
// It draws on JAX's own stream (threefry.cuh), as draw_network does. Rows
// go in blocks of row_block = max(1, min(n, 2^24 // (n K) + 1)) from row
// 0; block start s takes the key fold_in(key, s), split into k1, k2, k3.
// Row i = s + r and column j have the slab index r n + j: u =
// uniform(k3) there, and z_p (z_q) is the first argmax over c of
// gumbel(k1 (k2), (r n + j) K + c) + logits[i (j)][c], the logits
// log(max(pi, 1e-300)) made in float64 and kept in f32 on the host. The
// pair i < j is a link when u < (z_p == z_q ? beta[z_p] : eps). The
// plain version (svi/gen.py:gen_pairs_plain) computes the same in int64
// and f32 torch arithmetic; the uniforms are JAX's bit for bit, and the
// logs are logf at full precision.
//
// Exact shortcuts: u is drawn first. Where u >= max(max_k beta_k, eps)
// the pair is no link whatever the categories, and z_p is not drawn;
// where u < beta[z_p] and u < eps agree, the link does not depend on z_q,
// and z_q is not drawn. `stats` counts the pairs whose z_p and z_q were
// drawn.
//
// A warp owns a row. Pass 1 draws its pairs, 32 a step, and keeps each
// step's ballot in a word of a (rows, ceil(n / 32)) bit table and the
// row's link count; the caller scans the counts into offsets; pass 2
// reads the words and writes each row's links in ascending j (each link's
// place among the lanes below it). So each pair is drawn once. No atomics
// but the statistics.
//
// What bounds it on an H100: integer and special-function work, 2K + 1
// threefry2x32-20 blocks (about 100 integer instructions each) and 4K logf
// a pair where both categories are drawn; the output and the bit table
// are small beside it.

#include <cstdint>

#include "common.cuh"
#include "threefry.cuh"

namespace {

struct GenArgs {
  const float* logits;  // (n, k)
  const float* beta;    // (k,)
  float eps;
  float umax;           // max(max_k beta_k, eps)
  int64_t n;
  int k;
  int64_t row0, row1;
  int64_t row_block;
  svt::TfKey key;       // the draw's key (before the row blocks' fold_in)
  int64_t words;        // words a row of the bit table
  uint32_t* table;      // (row1 - row0, words)
  int64_t* counts;      // pass 1: (row1 - row0,) links a row
  const int64_t* offsets;  // pass 2: (row1 - row0,) exclusive scan
  int32_t* edges;       // pass 2: (total, 2)
  unsigned long long* stats;  // pass 1, or null: pairs with z_p, z_q drawn
};

// the first argmax over c of gumbel(key, base K + c) + row[c]
__device__ __forceinline__ int category(svt::TfKey key, uint64_t base,
                                        const float* __restrict__ row,
                                        int k) {
  const uint64_t x0 = base * static_cast<uint64_t>(k);
  int best = 0;
  float top = __fadd_rn(svt::tf_gumbel(key, x0), __ldg(row));
  for (int c = 1; c < k; ++c) {
    const float s = __fadd_rn(svt::tf_gumbel(key, x0 + c), __ldg(row + c));
    if (s > top) {
      top = s;
      best = c;
    }
  }
  return best;
}

__global__ void __launch_bounds__(svt::kBlockThreads)
gen_draw_kernel(const GenArgs a) {
  const int lane = threadIdx.x % svt::kWarp;
  const int64_t i = a.row0 +
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) /
      svt::kWarp;
  if (i >= a.row1) return;
  const int64_t start = i / a.row_block * a.row_block;
  const svt::TfKey kb = svt::tf_fold_in(a.key, static_cast<uint32_t>(start));
  const svt::TfKey k1 = svt::tf_split(kb, 0), k2 = svt::tf_split(kb, 1),
                   k3 = svt::tf_split(kb, 2);
  const uint64_t slab = static_cast<uint64_t>(i - start) * a.n;
  const float* row_i = a.logits + i * a.k;
  uint32_t* words = a.table + (i - a.row0) * a.words;
  int64_t count = 0;
  unsigned long long drawn_p = 0, drawn_q = 0;
  for (int64_t w = 0, base = i + 1; base < a.n; ++w, base += svt::kWarp) {
    const int64_t j = base + lane;
    bool hit = false;
    if (j < a.n) {
      const uint64_t x = slab + j;
      const float u = svt::tf_unit(svt::tf_bits(k3, x));
      if (u < a.umax) {
        ++drawn_p;
        const int zp = category(k1, x, row_i, a.k);
        const bool lo = u < __ldg(a.beta + zp), le = u < a.eps;
        if (lo == le) {
          hit = lo;
        } else {
          ++drawn_q;
          hit = category(k2, x, a.logits + j * a.k, a.k) == zp ? lo : le;
        }
      }
    }
    const unsigned votes = __ballot_sync(svt::kFull, hit);
    if (lane == 0) words[w] = votes;
    count += __popc(votes);
  }
  if (lane == 0) a.counts[i - a.row0] = count;
  if (a.stats != nullptr) {
#pragma unroll
    for (int off = svt::kWarp / 2; off > 0; off >>= 1) {
      drawn_p += __shfl_xor_sync(svt::kFull, drawn_p, off);
      drawn_q += __shfl_xor_sync(svt::kFull, drawn_q, off);
    }
    if (lane == 0) {
      atomicAdd(a.stats, drawn_p);
      atomicAdd(a.stats + 1, drawn_q);
    }
  }
}

__global__ void __launch_bounds__(svt::kBlockThreads)
gen_write_kernel(const GenArgs a) {
  const int lane = threadIdx.x % svt::kWarp;
  const int64_t i = a.row0 +
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) /
      svt::kWarp;
  if (i >= a.row1) return;
  const uint32_t* words = a.table + (i - a.row0) * a.words;
  int64_t at = a.offsets[i - a.row0];
  for (int64_t w = 0, base = i + 1; base < a.n; ++w, base += svt::kWarp) {
    const unsigned votes = words[w];
    if ((votes >> lane) & 1u) {
      const int64_t e = at + __popc(votes & ((1u << lane) - 1u));
      a.edges[2 * e] = static_cast<int32_t>(i);
      a.edges[2 * e + 1] = static_cast<int32_t>(base + lane);
    }
    at += __popc(votes);
  }
}

}  // namespace

// pass 1 (write = 0): table (row1 - row0, words) and counts (row1 - row0,)
// int64, each row's links; stats (2,) uint64 += the pairs whose z_p and
// z_q were drawn, when not null. pass 2 (write = 1): edges (total, 2)
// int32 at offsets (the exclusive scan of the counts), row-major,
// ascending j within a row. key = (k0, k1), the draw's key.
extern "C" int svt_gen_pairs(const float* logits, const float* beta,
                             uint32_t* table, int64_t* counts,
                             const int64_t* offsets, int32_t* edges,
                             unsigned long long* stats, int64_t n, int k,
                             int64_t row0, int64_t row1, int64_t row_block,
                             int64_t words, float eps, float umax,
                             int64_t k0, int64_t k1, int write,
                             cudaStream_t stream) {
  if (k <= 0 || n < 0 || row0 < 0 || row1 > n || row0 > row1 ||
      row_block < 1 || n > (int64_t{1} << 31) ||
      words < (n + svt::kWarp - 1) / svt::kWarp)
    return static_cast<int>(cudaErrorInvalidValue);
  if (row1 == row0) return 0;
  const GenArgs a{logits, beta, eps, umax, n, k, row0, row1, row_block,
                  svt::TfKey{static_cast<uint32_t>(k0),
                             static_cast<uint32_t>(k1)},
                  words, table, counts, offsets, edges, stats};
  const unsigned blocks = svt::blocks_for(row1 - row0, svt::kWarp);
  if (write)
    gen_write_kernel<<<blocks, svt::kBlockThreads, 0, stream>>>(a);
  else
    gen_draw_kernel<<<blocks, svt::kBlockThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
