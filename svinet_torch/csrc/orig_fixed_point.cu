// Kernel 15: the full blockmodel's coupled per-pair fixed point and the
// node sums it feeds, the body of every -orig batch iteration
// (svinet_tpu/svi/orig.py:39 _phi2_fixed_point inside :125
// orig_batch_step), and its ELBO form for -logl (:68 orig_approx_elbo's
// pair terms). It replaces no TPU kernel: the JAX function runs the
// rounds as (B, K) x (K, K) products in XLA.
//
// For a pair (p, q) with label y, from phi1 = phi2 = 1/K, Jacobi rounds
//   phi1' = softmax(Elogpi[p] + L_y phi2)
//   phi2' = softmax(Elogpi[q] + L_y phi1)
// with (L phi)_g = sum_h L[g, h] phi_h, L_1 = log max(beta, 1e-30) for a
// link and L_0 = log max(1 - beta, 1e-30) for a nonlink, under the JAX
// package's block rule (kernel 8's, csrc/phi_fixed_point.cu): the pairs
// are cut into blocks of B at positions [bB, (b+1)B); block b takes R_b
// rounds, the first round whose largest change (the larger mean absolute
// change of a pair's two phis) over its slots is below thresh, else
// max_iters. The JAX engine pads the pairs to whole blocks with (0, 0),
// y = 0; one virtual slot (0, 0) stands for that padding in the last
// block's R_b, and no padded array is made.
//
// The design: a block of the rule stays on chip for all its rounds. A
// thread-block cluster of C = 8 CTAs owns a rule block, each CTA a slice of
// S = ceil(B / C) slots (256 at B = 2,048); the grid has a cluster a rule
// block, and the card runs as many at once as it holds. A pair's rounds
// need no other pair, so the only traffic between the CTAs is each round's
// largest change: every CTA reduces its slice's, puts it in its shared
// memory, and after one cluster barrier reads the C values through
// distributed shared memory, so all C decide the same exit: the block ends
// at the first round whose largest change is below thresh (or at
// max_iters), R_b = r, and the phis after that round are the slots'. There
// is no launch per round and no host sync.
//
// Shared memory holds L_1 and L_0 first (transposed, each row padded with
// zeros to kp columns: 2 K kp floats, up to about K = 160), then the
// slice's phis where they fit too ([side][h][slot], 2 K (S + 1) floats, an
// odd stride: up to K = 80 beside L); otherwise the phis live in the phi
// output buffer itself (L1 and L2) and L is read from device memory, the
// same code over other strides. The SM's 512 threads (128 registers each)
// are split over as many CTAs as its shared memory holds, up to 4, so that
// their rounds' barriers overlap.
//
// A group of G lanes owns a pair (G the least power of two up to a warp
// with ceil(K / G) <= 16), and the columns are cut into T tiles of G NC
// (T = 1 up to K = 512; NC, the columns a lane a tile, ceil(K / (G T))
// rounded up to even; kp = T G NC, svt_orig_layout): lane g owns the NC
// consecutive columns [t G NC + g NC, t G NC + (g + 1) NC) of tile t. For
// each h the lane reads phi1[h], phi2[h] and its NC values of L's row h
// (float2 loads; padding columns are zero, so the loop has no branch), and
// makes 4 NC products and sums: each L value serves both sides. h runs 0,
// 1, ..., K - 1 in order and every product and sum is rounded alone
// (__fmul_rn, __fadd_rn: no fma): the arithmetic of
// ops/orig_phi.py:product_plain, so R_b is the plain version's on every
// block (a pair with two attractors is decided by the last bit of a
// logit) but at a tie: the softmax sums in another order, so a block whose
// largest change lies within an f32 unit of thresh may end a round apart.
// Without fma a product and a sum are two instructions, so the
// kernel can reach at most half of the operations bound that counts an fma
// as two operations. No tensor cores: TF32 moves the logits by about 1e-3,
// and FP64 MMA gives other bits than the plain version. With one tile the
// logits stay in registers; with more (K > 512) each tile's go to two rows
// of 2 K floats its group holds in shared memory (as many groups a CTA as
// fit, up to 16 and down to one: K up to about 28,000), and the softmax
// runs over them.
// The softmax (exp(x - max) over its sum, __fdiv_rn) and the change take
// the group's columns in order, in group shuffles of a fixed tree; the new
// phis are written after a group barrier, so that no lane overwrites a phi
// its group still reads (Jacobi). Tiles of two pairs a group (each L value
// read once for both) measured slower on an H100 at K <= 100: at 128
// registers a thread their 4 NC accumulators spill.
//
// The ELBO form runs the same rounds and then, in the same kernel, each
// real pair's term from its final phis (lf_y phi2 formed by the same
// products, tile by tile).
//
// Training form: the phi buffer's rows 2i and 2i + 1 hold pair i's phi1
// and phi2 when the rounds end; a node pass then adds 2 phi of every slot
// of node p into gacc[p] in slot order (the CSR of the pairs' ends,
// ops/edges.py:owner_csr), a warp a node, starting from gacc's present
// row: gamma_hat grows chunk by chunk in a fixed order. The K x K moments
// are the caller's, a product over the staged rows. ELBO form: each real
// pair's term, unweighted, into terms[i]:
//   phi1^T lf_y phi2 + phi1 . Elogpi'[p] + phi2 . Elogpi'[q]
//   - sum phi1 log max(phi1, 1e-30) - sum phi2 log max(phi2, 1e-30)
// (lf and Elogpi' of the updated beta and gamma). No float atomics: where
// a value lands depends on the pair alone, so two launches give the same
// bits.
//
// What bounds it on an H100: 4K^2 f32 operations a pair and round (two
// products of a K x K matrix) against two gathered K-rows a pair; the
// operations bind at every K the engine runs.

#include <math.h>

#include <cooperative_groups.h>

#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;          // CTAs a rule block
// threads an SM runs at the kernel's 128 registers a thread, the most a
// CTA takes
constexpr int kMaxThreads = 512;
constexpr int kMaxNC = 16;           // most columns a lane a tile

// gacc[p] += 2 phi over p's slots in slot order (slot j: phi row j), a
// warp a node, each lane its columns
__global__ void __launch_bounds__(svt::kBlockThreads)
orig_node_kernel(const int32_t* __restrict__ rowptr,
                 const int32_t* __restrict__ nbr,
                 const float* __restrict__ phi, float* __restrict__ gacc,
                 int64_t n, int k) {
  const int lane = threadIdx.x % svt::kWarp;
  const int64_t p =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) /
      svt::kWarp;
  if (p >= n) return;
  const int begin = rowptr[p], end = rowptr[p + 1];
  if (begin == end) return;
  for (int c = lane; c < k; c += svt::kWarp) {
    float acc = gacc[p * k + c];
    for (int j = begin; j < end; ++j)
      acc = __fadd_rn(acc, 2.0f * __ldg(phi + int64_t{nbr[j]} * k + c));
    gacc[p * k + c] = acc;
  }
}

// The columns at k: G lanes a group, the least power of two with ceil(K /
// G) <= kMaxNC, at most a warp; T tiles of G NC columns, NC = ceil(K / (G
// T)) rounded up to even; L's rows padded to kp = T G NC
struct Layout {
  int lanes;
  int nc;
  int tiles;
  int kp;
};

Layout layout_for(int k) {
  int g = 1;
  while (g < svt::kWarp && (k + g - 1) / g > kMaxNC) g *= 2;
  const int cols = (k + g - 1) / g;
  const int tiles = (cols + kMaxNC - 1) / kMaxNC;
  int nc = (cols + tiles - 1) / tiles;
  nc += nc & 1;
  return Layout{g, nc, tiles, tiles * g * nc};
}

struct BlockArgs {
  const float* elogpi;    // (n, k)
  const float* lt;        // (2, k, kp): L_1, L_0 transposed, columns past
                          // k zero
  const int32_t* pairs;   // (m, 2)
  const int32_t* y;       // (m,)
  const float* elogpi_e;  // ELBO form: (n, k)
  const float* lte;       // ELBO form: (2, k, kp) as lt
  float* phi;             // (m + pad, 2, k): the phis when the rounds end,
                          // and the state where it is not in shared memory
  int32_t* block_rounds;  // (rule blocks,) R_b
  float* terms;           // ELBO form: (m,)
  int64_t m;
  int64_t rule_blocks;
  int k;
  int kp;                 // T G NC: L's padded row
  int tiles;              // T
  int max_iters;
  int block;              // B
  int pad;                // 1: the virtual slot (0, 0), y = 0, at m
  float thresh;
  int slice;              // S, slots a CTA
  int sp;                 // the shared state's stride, S + 1 (odd)
  int lanes;              // G
  int state_smem;         // the slice's phis in shared memory
  int l_smem;             // L_1 and L_0 in shared memory
};

// NaN-propagating max, as jnp.maximum and .max() take it
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float gsum(float v, int g_lanes, unsigned mask) {
  for (int off = g_lanes >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off);
  return v;
}

__device__ __forceinline__ float gmax(float v, int g_lanes, unsigned mask) {
  for (int off = g_lanes >> 1; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(mask, v, off));
  return v;
}

// NC consecutive floats from p (8-byte aligned: NC and the row are even)
template <int NC>
__device__ __forceinline__ void load_cols(const float* p, float (&v)[NC]) {
#pragma unroll
  for (int j = 0; j < NC; j += 2) {
    const float2 t = *reinterpret_cast<const float2*>(p + j);
    v[j] = t.x;
    v[j + 1] = t.y;
  }
}

// A pair's products at this lane's columns c0 + j of a tile (L's rows lr,
// padded to kp with zeros; the phis f1, f2 at stride hs): x1[j] = sum_h
// L[c][h] phi2[h], x2[j] = sum_h L[c][h] phi1[h], h in order, every product
// and sum rounded alone. Each L value read serves both sides.
template <int NC>
__device__ __forceinline__ void pair_products(const float* lr,
                                              const float* f1,
                                              const float* f2, int hs, int k,
                                              int kp, float (&x1)[NC],
                                              float (&x2)[NC]) {
#pragma unroll
  for (int j = 0; j < NC; ++j) x1[j] = x2[j] = 0.0f;
#pragma unroll 2
  for (int h = 0; h < k; ++h) {
    const float v1 = f1[h * hs], v2 = f2[h * hs];
    float l[NC];
    load_cols<NC>(lr + h * kp, l);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      x1[j] = __fadd_rn(x1[j], __fmul_rn(l[j], v2));
      x2[j] = __fadd_rn(x2[j], __fmul_rn(l[j], v1));
    }
  }
}

// One side's softmax over the group's columns: x (the products) becomes
// the new phi, Elogpi added first, exp(x - max) over its sum; returns the
// group's sum of |phi' - phi| (old at stride hs). Columns c0 + j past k
// are padding: no logit, no phi.
template <int NC>
__device__ __forceinline__ float softmax_side(float (&x)[NC],
                                              const float* __restrict__ erow,
                                              const float* old, int hs, int k,
                                              int c0, int g_lanes,
                                              unsigned mask) {
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    if (c0 + j < k) {
      x[j] = __fadd_rn(__ldg(erow + c0 + j), x[j]);
      mx = fmaxf(mx, x[j]);
    }
  }
  mx = gmax(mx, g_lanes, mask);
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    if (c0 + j < k) {
      x[j] = expf(x[j] - mx);
      sum += x[j];
    }
  }
  sum = gsum(sum, g_lanes, mask);
  float d = 0.0f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    if (c0 + j < k) {
      x[j] = __fdiv_rn(x[j], sum);
      d += fabsf(x[j] - old[(c0 + j) * hs]);
    }
  }
  return gsum(d, g_lanes, mask);
}

template <int NC>
__device__ __forceinline__ void store_side(const float (&x)[NC], float* dst,
                                           int hs, int k, int c0) {
#pragma unroll
  for (int j = 0; j < NC; ++j)
    if (c0 + j < k) dst[(c0 + j) * hs] = x[j];
}

// One round of a pair over its T column tiles (T > 1): each tile's products
// as pair_products forms them, Elogpi added, into the group's logit rows
// x1, x2 (2 K floats in shared memory, a lane its own columns); the
// softmax over them; after the group's barrier the new phis over the old
// (at stride hs). Returns the pair's change, max(mean |phi1' - phi1|, mean
// |phi2' - phi2|), in every lane of the group.
template <int NC>
__device__ float tiled_round(const float* lr, const float* __restrict__ e1,
                             const float* __restrict__ e2, float* f1,
                             float* f2, float* x1, float* x2, int hs, int k,
                             int kp, int c0, int tiles, int g_lanes,
                             unsigned mask) {
  const int tw = g_lanes * NC;
  float m1 = -INFINITY, m2 = -INFINITY;
  for (int t = 0; t < tiles; ++t) {
    float p1[NC], p2[NC];
    pair_products<NC>(lr + t * tw, f1, f2, hs, k, kp, p1, p2);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = t * tw + c0 + j;
      if (c < k) {
        x1[c] = __fadd_rn(__ldg(e1 + c), p1[j]);
        x2[c] = __fadd_rn(__ldg(e2 + c), p2[j]);
        m1 = fmaxf(m1, x1[c]);
        m2 = fmaxf(m2, x2[c]);
      }
    }
  }
  m1 = gmax(m1, g_lanes, mask);
  m2 = gmax(m2, g_lanes, mask);
  float s1 = 0.0f, s2 = 0.0f;
  for (int t = 0; t < tiles; ++t) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = t * tw + c0 + j;
      if (c < k) {
        x1[c] = expf(x1[c] - m1);
        x2[c] = expf(x2[c] - m2);
        s1 += x1[c];
        s2 += x2[c];
      }
    }
  }
  s1 = gsum(s1, g_lanes, mask);
  s2 = gsum(s2, g_lanes, mask);
  float d1 = 0.0f, d2 = 0.0f;
  for (int t = 0; t < tiles; ++t) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = t * tw + c0 + j;
      if (c < k) {
        x1[c] = __fdiv_rn(x1[c], s1);
        x2[c] = __fdiv_rn(x2[c], s2);
        d1 += fabsf(x1[c] - f1[c * hs]);
        d2 += fabsf(x2[c] - f2[c * hs]);
      }
    }
  }
  d1 = gsum(d1, g_lanes, mask);
  d2 = gsum(d2, g_lanes, mask);
  __syncwarp(mask);   // every lane has read the old phis
  for (int t = 0; t < tiles; ++t) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = t * tw + c0 + j;
      if (c < k) {
        f1[c * hs] = x1[c];
        f2[c * hs] = x2[c];
      }
    }
  }
  __syncwarp(mask);
  const float kf = static_cast<float>(k);
  return nan_max(d1 / kf, d2 / kf);
}

// A pair's ELBO parts at this lane's columns c0 + j of one tile, from its
// phis (at stride hs) and xl = lf_y phi2 there: phi1 . xl into t, the
// phis' dots with Elogpi' into dots, their entropies' sums into ent
template <int NC>
__device__ __forceinline__ void term_parts(const BlockArgs& a,
                                           const float (&xl)[NC],
                                           const float* f1, const float* f2,
                                           int hs, int64_t p, int64_t q,
                                           int c0, float& t, float& dots,
                                           float& ent) {
  const int k = a.k;
  const float* ep = a.elogpi_e + p * k;
  const float* eq = a.elogpi_e + q * k;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = c0 + j;
    if (c < k) {
      const float v1 = f1[c * hs];
      const float v2 = f2[c * hs];
      t += v1 * xl[j];
      dots += v1 * __ldg(ep + c) + v2 * __ldg(eq + c);
      ent += v1 * logf(fmaxf(v1, 1e-30f)) + v2 * logf(fmaxf(v2, 1e-30f));
    }
  }
}

// A cluster of kCluster CTAs a rule block (clusters stride over the rule
// blocks where the grid has fewer); CTA r of a cluster owns slots [rb B +
// r S, rb B + (r + 1) S) of the block (clipped to the block and to the
// slots), a group of G lanes the slots s, s + groups, ..., lane g the
// columns [t G NC + g NC, t G NC + (g + 1) NC) of each tile t. kTiled: T >
// 1, the logits through the group's rows in shared memory.
template <int NC, bool kTiled>
__global__ void __launch_bounds__(kMaxThreads, 1)
orig_block_kernel(const BlockArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kMaxThreads / svt::kWarp];
  __shared__ float xch[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_rank = static_cast<int>(cluster.num_blocks());
  const int k = a.k;
  const int kp = a.kp;
  const int64_t kkp = static_cast<int64_t>(k) * kp;
  const int g_lanes = a.lanes;
  const int g = threadIdx.x % g_lanes;
  const int c0 = g * NC;
  const int tiles = kTiled ? a.tiles : 1;
  const int tw = g_lanes * NC;
  const int gi = threadIdx.x / g_lanes;
  const int n_groups = blockDim.x / g_lanes;
  const int lane = threadIdx.x % svt::kWarp;
  const unsigned mask =
      g_lanes >= svt::kWarp
          ? svt::kFull
          : ((1u << g_lanes) - 1u) << (lane & ~(g_lanes - 1));
  const float inv_k = 1.0f / static_cast<float>(k);
  const float kf = static_cast<float>(k);
  // shared memory: L (2 K kp, where staged), the state (2 K sp, where
  // kept), p, q and y of the slice's slots, then (tiled) each group's two
  // logit rows
  const float* lt = a.lt;
  float* rest = smem;
  if (a.l_smem) {
    for (int64_t i = threadIdx.x; i < 2 * kkp; i += blockDim.x)
      smem[i] = __ldg(a.lt + i);
    lt = smem;
    rest += 2 * kkp;
  }
  float* const st = rest;
  int* const meta =
      reinterpret_cast<int*>(rest + (a.state_smem ? 2 * k * a.sp : 0));
  int* const mp = meta;
  int* const mq = meta + a.sp;
  int* const my = meta + 2 * a.sp;
  float* const xrow =
      reinterpret_cast<float*>(meta + 3 * a.sp) + int64_t{2} * k * gi;
  // the state's strides: [side][h][slot] in shared memory, else the phi
  // buffer's [slot][side][h]
  const int hs = a.state_smem ? a.sp : 1;
  const int64_t side = a.state_smem ? int64_t{k} * a.sp : k;
  const int64_t is = a.state_smem ? 1 : 2 * int64_t{k};
  const int64_t slots = a.m + a.pad;
  const int n_cluster = gridDim.x / n_rank;
  int phase = 0;
  for (int64_t rb = blockIdx.x / n_rank; rb < a.rule_blocks;
       rb += n_cluster) {
    const int64_t b_lo = rb * a.block;
    const int64_t b_hi = b_lo + a.block < slots ? b_lo + a.block : slots;
    const int64_t lo = b_lo + static_cast<int64_t>(rank) * a.slice;
    const int64_t hi = lo + a.slice < b_hi ? lo + a.slice : b_hi;
    const int count = hi > lo ? static_cast<int>(hi - lo) : 0;
    float* const base = a.state_smem ? st : a.phi + lo * 2 * k;
    __syncthreads();   // the previous block's reads of the slice are done
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      const int64_t slot = lo + i;
      const bool real = slot < a.m;
      mp[i] = real ? a.pairs[2 * slot] : 0;
      mq[i] = real ? a.pairs[2 * slot + 1] : 0;
      my[i] = real ? a.y[slot] : 0;
    }
    if (a.state_smem) {
      for (int64_t i = threadIdx.x; i < 2 * int64_t{k} * a.sp;
           i += blockDim.x)
        st[i] = inv_k;
    } else {
      for (int64_t i = threadIdx.x; i < 2 * int64_t{k} * count;
           i += blockDim.x)
        base[i] = inv_k;
    }
    __syncthreads();
    int rounds = a.max_iters;
    for (int r = 1; r <= a.max_iters; ++r) {
      float worst = -INFINITY;
      for (int s = gi; s < count; s += n_groups) {
        float* const f1 = base + s * is;
        float* const f2 = f1 + side;
        const float* const lr = lt + (my[s] == 1 ? 0 : kkp) + c0;
        const float* const e1 = a.elogpi + static_cast<int64_t>(mp[s]) * k;
        const float* const e2 = a.elogpi + static_cast<int64_t>(mq[s]) * k;
        if (kTiled) {
          worst = nan_max(worst, tiled_round<NC>(lr, e1, e2, f1, f2, xrow,
                                                 xrow + k, hs, k, kp, c0,
                                                 tiles, g_lanes, mask));
          continue;
        }
        float x1[NC], x2[NC];
        pair_products<NC>(lr, f1, f2, hs, k, kp, x1, x2);
        const float d1 =
            softmax_side<NC>(x1, e1, f1, hs, k, c0, g_lanes, mask);
        const float d2 =
            softmax_side<NC>(x2, e2, f2, hs, k, c0, g_lanes, mask);
        worst = nan_max(worst, nan_max(d1 / kf, d2 / kf));
        __syncwarp(mask);   // every lane has read the old phis
        store_side<NC>(x1, f1, hs, k, c0);
        store_side<NC>(x2, f2, hs, k, c0);
        __syncwarp(mask);
      }
      // the slice's largest change, then the cluster's
#pragma unroll
      for (int off = svt::kWarp / 2; off > 0; off >>= 1)
        worst = nan_max(worst, __shfl_xor_sync(svt::kFull, worst, off));
      if (lane == 0) red[threadIdx.x / svt::kWarp] = worst;
      __syncthreads();
      if (threadIdx.x == 0) {
        float v = -INFINITY;
        for (int w = 0; w < static_cast<int>(blockDim.x / svt::kWarp); ++w)
          v = nan_max(v, red[w]);
        xch[phase & 1] = v;
      }
      cluster.sync();
      float all = -INFINITY;
      for (int c = 0; c < n_rank; ++c)
        all = nan_max(all, *cluster.map_shared_rank(&xch[phase & 1], c));
      ++phase;
      if (!(all >= a.thresh) || r == a.max_iters) {
        rounds = r;
        break;
      }
    }
    if (rank == 0 && threadIdx.x == 0) a.block_rounds[rb] = rounds;
    __syncthreads();
    if (a.terms != nullptr) {
      for (int s = gi; s < count; s += n_groups) {
        const float* f1 = base + s * is;
        const float* f2 = f1 + side;
        float t = 0.0f, dots = 0.0f, ent = 0.0f;
        for (int tt = 0; tt < tiles; ++tt) {
          float x1[NC], x2[NC];
          pair_products<NC>(a.lte + (my[s] == 1 ? 0 : kkp) + tt * tw + c0,
                            f1, f2, hs, k, kp, x1, x2);
          term_parts<NC>(a, x1, f1, f2, hs, mp[s], mq[s], tt * tw + c0, t,
                         dots, ent);
        }
        t = gsum(t, g_lanes, mask);
        dots = gsum(dots, g_lanes, mask);
        ent = gsum(ent, g_lanes, mask);
        if (g == 0 && lo + s < a.m) a.terms[lo + s] = (t + dots) - ent;
      }
    } else if (a.state_smem) {
      // the slice's phis into the phi buffer, [slot][side][h]
      for (int64_t i = threadIdx.x; i < 2 * int64_t{k} * count;
           i += blockDim.x) {
        const int64_t pos = i / (2 * k);
        const int64_t rem = i % (2 * k);
        const int64_t sd = rem / k, h = rem % k;
        a.phi[(lo + pos) * 2 * k + rem] = st[sd * side + h * hs + pos];
      }
    }
  }
  cluster.sync();   // no CTA leaves while another reads its xch
}

using BlockKernel = void (*)(BlockArgs);

// the kernel of nc columns a lane; tiled: over T > 1 tiles (K > 512, where
// NC is 10 to 16)
BlockKernel block_kernel(int nc, bool tiled) {
  if (tiled) {
    switch (nc) {
      case 10: return orig_block_kernel<10, true>;
      case 12: return orig_block_kernel<12, true>;
      case 14: return orig_block_kernel<14, true>;
      default: return orig_block_kernel<16, true>;
    }
  }
  switch (nc) {
    case 2: return orig_block_kernel<2, false>;
    case 4: return orig_block_kernel<4, false>;
    case 6: return orig_block_kernel<6, false>;
    case 8: return orig_block_kernel<8, false>;
    case 10: return orig_block_kernel<10, false>;
    case 12: return orig_block_kernel<12, false>;
    case 14: return orig_block_kernel<14, false>;
    default: return orig_block_kernel<16, false>;
  }
}

struct BlockPlan {
  Layout lay;
  int slice;         // S
  int sp;
  int threads;
  int state_smem;
  int l_smem;
  size_t bytes;      // dynamic shared memory a CTA
};

// A launch of `ctas` CTAs in clusters of kCluster with pl's threads and
// shared memory
void cluster_launch(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    int64_t ctas, const BlockPlan& pl) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->gridDim = dim3(static_cast<unsigned>(ctas));
  cfg->blockDim = dim3(pl.threads);
  cfg->dynamicSmemBytes = pl.bytes;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// The launch for (k, block): layout_for's columns; S = ceil(B / kCluster);
// L (2 K kp floats) in shared memory where it fits the card's opt-in beside
// the slots' ids, the state (2 K sp floats, sp = S + 1) too where it fits
// beside them; with T > 1 tiles each group's two logit rows (2 K floats),
// as many groups as fit up to kMaxThreads. Cached by (k, block, device).
cudaError_t block_plan_for(int k, int block, BlockPlan* out) {
  static std::mutex lock;
  static std::map<std::tuple<int, int, int>, BlockPlan> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(k, block, dev);
  std::lock_guard<std::mutex> hold(lock);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return cudaSuccess;
  }
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  BlockPlan pl{};
  pl.lay = layout_for(k);
  const int lanes = pl.lay.lanes;
  pl.slice = (block + kCluster - 1) / kCluster;
  pl.sp = pl.slice + 1 - (pl.slice & 1);
  const size_t ids_bytes = sizeof(int) * 3 * static_cast<size_t>(pl.sp);
  const size_t state_bytes = sizeof(float) * 2 * static_cast<size_t>(k) * pl.sp;
  const size_t l_bytes = sizeof(float) * 2 * static_cast<size_t>(k) * pl.lay.kp;
  const size_t room = static_cast<size_t>(optin) - 2 * 1024;  // the static
  pl.bytes = ids_bytes;
  if (pl.bytes + l_bytes <= room) {
    pl.l_smem = 1;
    pl.bytes += l_bytes;
  }
  if (pl.bytes + state_bytes <= room) {
    pl.state_smem = 1;
    pl.bytes += state_bytes;
  }
  // the SM's kMaxThreads threads split over as many CTAs as its shared
  // memory holds (up to 4), so that their rounds' barriers overlap
  int sm_bytes = 0;
  err = cudaDeviceGetAttribute(
      &sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err != cudaSuccess) return err;
  int per_sm = static_cast<int>(static_cast<size_t>(sm_bytes) /
                                (pl.bytes + 3 * 1024));
  per_sm = per_sm < 1 ? 1 : (per_sm > 4 ? 4 : per_sm);
  int threads = kMaxThreads / per_sm;
  const int want = pl.slice * lanes;
  threads = threads < want ? threads : want;
  pl.threads = (threads + svt::kWarp - 1) / svt::kWarp * svt::kWarp;
  const bool tiled = pl.lay.tiles > 1;
  if (tiled) {
    // a pair's round is long past K = 512 and its barriers few: as many
    // groups (warps) as fit, up to kMaxThreads threads, for a grid of few
    // rule blocks
    const size_t rows = sizeof(float) * 2 * static_cast<size_t>(k);
    int groups = kMaxThreads / lanes;
    while (groups > 1 && pl.bytes + groups * rows > room) --groups;
    if (groups < 1 || pl.bytes + groups * rows > room)
      return cudaErrorInvalidValue;   // K past the rows of one group
    pl.threads = groups * lanes;
    pl.bytes += groups * rows;
  }
  // the kernel of pl's columns serves other K too, so it may take the most
  // any plan asks for
  err = cudaFuncSetAttribute(block_kernel(pl.lay.nc, tiled),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(room));
  if (err != cudaSuccess) return err;
  cache[key] = pl;
  *out = pl;
  return cudaSuccess;
}

}  // namespace

// One chunk of pairs (whole blocks of the rule but for the last chunk's
// last block, which pad = 1 completes with the virtual slot); lt and lte
// (2, k, kp), L transposed, each row padded with zeros to kp (of
// svt_orig_layout): each block of the rule ending at its R_b
// (block_rounds, ceil(m / block)); phi ((m + pad) x 2 x k) holds the phis
// after them. Training form (elbo = 0): then gacc (n, k) += 2 phi over the
// CSR (rowptr (n + 1), nbr (2m) slot ids, ops/edges.py:owner_csr of the
// chunk's pairs). ELBO form: terms (m,) from elogpi_e and lte; the CSR and
// gacc unused.
extern "C" int svt_orig_fixed_point(
    const float* elogpi, const float* lt, const int32_t* pairs,
    const int32_t* y, const float* elogpi_e, const float* lte, float* phi,
    int32_t* block_rounds, float* terms, const int32_t* rowptr,
    const int32_t* nbr, float* gacc, int64_t n, int64_t m, int k, int kp,
    int max_iters, float thresh, int block, int pad, int elbo,
    cudaStream_t stream) {
  if (k <= 0 || block <= 0 || max_iters < 1 || m < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  BlockPlan bp;
  cudaError_t err = block_plan_for(k, block, &bp);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kp != bp.lay.kp) return static_cast<int>(cudaErrorInvalidValue);
  const int pad1 = pad && m % block != 0 ? 1 : 0;
  const int64_t rule_blocks = (m + block - 1) / block;
  const BlockArgs ba{elogpi,       lt,          pairs,    y,
                     elogpi_e,     lte,         phi,      block_rounds,
                     elbo ? terms : nullptr,    m,        rule_blocks,
                     k,            kp,          bp.lay.tiles,
                     max_iters,    block,       pad1,     thresh,
                     bp.slice,     bp.sp,       bp.lay.lanes,
                     bp.state_smem,             bp.l_smem};
  // a cluster a rule block: the card schedules them as room frees
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cluster_launch(&cfg, attr, rule_blocks * kCluster, bp);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, block_kernel(bp.lay.nc, bp.lay.tiles > 1),
                           ba);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (elbo) return 0;
  orig_node_kernel<<<svt::blocks_for(n, svt::kWarp), svt::kBlockThreads, 0,
                     stream>>>(rowptr, nbr, phi, gacc, n, k);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 15's columns at k, 4 ints into info: lanes a group (G), columns a
// lane a tile (NC), tiles (T) and kp = T G NC, the row that L's transposes
// are padded to (ops/orig_phi.py:orig_layout). No launch.
extern "C" int svt_orig_layout(int k, int* info) {
  if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = layout_for(k);
  info[0] = lay.lanes;
  info[1] = lay.nc;
  info[2] = lay.tiles;
  info[3] = lay.kp;
  return 0;
}
