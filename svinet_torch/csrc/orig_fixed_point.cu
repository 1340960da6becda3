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
// The rule is run as the JAX program runs it: round by round. A launch
// takes every slot of the blocks still running one round further, from
// the phis the round before left in a state buffer (2 rows a slot, the
// virtual one too), and writes each slot's change; a warp a block then
// takes its largest change and ends the block at this round when it is
// below thresh (or at max_iters), R_b = r. The launches of all max_iters
// rounds are queued at once, with no host sync: a block that has ended is
// skipped, and a round with none left returns at once (a count of the
// blocks still running, kept by integer atomics). So each pair takes
// exactly its block's R_b rounds, the work the rule asks for, and the
// state buffer holds its phis after them. A first design ran each pair
// alone to its bit-stable round and ran again the pairs past R_b, as
// kernel 8 does: -orig's pairs need some 2.5 to 10 times their R_b rounds
// to become bit-stable (26.6 rounds against 11.3 at K = 20, 35.3 against
// 5.0 at K = 100 on an H100, PERF.md), and it took 42.7 ms at (2,000, 20)
// and 916 ms at (2,000, 100).
//
// A group of G lanes owns a pair (8 lanes up to K = 32, 16 up to 64, a
// warp above) with six rows of K floats in shared memory: Elogpi[p],
// Elogpi[q], phi1, phi2 and the two logit rows. Lane g owns the columns
// g, g + G, ...; a round forms the logits of its columns (the K x K
// product, h = 0, 1, ..., K - 1 in order, every product and sum rounded
// alone, no fma: the plain version's order, since a pair with two
// attractors is decided by the last bit of a logit), takes the group's
// largest logit, the exponentials and their sum, then writes the new phis
// over the old ones after a group barrier (Jacobi). L_1 and L_0 are kept
// transposed (row h holds column h of L) so that the G lanes read
// consecutive floats; both sit in shared memory where they fit beside
// the groups' rows (2K^2 floats: up to about K = 165 on an H100), else the
// lanes read them from device memory through L1 and L2, the same code over
// other addresses, so any K with room for one group's rows runs.
//
// Training form: the state buffer's rows 2i and 2i + 1 hold pair i's phi1
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
// products of a K x K matrix) against two gathered K-rows a pair and the
// state read and written a round; at K = 50 and ~10 rounds the operations
// bind. This design takes the products on the f32 lanes from shared
// memory; tiles of pairs through the tensor cores are a later design's.

#include <math.h>

#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace {

// rows a group owns: Elogpi[p], Elogpi[q], phi1, phi2, logits 1 and 2
constexpr int kGroupRows = 6;
constexpr int kThreads = 256;

struct OrigArgs {
  const float* elogpi;    // (n, k)
  const float* lt;        // (2, k, k): L_1, L_0, each transposed
  const int32_t* pairs;   // (m, 2)
  const int32_t* y;       // (m,)
  const float* elogpi_e;  // ELBO form: Elogpi of the updated gamma (n, k)
  const float* lte;       // ELBO form: (2, k, k) lf_1, lf_0, transposed
  float* phi;             // (m + pad, 2, k) the state: phi1, phi2 a slot
  float* change;          // (m + pad,) each slot's change of its last round
  int32_t* done;          // (blocks of the rule,) 1 once a block has ended
  int32_t* block_rounds;  // (blocks of the rule,) R_b
  int32_t* remaining;     // (1,) blocks still running
  float* terms;           // ELBO form: (m,)
  int64_t m;
  int k;
  int max_iters;
  int block;              // B
  int pad;                // 1: the virtual slot (0, 0), y = 0, at m
  float thresh;
  int smem_l;             // L_1 and L_0 staged in shared memory
  int round;              // this launch's round, from 1
};

// NaN-propagating max, as jnp.maximum and .max() take it
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// acc1[j] = sum_h L[c][h] v2[h] and acc2[j] = sum_h L[c][h] v1[h] for
// this lane's columns c = c0 + g + jG of the tile, h in order, every
// product and sum rounded alone (lt holds L transposed: lt[h k + c])
template <int G, int R>
__device__ __forceinline__ void products(const float* lt, const float* v1,
                                         const float* v2, int k, int c0,
                                         int g, float (&acc1)[R],
                                         float (&acc2)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) acc1[j] = acc2[j] = 0.0f;
  for (int h = 0; h < k; ++h) {
    const float a = v1[h], b = v2[h];
    const float* row = lt + static_cast<int64_t>(h) * k;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = c0 + g + j * G;
      if (c < k) {
        const float l = row[c];
        acc1[j] = __fadd_rn(acc1[j], __fmul_rn(l, b));
        acc2[j] = __fadd_rn(acc2[j], __fmul_rn(l, a));
      }
    }
  }
}

// One round of one pair over its group's rows, the new phis written over
// the old ones (after every lane has read them: Jacobi); returns the
// pair's change, max(mean |phi1' - phi1|, mean |phi2' - phi2|), in every
// lane.
template <int G, int R>
__device__ float one_round(const float* lt, const float* ep,
                           const float* eq, float* phi1, float* phi2,
                           float* x1, float* x2, int k, int g,
                           unsigned mask) {
  const float kf = static_cast<float>(k);
  // the logits of this lane's columns, from the old phis
  float m1 = -INFINITY, m2 = -INFINITY;
  for (int c0 = 0; c0 < k; c0 += G * R) {
    float a1[R], a2[R];
    products<G, R>(lt, phi1, phi2, k, c0, g, a1, a2);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = c0 + g + j * G;
      if (c < k) {
        const float l1 = __fadd_rn(ep[c], a1[j]);
        const float l2 = __fadd_rn(eq[c], a2[j]);
        x1[c] = l1;
        x2[c] = l2;
        m1 = fmaxf(m1, l1);
        m2 = fmaxf(m2, l2);
      }
    }
  }
  m1 = svt::group_max<G>(m1, mask);
  m2 = svt::group_max<G>(m2, mask);
  float s1 = 0.0f, s2 = 0.0f;
  for (int c = g; c < k; c += G) {
    const float e1 = expf(x1[c] - m1);
    const float e2 = expf(x2[c] - m2);
    x1[c] = e1;
    x2[c] = e2;
    s1 += e1;
    s2 += e2;
  }
  s1 = svt::group_sum<G>(s1, mask);
  s2 = svt::group_sum<G>(s2, mask);
  // every lane has read the old phis
  __syncwarp(mask);
  float d1 = 0.0f, d2 = 0.0f;
  for (int c = g; c < k; c += G) {
    const float n1 = __fdiv_rn(x1[c], s1);
    const float n2 = __fdiv_rn(x2[c], s2);
    d1 += fabsf(n1 - phi1[c]);
    d2 += fabsf(n2 - phi2[c]);
    phi1[c] = n1;
    phi2[c] = n2;
  }
  d1 = svt::group_sum<G>(d1, mask);
  d2 = svt::group_sum<G>(d2, mask);
  __syncwarp(mask);
  return nan_max(d1 / kf, d2 / kf);
}

// A pair's ELBO term, unweighted (every lane gets it)
template <int G, int R>
__device__ float elbo_term(const OrigArgs& a, const float* lte, int64_t p,
                           int64_t q, const float* phi1, const float* phi2,
                           int g, unsigned mask) {
  const int k = a.k;
  const float* ep = a.elogpi_e + p * k;
  const float* eq = a.elogpi_e + q * k;
  float t = 0.0f, dots = 0.0f, ent = 0.0f;
  for (int c0 = 0; c0 < k; c0 += G * R) {
    // (lf phi2)_c and, unused, (lf phi1)_c
    float a1[R], a2[R];
    products<G, R>(lte, phi1, phi2, k, c0, g, a1, a2);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = c0 + g + j * G;
      if (c < k) t += phi1[c] * a1[j];
    }
  }
  for (int c = g; c < k; c += G) {
    const float v1 = phi1[c], v2 = phi2[c];
    dots += v1 * __ldg(ep + c) + v2 * __ldg(eq + c);
    ent += v1 * logf(fmaxf(v1, 1e-30f)) + v2 * logf(fmaxf(v2, 1e-30f));
  }
  t = svt::group_sum<G>(t, mask);
  dots = svt::group_sum<G>(dots, mask);
  ent = svt::group_sum<G>(ent, mask);
  return (t + dots) - ent;
}

// The group's rows in shared memory (L_1 and L_0 first where they are
// staged there; `lt` then points at them)
struct Rows {
  const float* lt;
  float* ep;
  float* eq;
  float* phi1;
  float* phi2;
  float* x1;
  float* x2;
};

template <int G>
__device__ __forceinline__ Rows group_rows(const OrigArgs& a,
                                           const float* lt_global) {
  extern __shared__ float smem[];
  const int k = a.k;
  const int64_t kk = static_cast<int64_t>(k) * k;
  const float* lt = lt_global;
  float* rows = smem;
  if (a.smem_l) {
    for (int64_t i = threadIdx.x; i < 2 * kk; i += blockDim.x)
      smem[i] = __ldg(lt_global + i);
    __syncthreads();
    lt = smem;
    rows = smem + 2 * kk;
  }
  rows += static_cast<int64_t>(threadIdx.x / G) * kGroupRows * k;
  return Rows{lt, rows, rows + k, rows + 2 * k, rows + 3 * k, rows + 4 * k,
              rows + 5 * k};
}

// Round a.round of every slot of the blocks still running: the phis from
// the state (1/K in round 1), one round, the new phis and the change
// written back.
template <int G, int R>
__global__ void __launch_bounds__(kThreads) orig_round_kernel(
    const OrigArgs a) {
  if (*a.remaining == 0) return;
  const int gpb = blockDim.x / G;
  const int g = threadIdx.x % G;
  const unsigned mask = svt::group_mask<G>(threadIdx.x % svt::kWarp);
  const int k = a.k;
  const Rows w = group_rows<G>(a, a.lt);
  const int64_t kk = static_cast<int64_t>(k) * k;
  const float inv_k = 1.0f / static_cast<float>(k);
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * gpb + threadIdx.x / G;
  const int64_t step = static_cast<int64_t>(gridDim.x) * gpb;
  for (int64_t item = first; item < a.m + a.pad; item += step) {
    if (a.done[item / a.block]) continue;
    const bool real = item < a.m;
    const bool link = real && a.y[item] == 1;
    const int64_t p = real ? a.pairs[2 * item] : 0;
    const int64_t q = real ? a.pairs[2 * item + 1] : 0;
    float* const s1 = a.phi + 2 * item * k;
    float* const s2 = s1 + k;
    for (int c = g; c < k; c += G) {
      w.ep[c] = __ldg(a.elogpi + p * k + c);
      w.eq[c] = __ldg(a.elogpi + q * k + c);
      w.phi1[c] = a.round == 1 ? inv_k : s1[c];
      w.phi2[c] = a.round == 1 ? inv_k : s2[c];
    }
    __syncwarp(mask);
    const float d = one_round<G, R>(w.lt + (link ? 0 : kk), w.ep, w.eq,
                                    w.phi1, w.phi2, w.x1, w.x2, k, g, mask);
    for (int c = g; c < k; c += G) {
      s1[c] = w.phi1[c];
      s2[c] = w.phi2[c];
    }
    if (g == 0) a.change[item] = d;
    __syncwarp(mask);
  }
}

// A warp a block still running: its largest change this round (the
// virtual slot's too where it ends the pairs); below thresh, or at
// max_iters, the block ends here, R_b = a.round.
__global__ void __launch_bounds__(svt::kBlockThreads)
orig_check_kernel(const OrigArgs a, int64_t n_blocks) {
  const int lane = threadIdx.x % svt::kWarp;
  const int64_t b =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) /
      svt::kWarp;
  if (b >= n_blocks || a.done[b]) return;
  const int64_t lo = b * a.block;
  int64_t hi = lo + a.block < a.m ? lo + a.block : a.m;
  if (a.pad && hi == a.m) ++hi;
  float worst = -INFINITY;
  for (int64_t s = lo + lane; s < hi; s += svt::kWarp)
    worst = nan_max(worst, a.change[s]);
#pragma unroll
  for (int off = svt::kWarp / 2; off > 0; off >>= 1)
    worst = nan_max(worst, __shfl_xor_sync(svt::kFull, worst, off));
  if (lane == 0 && (!(worst >= a.thresh) || a.round >= a.max_iters)) {
    a.done[b] = 1;
    a.block_rounds[b] = a.round;
    atomicSub(a.remaining, 1);
  }
}

__global__ void orig_init_kernel(const OrigArgs a, int64_t n_blocks) {
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       b < n_blocks; b += static_cast<int64_t>(gridDim.x) * blockDim.x)
    a.done[b] = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0)
    *a.remaining = static_cast<int32_t>(n_blocks);
}

// Each real pair's ELBO term from its phis in the state
template <int G, int R>
__global__ void __launch_bounds__(kThreads) orig_terms_kernel(
    const OrigArgs a) {
  const int gpb = blockDim.x / G;
  const int g = threadIdx.x % G;
  const unsigned mask = svt::group_mask<G>(threadIdx.x % svt::kWarp);
  const int k = a.k;
  const Rows w = group_rows<G>(a, a.lte);
  const int64_t kk = static_cast<int64_t>(k) * k;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * gpb + threadIdx.x / G;
  const int64_t step = static_cast<int64_t>(gridDim.x) * gpb;
  for (int64_t item = first; item < a.m; item += step) {
    const float* s1 = a.phi + 2 * item * k;
    for (int c = g; c < k; c += G) {
      w.phi1[c] = s1[c];
      w.phi2[c] = s1[k + c];
    }
    __syncwarp(mask);
    const bool link = a.y[item] == 1;
    const float t = elbo_term<G, R>(a, w.lt + (link ? 0 : kk),
                                    a.pairs[2 * item],
                                    a.pairs[2 * item + 1], w.phi1, w.phi2,
                                    g, mask);
    if (g == 0) a.terms[item] = t;
    __syncwarp(mask);
  }
}

// gacc[p] += 2 phi over p's slots in slot order (slot j: state row j), a
// warp a node, each lane its columns
__global__ void __launch_bounds__(kThreads)
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

using PairKernel = void (*)(OrigArgs);

// lanes a pair: 8 up to K = 32, 16 up to 64, a warp above
int lanes_for(int k) { return k <= 32 ? 8 : (k <= 64 ? 16 : 32); }

// the round kernel (terms false) or the ELBO terms kernel
PairKernel pair_kernel(int lanes, bool terms) {
  if (lanes == 8)
    return terms ? orig_terms_kernel<8, 4> : orig_round_kernel<8, 4>;
  if (lanes == 16)
    return terms ? orig_terms_kernel<16, 4> : orig_round_kernel<16, 4>;
  return terms ? orig_terms_kernel<32, 8> : orig_round_kernel<32, 8>;
}

struct Plan {
  int lanes;
  int gpb;       // groups a block
  int smem_l;    // L in shared memory
  size_t bytes;  // dynamic shared memory a block
  int blocks;    // blocks of the persistent grid
};

// The launch for k: the most groups a block up to kThreads lanes whose
// rows fit, L in shared memory where it fits beside them; the grid as
// many blocks as the card holds at once. Cached by (k, device).
cudaError_t plan_for(int k, Plan* out) {
  static std::mutex lock;
  static std::map<std::tuple<int, int>, Plan> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(k, dev);
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
  const int lanes = lanes_for(k);
  const size_t row_bytes = size_t{4} * kGroupRows * k;
  int gpb = kThreads / lanes;
  while (gpb > 1 && gpb * row_bytes > static_cast<size_t>(optin)) gpb /= 2;
  if (gpb * row_bytes > static_cast<size_t>(optin))
    return cudaErrorInvalidConfiguration;
  const size_t l_bytes = size_t{8} * k * k;
  Plan pl{lanes, gpb, 0, gpb * row_bytes, 0};
  if (pl.bytes + l_bytes <= static_cast<size_t>(optin)) {
    pl.smem_l = 1;
    pl.bytes += l_bytes;
  }
  for (const bool terms : {false, true}) {
    err = cudaFuncSetAttribute(pair_kernel(lanes, terms),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(pl.bytes));
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pair_kernel(lanes, false), gpb * lanes, pl.bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  pl.blocks = per_sm * svt::sm_count();
  cache[key] = pl;
  *out = pl;
  return cudaSuccess;
}

}  // namespace

// One chunk of pairs (whole blocks of the rule but for the last chunk's
// last block, which pad = 1 completes with the virtual slot): max_iters
// rounds queued (a round with no block left returns at once), each block
// ending at its R_b (block_rounds, ceil(m / block)); phi ((m + pad) x 2 x
// k) holds the phis after them. Training form (elbo = 0): then gacc (n, k)
// += 2 phi over the CSR (rowptr (n + 1), nbr (2m) slot ids,
// ops/edges.py:owner_csr of the chunk's pairs). ELBO form: terms (m,)
// from elogpi_e and lte; the CSR and gacc unused. change (m + pad), done
// (ceil(m / block)) and remaining (1) are scratch.
extern "C" int svt_orig_fixed_point(
    const float* elogpi, const float* lt, const int32_t* pairs,
    const int32_t* y, const float* elogpi_e, const float* lte, float* phi,
    float* change, int32_t* done, int32_t* block_rounds,
    int32_t* remaining, float* terms, const int32_t* rowptr,
    const int32_t* nbr, float* gacc, int64_t n, int64_t m, int k,
    int max_iters, float thresh, int block, int pad, int elbo,
    cudaStream_t stream) {
  if (k <= 0 || block <= 0 || max_iters < 1 || m < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  Plan pl;
  cudaError_t err = plan_for(k, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  pad = pad && m % block != 0 ? 1 : 0;
  OrigArgs a{elogpi, lt,        pairs,        y,         elogpi_e,
             lte,    phi,       change,       done,      block_rounds,
             remaining,         terms,        m,         k,
             max_iters,         block,        pad,       thresh,
             pl.smem_l,         0};
  const int64_t rule_blocks = (m + block - 1) / block;
  orig_init_kernel<<<svt::blocks_for(rule_blocks, 1) < 1024
                         ? svt::blocks_for(rule_blocks, 1)
                         : 1024,
                     svt::kBlockThreads, 0, stream>>>(a, rule_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned threads = pl.gpb * pl.lanes;
  const int64_t want = (m + pad + pl.gpb - 1) / pl.gpb;
  const unsigned grid =
      static_cast<unsigned>(want < pl.blocks ? want : pl.blocks);
  for (int r = 1; r <= max_iters; ++r) {
    a.round = r;
    pair_kernel(pl.lanes, false)<<<grid, threads, pl.bytes, stream>>>(a);
    orig_check_kernel<<<svt::blocks_for(rule_blocks, svt::kWarp),
                        svt::kBlockThreads, 0, stream>>>(a, rule_blocks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (elbo) {
    pair_kernel(pl.lanes, true)<<<grid, threads, pl.bytes, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  orig_node_kernel<<<svt::blocks_for(n, svt::kWarp), svt::kBlockThreads, 0,
                     stream>>>(rowptr, nbr, phi, gacc, n, k);
  return static_cast<int>(cudaGetLastError());
}
