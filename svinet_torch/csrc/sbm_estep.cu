// Kernel 14: SBM's E-step, one chunk of its blocked Gauss-Seidel
// (svinet_tpu/svi/sbm.py:97-142, phi_update and estep_round). It replaces
// no TPU kernel: the JAX function scatters each chunk's incident pairs in
// XLA.
//
// Chunk c holds the rows p = c, c + 16, ...; each takes
//   s1 = sum of phi_q over p's training neighbours,
//   h  = sum of phi_q over p's held-out partners,
//   s0 = ((tot - phi_p) - s1) - h,
//   phi'_p = softmax(Elogpi + s1 (A - A_K) + s0 (B - B_K)),
// all from phi as it stood before the chunk: the rows of the chunks before
// it at their new values, every other row (its own chunk's too: the JAX
// package computes a chunk's rows together) at the round's old value.
//
// A round's rows go into a second (n, K) array, `dst`, apart from the
// round's input, `src`: a neighbour q is read from dst when its chunk
// (q % n_chunks) comes before c, else from src, and the chunk's new rows
// are written into dst. No pass copies rows back; the caller swaps src and
// dst after the round.
//
// A warp owns a row at a time and strides over the chunk's rows. It takes
// the row's training neighbours then its held-out partners as one list,
// 32 ids at a time (a lane an id, handed round by shuffle), with the next
// 32 ids loaded while these are pulled, and D neighbour rows in flight
// (16-byte loads where K % 4 == 0). Each column is summed in list order. K
// above the tile (32 * VEC * N columns) is taken tile by tile, the logits
// parked in the row's own place in dst between the passes. The logits are
// formed as the plain version forms them, each operation rounded, no fma.
//
// Column sums without atomics: a warp adds each row it writes into its
// own row of warp_sums; at the end the block adds its warps' rows in warp
// order into its row of block_sums, and the last block to finish (a
// ticket) adds the blocks' rows in a fixed order (runs of blocks, then the
// runs in order) into partial[c], then tot = partial[0] + ... +
// partial[n_chunks - 1] in chunk order. tot is so phi's
// column sums renewed after every chunk from exact-order parts, with no
// running update to drift, and two launches give the same bits.
//
// What bounds it on an H100: each row gathers its neighbours' and
// held-out partners' rows, 4K bytes each, from random places; a round
// reads 2(E + H) rows and writes n. At stretch (n = 1M, K = 500, E = 20M)
// that is about 80 GB a round, 24 ms at 3.35 TB/s.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * svt::kWarp;
constexpr int kCodeDst = static_cast<int>(0x80000000u);  // read from dst

struct EStepArgs {
  const float* src;       // (n, K) phi before the round
  float* dst;             // (n, K) the round's new rows
  const float* elogpi;    // (K,)
  const float* da;        // (K,) A - A_K
  const float* db;        // (K,) B - B_K
  float* tot;             // (K,) phi's column sums as the chunk sees them
  const int32_t* rowptr;  // training links' CSR
  const int32_t* nbr;
  const int32_t* hrowptr;  // held-out pairs' CSR
  const int32_t* hnbr;
  float* change;      // (n,)
  float* warp_sums;   // (blocks * kWarpsPerBlock, K)
  float* block_sums;  // (blocks, K)
  float* partial;     // (n_chunks, K)
  unsigned* ticket;   // 0 between launches
  int64_t rows;       // rows of the chunk
  int k;
  int c;
  int n_chunks;
};

// neighbour q as a shuffled code: its row index, the top bit set when the
// row is read from dst (its chunk comes before c)
__device__ __forceinline__ int entry_code(const EStepArgs& a, int deg,
                                          int total, int64_t lb, int64_t hb,
                                          int e) {
  if (e >= total) return 0;
  const int q = e < deg ? __ldg(a.nbr + lb + e) : __ldg(a.hnbr + hb + e - deg);
  return q % a.n_chunks < a.c ? (q | kCodeDst) : q;
}

__device__ __forceinline__ const float* entry_row(const EStepArgs& a,
                                                  int code) {
  const int64_t q = code & 0x7fffffff;
  return (code < 0 ? a.dst : a.src) + q * a.k;
}

// acc1 (entries before deg) and acch (the rest) += the columns of this
// lane's units in the tile at col0, summed over the list in list order,
// D rows in flight
template <int VEC, int N, int D>
__device__ __forceinline__ void pull(const EStepArgs& a, int deg, int total,
                                     int64_t lb, int64_t hb, int col0,
                                     int lane, float (&acc1)[VEC * N],
                                     float (&acch)[VEC * N]) {
  constexpr int L = VEC * N;
  int next = entry_code(a, deg, total, lb, hb, lane);
  for (int e0 = 0; e0 < total; e0 += svt::kWarp) {
    const int mine = next;
    next = entry_code(a, deg, total, lb, hb, e0 + svt::kWarp + lane);
    const int cnt = min(svt::kWarp, total - e0);
    for (int j = 0; j < cnt; j += D) {
      float v[D][L];
#pragma unroll
      for (int u = 0; u < D; ++u) {
        const int code = __shfl_sync(svt::kFull, mine, (j + u) & 31);
        if (j + u < cnt) {
          svt::load_row<VEC, svt::kWarp, N>(entry_row(a, code) + col0,
                                            a.k - col0, lane, 0.0f, v[u]);
        } else {
#pragma unroll
          for (int i = 0; i < L; ++i) v[u][i] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < D; ++u) {
        const int e = e0 + j + u;
        if (j + u >= cnt) break;
        if (e < deg) {
#pragma unroll
          for (int i = 0; i < L; ++i) acc1[i] += v[u][i];
        } else {
#pragma unroll
          for (int i = 0; i < L; ++i) acch[i] += v[u][i];
        }
      }
    }
  }
}

// this lane's units of a row's tile at col0: (column index of value i) =
// col0 + (lane + 32 j) VEC + v for i = j VEC + v
template <int VEC>
__device__ __forceinline__ int unit_col(int col0, int lane, int j) {
  return col0 + (lane + svt::kWarp * j) * VEC;
}

// ws[tile] += x over this lane's units
template <int VEC, int N>
__device__ __forceinline__ void add_row(float* ws, int col0, int k, int lane,
                                        const float (&x)[VEC * N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int col = unit_col<VEC>(col0, lane, j);
    if (col >= k) continue;
    float t[VEC];
    svt::load_unit<VEC, false>(ws + col, t);
#pragma unroll
    for (int v = 0; v < VEC; ++v) t[v] += x[j * VEC + v];
    svt::store_unit<VEC>(ws + col, t);
  }
}

// Chunk c's row p: its new row into dst[p] and its change into change[p],
// the row added into the warp's sums ws.
template <int VEC, int N, int D>
__device__ __forceinline__ void estep_row(const EStepArgs& a, int64_t p,
                                          int lane, float* ws) {
  constexpr int L = VEC * N;
  constexpr int kTile = svt::kWarp * L;
  const int k = a.k;
  const float* own = a.src + p * k;
  float* out = a.dst + p * k;
  const int64_t lb = a.rowptr[p];
  const int64_t hb = a.hrowptr[p];
  const int deg = static_cast<int>(a.rowptr[p + 1] - lb);
  const int total = deg + static_cast<int>(a.hrowptr[p + 1] - hb);
  const bool one_tile = k <= kTile;
  float x[L];
  float mx = -INFINITY;
  for (int t0 = 0; t0 < k; t0 += kTile) {
    float s1[L], h[L];
#pragma unroll
    for (int i = 0; i < L; ++i) s1[i] = h[i] = 0.0f;
    pull<VEC, N, D>(a, deg, total, lb, hb, t0, lane, s1, h);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int col = unit_col<VEC>(t0, lane, j);
      if (col >= k) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) x[j * VEC + v] = -INFINITY;
        continue;
      }
      float tt[VEC], old[VEC], ep[VEC], ua[VEC], ub[VEC];
      svt::load_unit<VEC, false>(a.tot + col, tt);
      svt::load_unit<VEC>(own + col, old);
      svt::load_unit<VEC>(a.elogpi + col, ep);
      svt::load_unit<VEC>(a.da + col, ua);
      svt::load_unit<VEC>(a.db + col, ub);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const int i = j * VEC + v;
        const float s0 = __fsub_rn(
            __fsub_rn(__fsub_rn(tt[v], old[v]), s1[i]), h[i]);
        x[i] = __fadd_rn(__fadd_rn(ep[v], __fmul_rn(s1[i], ua[v])),
                         __fmul_rn(s0, ub[v]));
        mx = fmaxf(mx, x[i]);
      }
      if (!one_tile) svt::store_unit<VEC>(out + col, x + j * VEC);
    }
  }
  mx = svt::group_max<svt::kWarp>(mx, svt::kFull);
  float s = 0.0f;
  for (int t0 = 0; t0 < k; t0 += kTile) {
    if (!one_tile) svt::load_row<VEC, svt::kWarp, N, false>(
        out + t0, k - t0, lane, -INFINITY, x);
#pragma unroll
    for (int i = 0; i < L; ++i) {
      x[i] = expf(x[i] - mx);  // 0 past the row
      s += x[i];
    }
    if (!one_tile) svt::store_row<VEC, svt::kWarp, N>(out + t0, k - t0,
                                                      lane, x);
  }
  s = svt::warp_sum(s);
  float ch = 0.0f;
  for (int t0 = 0; t0 < k; t0 += kTile) {
    if (!one_tile) svt::load_row<VEC, svt::kWarp, N, false>(
        out + t0, k - t0, lane, 0.0f, x);
    float old[L];
    svt::load_row<VEC, svt::kWarp, N>(own + t0, k - t0, lane, 0.0f, old);
#pragma unroll
    for (int i = 0; i < L; ++i) {
      x[i] = __fdiv_rn(x[i], s);
      ch += fabsf(__fsub_rn(x[i], old[i]));  // 0 - 0 past the row
    }
    svt::store_row<VEC, svt::kWarp, N>(out + t0, k - t0, lane, x);
    add_row<VEC, N>(ws, t0, k, lane, x);
  }
  ch = svt::warp_sum(ch);
  if (lane == 0) a.change[p] = ch;
}

// src's row p added into the warp's sums ws
template <int VEC, int N>
__device__ __forceinline__ void sum_row(const EStepArgs& a, int64_t p,
                                        int lane, float* ws) {
  constexpr int kTile = svt::kWarp * VEC * N;
  const float* row = a.src + p * a.k;
  for (int t0 = 0; t0 < a.k; t0 += kTile) {
    float x[VEC * N];
    svt::load_row<VEC, svt::kWarp, N>(row + t0, a.k - t0, lane, 0.0f, x);
    add_row<VEC, N>(ws, t0, a.k, lane, x);
  }
}

// VEC floats of the scratch another block wrote (through L2, not L1)
template <int VEC>
__device__ __forceinline__ void load_cg(const float* src, float* dst) {
  if constexpr (VEC == 4) {
    const float4 t = __ldcg(reinterpret_cast<const float4*>(src));
    dst[0] = t.x;
    dst[1] = t.y;
    dst[2] = t.z;
    dst[3] = t.w;
  } else {
    dst[0] = __ldcg(src);
  }
}

// partial[c][col] = s, the chunk's column sum; tot[col] = the chunks'
// sums in chunk order
__device__ __forceinline__ void finish_column(const EStepArgs& a, int col,
                                              float s) {
  a.partial[static_cast<int64_t>(a.c) * a.k + col] = s;
  float t = 0.0f;
  for (int cc = 0; cc < a.n_chunks; ++cc)
    t += cc == a.c ? s : a.partial[static_cast<int64_t>(cc) * a.k + col];
  a.tot[col] = t;
}

// SUMS: only the chunk's column sums of src, nothing else written.
template <int VEC, int N, int D, bool SUMS>
__global__ void __launch_bounds__(kThreads, 2)
    estep_chunk_kernel(const EStepArgs a) {
  const int lane = threadIdx.x % svt::kWarp;
  const int k = a.k;
  const int64_t gw = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                     threadIdx.x / svt::kWarp;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  float* ws = a.warp_sums + gw * k;
  for (int col = lane * VEC; col < k; col += svt::kWarp * VEC) {
    const float zero[VEC] = {};
    svt::store_unit<VEC>(ws + col, zero);
  }
  for (int64_t i = gw; i < a.rows; i += warps) {
    const int64_t p = a.c + static_cast<int64_t>(a.n_chunks) * i;
    if constexpr (SUMS)
      sum_row<VEC, N>(a, p, lane, ws);
    else
      estep_row<VEC, N, D>(a, p, lane, ws);
  }
  __syncthreads();
  // the block's warps in warp order
  for (int col = threadIdx.x; col < k; col += kThreads) {
    const float* w0 = a.warp_sums +
                      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock * k;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarpsPerBlock; ++w) s += w0[w * k + col];
    a.block_sums[static_cast<int64_t>(blockIdx.x) * k + col] = s;
  }
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0) last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: the blocks in block order, then the chunks in order.
  // Its threads take VEC columns each; where the columns leave threads
  // over, `groups` of them each add a run of the blocks, and the runs are
  // then added in order.
  const int units = (k + VEC - 1) / VEC;
  const int groups = units >= kThreads ? 1 : kThreads / units;
  const int per = (static_cast<int>(gridDim.x) + groups - 1) / groups;
  __shared__ float runs[kThreads * VEC];
  for (int t = threadIdx.x; t < units * groups; t += kThreads) {
    const int u = t % units;
    const int g = t / units;
    const int b1 = min(static_cast<int>(gridDim.x), (g + 1) * per);
    float s[VEC] = {};
#pragma unroll 8
    for (int b = g * per; b < b1; ++b) {
      float v[VEC];
      load_cg<VEC>(a.block_sums + static_cast<int64_t>(b) * k + u * VEC, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) s[i] += v[i];
    }
    if (groups == 1) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) finish_column(a, u * VEC + i, s[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) runs[(g * units + u) * VEC + i] = s[i];
    }
  }
  if (groups > 1) {
    __syncthreads();
    for (int col = threadIdx.x; col < k; col += kThreads) {
      float s = 0.0f;
      for (int g = 0; g < groups; ++g) s += runs[g * units * VEC + col];
      finish_column(a, col, s);
    }
  }
  if (threadIdx.x == 0) *a.ticket = 0u;
}

using Kernel = void (*)(EStepArgs);

// The sums form holds no row in registers, so one tile width serves
// every K.
template <bool SUMS>
Kernel pick(int k) {
  if constexpr (SUMS) {
    return k % 4 == 0 ? estep_chunk_kernel<4, 4, 1, true>
                      : estep_chunk_kernel<1, 16, 1, true>;
  } else {
    if (k % 4 == 0) {
      if (k <= 128) return estep_chunk_kernel<4, 1, 8, false>;
      if (k <= 256) return estep_chunk_kernel<4, 2, 8, false>;
      return estep_chunk_kernel<4, 4, 3, false>;  // above 512 in tiles
    }
    if (k <= 32) return estep_chunk_kernel<1, 1, 8, false>;
    if (k <= 64) return estep_chunk_kernel<1, 2, 8, false>;
    if (k <= 128) return estep_chunk_kernel<1, 4, 8, false>;
    if (k <= 256) return estep_chunk_kernel<1, 8, 8, false>;
    return estep_chunk_kernel<1, 16, 3, false>;  // above 512 in tiles
  }
}

// Most blocks a chunk is launched with: as many as the card holds at once
// of the wider of the two forms. The scratch is sized by it. The last
// width's answer is kept (the card is one).
cudaError_t max_blocks(int k, int* blocks) {
  static int last_k = 0, last_blocks = 0;
  if (k == last_k) {
    *blocks = last_blocks;
    return cudaSuccess;
  }
  int most = 0;
  for (Kernel kern : {pick<false>(k), pick<true>(k)}) {
    int per_sm = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, kThreads, 0);
    if (err != cudaSuccess) return err;
    most = per_sm > most ? per_sm : most;
  }
  *blocks = (most < 1 ? 1 : most) * svt::sm_count();
  last_k = k;
  last_blocks = *blocks;
  return cudaSuccess;
}

int64_t chunk_size(int64_t n, int c, int n_chunks) {
  return c < n ? (n - c + n_chunks - 1) / n_chunks : 0;
}

template <bool SUMS>
cudaError_t launch_chunk(EStepArgs a, cudaStream_t stream) {
  int cap = 0;
  cudaError_t err = max_blocks(a.k, &cap);
  if (err != cudaSuccess) return err;
  const int64_t want = (a.rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int blocks = static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
  pick<SUMS>(a.k)<<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Floats of the scratch a chunk's launch takes at width k: the warps' and
// the blocks' column sums (no launch, no stream).
extern "C" int svt_sbm_estep_scratch(int k, int64_t* floats) {
  if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = max_blocks(k, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  floats[0] = static_cast<int64_t>(blocks) * (kWarpsPerBlock + 1) * k;
  return 0;
}

// phi (n, K); scratch (svt_sbm_estep_scratch's floats), ticket (1,) 0;
// partial (n_chunks, K), tot (K,) out: every chunk's column sums and their
// total.
extern "C" int svt_sbm_chunk_sums(const float* phi, float* scratch,
                                  unsigned* ticket, float* partial,
                                  float* tot, int64_t n, int k, int n_chunks,
                                  cudaStream_t stream) {
  if (n <= 0 || k <= 0 || n_chunks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int cap = 0;
  cudaError_t err = max_blocks(k, &cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int c = 0; c < n_chunks; ++c) {
    EStepArgs a{};
    a.src = phi;
    a.tot = tot;
    a.warp_sums = scratch;
    a.block_sums = scratch + static_cast<int64_t>(cap) * kWarpsPerBlock * k;
    a.partial = partial;
    a.ticket = ticket;
    a.rows = chunk_size(n, c, n_chunks);
    a.k = k;
    a.c = c;
    a.n_chunks = n_chunks;
    err = launch_chunk<true>(a, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Chunk c of the E-step: its new rows into dst and their changes into
// change[p], partial[c] and tot renewed from them. src and dst are the
// round's input and output (n, K).
extern "C" int svt_sbm_estep_chunk(
    const float* src, float* dst, const float* elogpi, const float* da,
    const float* db, const int32_t* rowptr, const int32_t* nbr,
    const int32_t* hrowptr, const int32_t* hnbr, float* change,
    float* scratch, unsigned* ticket, float* partial, float* tot, int64_t n,
    int k, int c, int n_chunks, cudaStream_t stream) {
  if (n <= 0 || k <= 0 || c < 0 || c >= n_chunks || src == dst)
    return static_cast<int>(cudaErrorInvalidValue);
  int cap = 0;
  const cudaError_t err = max_blocks(k, &cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EStepArgs a{src,     dst,
                    elogpi,  da,
                    db,      tot,
                    rowptr,  nbr,
                    hrowptr, hnbr,
                    change,  scratch,
                    scratch + static_cast<int64_t>(cap) * kWarpsPerBlock * k,
                    partial, ticket,
                    chunk_size(n, c, n_chunks),
                    k,       c,
                    n_chunks};
  return static_cast<int>(launch_chunk<false>(a, stream));
}
