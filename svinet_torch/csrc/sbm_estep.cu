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
// all from phi as it stood before the chunk (the JAX package computes a
// chunk's rows together, so a row reads a neighbour of its own chunk at
// its old value). A warp owns a row: it pulls the neighbours' rows over
// the CSR of the training links, then that of the held-out pairs, each
// lane its columns lane, lane + 32, ..., in list order, and writes the
// new row into `staged` (never into phi, which the chunk still reads) and
// the row's summed change |phi' - phi| into change[p]. K above 512 is
// taken in tiles of 512 columns, the logits parked in the staged row
// between the passes. The logits are formed as the plain version forms
// them, each operation rounded, no fma.
//
// The commit kernel then writes the staged rows into phi and adds them in
// a fixed order into per-block column sums; the finish kernel adds those
// into the chunk's column sums partial[c] and tot = partial[0] + ... +
// partial[15], in chunk order. So tot is phi's column sums renewed after
// every chunk from 16 exact-order parts, with no running update to drift
// and no atomics: two launches give the same bits.
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

struct EStepArgs {
  const float* phi;      // (n, K)
  const float* elogpi;   // (K,)
  const float* da;       // (K,) A - A_K
  const float* db;       // (K,) B - B_K
  const float* tot;      // (K,) phi's column sums
  const int32_t* rowptr;  // training links' CSR
  const int32_t* nbr;
  const int32_t* hrowptr;  // held-out pairs' CSR
  const int32_t* hnbr;
  float* staged;  // (rows, K)
  float* change;  // (n,)
  int64_t rows;   // rows of the chunk
  int k;
  int c;
  int n_chunks;
};

// acc[j] += the sum over the list nbr[b, e) of phi_q[col0 + lane + 32 j],
// in list order, four rows in flight
template <int NV>
__device__ __forceinline__ void pull(const float* __restrict__ phi,
                                     const int32_t* __restrict__ nbr,
                                     int64_t b, int64_t e, int k, int col0,
                                     int lane, float (&acc)[NV]) {
  int64_t i = b;
  for (; i + 4 <= e; i += 4) {
    int64_t q[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) q[u] = __ldg(nbr + i + u);
    float v[4][NV];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int col = col0 + lane + svt::kWarp * j;
        v[u][j] = col < k ? __ldg(phi + q[u] * k + col) : 0.0f;
      }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int j = 0; j < NV; ++j) acc[j] += v[u][j];
  }
  for (; i < e; ++i) {
    const int64_t q = __ldg(nbr + i);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int col = col0 + lane + svt::kWarp * j;
      if (col < k) acc[j] += __ldg(phi + q * k + col);
    }
  }
}

template <int NV>
__global__ void __launch_bounds__(kThreads) estep_chunk_kernel(
    const EStepArgs a) {
  constexpr int kTile = svt::kWarp * NV;
  const int lane = threadIdx.x % svt::kWarp;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / svt::kWarp;
  if (i >= a.rows) return;  // the whole warp
  const int k = a.k;
  const int64_t p = a.c + static_cast<int64_t>(a.n_chunks) * i;
  const float* phip = a.phi + p * k;
  float* out = a.staged + i * k;
  const int64_t lb = a.rowptr[p], le = a.rowptr[p + 1];
  const int64_t hb = a.hrowptr[p], he = a.hrowptr[p + 1];
  const bool one_tile = k <= kTile;
  float x[NV];
  float mx = -INFINITY;
  for (int t0 = 0; t0 < k; t0 += kTile) {
    float s1[NV], h[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) s1[j] = h[j] = 0.0f;
    pull<NV>(a.phi, a.nbr, lb, le, k, t0, lane, s1);
    pull<NV>(a.phi, a.hnbr, hb, he, k, t0, lane, h);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int col = t0 + lane + svt::kWarp * j;
      x[j] = -INFINITY;
      if (col >= k) continue;
      const float s0 = __fsub_rn(
          __fsub_rn(__fsub_rn(__ldg(a.tot + col), __ldg(phip + col)), s1[j]),
          h[j]);
      x[j] = __fadd_rn(
          __fadd_rn(__ldg(a.elogpi + col), __fmul_rn(s1[j], __ldg(a.da + col))),
          __fmul_rn(s0, __ldg(a.db + col)));
      mx = fmaxf(mx, x[j]);
      if (!one_tile) out[col] = x[j];
    }
  }
#pragma unroll
  for (int off = svt::kWarp / 2; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(svt::kFull, mx, off));
  float s = 0.0f;
  if (one_tile) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int col = lane + svt::kWarp * j;
      x[j] = col < k ? expf(x[j] - mx) : 0.0f;
      s += x[j];
    }
  } else {
    for (int col = lane; col < k; col += svt::kWarp) {
      const float e = expf(out[col] - mx);
      out[col] = e;
      s += e;
    }
  }
  s = svt::warp_sum(s);
  float ch = 0.0f;
  if (one_tile) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int col = lane + svt::kWarp * j;
      if (col >= k) continue;
      const float v = __fdiv_rn(x[j], s);
      out[col] = v;
      ch += fabsf(__fsub_rn(v, __ldg(phip + col)));
    }
  } else {
    for (int col = lane; col < k; col += svt::kWarp) {
      const float v = __fdiv_rn(out[col], s);
      out[col] = v;
      ch += fabsf(__fsub_rn(v, __ldg(phip + col)));
    }
  }
  ch = svt::warp_sum(ch);
  if (lane == 0) a.change[p] = ch;
}

// Block b adds rows b, b + B, ... of the chunk (staged rows when
// `staged` is given, which it also writes into phi; else phi's own rows)
// into its row of block_partial, column by column in row order.
__global__ void __launch_bounds__(kThreads) chunk_rows_kernel(
    float* __restrict__ phi, const float* __restrict__ staged, int64_t rows,
    int k, int c, int n_chunks, float* __restrict__ block_partial) {
  for (int col = threadIdx.x; col < k; col += kThreads) {
    float s = 0.0f;
    for (int64_t i = blockIdx.x; i < rows; i += gridDim.x) {
      float* const dst = phi + (c + static_cast<int64_t>(n_chunks) * i) * k;
      if (staged != nullptr) {
        const float v = staged[i * k + col];
        dst[col] = v;
        s += v;
      } else {
        s += dst[col];
      }
    }
    block_partial[static_cast<int64_t>(blockIdx.x) * k + col] = s;
  }
}

// partial[c] = the blocks' rows in block order; tot = partial[0] + ... +
// partial[n_chunks - 1] in chunk order. One thread a column.
__global__ void chunk_finish_kernel(const float* __restrict__ block_partial,
                                    int blocks, int k, int c, int n_chunks,
                                    float* __restrict__ partial,
                                    float* __restrict__ tot) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= k) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b)
    s += block_partial[static_cast<int64_t>(b) * k + col];
  partial[static_cast<int64_t>(c) * k + col] = s;
  float t = 0.0f;
  for (int cc = 0; cc < n_chunks; ++cc)
    t += cc == c ? s : partial[static_cast<int64_t>(cc) * k + col];
  tot[col] = t;
}

int64_t chunk_size(int64_t n, int c, int n_chunks) {
  return c < n ? (n - c + n_chunks - 1) / n_chunks : 0;
}

// the chunk's column sums into partial[c], then tot
cudaError_t chunk_sums(float* phi, const float* staged, int64_t n, int k,
                       int c, int n_chunks, float* block_partial,
                       float* partial, float* tot, cudaStream_t stream) {
  const int64_t rows = chunk_size(n, c, n_chunks);
  const int blocks = static_cast<int>(
      rows < 1 ? 1 : (rows < svt::kReduceBlocks ? rows : svt::kReduceBlocks));
  chunk_rows_kernel<<<blocks, kThreads, 0, stream>>>(phi, staged, rows, k, c,
                                                     n_chunks, block_partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  chunk_finish_kernel<<<(k + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(block_partial, blocks, k, c, n_chunks,
                                  partial, tot);
  return cudaGetLastError();
}

using Kernel = void (*)(EStepArgs);

Kernel pick(int k) {
  if (k <= 32) return estep_chunk_kernel<1>;
  if (k <= 64) return estep_chunk_kernel<2>;
  if (k <= 128) return estep_chunk_kernel<4>;
  if (k <= 256) return estep_chunk_kernel<8>;
  return estep_chunk_kernel<16>;  // K above 512 in tiles of 512
}

}  // namespace

// phi (n, K); block_partial (kReduceBlocks, K), partial (n_chunks, K),
// tot (K,) out: every chunk's column sums and their total.
extern "C" int svt_sbm_chunk_sums(float* phi, float* block_partial,
                                  float* partial, float* tot, int64_t n,
                                  int k, int n_chunks, cudaStream_t stream) {
  if (n <= 0 || k <= 0 || n_chunks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int c = 0; c < n_chunks; ++c) {
    const cudaError_t err = chunk_sums(phi, nullptr, n, k, c, n_chunks,
                                       block_partial, partial, tot, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Chunk c of the E-step: its new rows into staged and their changes into
// change[p], then into phi, partial[c] and tot renewed.
extern "C" int svt_sbm_estep_chunk(
    float* phi, const float* elogpi, const float* da, const float* db,
    const int32_t* rowptr, const int32_t* nbr, const int32_t* hrowptr,
    const int32_t* hnbr, float* staged, float* change, float* block_partial,
    float* partial, float* tot, int64_t n, int k, int c, int n_chunks,
    cudaStream_t stream) {
  if (n <= 0 || k <= 0 || c < 0 || c >= n_chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = chunk_size(n, c, n_chunks);
  if (rows > 0) {
    const EStepArgs a{phi,  elogpi, da,     db,   tot, rowptr, nbr, hrowptr,
                      hnbr, staged, change, rows, k,   c,      n_chunks};
    const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    pick(k)<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(chunk_sums(phi, staged, n, k, c, n_chunks,
                                     block_partial, partial, tot, stream));
}
