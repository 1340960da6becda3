// Shared helpers of the svinet_torch kernels: the row-in-registers layout
// they use for K <= 512, its dispatch on K, warp reductions, the work items
// of a pass over the links' adjacency, and reproducible column sums.
//
// Row layout <VEC, G, N>. A row of K floats is owned by a group of G lanes
// (G a power of two up to 32; 32/G rows share a warp, so a narrow row
// does not leave most of a warp idle). The row is cut into units of VEC
// floats: VEC = 4 (one 16-byte load or store) when K % 4 == 0, else
// VEC = 1. Lane g of the group holds units g, g+G, ..., g+(N-1)G, i.e.
// columns (g + jG)*VEC .. +VEC-1, so the G lanes of one j touch G*VEC
// consecutive floats. N is the next power of two that covers the row:
// G*N*VEC >= K. Units past the row are filled with a neutral value and
// never stored. 64-bit offsets throughout: n*K passes 2^31 elements for
// n above 4.3M at K=500.
//
// Row element type. A row in device memory is f32 or bf16 (-bf16: the
// gathered Elogpi and mphi rows at half the bytes); in registers it is
// always f32, and every sum is f32. A bf16 unit of VEC = 4 values is one
// 8-byte load, widened by a 16-bit shift (bf16 is the top half of an f32),
// and one 8-byte store after round-to-nearest-even, which is what a cast
// to bfloat16 does. The row stride is 2K bytes, so VEC = 4 again needs
// K % 4 == 0, with the base pointer on an 8-byte boundary. load_row and
// store_row take the type from the pointer.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace svt {

using bf16 = __nv_bfloat16;

constexpr int kWarp = 32;
constexpr int kBlockThreads = 256;  // 8 warps per block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRegMaxK = 512;       // widest row held in registers
// Most blocks a kernel that sums columns across rows is launched with
// (8 per SM on 132 SMs). Its groups stride over the rows, so the number
// of per-block partial rows does not grow with n.
constexpr int kReduceBlocks = 1056;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The lanes of this lane's group of G, as a shuffle mask. Groups of one
// warp may sit in different loop iterations, so each shuffles under its
// own mask.
template <int G>
__device__ __forceinline__ unsigned group_mask(int lane) {
  if constexpr (G == kWarp) return kFull;
  return ((1u << (G % kWarp)) - 1u) << (lane & ~(G - 1));
}

template <int G>
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off);
  return v;
}

template <int G>
__device__ __forceinline__ float group_max(float v, unsigned mask) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(mask, v, off));
  return v;
}

// digamma(x), x > 0: psi(x) = psi(x+5) - sum_{i<5} 1/(x+i), then the
// asymptotic series at y = x + 5 >= 5, whose first omitted term is
// 1/(240 y^8) < 1.1e-8. The lift's terms are paired,
//   1/(x+1) + 1/(x+2) = (2x+3) / (x^2+3x+2),
//   1/(x+3) + 1/(x+4) = (2x+7) / (x^2+7x+12),
// so four reciprocals become two; each pair is at most 1.5, so the
// approximate reciprocal's one ulp of relative error is far below the
// bar. 1/x itself is unbounded as x -> 0 (200 at x = 5e-3) and takes the
// correctly rounded reciprocal, subtracted last. Quadratic denominators stay finite up to
// x ~ 1e19; beyond that they reach inf, the reciprocal is 0 and the pair
// (then below 1e-18) drops out without a NaN. Absolute error against
// float64 stays below 5e-5 over [5e-3, 1e6].

// rcp.approx.ftz.f32: at most one ulp of relative error, one instruction
__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// psi(x) + 1/x: every term of digamma but the unbounded one.
__device__ __forceinline__ float digamma_bounded(float x) {
  const float p12 = fmaf(2.0f, x, 3.0f) *
                    rcp_approx(fmaf(x, x + 3.0f, 2.0f));
  const float p34 = fmaf(2.0f, x, 7.0f) *
                    rcp_approx(fmaf(x, x + 7.0f, 12.0f));
  const float y = x + 5.0f;
  const float inv = rcp_approx(y);
  const float inv2 = inv * inv;
  const float series =
      logf(y) - 0.5f * inv -
      inv2 * (1.0f / 12.0f - inv2 * (1.0f / 120.0f - inv2 * (1.0f / 252.0f)));
  return series - (p12 + p34);
}

__device__ __forceinline__ float digamma_f(float x) {
  return digamma_bounded(x) - __frcp_rn(x);
}

// psi(x) - ds with the bounded terms first and 1/x last, so that only one
// rounding happens at the magnitude of the result (217 at x = 5e-3).
__device__ __forceinline__ float expectation_f(float x, float ds) {
  return (digamma_bounded(x) - ds) - __frcp_rn(x);
}

// NC: load through the read-only path (__ldg). A kernel that writes the
// buffer it reads (an update in place) asks for NC = false.
template <int VEC, bool NC = true>
__device__ __forceinline__ void load_unit(const float* src, float* dst) {
  if constexpr (VEC == 4) {
    const float4 t = NC ? __ldg(reinterpret_cast<const float4*>(src))
                        : *reinterpret_cast<const float4*>(src);
    dst[0] = t.x;
    dst[1] = t.y;
    dst[2] = t.z;
    dst[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = NC ? __ldg(reinterpret_cast<const float2*>(src))
                        : *reinterpret_cast<const float2*>(src);
    dst[0] = t.x;
    dst[1] = t.y;
  } else {
    dst[0] = NC ? __ldg(src) : *src;
  }
}

// a bf16 value is the upper 16 bits of the f32 of the same value
__device__ __forceinline__ float bf16_bits_to_float(unsigned bits) {
  return __uint_as_float(bits << 16);
}

template <int VEC, bool NC = true>
__device__ __forceinline__ void load_unit(const bf16* src, float* dst) {
  static_assert(VEC != 2, "bf16 rows come in units of 4 or 1");
  if constexpr (VEC == 4) {
    const uint2 t = NC ? __ldg(reinterpret_cast<const uint2*>(src))
                       : *reinterpret_cast<const uint2*>(src);
    dst[0] = bf16_bits_to_float(t.x & 0xffffu);
    dst[1] = __uint_as_float(t.x & 0xffff0000u);
    dst[2] = bf16_bits_to_float(t.y & 0xffffu);
    dst[3] = __uint_as_float(t.y & 0xffff0000u);
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    dst[0] = bf16_bits_to_float(NC ? __ldg(s) : *s);
  }
}

// one element, for the kernels that hold no row in registers
__device__ __forceinline__ float load_scalar(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_scalar(const bf16* p) {
  return bf16_bits_to_float(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

template <int VEC>
__device__ __forceinline__ void store_unit(float* dst, const float* src) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(dst) =
        make_float4(src[0], src[1], src[2], src[3]);
  else if constexpr (VEC == 2)
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  else
    dst[0] = src[0];
}

// round to nearest even, as a cast to bfloat16 does
template <int VEC>
__device__ __forceinline__ void store_unit(bf16* dst, const float* src) {
  static_assert(VEC != 2, "bf16 rows come in units of 4 or 1");
  if constexpr (VEC == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(src[0], src[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(src[2], src[3]);
    uint2 t;
    t.x = *reinterpret_cast<const unsigned*>(&lo);
    t.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(dst) = t;
  } else {
    dst[0] = __float2bfloat16_rn(src[0]);
  }
}

__device__ __forceinline__ void store_scalar(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_scalar(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// This lane's part of `row` (K values, f32 or bf16) into registers; `g` is
// the lane's index in its group. Units past the row get `fill`.
template <int VEC, int G, int N, bool NC = true, class T>
__device__ __forceinline__ void load_row(const T* row, int k, int g,
                                         float fill, float (&dst)[VEC * N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = (g + j * G) * VEC;
    if (c < k) {
      load_unit<VEC, NC>(row + c, dst + j * VEC);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) dst[j * VEC + v] = fill;
    }
  }
}

template <int VEC, int G, int N, class T>
__device__ __forceinline__ void store_row(T* row, int k, int g,
                                          const float (&src)[VEC * N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = (g + j * G) * VEC;
    if (c < k) store_unit<VEC>(row + c, src + j * VEC);
  }
}

// A gathered row as it was loaded, before it is widened to f32: for f32
// rows the values themselves, for bf16 rows the 16-bit values, packed in
// pairs where the units are of four. The passes over links load the next
// neighbour's row while they reduce the current one; a load into a RawRow
// leaves nothing that uses its result until the row's turn comes, so
// it stays in flight meanwhile. (load_row widens as it loads: the warp
// then waits for the row at once. Kernel 2 over bf16 rows took 27.7 ms on
// n=1M, K=500, 19.9M links that way and 19.9 ms this way, on an H100 at
// 700 W, chip_smoke.py phase 3.)
template <int VEC, int N, class T>
struct RawRow {
  float v[VEC * N];
  __device__ __forceinline__ float at(int i) const { return v[i]; }
};

template <int N>
struct RawRow<4, N, bf16> {
  uint2 v[N];
  __device__ __forceinline__ float at(int i) const {
    const unsigned pair = (i & 2) ? v[i / 4].y : v[i / 4].x;
    return (i & 1) ? __uint_as_float(pair & 0xffff0000u)
                   : bf16_bits_to_float(pair & 0xffffu);
  }
};

template <int N>
struct RawRow<1, N, bf16> {
  unsigned short v[N];
  __device__ __forceinline__ float at(int i) const {
    return bf16_bits_to_float(v[i]);
  }
};

// This lane's part of `row` as loaded; units past the row hold zero bits,
// which is 0.0f in either type.
template <int VEC, int G, int N>
__device__ __forceinline__ void load_raw(const float* row, int k, int g,
                                         RawRow<VEC, N, float>& dst) {
  load_row<VEC, G, N>(row, k, g, 0.0f, dst.v);
}

template <int VEC, int G, int N>
__device__ __forceinline__ void load_raw(const bf16* row, int k, int g,
                                         RawRow<VEC, N, bf16>& dst) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = (g + j * G) * VEC;
    if constexpr (VEC == 4) {
      dst.v[j] = c < k ? __ldg(reinterpret_cast<const uint2*>(row + c))
                       : make_uint2(0u, 0u);
    } else {
      dst.v[j] =
          c < k ? __ldg(reinterpret_cast<const unsigned short*>(row + c))
                : static_cast<unsigned short>(0);
    }
  }
}

// Blocks of kBlockThreads for `items` rows at G lanes each.
inline unsigned blocks_for(int64_t items, int g) {
  const int64_t per_block = kBlockThreads / g;
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

// The same, capped at kReduceBlocks, for kernels whose groups stride over
// the items.
inline unsigned reduce_blocks_for(int64_t items, int g) {
  const unsigned b = blocks_for(items, g);
  return b < kReduceBlocks ? b : kReduceBlocks;
}

// Column sums across rows without atomics, in two steps. Step 1, at the
// end of a kernel whose groups each hold a row of per-column partial sums
// `v` (layout <VEC, G, N>): the block adds its groups' rows in group order
// through `smem` (kBlockThreads * VEC * N floats) and writes the K sums to
// `dst`, its row of a (blocks, K) scratch. Every thread of the block must
// call it. Step 2: colsum_partials_kernel adds the scratch rows in row
// order. Which rows a group sees depends only on the launch shape, so two
// launches give the same bits.
template <int VEC, int G, int N>
__device__ __forceinline__ void block_colsum(const float (&v)[VEC * N], int k,
                                             float* smem, float* dst) {
  constexpr int W = G * VEC * N;  // a group's row in smem, padded
  const int grp = threadIdx.x / G;
  const int g = threadIdx.x % G;
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int u = 0; u < VEC; ++u)
      smem[grp * W + (g + j * G) * VEC + u] = v[j * VEC + u];
  __syncthreads();
  for (int c = threadIdx.x; c < k; c += kBlockThreads) {
    float s = 0.0f;
    for (int r = 0; r < kBlockThreads / G; ++r) s += smem[r * W + c];
    dst[c] = s;
  }
  __syncthreads();  // smem may be filled again
}

// The same two steps for a kernel whose groups stride over several items:
// each group keeps its running row of column sums in `smem` itself
// (kBlockThreads * VEC * N floats, each thread its own places), so the
// sums cost no registers. smem_row_zero at the start, smem_row_add after
// each item, smem_colsum_write once at the end by every thread of the
// block: the block adds its groups' rows in group order into `dst`.
template <int VEC, int G, int N>
__device__ __forceinline__ void smem_row_zero(float* smem) {
  constexpr int W = G * VEC * N;
  const int grp = threadIdx.x / G;
  const int g = threadIdx.x % G;
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int u = 0; u < VEC; ++u) smem[grp * W + (g + j * G) * VEC + u] = 0.0f;
}

template <int VEC, int G, int N>
__device__ __forceinline__ void smem_row_add(const float (&v)[VEC * N],
                                             float* smem) {
  constexpr int W = G * VEC * N;
  const int grp = threadIdx.x / G;
  const int g = threadIdx.x % G;
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int u = 0; u < VEC; ++u)
      smem[grp * W + (g + j * G) * VEC + u] += v[j * VEC + u];
}

template <int VEC, int G, int N>
__device__ __forceinline__ void smem_colsum_write(int k, const float* smem,
                                                  float* dst) {
  constexpr int W = G * VEC * N;
  __syncthreads();
  for (int c = threadIdx.x; c < k; c += kBlockThreads) {
    float s = 0.0f;
    for (int r = 0; r < kBlockThreads / G; ++r) s += smem[r * W + c];
    dst[c] = s;
  }
}

// out[c] = sum over r < rows of partial[r * ld + c], in row order; one
// thread per column.
static __global__ void colsum_partials_kernel(const float* __restrict__ partial,
                                              int rows, int ld, int k,
                                              float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= k) return;
  float s = 0.0f;
  for (int r = 0; r < rows; ++r) s += partial[static_cast<int64_t>(r) * ld + c];
  out[c] = s;
}

inline void launch_colsum_partials(const float* partial, int rows, int ld,
                                   int k, float* out, cudaStream_t stream) {
  colsum_partials_kernel<<<(k + kBlockThreads - 1) / kBlockThreads,
                           kBlockThreads, 0, stream>>>(partial, rows, ld, k,
                                                       out);
}

// Step 1 for rows already in device memory: block b adds rows b, b + B,
// b + 2B, ... of `rows` (n of K values) in order into partial row b.
static __global__ void __launch_bounds__(kBlockThreads)
rows_colsum_kernel(const float* __restrict__ rows, int64_t n, int k,
                   float* __restrict__ partial) {
  for (int c = threadIdx.x; c < k; c += kBlockThreads) {
    float s = 0.0f;
    for (int64_t r = blockIdx.x; r < n; r += gridDim.x)
      s += rows[r * k + c];
    partial[static_cast<int64_t>(blockIdx.x) * k + c] = s;
  }
}

// Returns the number of partial rows written (at most kReduceBlocks).
inline unsigned launch_rows_colsum(const float* rows, int64_t n, int k,
                                   float* partial, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(
      n < kReduceBlocks ? (n > 0 ? n : 1) : kReduceBlocks);
  rows_colsum_kernel<<<blocks, kBlockThreads, 0, stream>>>(rows, n, k,
                                                           partial);
  return blocks;
}

// out[hub_node[h]] = the sum of hub h's scratch rows (hub_segptr[h] to
// hub_segptr[h + 1] of `partial`, K values each), in segment order.
static __global__ void __launch_bounds__(kBlockThreads)
combine_segments_kernel(const float* __restrict__ partial,
                        const int32_t* __restrict__ hub_node,
                        const int32_t* __restrict__ hub_segptr,
                        float* __restrict__ out, int k) {
  const int64_t h = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= k) return;
  float s = 0.0f;
  for (int64_t r = hub_segptr[h]; r < hub_segptr[h + 1]; ++r)
    s += partial[r * k + c];
  out[static_cast<int64_t>(hub_node[h]) * k + c] = s;
}

inline void launch_combine_segments(const float* partial,
                                    const int32_t* hub_node,
                                    const int32_t* hub_segptr, float* out,
                                    int64_t n_hubs, int k,
                                    cudaStream_t stream) {
  if (n_hubs == 0) return;
  const dim3 grid(static_cast<unsigned>(n_hubs),
                  (k + kBlockThreads - 1) / kBlockThreads);
  combine_segments_kernel<<<grid, kBlockThreads, 0, stream>>>(
      partial, hub_node, hub_segptr, out, k);
}

// The card's number of SMs (the current device's, read once).
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// A pass over the links' adjacency (ops/edges.py:Adjacency) takes nodes
// as its work items, or, in a second launch, the segments that the long
// lists of hubs are cut into.
struct AdjItems {
  const int32_t* rowptr;
  const int32_t* nbr;
  // hub segments: non-null when the launch walks segments, not nodes
  const int32_t* seg_node;
  const int32_t* seg_begin;
  const int32_t* seg_end;
  int64_t n_items;   // nodes, or segments
  int seg_len;
};

// The node of work item `item` and its slice of nbr. Returns false for a
// hub met in the pass over nodes: its segments are other items' work.
__device__ __forceinline__ bool adj_item(const AdjItems& a, int64_t item,
                                         int64_t* p, int* begin, int* end) {
  if (a.seg_node != nullptr) {
    *p = a.seg_node[item];
    *begin = a.seg_begin[item];
    *end = a.seg_end[item];
    return true;
  }
  *p = item;
  *begin = a.rowptr[item];
  *end = a.rowptr[item + 1];
  return *end - *begin <= a.seg_len;
}

// The block exit rule of the phi fixed points (svinet_tpu/ops/phicomp.py:
// 33-67, svinet_tpu/ops/sparse_gamma.py:123-129): R_b of every block of
// `block` slots, a warp a block: the AND of its slots' masks (bit r - 1 of
// a slot set when its round r changed by less than thresh; the virtual
// slot at n_pairs too where the last block is partial), whose first set
// bit is the first round every slot changed by less than thresh;
// max_iters where there is none within it.
static __global__ void __launch_bounds__(kBlockThreads)
block_rounds_kernel(const uint64_t* __restrict__ masks, int words,
                    int64_t n_pairs, int block, int pad, int max_iters,
                    int32_t* __restrict__ out, int64_t n_blocks) {
  const int lane = threadIdx.x % kWarp;
  const int64_t b =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) /
      kWarp;
  if (b >= n_blocks) return;
  const int64_t lo = b * block;
  const int64_t hi = lo + block < n_pairs ? lo + block : n_pairs;
  const bool with_pad = pad && hi == n_pairs;
  int r = max_iters;
  for (int j = 0; j < words; ++j) {
    uint64_t v = ~uint64_t{0};
    for (int64_t s = lo + lane; s < hi; s += kWarp)
      v &= masks[s * words + j];
    if (with_pad && lane == 0) v &= masks[n_pairs * words + j];
    const unsigned vl =
        __reduce_and_sync(kFull, static_cast<unsigned>(v));
    const unsigned vh =
        __reduce_and_sync(kFull, static_cast<unsigned>(v >> 32));
    v = (static_cast<uint64_t>(vh) << 32) | vl;
    if (v != 0) {
      const int first = 64 * j + __ffsll(static_cast<long long>(v));
      r = first < max_iters ? first : max_iters;
      break;
    }
  }
  if (lane == 0) out[b] = r;
}

// The lane of its group and the register of that lane that hold column c
// of a row in layout <VEC, G, N>.
template <int VEC, int G>
__device__ __forceinline__ void column_home(int c, int* lane, int* reg) {
  const int unit = c / VEC;
  *lane = unit % G;
  *reg = (unit / G) * VEC + c % VEC;
}

// v[column c] += x in the one lane of the group that holds c. The register
// index is not known at compile time, so every register is offered the
// sum under a predicate: the array stays in registers.
template <int VEC, int G, int N>
__device__ __forceinline__ void add_at_column(float (&v)[VEC * N], int c,
                                              int g, float x) {
  int lane, reg;
  column_home<VEC, G>(c, &lane, &reg);
  if (g != lane) return;
#pragma unroll
  for (int i = 0; i < VEC * N; ++i)
    if (i == reg) v[i] += x;
}

// Call f(VEC, G, N) as integral constants for the layout of a K-value row,
// 1 <= K <= kRegMaxK. `aligned` says whether every row starts on a
// boundary of one unit of four values (the base pointers do and
// K % 4 == 0): 16 bytes for f32 rows, 8 for bf16 rows.
template <class F>
inline void dispatch_row(int k, bool aligned, F&& f) {
  using std::integral_constant;
#define SVT_ROW(VEC, G, N)                                   \
  f(integral_constant<int, VEC>{}, integral_constant<int, G>{}, \
    integral_constant<int, N>{})
  const int units = aligned ? k / 4 : k;
  if (aligned) {
    if (units <= 1) SVT_ROW(4, 1, 1);
    else if (units <= 2) SVT_ROW(4, 2, 1);
    else if (units <= 4) SVT_ROW(4, 4, 1);
    else if (units <= 8) SVT_ROW(4, 8, 1);
    else if (units <= 16) SVT_ROW(4, 16, 1);
    else if (units <= 32) SVT_ROW(4, 32, 1);
    else if (units <= 64) SVT_ROW(4, 32, 2);
    else SVT_ROW(4, 32, 4);
  } else {
    if (units <= 1) SVT_ROW(1, 1, 1);
    else if (units <= 2) SVT_ROW(1, 2, 1);
    else if (units <= 4) SVT_ROW(1, 4, 1);
    else if (units <= 8) SVT_ROW(1, 8, 1);
    else if (units <= 16) SVT_ROW(1, 16, 1);
    else if (units <= 32) SVT_ROW(1, 32, 1);
    else if (units <= 64) SVT_ROW(1, 32, 2);
    else if (units <= 128) SVT_ROW(1, 32, 4);
    else if (units <= 256) SVT_ROW(1, 32, 8);
    else SVT_ROW(1, 32, 16);
  }
#undef SVT_ROW
}

// The same for a kernel that writes (n, K, 2) rows of pairs (-sparse-w's
// Elogpi and mean indicators side by side) from a K-value row: units of
// VEC = 2 values when K is even and the rows start on 16-byte boundaries,
// so that a lane's unit is one 16-byte store of two whole pairs and a
// warp's store fills consecutive 32-byte sectors; else VEC = 1, one
// 8-byte pair a lane. (A store of half a pair makes the L2 merge partial
// sectors: ten times the time of whole ones, tools/bench_kernels.py
// --only sectors.)
template <class F>
inline void dispatch_pair_row(int k, bool aligned, F&& f) {
  using std::integral_constant;
  if (!aligned || k % 2 != 0) {
    dispatch_row(k, false, f);  // units of one value
    return;
  }
#define SVT_ROW(G, N)                                      \
  f(integral_constant<int, 2>{}, integral_constant<int, G>{}, \
    integral_constant<int, N>{})
  const int units = k / 2;
  if (units <= 1) SVT_ROW(1, 1);
  else if (units <= 2) SVT_ROW(2, 1);
  else if (units <= 4) SVT_ROW(4, 1);
  else if (units <= 8) SVT_ROW(8, 1);
  else if (units <= 16) SVT_ROW(16, 1);
  else if (units <= 32) SVT_ROW(32, 1);
  else if (units <= 64) SVT_ROW(32, 2);
  else if (units <= 128) SVT_ROW(32, 4);
  else SVT_ROW(32, 8);
#undef SVT_ROW
}

// This lane's part of a K-value row into the pairs of (K, 2) row `pairs`:
// pairs[c][HALF] = src value of column c, and the other half of each pair
// = other[...] (the pairs' other values, as this lane holds them), in
// whole pairs, one store a unit.
template <int VEC, int G, int N>
__device__ __forceinline__ void store_pairs(float* pairs, int k, int g,
                                            int half,
                                            const float (&src)[VEC * N],
                                            const float (&other)[VEC * N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = (g + j * G) * VEC;
    if (c >= k) continue;
    const float* s = src + j * VEC;
    const float* o = other + j * VEC;
    if constexpr (VEC == 2) {
      *reinterpret_cast<float4*>(pairs + 2 * c) =
          half ? make_float4(o[0], s[0], o[1], s[1])
               : make_float4(s[0], o[0], s[1], o[1]);
    } else {
#pragma unroll
      for (int u = 0; u < VEC; ++u)
        *reinterpret_cast<float2*>(pairs + 2 * (c + u)) =
            half ? make_float2(o[u], s[u]) : make_float2(s[u], o[u]);
    }
  }
}

// The `half` values of this lane's pairs of (K, 2) row `pairs` (layout
// <VEC, G, N>; units past the row get 0), read as whole pairs.
template <int VEC, int G, int N>
__device__ __forceinline__ void load_pair_half(const float* pairs, int k,
                                               int g, int half,
                                               float (&dst)[VEC * N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = (g + j * G) * VEC;
    float* d = dst + j * VEC;
    if constexpr (VEC == 2) {
      const float4 t = c < k ? *reinterpret_cast<const float4*>(pairs + 2 * c)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      d[0] = half ? t.y : t.x;
      d[1] = half ? t.w : t.z;
    } else {
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        const float2 t =
            c + u < k ? *reinterpret_cast<const float2*>(pairs + 2 * (c + u))
                      : make_float2(0.f, 0.f);
        d[u] = half ? t.y : t.x;
      }
    }
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// whether p lies on a boundary of four values of its type; null counts as
// aligned (an array the launch does not use)
inline bool aligned_unit(const float* p) { return aligned16(p); }
inline bool aligned_unit(const bf16* p) {
  return reinterpret_cast<uintptr_t>(p) % 8 == 0;
}

}  // namespace svt
