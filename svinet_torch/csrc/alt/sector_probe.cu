// NOT PART OF THE LIBRARY. A probe of the card's rate for random 32-byte
// sectors of device memory, for svinet_torch/tools/bench_kernels.py
// --only sectors.
//
// Kernel 7 (csrc/sparse_union.cu) gathers single values at random
// (node, column) places of 2-4 GB arrays: every such value costs a 32-byte
// sector, and no two of a warp's loads share one. Its floor counts those
// sectors at the published 3.35 TB/s, which random sectors do not reach.
// This kernel measures what they do reach: every lane of a full card
// (2,048 threads an SM) loads one value from each of `depth` random
// sectors of a `2^log_sectors`-sector array (4 or 8 bytes from each, the
// one value or an (Elogpi, mphi) pair), adds them, and only then issues
// its next `depth` loads. So exactly `depth` loads a lane are in flight,
// and the rate at depth 1, 2, 4 and 8 says how many a kernel must keep in
// flight to reach the ceiling.
//
// The sector of load d of round `it` of thread t is a 32-bit hash of
// (seed, t, it, d): random over the array, the same in every launch.
//
// Kernel 7 does not gather single sectors at random: the W lanes that
// take one directed entry each read one value of the neighbour's row, so
// W random sectors fall in one random 2-4 KB row. row_probe_kernel
// measures that access: groups of W lanes, each group a random row of an
// (n_rows, k) array per round, each lane a random column of it, `depth`
// such rounds in flight a lane.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// lowbias32 (Chris Wellons' integer hash): a cheap bijection of 32 bits
__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float value(float v) { return v; }
__device__ __forceinline__ float value(float2 v) { return v.x + v.y; }

// PATTERN 0: one load a request, from its random sector s. 1: two, from
// sectors 2s and 2s + 1 (both halves of a 64-byte block: two values of a
// row stored in blocks of 8 columns). 2: two, from sector s of each half
// of the array (two arrays of the same shape, as Elogpi and mphi apart).
template <int D, int PATTERN, class T>
__global__ void __launch_bounds__(kThreads)
sector_probe_kernel(const T* __restrict__ src, uint32_t mask, int iters,
                    uint32_t seed, float* __restrict__ out) {
  constexpr int kPerSector = 32 / static_cast<int>(sizeof(T));
  constexpr int kLoads = PATTERN == 0 ? 1 : 2;
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t base = mix(seed ^ mix(t));
  float acc = 0.0f;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    T v[D * kLoads];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const uint32_t s =
          mix(base + static_cast<uint32_t>(it * D + d)) & mask;
      if constexpr (PATTERN == 0) {
        v[d] = __ldg(src + static_cast<int64_t>(s) * kPerSector);
      } else if constexpr (PATTERN == 1) {
        const int64_t s0 = static_cast<int64_t>(s & ~1u) * kPerSector;
        v[2 * d] = __ldg(src + s0);
        v[2 * d + 1] = __ldg(src + s0 + kPerSector);
      } else {
        const int64_t s0 = static_cast<int64_t>(s >> 1) * kPerSector;
        v[2 * d] = __ldg(src + s0);
        v[2 * d + 1] =
            __ldg(src + s0 + static_cast<int64_t>(mask / 2 + 1) * kPerSector);
      }
    }
    // the next round's loads are issued after these adds, which wait for
    // this round's loads
#pragma unroll
    for (int d = 0; d < D * kLoads; ++d) acc += value(v[d]);
  }
  out[t] = acc;
}

// A group of W lanes (lanes lane / W alike) reads row hash(seed, group,
// it, d) and each lane column hash(seed, lane, it, d) of it, D rounds at
// once; W a power of 2 up to 32.
template <int D, class T>
__global__ void __launch_bounds__(kThreads)
row_probe_kernel(const T* __restrict__ src, uint32_t n_rows, uint32_t k,
                 int w, int iters, uint32_t seed, float* __restrict__ out) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t row_base = mix(seed ^ mix(t / w));
  const uint32_t col_base = mix(~seed ^ mix(t));
  float acc = 0.0f;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    T v[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const uint32_t j = static_cast<uint32_t>(it * D + d);
      const uint32_t r = __umulhi(mix(row_base + j), n_rows);
      const uint32_t c = __umulhi(mix(col_base + j), k);
      v[d] = __ldg(src + static_cast<int64_t>(r) * k + c);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) acc += value(v[d]);
  }
  out[t] = acc;
}

// Writes of n_values floats (the mean indicators of an (n, K) array, K a
// multiple of 8) in the layouts a sweep could keep them in, the other half
// of the pairs left as it was. LAYOUT 0: contiguous, 16-byte stores. 1:
// the odd half of (n, K, 2) pairs, 4-byte stores at a stride of 8 bytes.
// 2: blocks of 4 columns (16 bytes of Elogpi, then 16 of mphi: one
// 32-byte sector), 16-byte stores into the sectors' second halves. 3:
// blocks of 8 columns (32 bytes of each), 16-byte stores, two lanes
// filling each sector. 4: whole pairs (0, mphi), two 16-byte stores.
template <int LAYOUT>
__global__ void __launch_bounds__(kThreads)
write_probe_kernel(float* __restrict__ dst, int64_t n_quads) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n_quads; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float x = static_cast<float>(i);
    const float4 v = make_float4(x, x + 1.0f, x + 2.0f, x + 3.0f);
    if constexpr (LAYOUT == 0) {
      reinterpret_cast<float4*>(dst)[i] = v;
    } else if constexpr (LAYOUT == 1) {
      float* p = dst + 8 * i + 1;
      p[0] = v.x;
      p[2] = v.y;
      p[4] = v.z;
      p[6] = v.w;
    } else if constexpr (LAYOUT == 2) {
      reinterpret_cast<float4*>(dst)[2 * i + 1] = v;
    } else if constexpr (LAYOUT == 3) {
      reinterpret_cast<float4*>(dst)[(i >> 1) * 4 + 2 + (i & 1)] = v;
    } else {
      float4* p = reinterpret_cast<float4*>(dst) + 2 * i;
      p[0] = make_float4(0.0f, v.x, 0.0f, v.y);
      p[1] = make_float4(0.0f, v.z, 0.0f, v.w);
    }
  }
}

// Blocks that fill every SM at `kernel`'s occupancy.
template <class Kernel>
cudaError_t full_card(Kernel kernel, unsigned* blocks) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = static_cast<unsigned>(per_sm * sms);
  return cudaSuccess;
}

template <int D, class T>
cudaError_t launch_rows(const void* src, uint32_t n_rows, uint32_t k, int w,
                        int iters, uint32_t seed, float* out,
                        int64_t* threads, cudaStream_t stream) {
  auto kernel = row_probe_kernel<D, T>;
  unsigned blocks = 0;
  const cudaError_t err = full_card(kernel, &blocks);
  if (err != cudaSuccess) return err;
  *threads = static_cast<int64_t>(blocks) * kThreads;
  kernel<<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(src), n_rows,
                                          k, w, iters, seed, out);
  return cudaGetLastError();
}

template <int D, class T, int PATTERN = 0>
cudaError_t launch(const void* src, int log_sectors, int iters,
                   uint32_t seed, float* out, int64_t* threads,
                   cudaStream_t stream) {
  auto kernel = sector_probe_kernel<D, PATTERN, T>;
  unsigned blocks = 0;
  const cudaError_t err = full_card(kernel, &blocks);
  if (err != cudaSuccess) return err;
  *threads = static_cast<int64_t>(blocks) * kThreads;
  const uint32_t mask = (1u << log_sectors) - 1u;
  kernel<<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(src), mask,
                                          iters, seed, out);
  return cudaGetLastError();
}

}  // namespace

// src: 2^log_sectors sectors of 32 bytes (log_sectors <= 31); bytes 4 or
// 8 from each; depth 1, 2, 4 or 8 loads in flight a lane; out: one float a
// thread (at least 2,048 per SM); *threads receives the threads launched.
extern "C" int svt_sector_probe(const void* src, int log_sectors, int bytes,
                                int depth, int iters, int seed, float* out,
                                int64_t* threads, cudaStream_t stream) {
  if (log_sectors < 1 || log_sectors > 31 || iters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t s = static_cast<uint32_t>(seed);
  cudaError_t err = cudaErrorInvalidValue;
#define SVT_PROBE(D)                                                        \
  if (depth == D)                                                           \
    err = bytes == 8                                                        \
              ? launch<D, float2>(src, log_sectors, iters, s, out, threads, \
                                  stream)                                   \
              : launch<D, float>(src, log_sectors, iters, s, out, threads,  \
                                 stream);
  if (bytes == 4 || bytes == 8) {
    SVT_PROBE(1)
    SVT_PROBE(2)
    SVT_PROBE(4)
    SVT_PROBE(8)
  }
#undef SVT_PROBE
  return static_cast<int>(err);
}

// Two 4-byte loads a request, `pattern` 1 (the two sectors of a random
// 64-byte block) or 2 (sector s of each half of the array), `depth` 1 or 4
// requests in flight a lane; as svt_sector_probe otherwise.
extern "C" int svt_sector_pair_probe(const void* src, int log_sectors,
                                     int pattern, int depth, int iters,
                                     int seed, float* out, int64_t* threads,
                                     cudaStream_t stream) {
  if (log_sectors < 2 || log_sectors > 31 || iters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t s = static_cast<uint32_t>(seed);
  if (pattern == 1 && depth == 1)
    return launch<1, float, 1>(src, log_sectors, iters, s, out, threads,
                               stream);
  if (pattern == 1 && depth == 4)
    return launch<4, float, 1>(src, log_sectors, iters, s, out, threads,
                               stream);
  if (pattern == 2 && depth == 1)
    return launch<1, float, 2>(src, log_sectors, iters, s, out, threads,
                               stream);
  if (pattern == 2 && depth == 4)
    return launch<4, float, 2>(src, log_sectors, iters, s, out, threads,
                               stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// src: an (n_rows, k) array of 4- or 8-byte elements (`bytes`); groups of
// w lanes (1, 2, 4, 8, 16 or 32) read w random columns of one random row a
// round, `depth` 1, 2 or 4 rounds in flight a lane; as svt_sector_probe
// otherwise.
extern "C" int svt_row_probe(const void* src, int64_t n_rows, int k,
                             int bytes, int w, int depth, int iters, int seed,
                             float* out, int64_t* threads,
                             cudaStream_t stream) {
  if (n_rows < 1 || n_rows > UINT32_MAX || k < 1 || iters < 1 || w < 1 ||
      w > 32 || (w & (w - 1)) != 0 || (bytes != 4 && bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t rows = static_cast<uint32_t>(n_rows);
  const uint32_t s = static_cast<uint32_t>(seed);
#define SVT_ROWS(D)                                                       \
  if (depth == D)                                                         \
    return static_cast<int>(                                              \
        bytes == 8 ? launch_rows<D, float2>(src, rows, k, w, iters, s,    \
                                            out, threads, stream)         \
                   : launch_rows<D, float>(src, rows, k, w, iters, s, out, \
                                           threads, stream));
  SVT_ROWS(1)
  SVT_ROWS(2)
  SVT_ROWS(4)
#undef SVT_ROWS
  return static_cast<int>(cudaErrorInvalidValue);
}

// n_values floats (a multiple of 4) written in `layout` 0-4 (see
// write_probe_kernel) into dst, which holds 2 n_values floats (n_values for
// layout 0).
extern "C" int svt_write_probe(float* dst, int64_t n_values, int layout,
                               cudaStream_t stream) {
  const int64_t quads = n_values / 4;
  const unsigned blocks = 132 * 8;
  switch (layout) {
    case 0:
      write_probe_kernel<0><<<blocks, kThreads, 0, stream>>>(dst, quads);
      break;
    case 1:
      write_probe_kernel<1><<<blocks, kThreads, 0, stream>>>(dst, quads);
      break;
    case 2:
      write_probe_kernel<2><<<blocks, kThreads, 0, stream>>>(dst, quads);
      break;
    case 3:
      write_probe_kernel<3><<<blocks, kThreads, 0, stream>>>(dst, quads);
      break;
    case 4:
      write_probe_kernel<4><<<blocks, kThreads, 0, stream>>>(dst, quads);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
