// The slab form of kernel 4, the s3 cross-moment of the link-sampling sweep,
//   s3[k] = sum over links (p, q) of mphi[p,k] * mphi[q,k]
// (svinet_tpu/svi/sweep_math.py:117-151): a design around the H100's L2
// that is not on the package's path (csrc/s3_pass.cu is, at every shape).
// It is built and timed by tools/bench_kernels.py through tools/s3_slab.py,
// which holds its wrapper, its plain version and the forward lists it walks.
// It wins where a slab of at least 64 bytes a row fits the L2 and mphi does
// not (K = 500, 20 links a node: n = 250k to 500k, 1.4-1.6 times the pull
// form's speed), draws or loses at n = 1M and above and under -freeze; no
// workload the package documents falls in the range where it wins, and the
// crossover at other K and degrees is not measured.
//
// The pull form (s3_pull_kernel in csrc/s3_pass.cu) needs a whole row per
// link, and rows of a 1-2 GB mphi come from DRAM. But the columns of s3 are
// independent: a slab of 64 bytes of every row (16 f32 or 32 bf16 columns)
// is n * 64 bytes, 32 MB at n=500k, which the H100's 50 MB L2 holds. So the
// pass runs slab by slab, with one slab live at a time (one cooperative
// launch whose blocks cross from slab to slab together; a launch per slab
// is kept beside it): within a slab a link costs one short row that is an L2
// hit; DRAM supplies mphi once and the links' ids once per slab.
//  - Layout. A piece of a row of a row-major (n,K) array starts wherever
//    the row does (K=500: every other f32 row, three of four bf16 rows
//    straddle a sector) and takes a 128-byte line of the cache to itself.
//    The kernel therefore reads slab-major rows, (K/W, n, W) with W the
//    slab's columns, zero in the columns past K: a row of a slab is 32, 64
//    or 128 aligned bytes, rows share lines, and a slab is filled by a
//    sequential read. slab_copy_kernel makes that copy from the row-major
//    array, a batch of slabs at a time so that the scratch stays small
//    (0.7 of 4.7 ms at n=500k). Reading the row-major array in place (the
//    same kernel, other strides) is 1.2 to 2.5 times slower and is kept for
//    timing.
//  - Lanes over links. The forward lists (tools/s3_slab.py) hold each link once
//    under its lower end, E ids in one compact array, so a lane takes four
//    consecutive entries: their neighbours are one 16-byte load, and their
//    owners, mostly one node, come from a search of fwd_ptr between the two
//    owners recorded for the chunk of 32 entries, then a step when an entry
//    passes the end of its owner's list. No hub needs segments: no lane
//    walks a list. A lane loads two 16-byte units of each of the two rows
//    (one lane a link at 32 bytes a row, two at 64, four at 128), multiplies
//    and adds into its own running sums, with the four links in flight and
//    the ids of the next four already loaded.
//  - What bounds it: the L2 answers about 95 G random requests a second up
//    to 64 bytes each: 3.0 TB/s for rows of 32 bytes, 4.8-5.0 TB/s for 64
//    and 128 (H100 80GB HBM3, 700 W, tools/bench_kernels.py). Rows of 32
//    bytes, the only ones that fit at n=1M, gain nothing over the pull's
//    2 KB rows from DRAM; the form wins only where rows of at least 64
//    bytes fit.
//  - Residency. The ids are read once per slab with a streaming load
//    (__ldcs, evict-first) and the rows of mphi with an L2 evict_last
//    policy, which is worth 5-14% with two units a lane (nothing with one).
//    A slab of 32 MB stays resident; one of 48 MB does not.
//  - One cooperative launch over a batch of slabs, with a grid-wide barrier
//    between slabs, against a launch per slab: level over f32 rows of 64
//    bytes, 8-16% ahead over bf16 rows and at 128 bytes (fewer, shorter
//    slabs, so the gaps between launches weigh more). The wrapper takes it
//    unless told otherwise; CONV has the launch per slab only.
//  - Sums across lanes are shuffles in a fixed order, across warps shared
//    memory in warp order, across blocks the scratch rows and
//    colsum_partials_kernel as above: no atomics, the same bits every time.
//  - CONV. A lane has both ends of its link: a one-sided link adds the free
//    end's value at column max(cp, cq) - 1 when the slab holds that column
//    (a predicated add over the lane's registers), and loads the
//    neighbour's row only if the neighbour is the free end and the column
//    is in the slab. It still meets every link in every slab, where the
//    pull fetches nothing for a one-sided link at all: under -freeze the
//    pull wins.

#include <limits.h>

#include <cooperative_groups.h>

#include "../common.cuh"

namespace {

constexpr int kOwnerChunk = 32;  // tools/s3_slab.py FWD_CHUNK
constexpr int kSlabBatch = 4;    // links a thread has in flight: one int4 of ids

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// 16 bytes through the read-only path; HINT: kept in the L2 ahead of
// whatever carries no such policy
template <bool HINT>
__device__ __forceinline__ uint4 load_unit16(const void* p, uint64_t policy) {
  if constexpr (HINT) {
    uint4 r;
    asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
        : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
        : "l"(p), "l"(policy));
    return r;
  } else {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
}

// value i of a 16-byte unit of T: 4 f32, or 8 bf16
template <class T>
__device__ __forceinline__ float unit_at(const uint4& u, int i) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w);
  } else {
    const int h = i / 2;
    const unsigned pair = h == 0 ? u.x : h == 1 ? u.y : h == 2 ? u.z : u.w;
    return (i & 1) ? __uint_as_float(pair & 0xffff0000u)
                   : svt::bf16_bits_to_float(pair & 0xffffu);
  }
}

// B = 4 ids of consecutive entries from `e` on, -1 past the end; e is a
// multiple of 4 and the array starts on a 16-byte boundary
__device__ __forceinline__ int4 load_ids(const int32_t* ids, int64_t e,
                                         int64_t n) {
  if (e + 4 <= n) return __ldcs(reinterpret_cast<const int4*>(ids + e));
  int4 r;
  r.x = e < n ? __ldcs(ids + e) : -1;
  r.y = e + 1 < n ? __ldcs(ids + e + 1) : -1;
  r.z = e + 2 < n ? __ldcs(ids + e + 2) : -1;
  r.w = e + 3 < n ? __ldcs(ids + e + 3) : -1;
  return r;
}

// the last p in [lo, hi] with ptr[p] <= e, which ptr[lo] is
__device__ __forceinline__ int owner_of(const int32_t* ptr, int lo, int hi,
                                        int64_t e) {
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (ptr[mid] <= e) lo = mid; else hi = mid - 1;
  }
  return lo;
}

template <class T>
struct SlabArgs {
  const T* rows;        // unit u of row r of this slab: rows + r*row_stride + u*UC
  int64_t row_stride;   // in values: the slab's width, or K when strided
  const int32_t* fwd_ptr;
  const int32_t* fwd_nbr;
  const int32_t* chunk_owner;
  int64_t n_links;
  float* partial;       // (blocks, ld) scratch, offset to this slab's column
  int ld;
  int width;            // columns of this slab that lie within K
  // CONV only
  const int32_t* conv;
  int col0;             // first column of this slab
};

// UPL: 16-byte units of a slab's row (2, 4 or 8: 32, 64 or 128 bytes);
// UN: units a lane loads, so UPL / UN lanes share a link.
template <class T, int UPL, int UN, bool CONV, bool HINT>
__device__ __forceinline__ void s3_slab_body(const SlabArgs<T>& a) {
  constexpr int UC = 16 / sizeof(T);  // columns of a unit
  constexpr int LPL = UPL / UN;       // lanes of a link
  constexpr int A = UN * UC;          // columns, and running sums, of a lane
  constexpr int LINKS = svt::kBlockThreads / LPL;  // links of a block step
  constexpr int B = kSlabBatch;
  constexpr int WARPS = svt::kBlockThreads / svt::kWarp;
  __shared__ float smem[WARPS * UPL * UC];
  const int lane = threadIdx.x % svt::kWarp;
  const int sub = threadIdx.x % LPL;
  const int col_lane = sub * A;  // this lane's first column within the slab
  uint64_t policy = 0;
  if constexpr (HINT) policy = evict_last_policy();

  float acc[A];
#pragma unroll
  for (int i = 0; i < A; ++i) acc[i] = 0.0f;
  // units of the ragged last slab that start past K are never loaded
  bool unit_ok[UN];
#pragma unroll
  for (int j = 0; j < UN; ++j) unit_ok[j] = col_lane + j * UC < a.width;

  // A lane (the lanes of a link) takes B consecutive entries of the forward
  // lists: their ids are one 16-byte load, and they mostly share an owner.
  const int64_t tile = static_cast<int64_t>(LINKS) * B;
  const int64_t hop = static_cast<int64_t>(gridDim.x) * tile;
  int64_t base = static_cast<int64_t>(blockIdx.x) * tile +
                 static_cast<int64_t>(threadIdx.x / LPL) * B;
  int4 qn = load_ids(a.fwd_nbr, base, a.n_links);
  // the block leaves the loop together: its tile starts at
  // base - (threadIdx.x / LPL) * B
  for (; base - (threadIdx.x / LPL) * B < a.n_links; base += hop) {
    int q[B], p[B], cp[B], cq[B];
    uint4 own[B][UN], nb[B][UN];
    q[0] = qn.x;
    q[1] = qn.y;
    q[2] = qn.z;
    q[3] = qn.w;
    qn = load_ids(a.fwd_nbr, base + hop, a.n_links);
    // the owner of an entry is the last node whose forward list starts at
    // or before it; the B entries lie in one chunk, between its two
    // recorded owners
    {
      const int hi = q[0] < 0 ? 0 : a.chunk_owner[base / kOwnerChunk + 1];
      int at = q[0] < 0 ? 0
                        : owner_of(a.fwd_ptr, a.chunk_owner[base / kOwnerChunk],
                                   hi, base);
      int64_t next = q[0] < 0 ? 0 : a.fwd_ptr[at + 1];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        if (q[b] >= 0 && base + b >= next) {
          at = owner_of(a.fwd_ptr, at + 1, hi, base + b);
          next = a.fwd_ptr[at + 1];
        }
        p[b] = at;
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      cp[b] = cq[b] = 0;
      bool need_nb = q[b] >= 0;
      if constexpr (CONV) {
        if (q[b] >= 0) {
          cp[b] = a.conv[p[b]];
          cq[b] = a.conv[q[b]];
          // one-sided: the column within this lane, or out of it
          const int c = max(cp[b], cq[b]) - 1 - a.col0 - col_lane;
          need_nb = (cp[b] > 0) == (cq[b] > 0) ||
                    (cp[b] > 0 && c >= 0 && c < A);
        }
      }
      const T* prow = a.rows + static_cast<int64_t>(p[b]) * a.row_stride +
                      col_lane;
      const T* qrow = a.rows +
                      static_cast<int64_t>(q[b] < 0 ? 0 : q[b]) * a.row_stride +
                      col_lane;
#pragma unroll
      for (int j = 0; j < UN; ++j) {
        own[b][j] = nb[b][j] = make_uint4(0u, 0u, 0u, 0u);
        if (q[b] >= 0 && unit_ok[j])
          own[b][j] = load_unit16<HINT>(prow + j * UC, policy);
        if (need_nb && unit_ok[j])
          nb[b][j] = load_unit16<HINT>(qrow + j * UC, policy);
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const bool dense = !CONV || (cp[b] > 0) == (cq[b] > 0);
      // a link past the end has zero rows and cp == cq: it adds zeros
      if (dense) {
#pragma unroll
        for (int i = 0; i < A; ++i)
          acc[i] = fmaf(unit_at<T>(own[b][i / UC], i % UC),
                        unit_at<T>(nb[b][i / UC], i % UC), acc[i]);
      } else {
        // the free end's value at the frozen column, if this lane holds it
        const int c = max(cp[b], cq[b]) - 1 - a.col0 - col_lane;
#pragma unroll
        for (int i = 0; i < A; ++i)
          if (i == c)
            acc[i] += cp[b] > 0 ? unit_at<T>(nb[b][i / UC], i % UC)
                                : unit_at<T>(own[b][i / UC], i % UC);
      }
    }
  }

  // lanes with the same `sub` hold the same columns: add them across the
  // warp, then across the warps in warp order
#pragma unroll
  for (int off = svt::kWarp / 2; off >= LPL; off >>= 1)
#pragma unroll
    for (int i = 0; i < A; ++i)
      acc[i] += __shfl_xor_sync(svt::kFull, acc[i], off);
  if (lane < LPL) {
#pragma unroll
    for (int i = 0; i < A; ++i)
      smem[(threadIdx.x / svt::kWarp) * (UPL * UC) + lane * A + i] = acc[i];
  }
  __syncthreads();
  if (threadIdx.x < a.width) {
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) s += smem[w * (UPL * UC) + threadIdx.x];
    a.partial[static_cast<int64_t>(blockIdx.x) * a.ld + threadIdx.x] = s;
  }
}

template <class T, int UPL, int UN, bool CONV, bool HINT>
__global__ void __launch_bounds__(svt::kBlockThreads)
s3_slab_kernel(const SlabArgs<T> a) {
  s3_slab_body<T, UPL, UN, CONV, HINT>(a);
}

// The same over n_slabs slabs in one cooperative launch: every block is
// resident, and the grid crosses from slab to slab together, so that one
// slab is live at a time as with a launch per slab. `a` describes the
// first slab; the next one's rows are slab_stride values on.
template <class T, int UPL>
__global__ void __launch_bounds__(svt::kBlockThreads)
s3_slab_persistent_kernel(SlabArgs<T> a, int n_slabs, int64_t slab_stride,
                          int k) {
  constexpr int W = UPL * (16 / static_cast<int>(sizeof(T)));
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int s = 0; s < n_slabs; ++s) {
    s3_slab_body<T, UPL, 2, false, true>(a);
    a.rows += slab_stride;
    a.partial += W;
    a.col0 += W;
    a.width = k - a.col0 < W ? k - a.col0 : W;
    // also keeps the block's shared memory until its sums are read
    if (s + 1 < n_slabs) grid.sync();
  }
}

// Rows [0, n) of slabs [s0, s0 + n_slabs) of the row-major (n, k) src into
// dst (n_slabs, n, w), zero past column k. A thread moves one 16-byte unit,
// loaded in pieces of `gran` bytes, the most the rows' alignment allows.
template <class T>
__global__ void __launch_bounds__(svt::kBlockThreads)
slab_copy_kernel(const T* __restrict__ src, T* __restrict__ dst, int64_t n,
                 int k, int w, int s0, int n_slabs, int gran) {
  constexpr int UC = 16 / sizeof(T);
  const int upl = w / UC;
  const int64_t units = static_cast<int64_t>(n_slabs) * upl;  // of a row
  const int64_t total = n * units;
  const int64_t hop = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       idx < total; idx += hop) {
    const int64_t r = idx / units;
    const int j = static_cast<int>(idx - r * units);
    const int c = s0 * w + j * UC;
    const T* from = src + r * k + c;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gran == 16) {
      if (c < k) v = __ldcs(reinterpret_cast<const uint4*>(from));
    } else if (gran == 8) {
      if (c < k) {
        const uint2 t = __ldcs(reinterpret_cast<const uint2*>(from));
        v.x = t.x;
        v.y = t.y;
      }
      if (c + UC / 2 < k) {
        const uint2 t = __ldcs(reinterpret_cast<const uint2*>(from) + 1);
        v.z = t.x;
        v.w = t.y;
      }
    } else {
      alignas(16) T tmp[UC];
#pragma unroll
      for (int i = 0; i < UC; ++i)
        tmp[i] = c + i < k ? from[i] : static_cast<T>(0.0f);
      v = *reinterpret_cast<const uint4*>(tmp);
    }
    const int s = j / upl;
    const int u = j - s * upl;
    *reinterpret_cast<uint4*>(
        dst + (static_cast<int64_t>(s) * n + r) * w + u * UC) = v;
  }
}

template <class T, int UPL, int UN>
void launch_slab(const SlabArgs<T>& a, bool hint, unsigned blocks,
                 cudaStream_t stream) {
#define SVT_SLAB(CONV, HINT)                      \
  s3_slab_kernel<T, UPL, UN, CONV, HINT>          \
      <<<blocks, svt::kBlockThreads, 0, stream>>>(a)
  if (a.conv != nullptr) {
    if (hint) SVT_SLAB(true, true); else SVT_SLAB(true, false);
  } else {
    if (hint) SVT_SLAB(false, true); else SVT_SLAB(false, false);
  }
#undef SVT_SLAB
}

// One cooperative launch over n_slabs slabs from `a` on, with at most
// `blocks` blocks and no more than the device holds at once; returns the
// number launched, or 0 after an error (left for cudaGetLastError).
template <class T, int UPL>
unsigned launch_persistent(SlabArgs<T> a, int n_slabs, int64_t slab_stride,
                           int k, unsigned blocks, cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, s3_slab_persistent_kernel<T, UPL>, svt::kBlockThreads, 0) !=
          cudaSuccess)
    return 0;
  const unsigned fit = static_cast<unsigned>(sms * per_sm);
  if (blocks > fit) blocks = fit;
  void* args[] = {&a, &n_slabs, &slab_stride, &k};
  if (blocks == 0 ||
      cudaLaunchCooperativeKernel(
          reinterpret_cast<void*>(s3_slab_persistent_kernel<T, UPL>),
          dim3(blocks), dim3(svt::kBlockThreads), args, 0, stream) !=
          cudaSuccess)
    return 0;
  return blocks;
}

enum SlabMode { kSlabCopy = 0, kSlabStrided = 1, kSlabGiven = 2 };

template <class T>
int s3_slab_pass(const T* rows, int mode, T* slab_buf, int buf_slabs,
                 const int32_t* conv, const int32_t* fwd_ptr,
                 const int32_t* fwd_nbr, const int32_t* chunk_owner,
                 float* partial, float* s3, int64_t n, int64_t n_links, int k,
                 int slab_bytes, int lane_units, int hint, int persistent,
                 cudaStream_t stream) {
  const int w = slab_bytes / static_cast<int>(sizeof(T));
  const int upl = slab_bytes / 16;
  const int n_slabs = (k + w - 1) / w;
  const int row_bytes = k * static_cast<int>(sizeof(T));
  if ((upl != 2 && upl != 4 && upl != 8) ||
      (lane_units != 1 && lane_units != 2) ||
      (mode == kSlabCopy && buf_slabs < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  // in place, every unit must sit on a 16-byte boundary
  if (mode == kSlabStrided && (row_bytes % 16 != 0 || !svt::aligned16(rows)))
    return static_cast<int>(cudaErrorInvalidValue);
  // one launch over a run of slabs has one form only
  if (persistent && (lane_units != 2 || conv != nullptr || !hint))
    return static_cast<int>(cudaErrorInvalidValue);
  const int lpl = upl / lane_units;
  const int64_t tile =
      static_cast<int64_t>(svt::kBlockThreads / lpl) * kSlabBatch;
  const int64_t want = (n_links + tile - 1) / tile;
  unsigned blocks = static_cast<unsigned>(
      want < svt::kReduceBlocks ? want : svt::kReduceBlocks);
  const int gran = row_bytes % 16 == 0 && svt::aligned16(rows) ? 16
                   : row_bytes % 8 == 0 &&
                           reinterpret_cast<uintptr_t>(rows) % 8 == 0
                       ? 8
                       : static_cast<int>(sizeof(T));
  // a run: slabs from s on whose rows lie one after another in memory
  for (int s = 0, run = 0; s < n_slabs && blocks > 0; s += run) {
    run = n_slabs - s;
    const T* base = rows + static_cast<int64_t>(s) * n * w;
    int64_t slab_stride = n * w;
    int64_t row_stride = w;
    if (mode == kSlabStrided) {
      base = rows + s * w;
      slab_stride = w;
      row_stride = k;
    } else if (mode == kSlabCopy) {
      if (run > buf_slabs) run = buf_slabs;
      const int64_t units = n * run * upl;
      const int64_t cb = (units + svt::kBlockThreads - 1) / svt::kBlockThreads;
      slab_copy_kernel<T>
          <<<static_cast<unsigned>(cb < 65535 * 16 ? cb : 65535 * 16),
             svt::kBlockThreads, 0, stream>>>(rows, slab_buf, n, k, w, s, run,
                                               gran);
      base = slab_buf;
    }
    SlabArgs<T> a{base,    row_stride,      fwd_ptr, fwd_nbr, chunk_owner,
                  n_links, partial + s * w, k,       0,       conv,
                  s * w};
    if (persistent) {
      a.width = k - a.col0 < w ? k - a.col0 : w;
      if (upl == 2)
        blocks = launch_persistent<T, 2>(a, run, slab_stride, k, blocks, stream);
      else if (upl == 4)
        blocks = launch_persistent<T, 4>(a, run, slab_stride, k, blocks, stream);
      else
        blocks = launch_persistent<T, 8>(a, run, slab_stride, k, blocks, stream);
      if (blocks == 0) {
        const cudaError_t err = cudaGetLastError();
        return static_cast<int>(err != cudaSuccess ? err
                                                   : cudaErrorLaunchFailure);
      }
      continue;
    }
    for (int i = 0; i < run; ++i) {
      a.width = k - a.col0 < w ? k - a.col0 : w;
      const bool h = hint != 0;
      if (lane_units == 2) {
        if (upl == 2) launch_slab<T, 2, 2>(a, h, blocks, stream);
        else if (upl == 4) launch_slab<T, 4, 2>(a, h, blocks, stream);
        else launch_slab<T, 8, 2>(a, h, blocks, stream);
      } else {
        if (upl == 2) launch_slab<T, 2, 1>(a, h, blocks, stream);
        else if (upl == 4) launch_slab<T, 4, 1>(a, h, blocks, stream);
        else launch_slab<T, 8, 1>(a, h, blocks, stream);
      }
      a.rows += slab_stride;
      a.partial += w;
      a.col0 += w;
    }
  }
  svt::launch_colsum_partials(partial, static_cast<int>(blocks), k, k, s3,
                              stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The slab form. s3 (K,) is written; partial is scratch of
// svt::kReduceBlocks rows of K. rows is (n,K) row-major f32 (bf16 when
// rows_bf16), gathered through slab_buf, scratch of buf_slabs slabs of
// n * slab_bytes (mode 0), or in place (mode 1: rows on 16-byte
// boundaries); or rows is slab-major already, (ceil(K/W), n, W) with W =
// slab_bytes / the value's size and zeros past K (mode 2). slab_bytes is
// 32, 64 or 128; lane_units 1 or 2 (a lane loads one 16-byte unit of a
// link's row, or two); hint asks for the L2 evict_last policy; persistent
// for one cooperative launch over each run of slabs in place of a launch a
// slab (lane_units 2, hint, no conv).
extern "C" int svt_s3_slab_pass(const void* rows, int rows_bf16, int mode,
                                void* slab_buf, int buf_slabs,
                                const int32_t* conv, const int32_t* fwd_ptr,
                                const int32_t* fwd_nbr,
                                const int32_t* chunk_owner, float* partial,
                                float* s3, int64_t n, int64_t n_links, int k,
                                int slab_bytes, int lane_units, int hint,
                                int persistent, cudaStream_t stream) {
  if (k <= 0) return static_cast<int>(cudaGetLastError());
  if (rows_bf16)
    return s3_slab_pass(static_cast<const svt::bf16*>(rows), mode,
                        static_cast<svt::bf16*>(slab_buf), buf_slabs, conv,
                        fwd_ptr, fwd_nbr, chunk_owner, partial, s3, n, n_links,
                        k, slab_bytes, lane_units, hint, persistent, stream);
  return s3_slab_pass(static_cast<const float*>(rows), mode,
                      static_cast<float*>(slab_buf), buf_slabs, conv, fwd_ptr,
                      fwd_nbr, chunk_owner, partial, s3, n, n_links, k,
                      slab_bytes, lane_units, hint, persistent, stream);
}
