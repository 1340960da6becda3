// Kernel 16: the generator's dense pair draw (svinet_tpu/svi/gen.py:45
// _gen_rows inside :64 draw_network), used by -gen up to n = 65,536 and
// by every -ppc draw. It replaces no TPU kernel: the JAX function draws
// (rows, n) slabs of categorical samples in XLA.
//
// For every pair i < j of rows [row0, row1): z_p ~ Cat(pi_i), z_q ~
// Cat(pi_j), and the pair is a link when u < rate, rate = beta[z_p] if
// z_p == z_q, else eps. The uniforms come from Philox4x32-10 (Salmon et
// al., SC'11), keyed by (seed low word, seed high word ^ stream) and
// counted by the pair, counter (j, i, 0, 0): its four words give u_p, u_q,
// u and one left unused, each as (x >> 8) * 2^-24, exact in f32. A
// category is the inverse CDF against the row's cumulative pi (an (n, K)
// f32 table made once on the host): z = the number of its first K - 1
// entries that are <= u, by binary search. The plain version
// (svi/gen.py:gen_pairs_plain) does the same in int64 torch arithmetic,
// so the two give the same edges bit for bit, whatever the launch.
//
// A warp owns a row: pass 1 counts its links, 32 pairs a step; the caller
// scans the counts into offsets; pass 2 draws the same pairs again and
// writes each row's links in ascending j (a ballot, then each link's place
// among the lanes below it). No atomics.
//
// What bounds it on an H100: the integer multiplies of Philox (20 wide
// multiplies a pair) and two binary searches in L2-resident cumulative
// rows; the output is tiny. Both passes draw every pair.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t lo0 = kM0 * c.x, hi0 = __umulhi(kM0, c.x);
    const uint32_t lo1 = kM1 * c.z, hi1 = __umulhi(kM1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float uniform24(uint32_t x) {
  return static_cast<float>(x >> 8) * 5.9604644775390625e-8f;  // 2^-24
}

// the number of cum[0 .. k-2] that are <= u
__device__ __forceinline__ int category(const float* __restrict__ cum, int k,
                                        float u) {
  int lo = 0, hi = k - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(cum + mid) <= u)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

struct GenArgs {
  const float* cum;    // (n, k) cumulative pi
  const float* beta;   // (k,)
  float eps;
  int64_t n;
  int k;
  int64_t row0, row1;
  uint32_t k0, k1;     // the Philox key
  int64_t* counts;     // pass 1: (row1 - row0,) links a row
  const int64_t* offsets;  // pass 2: (row1 - row0,) exclusive scan
  int32_t* edges;      // pass 2: (total, 2)
};

__device__ __forceinline__ bool draw(const GenArgs& a, const float* cum_i,
                                     int64_t i, int64_t j) {
  const uint4 x = philox(make_uint4(static_cast<uint32_t>(j),
                                    static_cast<uint32_t>(i), 0u, 0u),
                         a.k0, a.k1);
  const int zp = category(cum_i, a.k, uniform24(x.x));
  const int zq = category(a.cum + j * a.k, a.k, uniform24(x.y));
  const float rate = zp == zq ? __ldg(a.beta + zp) : a.eps;
  return uniform24(x.z) < rate;
}

template <bool WRITE>
__global__ void __launch_bounds__(svt::kBlockThreads)
gen_rows_kernel(const GenArgs a) {
  const int lane = threadIdx.x % svt::kWarp;
  const int64_t i = a.row0 +
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) /
      svt::kWarp;
  if (i >= a.row1) return;
  const float* cum_i = a.cum + i * a.k;
  int64_t at = WRITE ? a.offsets[i - a.row0] : 0;
  int64_t count = 0;
  for (int64_t base = i + 1; base < a.n; base += svt::kWarp) {
    const int64_t j = base + lane;
    const bool hit = j < a.n && draw(a, cum_i, i, j);
    const unsigned votes = __ballot_sync(svt::kFull, hit);
    if constexpr (WRITE) {
      if (hit) {
        const int64_t e =
            at + __popc(votes & ((1u << lane) - 1u));
        a.edges[2 * e] = static_cast<int32_t>(i);
        a.edges[2 * e + 1] = static_cast<int32_t>(j);
      }
      at += __popc(votes);
    } else {
      count += __popc(votes);
    }
  }
  if (!WRITE && lane == 0) a.counts[i - a.row0] = count;
}

}  // namespace

// pass 1 (write = 0): counts (row1 - row0,) int64, each row's links;
// pass 2 (write = 1): edges (total, 2) int32 at offsets (the exclusive
// scan of the counts), row-major, ascending j within a row.
extern "C" int svt_gen_pairs(const float* cum, const float* beta,
                             int64_t* counts, const int64_t* offsets,
                             int32_t* edges, int64_t n, int k, int64_t row0,
                             int64_t row1, float eps, int64_t seed,
                             int64_t stream_id, int write,
                             cudaStream_t stream) {
  if (k <= 0 || n < 0 || row0 < 0 || row1 > n || row0 > row1 ||
      n > (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (row1 == row0) return 0;
  const uint64_t s = static_cast<uint64_t>(seed);
  const GenArgs a{cum,  beta, eps,
                  n,    k,    row0,
                  row1, static_cast<uint32_t>(s),
                  static_cast<uint32_t>(s >> 32) ^
                      static_cast<uint32_t>(stream_id),
                  counts, offsets, edges};
  const unsigned blocks = svt::blocks_for(row1 - row0, svt::kWarp);
  if (write)
    gen_rows_kernel<true><<<blocks, svt::kBlockThreads, 0, stream>>>(a);
  else
    gen_rows_kernel<false><<<blocks, svt::kBlockThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
