// Kernel 12: FastInit's label-propagation vote (-findk, and SBM's phi
// init), svinet_tpu/svi/fastinit.py:38-92 vote_topk. It replaces no TPU
// kernel: the JAX function is two device-wide lexsorts of the 2E directed
// votes and run counts, in XLA.
//
// Per node p, the labels of its training neighbours are counted and the
// `width` most voted kept, count descending then label ascending; empty
// slots get the sentinel id n and count 0. Here a node pulls its own
// votes over the adjacency (svinet_torch/ops/edges.py, owner-major) and
// sorts them alone: a warp sorts an ordinary node's labels (at most
// kWarpMax) in shared memory, finds each run's length by a binary search
// of the sorted list, packs every run as the 64-bit key
// (deg - count) << 32 | label and sorts the keys, whose first `width` are
// the slots in order. A hub (more than kWarpMax neighbours) takes a block
// of its own doing the same over global scratch (a power of two of at
// least its degree, placed by the wrapper). Integers throughout: the
// result equals the plain version's bit for bit.
//
// What bounds it on an H100: the 2E neighbour ids read in order (4 bytes
// each), the 2E label gathers, each a 32-byte sector of a random place in
// the (n,) labels (in L2 while n is a few million), and the (n, width) ids
// and counts written, 8 bytes a slot. At stretch (n = 1M, 2E = 40M, width
// 64) that is about 0.16 + 1.28 + 0.51 GB, 0.6 ms at 3.35 TB/s with the
// gathers from device memory, 0.2 ms with them from L2.

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarpMax = 256;        // labels a warp sorts in shared memory
constexpr int kWarpsPerBlock = 8;
constexpr int kHubThreads = 1024;
constexpr uint64_t kNoKey = ~0ull;

struct VoteArgs {
  const int32_t* labels;   // (n,)
  const int32_t* rowptr;   // (n + 1,)
  const int32_t* nbr;      // (2E,)
  const int32_t* hub_node; // (H,)
  const int64_t* hub_off;  // (H,) each hub's place in the scratch
  int32_t* lab_scratch;    // hubs' labels
  uint64_t* key_scratch;   // hubs' run keys
  int32_t* ids;            // (n, width)
  float* cnt;              // (n, width)
  int64_t n;
  int64_t n_hubs;
  int width;
};

struct WarpSync {
  __device__ void operator()() const { __syncwarp(); }
};
struct BlockSync {
  __device__ void operator()() const { __syncthreads(); }
};

__device__ __forceinline__ int next_pow2(int d) {
  int p = 1;
  while (p < d) p <<= 1;
  return p;
}

// Ascending bitonic sort of a[0, len), len a power of two, by `threads`
// threads (`tid` this one's index) that all call it.
template <class T, class Sync>
__device__ void bitonic_sort(T* a, int len, int tid, int threads,
                             Sync sync) {
  sync();
  for (int k = 2; k <= len; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < len; i += threads) {
        const int o = i ^ j;
        if (o > i) {
          const T x = a[i], y = a[o];
          if ((x > y) == ((i & k) == 0)) {
            a[i] = y;
            a[o] = x;
          }
        }
      }
      sync();
    }
  }
}

// One node's vote: its d neighbours' labels into lab[0, len) (len the
// next power of two of d, padded with INT_MAX), sorted; each run's key at
// its first place in key[], kNoKey elsewhere, sorted; the first `width`
// keys are the node's slots.
template <class Sync>
__device__ void vote_node(const VoteArgs& a, int64_t p, int32_t* lab,
                          uint64_t* key, int tid, int threads, Sync sync) {
  const int64_t b = a.rowptr[p];
  const int d = static_cast<int>(a.rowptr[p + 1] - b);
  const int len = next_pow2(d > 0 ? d : 1);
  for (int i = tid; i < len; i += threads)
    lab[i] = i < d ? __ldg(a.labels + __ldg(a.nbr + b + i)) : INT_MAX;
  bitonic_sort(lab, len, tid, threads, sync);
  for (int i = tid; i < len; i += threads) {
    uint64_t k = kNoKey;
    if (i < d && (i == 0 || lab[i - 1] != lab[i])) {
      // the run's end: the first place past i holding a larger label
      const int v = lab[i];
      int lo = i + 1, hi = d;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (lab[mid] <= v)
          lo = mid + 1;
        else
          hi = mid;
      }
      const uint32_t count = static_cast<uint32_t>(lo - i);
      k = (static_cast<uint64_t>(static_cast<uint32_t>(d) - count) << 32) |
          static_cast<uint32_t>(v);
    }
    key[i] = k;
  }
  bitonic_sort(key, len, tid, threads, sync);
  for (int s = tid; s < a.width; s += threads) {
    const int64_t at = p * a.width + s;
    const uint64_t k = s < len ? key[s] : kNoKey;
    if (k == kNoKey) {
      a.ids[at] = static_cast<int32_t>(a.n);
      a.cnt[at] = 0.0f;
    } else {
      a.ids[at] = static_cast<int32_t>(k & 0xffffffffu);
      a.cnt[at] = static_cast<float>(d - static_cast<int>(k >> 32));
    }
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * svt::kWarp)
vote_warp_kernel(const VoteArgs a) {
  __shared__ int32_t lab[kWarpsPerBlock][kWarpMax];
  __shared__ uint64_t key[kWarpsPerBlock][kWarpMax];
  const int w = threadIdx.x / svt::kWarp;
  const int lane = threadIdx.x % svt::kWarp;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + w;
  if (p >= a.n) return;  // the whole warp
  if (a.rowptr[p + 1] - a.rowptr[p] > kWarpMax) return;  // a hub
  vote_node(a, p, lab[w], key[w], lane, svt::kWarp, WarpSync{});
}

__global__ void __launch_bounds__(kHubThreads) vote_hub_kernel(
    const VoteArgs a) {
  const int64_t h = blockIdx.x;
  const int64_t off = a.hub_off[h];
  vote_node(a, a.hub_node[h], a.lab_scratch + off, a.key_scratch + off,
            threadIdx.x, kHubThreads, BlockSync{});
}

}  // namespace

// labels, the adjacency's rowptr and nbr; the hubs (nodes of more than
// 256 neighbours) and their offsets into the two scratch arrays (each hub
// a power of two of at least its degree); out: ids, cnt (n, width).
extern "C" int svt_fastinit_vote(const int32_t* labels, const int32_t* rowptr,
                                 const int32_t* nbr, const int32_t* hub_node,
                                 const int64_t* hub_off, int32_t* lab_scratch,
                                 uint64_t* key_scratch, int32_t* ids,
                                 float* cnt, int64_t n, int64_t n_hubs,
                                 int width, cudaStream_t stream) {
  if (n <= 0 || width < 1 || n_hubs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const VoteArgs a{labels,      rowptr, nbr, hub_node, hub_off, lab_scratch,
                   key_scratch, ids,    cnt, n,        n_hubs,  width};
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  vote_warp_kernel<<<static_cast<unsigned>(blocks),
                     kWarpsPerBlock * svt::kWarp, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_hubs == 0) return static_cast<int>(err);
  vote_hub_kernel<<<static_cast<unsigned>(n_hubs), kHubThreads, 0,
                    stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
