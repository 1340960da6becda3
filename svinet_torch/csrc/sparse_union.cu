// Kernel 7: the top-W union pass of -sparse-w over the training links.
//
// Replaces the block function of svinet_tpu/svi/sweep_math.py:252-277
// (sparse_union_sweep_body), which ran inside the XLA sweep program on the
// TPU. For every link (p, q), with ids[p] and ids[q] the W columns of the
// largest gamma of each end and topvals their Elogpi values:
//   the 2W slots: p's columns c with logit topvals[p][j] + Elogpi[q,c]
//                 + Elogbeta0[c], and q's columns with Elogpi[p,c]
//                 + topvals[q][j] + Elogbeta0[c];
//   a column in both lists is kept once (the two copies carry the same
//   logit bit for bit: topvals[p][j] is Elogpi[p,c], and an f32 add
//   commutes);
//   phi = softmax over the kept slots; gacc[p,c] += phi, gacc[q,c] += phi,
//   sumk[c] += 2 phi;
//   s3[c] += mphi[p,c] * mphi[q,c] over the kept slots (mphi of the sweep
//   before: s3 lags one sweep, as under -fuse-s3).
// The TPU sorted each link's 2W ids to find the duplicates and scattered
// phi at (node, column) element by element.
//
// What bounds it on an H100: random 32-byte sectors. Per directed entry
// the pass needs W values of the neighbour's Elogpi row at the owner's
// columns, the neighbour's ids and topvals, and at each link's lower end
// the neighbour's mphi at both lists' columns. No two of them share a
// sector (random neighbours, 2 GB arrays, a 50 MB L2), so each costs 32
// bytes where the bound counts 4; the floor counts the sectors.
//
// What the design does about it:
//  - fewer sectors a link. Elogpi and the mean indicators of the sweep
//    before are stored side by side, (n, K, 2) f32 `rows` (the top-W form
//    of kernel 1 writes the even half, kernel 3 the odd one): the pair at
//    (q, c) is one 8-byte load from one sector, where the first design's
//    two arrays took two. And the neighbour's own mphi at its own
//    columns, which the first design gathered at random a link, travels
//    with its list: `topm` (n, W), written by the top-W form beside
//    topvals, read in order beside ids. On n=1M, K=500, 19.9M links, W=16
//    that is about 2E(W+4) = 0.80 G sectors a pass where the two arrays
//    took 1.42 G.
//  - more of them in flight. Up to W = 32 (one slot a lane), the loads of
//    a group's next neighbour (its ids, topvals, topm and the W pairs at
//    the owner's columns, which need only the neighbour's number) are
//    issued before the group reduces the present one, so they are in
//    flight through its max, exp and sum reductions and its turn at the
//    accumulator; the neighbour's number is loaded a step further ahead.
//    Only the owner's own pairs at the neighbour's columns wait for its
//    ids, and those come from the owner's row, which the L1 or the L2
//    holds across the owner's neighbours. At W = 64 the second entry's
//    registers (73 a thread: 24 warps an SM where 64 give 32) bought
//    nothing (70.03 ms with them, 69.78 without, on stretch), so there a
//    group loads its own entry only.
// Random sectors come at about 32 G/s on an H100 whether one or eight
// loads a lane are in flight (tools/bench_kernels.py --only sectors); at
// that rate this layout's 0.84 G sectors a pass on stretch at W = 16 take
// 26 ms, and the kernel takes 28.1 (the first design: 34.5; H100 80GB
// HBM3, 700 W).
//
// As in the first design, pull over the adjacency, as kernels 2 and 4 do,
// so that nothing is scattered. A warp owns node p (a hub's list comes cut
// into segments, each summed into its own scratch row and combined in
// segment order by common.cuh's combine_segments_kernel):
//  - p's W columns are set as bits of a K-bit mask in shared memory; a
//    column of q's list is a duplicate exactly when its bit is set, and
//    p's copy is the one kept. No sort.
//  - phi goes into p's K-wide accumulator in shared memory and is written
//    once, densely, to gacc[p]: nothing in device memory is zero-filled
//    and nothing is atomic. A group of S lanes takes one neighbour, with
//    one slot of p's list and one of q's a lane (two a lane at W <= 64);
//    32/S neighbours share a warp and add their phi to the accumulator
//    one group after the other, in a fixed order.
//  - sumk is the column sum of every row written (each link's phi is met
//    from both ends); s3 is summed once per link, from its lower end
//    (kernel 4's rule), at the kept slots. Both are per-warp rows in shared
//    memory that the block adds in warp order into a scratch row, and
//    colsum_partials_kernel adds the scratch rows in order. Two launches
//    give the same bits.
//  - Any W from 1 to K, any K up to what three K-wide rows a warp fit in
//    shared memory (about 19,000): the shared memory is sized from K, with
//    fewer warps a block as K grows. W up to 64 keeps its logits in
//    registers; wider lists compute them again for each of the softmax's
//    three steps and load nothing ahead.
// The first design is kept in csrc/alt/sparse_union_v1.cu for timing.

#include <math.h>

#include <climits>

#include "common.cuh"

namespace {

struct UnionArgs {
  // work items 0..n-1 are the nodes (a hub is skipped: its segments are
  // items n..n+n_segs-1)
  const int32_t* rowptr;
  const int32_t* nbr;
  const int32_t* seg_node;
  const int32_t* seg_begin;
  const int32_t* seg_end;
  const float2* rows;    // (n,K): (Elogpi, mphi of the sweep before)
  const int32_t* ids;    // (n,W)
  const float* topvals;  // (n,W): Elogpi at ids
  const float* topm;     // (n,W): mphi of the sweep before at ids
  const float* elb0;     // (K,)
  float* gacc;           // (n,K)
  float* seg_rows;       // (n_segs,K)
  float* partial;        // (2 * blocks, K): sumk rows, then s3 rows
  int64_t n;
  int64_t n_items;
  int k;
  int w;
  int seg_len;
};

// The node of item `item`, its slice of nbr and the row it writes. False
// for a hub met among the nodes.
__device__ __forceinline__ bool union_item(const UnionArgs& a, int64_t item,
                                           int64_t* p, int* begin, int* end,
                                           float** out) {
  if (item >= a.n) {
    const int64_t s = item - a.n;
    *p = a.seg_node[s];
    *begin = a.seg_begin[s];
    *end = a.seg_end[s];
    *out = a.seg_rows + s * a.k;
    return true;
  }
  *p = item;
  *begin = a.rowptr[item];
  *end = a.rowptr[item + 1];
  *out = a.gacc + item * a.k;
  return *end - *begin <= a.seg_len;
}

// Floats of shared memory a warp takes: its accumulator, its sumk and s3
// rows, and the K-bit mask.
__host__ __device__ inline int warp_floats(int k) {
  return 3 * k + (k + 31) / 32;
}

__device__ __forceinline__ bool in_mask(const unsigned* bits, int c) {
  return (bits[c >> 5] >> (c & 31)) & 1u;
}

// What a lane loads of one neighbour q for its T slots: q's list at slot j
// (column, Elogpi, mphi) and the pair at the owner's column of slot j.
template <int T>
struct Entry {
  int64_t q;
  int idq[T];
  float tvq[T];
  float tmq[T];
  float2 rq[T];
};

// Issue the loads of neighbour q; nothing here waits for them. mphi of q's
// own list is needed only at the link's lower end.
template <int S, int T>
__device__ __forceinline__ void load_entry(const UnionArgs& a, int64_t p,
                                           int64_t q, int l,
                                           const int (&pid)[T],
                                           Entry<T>& e) {
  e.q = q;
  const bool lower = q > p;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int j = l + S * t;
    if (j < a.w) {
      e.idq[t] = __ldg(a.ids + q * a.w + j);
      e.tvq[t] = __ldg(a.topvals + q * a.w + j);
      e.tmq[t] = lower ? __ldg(a.topm + q * a.w + j) : 0.0f;
      e.rq[t] = __ldg(a.rows + q * a.k + pid[t]);
    }
  }
}

// S lanes a neighbour; NT > 0: slot j = l + S t (t < NT) of each list per
// lane, logits held in registers (W <= S NT), the next neighbour's loads
// in flight; NT = 0: any W, S = 32, the logits computed again for each
// step.
template <int S, int NT>
__global__ void __launch_bounds__(svt::kBlockThreads)
sparse_union_kernel(const UnionArgs a) {
  extern __shared__ float smem[];
  constexpr int kGroups = svt::kWarp / S;
  constexpr int T = NT > 0 ? NT : 1;
  const int k = a.k, w = a.w;
  const int lane = threadIdx.x % svt::kWarp;
  const int warp = threadIdx.x / svt::kWarp;
  const int warps = blockDim.x / svt::kWarp;
  const int grp = lane / S;
  const int l = lane % S;
  const unsigned gmask = svt::group_mask<S>(lane);
  float* acc = smem + static_cast<int64_t>(warp) * warp_floats(k);
  float* psum = acc + k;
  float* ps3 = psum + k;
  unsigned* bits = reinterpret_cast<unsigned*>(ps3 + k);
  for (int c = lane; c < 3 * k; c += svt::kWarp) acc[c] = 0.0f;
  for (int c = lane; c < (k + 31) / 32; c += svt::kWarp) bits[c] = 0u;
  __syncwarp();

  for (int64_t item = static_cast<int64_t>(blockIdx.x) * warps + warp;
       item < a.n_items; item += static_cast<int64_t>(gridDim.x) * warps) {
    int64_t p;
    int begin, end;
    float* out;
    if (!union_item(a, item, &p, &begin, &end, &out)) continue;
    const int32_t* idp_row = a.ids + p * w;
    const float* tvp_row = a.topvals + p * w;
    const float* tmp_row = a.topm + p * w;
    const float2* rp_row = a.rows + p * k;
    for (int j = lane; j < w; j += svt::kWarp) {
      const int c = idp_row[j];
      atomicOr(bits + (c >> 5), 1u << (c & 31));  // an OR: order-free
    }
    // this lane's slots of p's list: column, logit part, Elogbeta0 and
    // mphi[p, column]
    int pid[T];
    float ptv[T], pe0[T], pm[T];
    if constexpr (NT > 0) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int j = l + S * t;
        pid[t] = j < w ? idp_row[j] : 0;
        ptv[t] = j < w ? tvp_row[j] : 0.0f;
        pe0[t] = j < w ? __ldg(a.elb0 + pid[t]) : 0.0f;
        pm[t] = j < w ? tmp_row[j] : 0.0f;
      }
    }
    __syncwarp();

    if constexpr (NT > 0) {
      // this group's entries are begin + grp, + kGroups, ...: `cur` holds
      // the loads of the present one, `nxt` those of the next, issued
      // before the present one is reduced; q_next is two entries ahead
      // (two slots a lane, W <= 64: the next entry's registers would cost
      // a quarter of the warps an SM, so it loads its own entry only)
      constexpr bool kAhead = NT == 1;
      Entry<T> cur{}, nxt{};
      const int e0 = begin + grp;
      if (kAhead && e0 < end)
        load_entry<S, T>(a, p, __ldg(a.nbr + e0), l, pid, cur);
      int64_t q_next = e0 + kGroups < end ? __ldg(a.nbr + e0 + kGroups) : 0;
      for (int base = begin; base < end; base += kGroups) {
        const int e = base + grp;
        const bool live = e < end;  // the same in every lane of the group
        if (!kAhead && live)
          load_entry<S, T>(a, p, __ldg(a.nbr + e), l, pid, cur);
        if (kAhead && e + kGroups < end)
          load_entry<S, T>(a, p, q_next, l, pid, nxt);
        if (kAhead && e + 2 * kGroups < end)
          q_next = __ldg(a.nbr + e + 2 * kGroups);
        const bool lower = cur.q > p;
        // the logits, then phi; q's column, whether it is kept, and the
        // two s3 terms of the slot: mphi[q, p's column] (times pm) and
        // mphi[p, q's column] * mphi[q, q's column]
        float lp[T], lq[T], mqp[T], s3q[T];
        int qid[T];
        bool keep[T];
        float m = -INFINITY, denom = 0.0f;
        if (live) {
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            if (l + S * t < w) {
              const int c = cur.idq[t];
              qid[t] = c;
              keep[t] = !in_mask(bits, c);
              const float2 rp =
                  keep[t] ? __ldg(rp_row + c) : make_float2(0.f, 0.f);
              lp[t] = (ptv[t] + cur.rq[t].x) + pe0[t];
              lq[t] = keep[t] ? (rp.x + cur.tvq[t]) + __ldg(a.elb0 + c)
                              : -INFINITY;
              mqp[t] = lower ? cur.rq[t].y : 0.0f;
              s3q[t] = lower && keep[t] ? rp.y * cur.tmq[t] : 0.0f;
            } else {
              lp[t] = lq[t] = -INFINITY;
              qid[t] = 0;
              keep[t] = false;
              mqp[t] = s3q[t] = 0.0f;
            }
            m = fmaxf(m, fmaxf(lp[t], lq[t]));
          }
          m = svt::group_max<S>(m, gmask);
          float s = 0.0f;
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            lp[t] = expf(lp[t] - m);  // exp(-inf) = 0 off the list
            lq[t] = expf(lq[t] - m);
            s += lp[t] + lq[t];
          }
          denom = svt::group_sum<S>(s, gmask);
        }
        // the groups of the warp add to the accumulator one after the other
        for (int turn = 0; turn < kGroups; ++turn) {
          if (turn == grp && live) {
#pragma unroll
            for (int t = 0; t < NT; ++t) {
              if (l + S * t < w) {
                acc[pid[t]] += lp[t] / denom;
                if (lower) ps3[pid[t]] += pm[t] * mqp[t];
                if (keep[t]) {
                  acc[qid[t]] += lq[t] / denom;
                  if (lower) ps3[qid[t]] += s3q[t];
                }
              }
            }
          }
          __syncwarp();
        }
        if (kAhead) cur = nxt;
      }
    } else {
      // any W: three walks over the slots, the logits computed in each
      for (int base = begin; base < end; base += kGroups) {
        const int e = base + grp;
        const bool live = e < end;
        const int64_t q = live ? __ldg(a.nbr + e) : 0;
        const bool lower = q > p;
        const float2* rq_row = a.rows + q * k;
        const int32_t* idq_row = a.ids + q * w;
        const float* tvq_row = a.topvals + q * w;
        const float* tmq_row = a.topm + q * w;
        float m = -INFINITY, denom = 0.0f;
        if (live) {
          for (int j = l; j < w; j += S) {
            const int cp = __ldg(idp_row + j);
            const int c = __ldg(idq_row + j);
            m = fmaxf(m, (__ldg(tvp_row + j) + __ldg(rq_row + cp).x) +
                             __ldg(a.elb0 + cp));
            if (!in_mask(bits, c))
              m = fmaxf(m, (__ldg(rp_row + c).x + __ldg(tvq_row + j)) +
                               __ldg(a.elb0 + c));
          }
          m = svt::group_max<S>(m, gmask);
          float s = 0.0f;
          for (int j = l; j < w; j += S) {
            const int cp = __ldg(idp_row + j);
            const int c = __ldg(idq_row + j);
            s += expf((__ldg(tvp_row + j) + __ldg(rq_row + cp).x) +
                      __ldg(a.elb0 + cp) - m);
            if (!in_mask(bits, c))
              s += expf((__ldg(rp_row + c).x + __ldg(tvq_row + j)) +
                        __ldg(a.elb0 + c) - m);
          }
          denom = svt::group_sum<S>(s, gmask);
        }
        for (int turn = 0; turn < kGroups; ++turn) {
          if (turn == grp && live) {
            for (int j = l; j < w; j += S) {
              const int cp = __ldg(idp_row + j);
              const int c = __ldg(idq_row + j);
              const float2 rqp = __ldg(rq_row + cp);
              acc[cp] += expf((__ldg(tvp_row + j) + rqp.x) +
                              __ldg(a.elb0 + cp) - m) /
                         denom;
              if (lower) ps3[cp] += tmp_row[j] * rqp.y;
              if (!in_mask(bits, c)) {
                const float2 rpc = __ldg(rp_row + c);
                acc[c] += expf((rpc.x + __ldg(tvq_row + j)) +
                               __ldg(a.elb0 + c) - m) /
                          denom;
                if (lower) ps3[c] += rpc.y * __ldg(tmq_row + j);
              }
            }
          }
          __syncwarp();
        }
      }
    }
    // p's row once, densely; the accumulator and the mask left clear
    for (int c = lane; c < k; c += svt::kWarp) {
      const float v = acc[c];
      out[c] = v;
      psum[c] += v;
      acc[c] = 0.0f;
    }
    for (int j = lane; j < w; j += svt::kWarp) bits[idp_row[j] >> 5] = 0u;
    __syncwarp();
  }

  // the block's sumk and s3 rows: its warps' rows added in warp order
  __syncthreads();
  float* sum_row = a.partial + static_cast<int64_t>(blockIdx.x) * k;
  float* s3_row = a.partial + static_cast<int64_t>(gridDim.x + blockIdx.x) * k;
  for (int c = threadIdx.x; c < k; c += blockDim.x) {
    float s1 = 0.0f, s3 = 0.0f;
    for (int r = 0; r < warps; ++r) {
      s1 += smem[static_cast<int64_t>(r) * warp_floats(k) + k + c];
      s3 += smem[static_cast<int64_t>(r) * warp_floats(k) + 2 * k + c];
    }
    sum_row[c] = s1;
    s3_row[c] = s3;
  }
}

// Warps a block, so that a block's shared memory stays under a quarter of
// the SM's (four blocks an SM at K = 500), or one warp when even that is
// more.
int union_warps(int k) {
  const int64_t per_warp = static_cast<int64_t>(warp_floats(k)) * 4;
  int warps = svt::kBlockThreads / svt::kWarp;
  while (warps > 1 && warps * per_warp > 56 * 1024) warps /= 2;
  return warps;
}

// The kernel for lists of w columns.
using UnionKernel = void (*)(UnionArgs);

UnionKernel union_kernel(int w) {
  if (w <= 1) return sparse_union_kernel<1, 1>;
  if (w <= 2) return sparse_union_kernel<2, 1>;
  if (w <= 4) return sparse_union_kernel<4, 1>;
  if (w <= 8) return sparse_union_kernel<8, 1>;
  if (w <= 16) return sparse_union_kernel<16, 1>;
  if (w <= 32) return sparse_union_kernel<32, 1>;
  if (w <= 64) return sparse_union_kernel<32, 2>;
  return sparse_union_kernel<32, 0>;
}

// Blocks an SM holds of the kernel for (k, w), after raising its shared
// memory limit to what a block of union_warps(k) warps takes.
cudaError_t union_blocks_per_sm(int k, int w, int* per_sm) {
  const int warps = union_warps(k);
  const size_t smem = static_cast<size_t>(warps) * warp_floats(k) * 4;
  const UnionKernel kernel = union_kernel(w);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kernel, warps * svt::kWarp, smem);
}

}  // namespace

// rows (n,K,2) f32: Elogpi and the mean indicators of the sweep before
// side by side; ids (n,W) int32, topvals and topm (n,W) f32; elb0 (K,); the
// seven adjacency arrays; seg_rows scratch of n_segs rows of K, partial of
// 2 * svt::kReduceBlocks rows of K; out: gacc (n,K), sumk (K,), s3 (K,).
extern "C" int svt_sparse_union(
    const float* rows, const int32_t* ids, const float* topvals,
    const float* topm, const float* elb0, const int32_t* rowptr,
    const int32_t* nbr, const int32_t* hub_node, const int32_t* hub_segptr,
    const int32_t* seg_node, const int32_t* seg_begin, const int32_t* seg_end,
    float* seg_rows, float* partial, float* gacc, float* sumk, float* s3,
    int64_t n, int64_t n_hubs, int64_t n_segs, int k, int w, int seg_len,
    cudaStream_t stream) {
  if (k <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  if (w < 1 || w > k) return static_cast<int>(cudaErrorInvalidValue);
  const UnionArgs a{rowptr,
                    nbr,
                    seg_node,
                    seg_begin,
                    seg_end,
                    reinterpret_cast<const float2*>(rows),
                    ids,
                    topvals,
                    topm,
                    elb0,
                    gacc,
                    seg_rows,
                    partial,
                    n,
                    n + n_segs,
                    k,
                    w,
                    seg_len};
  int per_sm = 0;
  cudaError_t err = union_blocks_per_sm(k, w, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // as many blocks as the card holds at once, at most kReduceBlocks (the
  // scratch's rows)
  const int warps = union_warps(k);
  int64_t blocks = (a.n_items + warps - 1) / warps;
  blocks = blocks < int64_t{per_sm} * svt::sm_count()
               ? blocks
               : int64_t{per_sm} * svt::sm_count();
  blocks = blocks < svt::kReduceBlocks ? blocks : svt::kReduceBlocks;
  blocks = blocks > 0 ? blocks : 1;
  const size_t smem = static_cast<size_t>(warps) * warp_floats(k) * 4;
  union_kernel(w)<<<static_cast<unsigned>(blocks), warps * svt::kWarp, smem,
                    stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  svt::launch_combine_segments(seg_rows, hub_node, hub_segptr, gacc, n_hubs,
                               k, stream);
  svt::launch_colsum_partials(partial, static_cast<int>(blocks), k, k, sumk,
                              stream);
  svt::launch_colsum_partials(partial + blocks * k, static_cast<int>(blocks),
                              k, k, s3, stream);
  return static_cast<int>(cudaGetLastError());
}

// What the launch for (k, w) gets of an SM: info[0] registers a thread,
// info[1] bytes of shared memory a warp, info[2] warps an SM.
extern "C" int svt_sparse_union_info(int k, int w, int* info) {
  if (k <= 0 || w < 1 || w > k)
    return static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0;
  cudaError_t err = union_blocks_per_sm(k, w, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, union_kernel(w));
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = warp_floats(k) * 4;
  info[2] = per_sm * union_warps(k);
  return 0;
}
