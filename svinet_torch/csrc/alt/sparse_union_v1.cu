// NOT PART OF THE LIBRARY. Kernel 7 as first designed, kept so that
// svinet_torch/tools/bench_kernels.py --only sparse can time it beside the
// present csrc/sparse_union.cu in one run on one card: Elogpi and mphi as
// two (n,K) arrays, each value gathered from its own 32-byte sector, and
// mphi[q] read at q's own columns per link; the neighbour's id loaded one
// step ahead and nothing else.
//
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
// What bounds it on an H100: bytes, and how many of them are random. Per
// directed entry the pass reads W single values of the neighbour's Elogpi
// row and the neighbour's W ids and values; per link up to 2W single
// values of the neighbour's mphi row (the s3 half); per node the owner's
// rows once and gacc written once. Random single values cost a 32-byte
// sector each, so the floor is a sector a gathered value; the bound counts
// 4 bytes.
//
// What the design does about it: pull over the adjacency, as kernels 2 and
// 4 do, so that nothing is scattered. A warp owns node p (a hub's list
// comes cut into segments, each summed into its own scratch row and
// combined in segment order by common.cuh's combine_segments_kernel):
//  - p's W columns are set as bits of a K-bit mask in shared memory; a
//    column of q's list is a duplicate exactly when its bit is set, and
//    p's copy is the one kept. No sort.
//  - Elogpi[p, c] for q's columns comes from p's own row (the L1 holds it
//    across p's neighbours); Elogpi[q, c] for p's columns is W single
//    gathers.
//  - phi goes into p's K-wide accumulator in shared memory and is written
//    once, densely, to gacc[p]: nothing in device memory is zero-filled
//    and nothing is atomic. A group of S lanes takes one neighbour, with
//    one slot of p's list and one of q's a lane (several a lane when W is
//    above 32); 32/S neighbours share a warp and add their phi to the
//    accumulator one group after the other, in a fixed order.
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
//    three steps.

#include <math.h>

#include <climits>

#include "../common.cuh"

namespace {

struct UnionArgs {
  // work items 0..n-1 are the nodes (a hub is skipped: its segments are
  // items n..n+n_segs-1)
  const int32_t* rowptr;
  const int32_t* nbr;
  const int32_t* seg_node;
  const int32_t* seg_begin;
  const int32_t* seg_end;
  const float* elogpi;   // (n,K)
  const int32_t* ids;    // (n,W)
  const float* topvals;  // (n,W)
  const float* elb0;     // (K,)
  const float* mphi;     // (n,K) of the sweep before
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

// S lanes a neighbour; NT > 0: slot j = l + S t (t < NT) of each list per
// lane, logits held in registers (W <= S NT); NT = 0: any W, S = 32, the
// logits computed again for each step.
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
    const float* ep = a.elogpi + p * k;
    const float* mp = a.mphi + p * k;
    for (int j = lane; j < w; j += svt::kWarp) {
      const int c = idp_row[j];
      atomicOr(bits + (c >> 5), 1u << (c & 31));  // an OR: order-free
    }
    // this lane's slots of p's list: column, logit part, mphi[p, column]
    int pid[T];
    float ptv[T], pm[T];
    if constexpr (NT > 0) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int j = l + S * t;
        pid[t] = j < w ? idp_row[j] : 0;
        ptv[t] = j < w ? tvp_row[j] : 0.0f;
        pm[t] = j < w ? __ldg(mp + pid[t]) : 0.0f;
      }
    }
    __syncwarp();

    // the neighbour of this group's next entry, loaded a step ahead
    int32_t q_next = begin + grp < end ? a.nbr[begin + grp] : 0;
    for (int base = begin; base < end; base += kGroups) {
      const int e = base + grp;
      const bool live = e < end;  // the same in every lane of the group
      const int64_t q = q_next;
      if (e + kGroups < end) q_next = a.nbr[e + kGroups];
      float m = -INFINITY, denom = 0.0f;
      // the logits (NT > 0), then phi; the q side's column and whether it
      // is kept; mphi[q, column] of both sides for s3
      float lp[T], lq[T], mqp[T], mqq[T];
      int qid[T];
      bool keep[T];
      if (live) {
        const float* eq = a.elogpi + q * k;
        const float* mq = a.mphi + q * k;
        const int32_t* idq_row = a.ids + q * w;
        const float* tvq_row = a.topvals + q * w;
        const bool lower = q > p;
        if constexpr (NT > 0) {
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            const int j = l + S * t;
            if (j < w) {
              lp[t] = (ptv[t] + __ldg(eq + pid[t])) + __ldg(a.elb0 + pid[t]);
              const int c = __ldg(idq_row + j);
              qid[t] = c;
              keep[t] = !((bits[c >> 5] >> (c & 31)) & 1u);
              lq[t] = keep[t] ? (__ldg(ep + c) + __ldg(tvq_row + j)) +
                                    __ldg(a.elb0 + c)
                              : -INFINITY;
              mqp[t] = lower ? __ldg(mq + pid[t]) : 0.0f;
              mqq[t] = lower && keep[t] ? __ldg(mq + c) : 0.0f;
            } else {
              lp[t] = lq[t] = -INFINITY;
              qid[t] = 0;
              keep[t] = false;
              mqp[t] = mqq[t] = 0.0f;
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
        } else {
          // any W: three walks over the slots, the logits computed in each
          for (int j = l; j < w; j += S) {
            const int cp = __ldg(idp_row + j);
            const int c = __ldg(idq_row + j);
            const float vp = (__ldg(tvp_row + j) + __ldg(eq + cp)) +
                             __ldg(a.elb0 + cp);
            m = fmaxf(m, vp);
            if (!((bits[c >> 5] >> (c & 31)) & 1u))
              m = fmaxf(m, (__ldg(ep + c) + __ldg(tvq_row + j)) +
                               __ldg(a.elb0 + c));
          }
          m = svt::group_max<S>(m, gmask);
          float s = 0.0f;
          for (int j = l; j < w; j += S) {
            const int cp = __ldg(idp_row + j);
            const int c = __ldg(idq_row + j);
            s += expf((__ldg(tvp_row + j) + __ldg(eq + cp)) +
                      __ldg(a.elb0 + cp) - m);
            if (!((bits[c >> 5] >> (c & 31)) & 1u))
              s += expf((__ldg(ep + c) + __ldg(tvq_row + j)) +
                        __ldg(a.elb0 + c) - m);
          }
          denom = svt::group_sum<S>(s, gmask);
        }
      }
      // the groups of the warp add to the accumulator one after the other
      for (int turn = 0; turn < kGroups; ++turn) {
        if (turn == grp && live) {
          const bool lower = q > p;
          if constexpr (NT > 0) {
#pragma unroll
            for (int t = 0; t < NT; ++t) {
              if (l + S * t < w) {
                acc[pid[t]] += lp[t] / denom;
                if (lower) ps3[pid[t]] += pm[t] * mqp[t];
                if (keep[t]) {
                  acc[qid[t]] += lq[t] / denom;
                  if (lower) ps3[qid[t]] += __ldg(mp + qid[t]) * mqq[t];
                }
              }
            }
          } else {
            const float* eq = a.elogpi + q * k;
            const float* mq = a.mphi + q * k;
            const int32_t* idq_row = a.ids + q * w;
            const float* tvq_row = a.topvals + q * w;
            for (int j = l; j < w; j += S) {
              const int cp = __ldg(idp_row + j);
              const int c = __ldg(idq_row + j);
              acc[cp] += expf((__ldg(tvp_row + j) + __ldg(eq + cp)) +
                              __ldg(a.elb0 + cp) - m) /
                         denom;
              if (lower) ps3[cp] += __ldg(mp + cp) * __ldg(mq + cp);
              if (!((bits[c >> 5] >> (c & 31)) & 1u)) {
                acc[c] += expf((__ldg(ep + c) + __ldg(tvq_row + j)) +
                               __ldg(a.elb0 + c) - m) /
                          denom;
                if (lower) ps3[c] += __ldg(mp + c) * __ldg(mq + c);
              }
            }
          }
        }
        __syncwarp();
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

// Launch with as many blocks as the card holds at once (at most
// kReduceBlocks, the scratch's rows); their number goes to *blocks_out.
template <int S, int NT>
cudaError_t launch_union(const UnionArgs& a, unsigned* blocks_out,
                         cudaStream_t stream) {
  const int warps = union_warps(a.k);
  const size_t smem = static_cast<size_t>(warps) * warp_floats(a.k) * 4;
  auto kernel = sparse_union_kernel<S, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, warps * svt::kWarp, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int64_t blocks = (a.n_items + warps - 1) / warps;
  blocks = blocks < int64_t{per_sm} * svt::sm_count()
               ? blocks
               : int64_t{per_sm} * svt::sm_count();
  blocks = blocks < svt::kReduceBlocks ? blocks : svt::kReduceBlocks;
  blocks = blocks > 0 ? blocks : 1;
  *blocks_out = static_cast<unsigned>(blocks);
  kernel<<<*blocks_out, warps * svt::kWarp, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// elogpi (n,K), topvals (n,W), elb0 (K,), mphi (n,K) f32; ids (n,W) int32;
// the seven adjacency arrays; seg_rows scratch of n_segs rows of K, partial
// of 2 * svt::kReduceBlocks rows of K; out: gacc (n,K), sumk (K,), s3 (K,).
extern "C" int svt_sparse_union_v1(
    const float* elogpi, const int32_t* ids, const float* topvals,
    const float* elb0, const float* mphi, const int32_t* rowptr,
    const int32_t* nbr, const int32_t* hub_node, const int32_t* hub_segptr,
    const int32_t* seg_node, const int32_t* seg_begin, const int32_t* seg_end,
    float* seg_rows, float* partial, float* gacc, float* sumk, float* s3,
    int64_t n, int64_t n_hubs, int64_t n_segs, int k, int w, int seg_len,
    cudaStream_t stream) {
  if (k <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  if (w < 1 || w > k) return static_cast<int>(cudaErrorInvalidValue);
  const UnionArgs a{rowptr,  nbr,  seg_node, seg_begin, seg_end, elogpi,
                    ids,     topvals, elb0,  mphi,      gacc,    seg_rows,
                    partial, n,    n + n_segs, k,       w,       seg_len};
  unsigned blocks = 0;
  cudaError_t err;
  if (w <= 1)
    err = launch_union<1, 1>(a, &blocks, stream);
  else if (w <= 2)
    err = launch_union<2, 1>(a, &blocks, stream);
  else if (w <= 4)
    err = launch_union<4, 1>(a, &blocks, stream);
  else if (w <= 8)
    err = launch_union<8, 1>(a, &blocks, stream);
  else if (w <= 16)
    err = launch_union<16, 1>(a, &blocks, stream);
  else if (w <= 32)
    err = launch_union<32, 1>(a, &blocks, stream);
  else if (w <= 64)
    err = launch_union<32, 2>(a, &blocks, stream);
  else
    err = launch_union<32, 0>(a, &blocks, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  svt::launch_combine_segments(seg_rows, hub_node, hub_segptr, gacc, n_hubs,
                               k, stream);
  svt::launch_colsum_partials(partial, static_cast<int>(blocks), k, k, sumk,
                              stream);
  svt::launch_colsum_partials(partial + static_cast<int64_t>(blocks) * k,
                              static_cast<int>(blocks), k, k, s3, stream);
  return static_cast<int>(cudaGetLastError());
}
