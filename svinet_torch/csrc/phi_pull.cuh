// Kernels 2 and 5 as templates over the type T of the gathered rows (f32
// or bf16); csrc/phi_pass.cu describes the design and instantiates T =
// float, csrc/phi_pass_bf16.cu T = bf16. Everything here has internal
// linkage, so the two translation units share no symbol.
#pragma once

#include <math.h>

#include "common.cuh"

namespace svt {
namespace {

template <class T>
struct PhiArgs {
  AdjItems items;
  const T* elogpi;
  const float* elb0;
  float* out;          // gacc (n,K), or the scratch rows (n_segs,K)
  int k;
  // -freeze only: (n,) 0 = free, else frozen column + 1; null otherwise
  const int32_t* conv;
  // kernel 5 only
  const T* mphi;       // (n,K) mean indicators of the sweep before
  float* s3_partial;   // (blocks,K) scratch for the column sums of s3
  // (blocks,K) scratch for the column sums of the rows written to `out`:
  // sumk, added across blocks by colsum_partials_kernel
  float* sumk_partial;
};

// Whether exp is one ex2.approx of a scaled argument (__expf) in place of
// expf. __expf(x) is off by up to 2 + floor(|1.4427 x|) ulp of its result;
// its argument here is a logit less the row's largest, so the result is at
// most 1 and the error of a term of phi stays under 3e-7 whatever x is (the
// ulp shrinks with e^x faster than their number grows). bf16 rows have
// rounded every logit to 8 bits already, and with half the bytes to wait
// for, the arithmetic is what is left to shorten. f32 rows keep expf.
// SVT_EXACT_EXP is set by tools/bench_kernels.py alone, which builds this
// file a second time with expf to time the two beside each other.
#ifdef SVT_EXACT_EXP
template <class T>
constexpr bool kFastExp = false;
#else
template <class T>
constexpr bool kFastExp = std::is_same<T, bf16>::value;
#endif

// FUSED = false is kernel 2; FUSED = true is kernel 5, which also sums
// mphi[p] * mphi[q] over the links it meets from their lower end. CONV is
// kernel 2's -freeze form. The groups stride over the items, and each adds
// the row it writes to its running column sums (sumk) in shared memory.
template <int VEC, int G, int N, bool FUSED, bool CONV, class T>
__global__ void __launch_bounds__(kBlockThreads)
phi_pull_kernel(const PhiArgs<T> a) {
  static_assert(!(FUSED && CONV), "the fused pass has no -freeze form");
  constexpr int L = VEC * N;
  constexpr int LF = FUSED ? L : 1;
  const int lane = threadIdx.x % kWarp;
  const int g = lane % G;
  const unsigned mask = group_mask<G>(lane);
  const int k = a.k;
  const int32_t* nbr = a.items.nbr;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x / G;
  __shared__ float sumk_smem[kBlockThreads * L];
  smem_row_zero<VEC, G, N>(sumk_smem);

  float base[L], acc[L], x[L];
  float own[LF], s3[LF];
  // neighbour rows as loaded (see RawRow): the one being reduced, the next
  // one, and for kernel 5 the mphi row that goes with the first
  RawRow<VEC, N, T> cur, nxt = {}, other;
#pragma unroll
  for (int i = 0; i < LF; ++i) s3[i] = 0.0f;

  // item, p, begin and end are the same in every lane of a group, so the
  // group takes each branch below together
  for (int64_t item = first; item < a.items.n_items; item += step) {
    int64_t p;
    int begin, end;
    if (!adj_item(a.items, item, &p, &begin, &end)) continue;

    // base = Elogpi[p] + Elogbeta0; columns past K hold -inf, so their
    // logits never win the max and their exp is 0. A column that a
    // compacted sweep pads out carries Elogbeta0 = -1e30: finite, so no
    // inf - inf, and far enough below any real logit that its exp is 0.
    load_row<VEC, G, N>(a.elogpi + p * k, k, g, -INFINITY, base);
    load_row<VEC, G, N>(a.elb0, k, g, 0.0f, x);
#pragma unroll
    for (int i = 0; i < L; ++i) {
      base[i] += x[i];
      acc[i] = 0.0f;
    }
    if constexpr (FUSED)
      load_row<VEC, G, N>(a.mphi + p * k, k, g, 0.0f, own);
    int cp = 0;
    int free_nbrs = 0;  // frozen owner: neighbours that give its one-hot
    if constexpr (CONV) cp = a.conv[p];

    // G neighbour ids at a time, one per lane, handed round by shuffle
    for (int chunk = begin; chunk < end; chunk += G) {
      const int cnt = min(G, end - chunk);
      const int mine = g < cnt ? nbr[chunk + g] : 0;
      int mine_c = 0;
      if constexpr (CONV) {
        if (g < cnt) mine_c = a.conv[mine];
      }
      int64_t q = __shfl_sync(mask, mine, 0, G);
      int cq = CONV ? __shfl_sync(mask, mine_c, 0, G) : 0;
      // both ends frozen or both free: the softmax of the two rows
      bool soft = (cp > 0) == (cq > 0);
      if (!CONV || soft) load_raw<VEC, G, N>(a.elogpi + q * k, k, g, cur);
      for (int j = 0; j < cnt; ++j) {
        bool upper = false;  // q > p: the link's lower end is here
        if constexpr (FUSED) {
          upper = q > p;
          // in flight while the softmax below is computed
          if (upper) load_raw<VEC, G, N>(a.mphi + q * k, k, g, other);
        }
        bool soft_n = false;
        int cq_n = 0;
        if (j + 1 < cnt) {  // uniform across the group
          q = __shfl_sync(mask, mine, j + 1, G);
          if constexpr (CONV) cq_n = __shfl_sync(mask, mine_c, j + 1, G);
          soft_n = (cp > 0) == (cq_n > 0);
          if (!CONV || soft_n)
            load_raw<VEC, G, N>(a.elogpi + q * k, k, g, nxt);
        }
        if (!CONV || soft) {
          float m = -INFINITY;
#pragma unroll
          for (int i = 0; i < L; ++i) {
            x[i] = cur.at(i) + base[i];
            m = fmaxf(m, x[i]);
          }
          m = group_max<G>(m, mask);
          float s = 0.0f;
#pragma unroll
          for (int i = 0; i < L; ++i) {
            x[i] = kFastExp<T> ? __expf(x[i] - m) : expf(x[i] - m);
            s += x[i];
          }
          const float inv = 1.0f / group_sum<G>(s, mask);
#pragma unroll
          for (int i = 0; i < L; ++i) acc[i] = fmaf(x[i], inv, acc[i]);
        } else if (cp > 0) {
          ++free_nbrs;
        } else {
          add_at_column<VEC, G, N>(acc, cq - 1, g, 1.0f);
        }
        cur = nxt;
        soft = soft_n;
        cq = cq_n;
        if constexpr (FUSED) {
          if (upper) {
#pragma unroll
            for (int i = 0; i < L; ++i)
              s3[i] = fmaf(own[i], other.at(i), s3[i]);
          }
        }
      }
    }
    if constexpr (CONV) {
      if (free_nbrs > 0)
        add_at_column<VEC, G, N>(acc, cp - 1, g,
                                 static_cast<float>(free_nbrs));
    }
    store_row<VEC, G, N>(a.out + item * k, k, g, acc);
    smem_row_add<VEC, G, N>(acc, sumk_smem);
  }
  smem_colsum_write<VEC, G, N>(
      k, sumk_smem, a.sumk_partial + static_cast<int64_t>(blockIdx.x) * k);
  if constexpr (FUSED) {
    __shared__ float smem[kBlockThreads * L];
    block_colsum<VEC, G, N>(
        s3, k, smem, a.s3_partial + static_cast<int64_t>(blockIdx.x) * k);
  }
}

// Any K: one warp per item, nothing held per column.
template <bool CONV, class T>
__global__ void __launch_bounds__(kBlockThreads)
phi_pull_wide_kernel(const PhiArgs<T> a) {
  const int lane = threadIdx.x % kWarp;
  const int64_t item =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  if (item >= a.items.n_items) return;
  int64_t p;
  int begin, end;
  if (!adj_item(a.items, item, &p, &begin, &end)) return;
  const int k = a.k;
  const T* rp = a.elogpi + p * k;
  float* orow = a.out + item * k;
  // the running sum lives in the owner's row itself, so it starts at 0
  // here when the first neighbour might not write every column
  if (begin == end || CONV)
    for (int c = lane; c < k; c += kWarp) orow[c] = 0.0f;
  const int cp = CONV ? a.conv[p] : 0;

  for (int i = begin; i < end; ++i) {
    const int64_t q = a.items.nbr[i];
    if constexpr (CONV) {
      const int cq = a.conv[q];
      if ((cp > 0) != (cq > 0)) {
        // one frozen end: the one-hot of its column; column c is always
        // lane c % 32's
        const int c = max(cp, cq) - 1;
        if (lane == c % kWarp) orow[c] += 1.0f;
        continue;
      }
    }
    const T* rq = a.elogpi + q * k;
    // pass 1: per-lane online softmax over columns lane, lane+32, ...
    float m = -INFINITY;
    float s = 0.0f;
    for (int c = lane; c < k; c += kWarp) {
      const float v = load_scalar(rp + c) + load_scalar(rq + c) + a.elb0[c];
      if (v > m) {
        s = s * expf(m - v) + 1.0f;  // expf(-inf) = 0 on the first column
        m = v;
      } else {
        s += expf(v - m);
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(kFull, m, off);
      const float so = __shfl_xor_sync(kFull, s, off);
      const float mn = fmaxf(m, mo);
      s = s * expf(m - mn) + so * expf(mo - mn);  // K > 512: no lane is empty
      m = mn;
    }
    // pass 2: phi into the owner's row; column c is always lane c % 32's
    const float inv = 1.0f / s;
    for (int c = lane; c < k; c += kWarp) {
      const float phi =
          expf(load_scalar(rp + c) + load_scalar(rq + c) + a.elb0[c] - m) *
          inv;
      orow[c] = (!CONV && i == begin) ? phi : orow[c] + phi;
    }
  }
}

// Launch over a.items; with `fused`, kernel 5 (K <= kRegMaxK only). Returns
// the number of blocks of the register kernel, which is the number of sumk
// (and, for kernel 5, s3) scratch rows written; 0 for the wide kernel.
template <class T>
unsigned launch_pull(const PhiArgs<T>& a, bool fused, cudaStream_t stream) {
  unsigned blocks = 0;
  if (a.items.n_items == 0) return blocks;
  const bool conv = a.conv != nullptr;
  if (a.k > kRegMaxK) {
    // no scratch rows: launch_phi sums the written rows afterwards
    const unsigned wide_blocks = blocks_for(a.items.n_items, kWarp);
    if (conv)
      phi_pull_wide_kernel<true, T>
          <<<wide_blocks, kBlockThreads, 0, stream>>>(a);
    else
      phi_pull_wide_kernel<false, T>
          <<<wide_blocks, kBlockThreads, 0, stream>>>(a);
    return 0;
  }
  const bool aligned = a.k % 4 == 0 && aligned_unit(a.elogpi) &&
                       aligned16(a.elb0) && aligned16(a.out) &&
                       aligned_unit(a.mphi);
  dispatch_row(a.k, aligned, [&](auto vec, auto grp, auto cnt) {
    constexpr int VEC = decltype(vec)::value;
    constexpr int G = decltype(grp)::value;
    constexpr int N = decltype(cnt)::value;
    blocks = reduce_blocks_for(a.items.n_items, G);
    if (fused) {
      phi_pull_kernel<VEC, G, N, true, false, T>
          <<<blocks, kBlockThreads, 0, stream>>>(a);
    } else {
      if (conv)
        phi_pull_kernel<VEC, G, N, false, true, T>
            <<<blocks, kBlockThreads, 0, stream>>>(a);
      else
        phi_pull_kernel<VEC, G, N, false, false, T>
            <<<blocks, kBlockThreads, 0, stream>>>(a);
    }
  });
  return blocks;
}

// The pass over nodes, the pass over hub segments, the hubs' combine and
// sumk from the scratch rows of both passes. Returns the number of scratch
// rows written (for kernel 5, of s3's too).
template <class T>
unsigned launch_phi(PhiArgs<T> a, bool fused, const int32_t* hub_node,
                    const int32_t* hub_segptr, const int32_t* seg_node,
                    const int32_t* seg_begin, const int32_t* seg_end,
                    float* partial, float* sumk, int64_t n_hubs,
                    int64_t n_segs, cudaStream_t stream) {
  float* gacc = a.out;
  float* sumk_partial = a.sumk_partial;
  const int64_t n = a.items.n_items;
  unsigned rows = launch_pull(a, fused, stream);
  if (n_segs > 0) {
    a.items.seg_node = seg_node;
    a.items.seg_begin = seg_begin;
    a.items.seg_end = seg_end;
    a.items.n_items = n_segs;
    a.out = partial;
    a.sumk_partial += static_cast<int64_t>(rows) * a.k;
    if (fused) a.s3_partial += static_cast<int64_t>(rows) * a.k;
    rows += launch_pull(a, fused, stream);
    launch_combine_segments(partial, hub_node, hub_segptr, gacc, n_hubs, a.k,
                            stream);
  }
  // the wide kernel keeps no row of sums: sumk from the gacc it wrote
  if (a.k > kRegMaxK)
    rows = launch_rows_colsum(gacc, n, a.k, sumk_partial, stream);
  launch_colsum_partials(sumk_partial, static_cast<int>(rows), a.k, a.k, sumk,
                         stream);
  return rows;
}

// Kernel 2. elogpi (n,K) of type T, elb0 (K,), gacc (n,K) and sumk (K,)
// f32; conv (n,) int32 or null; partial is scratch of n_segs rows of K,
// sumk_partial of 2 * kReduceBlocks rows of K.
template <class T>
int phi_pass(const T* elogpi, const float* elb0, const int32_t* conv,
             const int32_t* rowptr, const int32_t* nbr,
             const int32_t* hub_node, const int32_t* hub_segptr,
             const int32_t* seg_node, const int32_t* seg_begin,
             const int32_t* seg_end, float* partial, float* gacc,
             float* sumk_partial, float* sumk, int64_t n, int64_t n_hubs,
             int64_t n_segs, int k, int seg_len, cudaStream_t stream) {
  if (k <= 0) return static_cast<int>(cudaGetLastError());
  const PhiArgs<T> a{{rowptr, nbr, nullptr, nullptr, nullptr, n, seg_len},
                     elogpi, elb0, gacc, k, conv, nullptr, nullptr,
                     sumk_partial};
  launch_phi(a, false, hub_node, hub_segptr, seg_node, seg_begin, seg_end,
             partial, sumk, n_hubs, n_segs, stream);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 5. As phi_pass without conv, and s3 (K,) f32 from mphi (n,K) of
// type T; s3_partial is scratch of 2 * kReduceBlocks rows of K.
template <class T>
int phi_s3_pass(const T* elogpi, const T* mphi, const float* elb0,
                const int32_t* rowptr, const int32_t* nbr,
                const int32_t* hub_node, const int32_t* hub_segptr,
                const int32_t* seg_node, const int32_t* seg_begin,
                const int32_t* seg_end, float* partial, float* gacc,
                float* sumk_partial, float* sumk, float* s3_partial, float* s3,
                int64_t n, int64_t n_hubs, int64_t n_segs, int k, int seg_len,
                cudaStream_t stream) {
  if (k <= 0) return static_cast<int>(cudaGetLastError());
  if (k > kRegMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const PhiArgs<T> a{{rowptr, nbr, nullptr, nullptr, nullptr, n, seg_len},
                     elogpi, elb0, gacc, k, nullptr, mphi, s3_partial,
                     sumk_partial};
  const unsigned rows =
      launch_phi(a, true, hub_node, hub_segptr, seg_node, seg_begin, seg_end,
                 partial, sumk, n_hubs, n_segs, stream);
  launch_colsum_partials(s3_partial, static_cast<int>(rows), k, k, s3, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace svt
