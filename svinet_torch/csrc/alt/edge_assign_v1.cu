// NOT PART OF THE LIBRARY. Kernel 9 as PR 8 designed it (a group's next
// link's row held in registers, one row in flight; three reads of each row
// and two expf a value above K = 512), kept so that chip_smoke.py can hold
// the present design in csrc/edge_assign.cu to it bit for bit and time the
// two in one run on one card. Its entry point takes the library's
// arguments.
//
// Kernel 9: the edge assignments of the link-community extraction, once
// per report (svinet_tpu/svi/communities.py:24 _edge_assignments_blocked;
// reference: src/linksampling.cc:668-681). For every training link (p, q):
//   phi = softmax((Elogpi[p] + Elogpi[q]) + Elogbeta[:, 0])
// and its argmax (the first column among equal values, as jnp.argmax and
// torch.max take it) and its max. The (E, K) phi never exists.
//
// The links are walked by their first end, through a CSR of it; a group
// of G lanes (layout <VEC, G, N>) loads Elogpi[p] once and keeps it in
// registers across p's run, and the next link's row is loaded while the
// present one is reduced. K above 512: one warp per item, the rows read
// three times (from the L1 after the first).

#include <math.h>

#include "../common.cuh"

namespace {

struct AssignArgs {
  svt::AdjItems items;
  const float* elogpi;   // (n, k)
  const float* elb0;     // (k,)
  const int32_t* edges;  // (n_edges, 2)
  int32_t* argmax;       // (n_edges,)
  float* maxval;         // (n_edges,)
  int k;
};

// (v, c) of the two with the larger v; of equal v, the smaller c
__device__ __forceinline__ void take_best(float* v, int* c, float ov,
                                          int oc) {
  if (ov > *v || (ov == *v && oc < *c)) {
    *v = ov;
    *c = oc;
  }
}

template <int VEC, int G, int N>
__global__ void __launch_bounds__(svt::kBlockThreads)
edge_assign_kernel(const AssignArgs a) {
  constexpr int L = VEC * N;
  const int lane = threadIdx.x % svt::kWarp;
  const int g = lane % G;
  const unsigned mask = svt::group_mask<G>(lane);
  const int k = a.k;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x / G;
  float b[L], ep[L], x[L], nx[L];
  svt::load_row<VEC, G, N>(a.elb0, k, g, 0.0f, b);
  for (int64_t item = first; item < a.items.n_items; item += step) {
    int64_t p;
    int begin, end;
    if (!svt::adj_item(a.items, item, &p, &begin, &end)) continue;
    if (begin == end) continue;
    svt::load_row<VEC, G, N>(a.elogpi + p * k, k, g, 0.0f, ep);
    int64_t link = a.items.nbr[begin];
    svt::load_row<VEC, G, N>(
        a.elogpi + static_cast<int64_t>(a.edges[2 * link + 1]) * k, k, g,
        0.0f, x);
    for (int j = begin; j < end; ++j) {
      // the next link's row is on its way while this one is reduced
      int64_t next = 0;
      if (j + 1 < end) {
        next = a.items.nbr[j + 1];
        svt::load_row<VEC, G, N>(
            a.elogpi + static_cast<int64_t>(a.edges[2 * next + 1]) * k, k, g,
            0.0f, nx);
      }
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const int c = (g + (i / VEC) * G) * VEC + i % VEC;
        x[i] = c < k ? (ep[i] + x[i]) + b[i] : -INFINITY;
        mx = fmaxf(mx, x[i]);
      }
      mx = svt::group_max<G>(mx, mask);
      // phi_c = e_c / s rises with e_c: the first column of the largest
      // e_c is the first of the largest phi (up to a tie that the division
      // makes), and only that one is divided
      float s = 0.0f, best = -1.0f;
      int col = k;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const int c = (g + (i / VEC) * G) * VEC + i % VEC;
        x[i] = expf(x[i] - mx);
        s += x[i];
        if (c < k && x[i] > best) {
          best = x[i];
          col = c;
        }
      }
      s = svt::group_sum<G>(s, mask);
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(mask, best, off);
        const int oc = __shfl_xor_sync(mask, col, off);
        take_best(&best, &col, ov, oc);
      }
      if (g == 0) {
        a.argmax[link] = col;
        a.maxval[link] = best / s;
      }
#pragma unroll
      for (int i = 0; i < L; ++i) x[i] = nx[i];
      link = next;
    }
  }
}

// any K: one warp per item; each link's rows are read three times
__global__ void __launch_bounds__(svt::kBlockThreads)
edge_assign_wide_kernel(const AssignArgs a) {
  const int lane = threadIdx.x % svt::kWarp;
  const int k = a.k;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) /
      svt::kWarp;
  const int64_t step =
      static_cast<int64_t>(gridDim.x) * blockDim.x / svt::kWarp;
  for (int64_t item = first; item < a.items.n_items; item += step) {
    int64_t p;
    int begin, end;
    if (!svt::adj_item(a.items, item, &p, &begin, &end)) continue;
    const float* rp = a.elogpi + p * k;
    for (int j = begin; j < end; ++j) {
      const int64_t link = a.items.nbr[j];
      const float* rq =
          a.elogpi + static_cast<int64_t>(a.edges[2 * link + 1]) * k;
      float mx = -INFINITY;
      for (int c = lane; c < k; c += svt::kWarp)
        mx = fmaxf(mx, (__ldg(rp + c) + __ldg(rq + c)) + __ldg(a.elb0 + c));
      mx = svt::group_max<svt::kWarp>(mx, svt::kFull);
      float s = 0.0f;
      for (int c = lane; c < k; c += svt::kWarp)
        s += expf((__ldg(rp + c) + __ldg(rq + c)) + __ldg(a.elb0 + c) - mx);
      s = svt::warp_sum(s);
      float best = -1.0f;
      int col = k;
      for (int c = lane; c < k; c += svt::kWarp) {
        const float e =
            expf((__ldg(rp + c) + __ldg(rq + c)) + __ldg(a.elb0 + c) - mx);
        if (e > best) {
          best = e;
          col = c;
        }
      }
#pragma unroll
      for (int off = svt::kWarp / 2; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(svt::kFull, best, off);
        const int oc = __shfl_xor_sync(svt::kFull, col, off);
        take_best(&best, &col, ov, oc);
      }
      if (lane == 0) {
        a.argmax[link] = col;
        a.maxval[link] = best / s;
      }
    }
  }
}

template <class F>
void for_items(const svt::AdjItems& nodes, const svt::AdjItems& segs,
               F&& launch) {
  launch(nodes);
  if (segs.n_items > 0) launch(segs);
}

}  // namespace

// argmax (n_edges,) int32 and maxval (n_edges,) f32 are written for every
// link the CSR lists (rowptr over n nodes, nbr the link ids, hub segments
// seg_*). elogpi (n, k) and elb0 (k,) f32; edges (n_edges, 2) int32.
extern "C" int svt_edge_assign_v1(const float* elogpi, const float* elb0,
                               const int32_t* edges, const int32_t* rowptr,
                               const int32_t* nbr, const int32_t* seg_node,
                               const int32_t* seg_begin,
                               const int32_t* seg_end, int32_t* argmax,
                               float* maxval, int64_t n, int64_t n_segs,
                               int k, int seg_len, cudaStream_t stream) {
  if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const svt::AdjItems nodes{rowptr, nbr, nullptr, nullptr, nullptr, n,
                            seg_len};
  const svt::AdjItems segs{rowptr,  nbr,    seg_node, seg_begin,
                           seg_end, n_segs, seg_len};
  if (k > svt::kRegMaxK) {
    for_items(nodes, segs, [&](const svt::AdjItems& it) {
      const AssignArgs a{it, elogpi, elb0, edges, argmax, maxval, k};
      edge_assign_wide_kernel<<<svt::blocks_for(it.n_items, svt::kWarp),
                                svt::kBlockThreads, 0, stream>>>(a);
    });
    return static_cast<int>(cudaGetLastError());
  }
  const bool aligned =
      k % 4 == 0 && svt::aligned16(elogpi) && svt::aligned16(elb0);
  svt::dispatch_row(k, aligned, [&](auto vec, auto grp, auto cnt) {
    constexpr int VEC = decltype(vec)::value;
    constexpr int G = decltype(grp)::value;
    constexpr int N = decltype(cnt)::value;
    for_items(nodes, segs, [&](const svt::AdjItems& it) {
      const AssignArgs a{it, elogpi, elb0, edges, argmax, maxval, k};
      edge_assign_kernel<VEC, G, N>
          <<<svt::blocks_for(it.n_items, G), svt::kBlockThreads, 0,
             stream>>>(a);
    });
  });
  return static_cast<int>(cudaGetLastError());
}
