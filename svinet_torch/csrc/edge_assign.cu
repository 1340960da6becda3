// Kernel 9: the edge assignments of the link-community extraction, once
// per report (svinet_tpu/svi/communities.py:24 _edge_assignments_blocked;
// reference: src/linksampling.cc:668-681). For every training link (p, q):
//   phi = softmax((Elogpi[p] + Elogpi[q]) + Elogbeta[:, 0])
// and its argmax (the first column among equal values, as jnp.argmax and
// torch.max take it) and its max. The (E, K) phi never exists.
//
// What bounds it on an H100: bytes, the gathered rows. Read as 2E random
// rows that is 79.6 GB at 19,899,599 links of K=500 (23.8 ms at 3.35
// TB/s); walked by first end, E + (nodes with links) rows, 12.5 ms. The
// outputs are 8 bytes a link.
//
// What the design does about it. The links are walked by their first end,
// through a CSR of it (ops/edges.py:owner_csr of the links' first ends:
// each node's run lists its link ids ascending, which are not consecutive
// where the links are in file order, as stretch's are); a node with more
// than seg_len links is cut into segments, each its own item. A group of
// G lanes owns an item, and Elogpi[p] serves p's whole run. The run's link
// ids and far ends come a chunk of G links at a time, lane t loading those
// of link t of the chunk, the next chunk on its way while this one is
// used, so a link's row waits on no index load; the far ends' rows go by
// cp.async into a ring of D rows in shared memory (kDepth), D links ahead
// of the one reduced. PR 8's design (csrc/alt/edge_assign_v1.cu) fetched
// the next row only after two dependent index loads, random ones where the
// links are in file order. Up to K = 512 Elogpi[p], Elogbeta[:, 0] and the
// logits stay in registers in PR 8's layout; above, a warp a link keeps
// Elogpi[p] and Elogbeta[:, 0] in shared memory and writes the logits over
// the ring row, so each row is read once from device memory where PR 8's
// wide form read it three times and took two expf a value. Per link: the
// logits' max, one expf a value, their sum s and the first column of the
// largest, reduced across the group; max phi = e_max / s, the one
// division. phi_c = e_c / s rises with e_c, so that column is the first of
// the largest phi, as the plain version's argmax over phi takes it, except
// where the division rounds two different e_c to one phi (a gap under one
// f32 unit). Lane g owns the columns PR 8's design gave it and sums them in
// the same order with the same butterflies, so the two give the same
// bits.

#include <math.h>

#include "common.cuh"

namespace {

// most threads a block has
constexpr int kAssignThreads = 256;
// rows of a group's ring up to K = 512, and of a warp's above, where each
// row more costs warps an SM: on an H100, 2 and 1 were the fastest of 1-4
// (PERF.md, kernel 9)
constexpr int kDepth = 2;
constexpr int kWideDepth = 1;

struct AssignArgs {
  svt::AdjItems items;
  const float* elogpi;   // (n, k)
  const float* elb0;     // (k,)
  const int32_t* edges;  // (n_edges, 2)
  int32_t* argmax;       // (n_edges,)
  float* maxval;         // (n_edges,)
  int k;
  int kp;                // k rounded up to 4: a row of shared memory
  bool vec16;            // k % 4 == 0 and Elogpi on 16 bytes: 16-byte copies
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// This lane's part of the K-row `src` into the shared row `dst`, by
// cp.async: 16-byte units g, g+G, ... where the rows allow it, else the
// lane's own columns g, g+G, ... by 4 bytes.
template <int G>
__device__ __forceinline__ void copy_row(const AssignArgs& a, float* dst,
                                         const float* src, int g) {
  if (a.vec16) {
    for (int u = g; u < a.k / 4; u += G) cp_async16(dst + 4 * u, src + 4 * u);
  } else {
    for (int c = g; c < a.k; c += G) cp_async4(dst + c, src + c);
  }
}

// link ids and far ends of the chunk of G links from c0: lane g's
__device__ __forceinline__ void load_chunk(const AssignArgs& a, int c0,
                                           int end, int g, int* link,
                                           int* far) {
  *link = 0;
  *far = 0;
  if (c0 + g < end) {
    *link = a.items.nbr[c0 + g];
    *far = a.edges[2 * static_cast<int64_t>(*link) + 1];
  }
}

// (v, c) of the two with the larger v; of equal v, the smaller c
__device__ __forceinline__ void take_best(float* v, int* c, float ov,
                                          int oc) {
  if (ov > *v || (ov == *v && oc < *c)) {
    *v = ov;
    *c = oc;
  }
}

// Above K = 512: a warp a link over single columns (lane g's are g, g+32,
// ..., PR 8's wide form's), Elogbeta[:, 0] in shared memory for the
// block, Elogpi[p] and the ring's D rows for each warp; the logits are
// written over the ring row and read again for their exponentials.
template <int D>
__global__ void __launch_bounds__(kAssignThreads)
edge_assign_wide_kernel(const AssignArgs a) {
  constexpr int G = svt::kWarp;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int gpb = blockDim.x / G;
  const int grp = threadIdx.x / G;
  const int g = threadIdx.x % G;
  const unsigned mask = svt::kFull;
  const int k = a.k, kp = a.kp;
  float* const b = smem;
  for (int c = threadIdx.x; c < k; c += blockDim.x) b[c] = a.elb0[c];
  __syncthreads();
  float* const ep = smem + kp + static_cast<int64_t>(grp) * (D + 1) * kp;
  float* const ring = ep + kp;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * gpb + grp;
  const int64_t step = static_cast<int64_t>(gridDim.x) * gpb;
  for (int64_t item = first; item < a.items.n_items; item += step) {
    int64_t p;
    int begin, end;
    if (!svt::adj_item(a.items, item, &p, &begin, &end)) continue;
    if (begin == end) continue;
    copy_row<G>(a, ep, a.elogpi + p * k, g);
    cp_async_commit();
    int c0 = begin;
    int link_c, far_c, link_n, far_n;
    load_chunk(a, c0, end, g, &link_c, &far_c);
    load_chunk(a, c0 + G, end, g, &link_n, &far_n);
    // the rows of the run's first D links
#pragma unroll
    for (int s = 0; s < D; ++s) {
      const int f = __shfl_sync(mask, far_c, s);
      if (begin + s < end)
        copy_row<G>(a, ring + s * kp, a.elogpi + static_cast<int64_t>(f) * k,
                    g);
      cp_async_commit();
    }
    for (int j = begin; j < end; ++j) {
      const int o = j - c0;
      float* const row = ring + ((j - begin) % D) * kp;
      // Elogpi[p] and this link's row are in (one group of copies a link
      // since); with 16-byte copies the lanes read each other's
      cp_async_wait<D - 1>();
      __syncwarp(mask);
      float mx = -INFINITY;
      for (int c = g; c < k; c += G) {
        const float x = (ep[c] + row[c]) + b[c];
        row[c] = x;
        mx = fmaxf(mx, x);
      }
      mx = svt::group_max<G>(mx, mask);
      // one expf a value: their sum and the first column of the largest
      float s = 0.0f, best = -1.0f;
      int col = k;
      for (int c = g; c < k; c += G) {
        const float e = expf(row[c] - mx);
        s += e;
        if (e > best) {
          best = e;
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
      const int link = __shfl_sync(mask, link_c, o);
      if (g == 0) {
        a.argmax[link] = col;
        a.maxval[link] = best / s;
      }
      // the row of link j + D into the ring row just read (its far end in
      // this chunk or the next), once every lane is done with it
      const int ahead = o + D;
      const int f = __shfl_sync(mask, ahead < G ? far_c : far_n, ahead % G);
      __syncwarp(mask);
      if (j + D < end)
        copy_row<G>(a, row, a.elogpi + static_cast<int64_t>(f) * k, g);
      cp_async_commit();
      if (o == G - 1) {
        c0 += G;
        link_c = link_n;
        far_c = far_n;
        load_chunk(a, c0 + G, end, g, &link_n, &far_n);
      }
    }
  }
  cp_async_wait<0>();
}

// Up to K = 512: Elogpi[p], Elogbeta[:, 0] and the logits in registers in
// PR 8's layout <VEC, G, N> (common.cuh), as PR 8's design held them; only
// the ring of D rows is in shared memory. With units of 4 each lane copies
// and reads its own units of a row.
template <int VEC, int G, int N, int D>
__global__ void __launch_bounds__(kAssignThreads)
edge_assign_kernel(const AssignArgs a) {
  static_assert(D <= G, "a link's far end is at most a chunk ahead");
  constexpr int L = VEC * N;
  extern __shared__ float4 smem4[];
  const int gpb = blockDim.x / G;
  const int grp = threadIdx.x / G;
  const int g = threadIdx.x % G;
  const unsigned mask = svt::group_mask<G>(threadIdx.x % svt::kWarp);
  const int k = a.k, kp = a.kp;
  // single columns copied 16 bytes at a time: the lanes read each other's
  const bool cross = VEC == 1 && a.vec16;
  float* const ring =
      reinterpret_cast<float*>(smem4) + static_cast<int64_t>(grp) * D * kp;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * gpb + grp;
  const int64_t step = static_cast<int64_t>(gridDim.x) * gpb;
  float b[L], ep[L], x[L];
  svt::load_row<VEC, G, N>(a.elb0, k, g, 0.0f, b);
  for (int64_t item = first; item < a.items.n_items; item += step) {
    int64_t p;
    int begin, end;
    if (!svt::adj_item(a.items, item, &p, &begin, &end)) continue;
    if (begin == end) continue;
    int c0 = begin;
    int link_c, far_c, link_n, far_n;
    load_chunk(a, c0, end, g, &link_c, &far_c);
    load_chunk(a, c0 + G, end, g, &link_n, &far_n);
#pragma unroll
    for (int s = 0; s < D; ++s) {
      const int f = __shfl_sync(mask, far_c, s, G);
      if (begin + s < end)
        copy_row<G>(a, ring + s * kp, a.elogpi + static_cast<int64_t>(f) * k,
                    g);
      cp_async_commit();
    }
    // Elogpi[p] into registers while the first rows are on their way
    svt::load_row<VEC, G, N>(a.elogpi + p * k, k, g, 0.0f, ep);
    for (int j = begin; j < end; ++j) {
      const int o = j - c0;
      float* const row = ring + ((j - begin) % D) * kp;
      cp_async_wait<D - 1>();
      if (cross) __syncwarp(mask);
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const int c = (g + (i / VEC) * G) * VEC + i % VEC;
        x[i] = c < k ? (ep[i] + row[c]) + b[i] : -INFINITY;
        mx = fmaxf(mx, x[i]);
      }
      // the row is in registers: the row of link j + D takes its place
      // (its far end in this chunk or the next)
      const int ahead = o + D;
      const int f =
          __shfl_sync(mask, ahead < G ? far_c : far_n, ahead & (G - 1), G);
      if (cross) __syncwarp(mask);
      if (j + D < end)
        copy_row<G>(a, row, a.elogpi + static_cast<int64_t>(f) * k, g);
      cp_async_commit();
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
      const int link = __shfl_sync(mask, link_c, o, G);
      if (g == 0) {
        a.argmax[link] = col;
        a.maxval[link] = best / s;
      }
      if (o == G - 1) {
        c0 += G;
        link_c = link_n;
        far_c = far_n;
        load_chunk(a, c0 + G, end, g, &link_n, &far_n);
      }
    }
  }
  cp_async_wait<0>();
}

// One launch over `items` (nodes, or hub segments): as many blocks as the
// card holds at once, each as many groups of G lanes as 256 threads and
// the shared memory allow, `group_rows` K-rows a group and `block_rows`
// more a block.
cudaError_t launch_assign(void (*kernel)(AssignArgs), const AssignArgs& a,
                          int G, int group_rows, int block_rows,
                          cudaStream_t stream) {
  if (a.items.n_items == 0) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int64_t row_bytes = int64_t{4} * a.kp;
  const int64_t group_bytes = group_rows * row_bytes;
  int64_t gpb = (optin - block_rows * row_bytes) / group_bytes;
  gpb = gpb < kAssignThreads / G ? gpb : kAssignThreads / G;
  if (gpb < 1) return cudaErrorInvalidConfiguration;
  const int64_t bytes = block_rows * row_bytes + gpb * group_bytes;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int threads = static_cast<int>(gpb) * G;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int64_t blocks = (a.items.n_items + gpb - 1) / gpb;
  const int64_t card = int64_t{per_sm} * svt::sm_count();
  blocks = blocks < card ? blocks : card;
  kernel<<<static_cast<unsigned>(blocks), threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// argmax (n_edges,) int32 and maxval (n_edges,) f32 are written for every
// link the CSR lists (rowptr over n nodes, nbr the link ids, hub segments
// seg_*). elogpi (n, k) and elb0 (k,) f32; edges (n_edges, 2) int32.
extern "C" int svt_edge_assign(const float* elogpi, const float* elb0,
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
  const bool vec16 = k % 4 == 0 && svt::aligned16(elogpi);
  // PR 8's register layout took units of 4 where elb0 was on 16 bytes too
  const bool aligned = vec16 && svt::aligned16(elb0);
  const int kp = (k + 3) / 4 * 4;
  // every node, then the hubs' segments
  auto run = [&](void (*kernel)(AssignArgs), int G, int group_rows,
                 int block_rows) {
    for (const svt::AdjItems* it : {&nodes, &segs}) {
      const AssignArgs a{*it, elogpi, elb0, edges, argmax, maxval, k, kp,
                         vec16};
      const cudaError_t e =
          launch_assign(kernel, a, G, group_rows, block_rows, stream);
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  };
  cudaError_t err = cudaSuccess;
  if (k <= svt::kRegMaxK) {
    // a ring of at most G rows: a link's far end is at most a chunk ahead
    svt::dispatch_row(k, aligned, [&](auto vec, auto grp, auto cnt) {
      constexpr int VEC = decltype(vec)::value;
      constexpr int G = decltype(grp)::value;
      constexpr int N = decltype(cnt)::value;
      constexpr int D = kDepth < G ? kDepth : G;
      err = run(edge_assign_kernel<VEC, G, N, D>, G, D, 0);
    });
  } else {
    err = run(edge_assign_wide_kernel<kWideDepth>, svt::kWarp,
              kWideDepth + 1, 1);
  }
  return static_cast<int>(err);
}
