// Kernel 2: the link-sampling phi pass over the training links.
//
// For every link (p, q):
//   phi = softmax_k(Elogpi[p,k] + Elogpi[q,k] + Elogbeta0[k])
//   gacc[p] += phi,  gacc[q] += phi
// (svinet_tpu/svi/sweep_math.py:46-87, phi_pass with conv=None). The
// gather+softmax half of it is the TPU prototype
// tools/pallas_gather_bench.py:69-183 (pallas_gather_softmax), which had
// to DMA 8-row panels and pick rows with a one-hot matmul because Mosaic
// could not slice a single row; the scatter half was an XLA scatter-add.
//
// What bounds it on an H100: bytes. Elogpi and gacc are (n,K) f32, 2 GB
// each at n=1M, K=500, forty times the 50 MB L2, and the endpoints are
// random, so a gathered 2 KB row is never found in cache: the floor is
// one row from DRAM per gather. A scatter with atomicAdd costs three
// times that (each f32 atomic reads and writes a gacc sector that is not
// in L2), plus a zero-fill of gacc.
//
// What the design does about it: pull, not push. The input is the
// symmetric adjacency (CSR) of the links, so each link is met from both
// ends. The owner of node p keeps Elogpi[p] + Elogbeta0 and the running
// sum of phi in registers (layout <VEC, G, N> of common.cuh: 16-byte
// loads, a part of a warp per row when K is small), walks p's neighbours,
// reads each neighbour row once, keeps the logits in registers so the
// softmax costs one expf per element, and writes gacc[p] once with plain
// stores. Nobody else writes that row: no atomics, no zero-fill (a node
// without links gets zeros), and the result is the same from run to run.
// The price is that phi of a link is computed at both ends: twice the
// arithmetic for a third of the DRAM traffic. The neighbour row of the
// next iteration is loaded before the current one is reduced, so a warp
// keeps two gathers in flight.
//
// Hubs. A node with more than seg_len neighbours would serialise on one
// warp, so its list arrives cut into segments (ops/edges.py). The same
// kernel, launched over the segments, sums each into its own row of a
// scratch buffer, and common.cuh's combine_segments_kernel adds a hub's
// rows in segment order into gacc: still no atomics, still reproducible.
//
// sumk, the column sums of gacc (every link's phi counted at both ends),
// comes out of the register kernel's own launches: each group adds every
// row it writes to a running row of column sums that it keeps in shared
// memory (the groups stride over the nodes, at most common.cuh's
// kReduceBlocks blocks), the block adds its groups' rows in order into one
// scratch row, and colsum_partials_kernel adds the scratch rows of both
// passes (nodes, hub segments) in order. Before, sumk was a PyTorch
// gacc.sum(0): a second read of the 2 GB gacc at n=1M, K=500, 0.755 ms of
// a 48 ms stretch step on an H100 at 700 W (tools/profile_stretch.py).
//
// K above 512 does not fit the register layout and takes
// phi_pull_wide_kernel: one warp per node, an online softmax over
// 32-column chunks (any K, no register array), a second read of the
// neighbour row to form phi, and the running sum kept in the owner's
// gacc row itself (read and written only by the lane that owns the
// column). It moves about twice the bytes of the register kernel. It keeps
// no running column sums: sumk comes from common.cuh's rows_colsum_kernel
// over the gacc rows it wrote (one more read of gacc, in a fixed order).
//
// Kernel 5: the fused phi + s3 pass of -fuse-s3
// (svinet_tpu/svi/sweep_math.py:160-206, fused_phi_s3_pass). The same
// walk also sums the cross-moment of the mean indicators of the sweep
// before, s3[k] = sum over links of mphi[p,k] * mphi[q,k]. The TPU packed
// [Elogpi | mphi] into rows of 2K because a row twice as wide cost it
// little; here bytes bind, so the two arrays stay apart and mphi[q] is
// read only where q > p (the list is ascending), once per link: the
// gathers are 2E rows of Elogpi and E rows of mphi, the same rows that
// kernel 2 followed by kernel 4 (csrc/s3_pass.cu) would read. What the
// fusion saves is the second walk of the adjacency and its launches, not
// row traffic. Its price is registers: the owner's mphi row, the gathered
// one and the running s3 are three more rows in registers, and the groups
// stride over the nodes so that s3 is kept across them and summed across
// blocks by common.cuh's two steps (no atomics). It is a template flag on
// the register kernel; K above 512 has no fused form.
//
// Forms (csrc/phi_pull.cuh holds the kernels, as templates; this file
// instantiates them for f32 rows and csrc/phi_pass_bf16.cu for bf16 rows,
// so that the two build side by side).
//  - T, the type of the gathered rows. Under -bf16 Elogpi (and, for kernel
//    5, mphi) are stored as bf16: the owner's row and every neighbour's row
//    come from the bf16 array, are widened in registers, and logits,
//    softmax and sums are f32 as before; Elogbeta0 and gacc stay f32. A
//    gathered row is 1 KB at K=500 instead of 2 KB. With half the bytes
//    the pass is bound as much by its arithmetic and by how many gathers
//    it keeps in flight as by bytes, so the prefetched row waits packed,
//    as loaded (svt::RawRow: fewer registers, a third block per SM, and no
//    operation that waits for the load before the row's turn), and exp
//    is one ex2.approx.
//  - CONV (-freeze, svinet_tpu/svi/sweep_math.py:46-87, phi_pass with
//    conv): conv[p] > 0 names the column node p is frozen to, plus one. A
//    link with exactly one frozen end gives the one-hot of
//    max(cp, cq) - 1 in place of the softmax, to both ends alike, so
//    sumk = gacc.sum(0) still holds. The owner reads conv[p] once and
//    conv[q] with each neighbour id; for such a link it fetches no row at
//    all. A frozen owner counts its free neighbours and adds the count to
//    its column at the end; a free owner adds 1 at the neighbour's column,
//    a column known only at run time (svt::add_at_column). Kernel 5 has no
//    such form: the JAX engine runs -freeze unfused.

#include "phi_pull.cuh"

extern "C" int svt_phi_pass(const float* elogpi, const float* elb0,
                            const int32_t* conv, const int32_t* rowptr,
                            const int32_t* nbr, const int32_t* hub_node,
                            const int32_t* hub_segptr,
                            const int32_t* seg_node, const int32_t* seg_begin,
                            const int32_t* seg_end, float* partial,
                            float* gacc, float* sumk_partial, float* sumk,
                            int64_t n, int64_t n_hubs, int64_t n_segs, int k,
                            int seg_len, cudaStream_t stream) {
  return svt::phi_pass(elogpi, elb0, conv, rowptr, nbr, hub_node, hub_segptr,
                       seg_node, seg_begin, seg_end, partial, gacc,
                       sumk_partial, sumk, n, n_hubs, n_segs, k, seg_len,
                       stream);
}

// Kernel 5: svt_phi_pass, and s3 (K,) = sum over links of
// mphi[p] * mphi[q] from the same walk. K <= svt::kRegMaxK; s3_partial is
// scratch of 2 * svt::kReduceBlocks rows of K.
extern "C" int svt_phi_s3_pass(const float* elogpi, const float* mphi,
                               const float* elb0, const int32_t* rowptr,
                               const int32_t* nbr, const int32_t* hub_node,
                               const int32_t* hub_segptr,
                               const int32_t* seg_node,
                               const int32_t* seg_begin,
                               const int32_t* seg_end, float* partial,
                               float* gacc, float* sumk_partial, float* sumk,
                               float* s3_partial, float* s3, int64_t n,
                               int64_t n_hubs, int64_t n_segs, int k,
                               int seg_len, cudaStream_t stream) {
  return svt::phi_s3_pass(elogpi, mphi, elb0, rowptr, nbr, hub_node,
                          hub_segptr, seg_node, seg_begin, seg_end, partial,
                          gacc, sumk_partial, sumk, s3_partial, s3, n, n_hubs,
                          n_segs, k, seg_len, stream);
}
