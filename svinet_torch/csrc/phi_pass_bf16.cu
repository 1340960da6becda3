// Kernels 2 and 5 over bf16 rows (-bf16): the templates of
// csrc/phi_pull.cuh with T = bf16; csrc/phi_pass.cu describes the design
// and holds the f32 entry points. Elogpi (n,K) and mphi (n,K) are bf16
// here; Elogbeta0, gacc and s3 are f32.

#include "phi_pull.cuh"

extern "C" int svt_phi_pass_bf16(const void* elogpi, const float* elb0,
                                 const int32_t* conv, const int32_t* rowptr,
                                 const int32_t* nbr, const int32_t* hub_node,
                                 const int32_t* hub_segptr,
                                 const int32_t* seg_node,
                                 const int32_t* seg_begin,
                                 const int32_t* seg_end, float* partial,
                                 float* gacc, float* sumk_partial,
                                 float* sumk, int64_t n, int64_t n_hubs,
                                 int64_t n_segs, int k, int seg_len,
                                 cudaStream_t stream) {
  return svt::phi_pass(static_cast<const svt::bf16*>(elogpi), elb0, conv,
                       rowptr, nbr, hub_node, hub_segptr, seg_node, seg_begin,
                       seg_end, partial, gacc, sumk_partial, sumk, n, n_hubs,
                       n_segs, k, seg_len, stream);
}

extern "C" int svt_phi_s3_pass_bf16(
    const void* elogpi, const void* mphi, const float* elb0,
    const int32_t* rowptr, const int32_t* nbr, const int32_t* hub_node,
    const int32_t* hub_segptr, const int32_t* seg_node,
    const int32_t* seg_begin, const int32_t* seg_end, float* partial,
    float* gacc, float* sumk_partial, float* sumk, float* s3_partial,
    float* s3, int64_t n, int64_t n_hubs, int64_t n_segs, int k, int seg_len,
    cudaStream_t stream) {
  return svt::phi_s3_pass(static_cast<const svt::bf16*>(elogpi),
                          static_cast<const svt::bf16*>(mphi), elb0, rowptr,
                          nbr, hub_node, hub_segptr, seg_node, seg_begin,
                          seg_end, partial, gacc, sumk_partial, sumk,
                          s3_partial, s3, n, n_hubs, n_segs, k, seg_len,
                          stream);
}
