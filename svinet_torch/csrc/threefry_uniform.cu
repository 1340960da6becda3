// Kernel 17: jax.random.uniform(key, (rows, K)) into an f32 buffer, bit for
// bit JAX's (threefry.cuh). LinkSampling's device init draws every padded
// edge block's phi with it from split(PRNGKey(seed), num_blocks)[b], as
// svinet_tpu/svi/linksampling.py:397-406 does; the row normalisation,
// the mask and the adds into both ends' rows stay in PyTorch
// (svi/linksampling.py:init_gamma_from_links_device). It replaces no TPU
// kernel: the JAX function draws the block in XLA.
//
// Element x of the buffer is (bits >> 9 | 1.0f's bits) - 1 of
// threefry2x32(key, (x >> 32, x mod 2^32)). A thread draws four
// consecutive elements and writes them as one 16-byte store where the
// buffer allows it.
//
// What bounds it on an H100: the integer work of threefry2x32-20 (about
// 100 instructions an element: 20 rounds of an add, a funnel shift and a
// xor, and the key schedule) against 4 bytes written an element; at 10^10
// elements (stretch's 19.9M links at K = 500) that is about 1 T integer
// instructions, some 60 ms at the card's 32-bit integer rate.

#include <cstdint>

#include "common.cuh"
#include "threefry.cuh"

namespace {

__global__ void __launch_bounds__(svt::kBlockThreads)
threefry_uniform_kernel(float* __restrict__ out, int64_t total,
                        svt::TfKey key) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x * 4;
  for (int64_t x = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x) * 4;
       x < total; x += step) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = svt::tf_unit(svt::tf_bits(key, static_cast<uint64_t>(x + j)));
    if (x + 4 <= total &&
        (reinterpret_cast<uintptr_t>(out + x) & 15u) == 0) {
      *reinterpret_cast<float4*>(out + x) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
    } else {
      for (int j = 0; j < 4 && x + j < total; ++j) out[x + j] = v[j];
    }
  }
}

}  // namespace

// out (total,) f32 = uniform((k0, k1), (total,)): the flat (rows, K) buffer
extern "C" int svt_threefry_uniform(float* out, int64_t total, int64_t k0,
                                    int64_t k1, cudaStream_t stream) {
  if (total < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0) return 0;
  const int64_t quads = (total + 3) / 4;
  int64_t blocks = (quads + svt::kBlockThreads - 1) / svt::kBlockThreads;
  const int64_t cap = int64_t{svt::sm_count()} * 16;
  if (blocks > cap) blocks = cap;
  threefry_uniform_kernel<<<static_cast<unsigned>(blocks),
                            svt::kBlockThreads, 0, stream>>>(
      out, total,
      svt::TfKey{static_cast<uint32_t>(k0), static_cast<uint32_t>(k1)});
  return static_cast<int>(cudaGetLastError());
}
