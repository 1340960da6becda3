// JAX's threefry stream on the card: threefry2x32-20 (Salmon et al.,
// SC'11) and jax.random's bits, uniforms and Gumbel draws, as
// svinet_torch/ops/threefry.py computes them in plain PyTorch (its
// docstring gives JAX's layout). Kernel 16 (gen_pairs.cu) and kernel 17
// (threefry_uniform.cu) include it. The uniforms equal JAX's bit for bit;
// the Gumbel takes logf at full precision (the library is built without
// fast math).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace svt {

struct TfKey {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t tf_rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define SVT_TF_ROUND(r) \
  x0 += x1;             \
  x1 = tf_rotl(x1, r) ^ x0;

// threefry2x32-20 of the counter (c0, c1) under key, in place
__device__ __forceinline__ void threefry2x32(TfKey key, uint32_t& c0,
                                             uint32_t& c1) {
  const uint32_t k2 = key.k0 ^ key.k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + key.k0, x1 = c1 + key.k1;
  SVT_TF_ROUND(13) SVT_TF_ROUND(15) SVT_TF_ROUND(26) SVT_TF_ROUND(6)
  x0 += key.k1;
  x1 += k2 + 1u;
  SVT_TF_ROUND(17) SVT_TF_ROUND(29) SVT_TF_ROUND(16) SVT_TF_ROUND(24)
  x0 += k2;
  x1 += key.k0 + 2u;
  SVT_TF_ROUND(13) SVT_TF_ROUND(15) SVT_TF_ROUND(26) SVT_TF_ROUND(6)
  x0 += key.k0;
  x1 += key.k1 + 3u;
  SVT_TF_ROUND(17) SVT_TF_ROUND(29) SVT_TF_ROUND(16) SVT_TF_ROUND(24)
  x0 += key.k1;
  x1 += k2 + 4u;
  SVT_TF_ROUND(13) SVT_TF_ROUND(15) SVT_TF_ROUND(26) SVT_TF_ROUND(6)
  x0 += k2;
  x1 += key.k0 + 5u;
  c0 = x0;
  c1 = x1;
}

#undef SVT_TF_ROUND

// jax.random.fold_in(key, d)
__device__ __forceinline__ TfKey tf_fold_in(TfKey key, uint32_t d) {
  uint32_t a = 0u, b = d;
  threefry2x32(key, a, b);
  return TfKey{a, b};
}

// jax.random.split(key, m)[i]
__device__ __forceinline__ TfKey tf_split(TfKey key, uint32_t i) {
  return tf_fold_in(key, i);
}

// random_bits(key, shape) at the flat index x
__device__ __forceinline__ uint32_t tf_bits(TfKey key, uint64_t x) {
  uint32_t a = static_cast<uint32_t>(x >> 32), b = static_cast<uint32_t>(x);
  threefry2x32(key, a, b);
  return a ^ b;
}

// jax.random.uniform's float in [0, 1) from its bits
__device__ __forceinline__ float tf_unit(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// uniform(key, shape, minval=tiny, maxval=1) at x, then -log(-log(u)):
// (maxval - minval) is 1.0f in f32, and u + tiny rounds to u unless u is 0
constexpr float kTfTiny = 1.17549435e-38f;

__device__ __forceinline__ float tf_gumbel(TfKey key, uint64_t x) {
  const float u = fmaxf(kTfTiny, tf_unit(tf_bits(key, x)) + kTfTiny);
  return -logf(-logf(u));
}

}  // namespace svt
