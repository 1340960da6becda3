"""JAX's threefry random stream, without JAX: threefry2x32-20 (Salmon et
al., SC'11, the paper of Philox) and jax.random's key handling, uniforms
and Gumbel draws, as the JAX package's two draws take them (the generator's
pair draw, svinet_tpu/svi/gen.py:45-82, and LinkSampling's device init,
svinet_tpu/svi/linksampling.py:387-411). With jax_threefry_partitionable
on (JAX's default) and 64-bit types off (the JAX package's setting):

- a key is two 32-bit words (k0, k1); PRNGKey(seed) is (0, seed mod 2^32):
  the seed is cut to 32 bits first, so its high word is 0;
- fold_in(key, d) is threefry2x32(key, (0, d)); split(key, m)[i] is
  threefry2x32(key, (0, i));
- random_bits(key, shape) at flat index x is b1 ^ b2 of
  threefry2x32(key, (x >> 32, x mod 2^32));
- uniform(key, shape, minval, maxval) takes those bits, makes the float
  (bits >> 9 | 0x3f800000) - 1 in [0, 1), then f * (maxval - minval) +
  minval in f32, floored at minval;
- gumbel(key, shape) is -log(-log(uniform(minval=tiny))) (tiny the
  smallest normal f32), and categorical(key, logits) the first index of the
  largest gumbel + logits over the last axis.

Everything up to the uniforms is integer arithmetic and equals JAX's bit
for bit. A Gumbel is the correctly rounded -log(-log(u)) on the CPU
(gumbel_of) and logf's on the card; JAX's are XLA's logs, so a draw may
differ from JAX's in its last bits (within 1e-6), and a category only
where two scores tie that closely.

All functions work on int64 tensors holding 32-bit values (or Python
ints); csrc/threefry.cuh computes the same on the card. Kernel 17
(csrc/threefry_uniform.cu, uniform_rows) fills a (rows, K) f32 buffer with
uniform(key, (rows, K)).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from svinet_torch.kernels import build

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3F800000
TINY = float(torch.finfo(torch.float32).tiny)

Key = Tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, c0, c1):
    """threefry2x32-20 of the counter words (c0, c1) under the key (k0, k1),
    as jax's threefry2x32 primitive computes it: five groups of four
    rounds (add, rotate, xor), the key schedule injected after each."""
    ks = (k0 & MASK32, k1 & MASK32, (k0 ^ k1 ^ _PARITY) & MASK32)
    x0 = (c0 + ks[0]) & MASK32
    x1 = (c1 + ks[1]) & MASK32
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & MASK32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & MASK32
    return x0, x1


def prng_key(seed: int) -> Key:
    """jax.random.PRNGKey(seed) with 64-bit types off: (0, seed mod 2^32)."""
    return 0, int(seed) & MASK32


def fold_in(key: Key, d: int) -> Key:
    """jax.random.fold_in(key, d): threefry2x32(key, (0, d))."""
    x0, x1 = threefry2x32(key[0], key[1], 0, int(d) & MASK32)
    return int(x0), int(x1)


def split(key: Key, m: int) -> torch.Tensor:
    """jax.random.split(key, m): (m, 2) int64, row i threefry2x32(key,
    (0, i))."""
    i = torch.arange(m, dtype=torch.int64)
    x0, x1 = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return torch.stack([x0, x1], 1)


def split_keys(key: Key, m: int) -> list:
    """split(key, m) as a list of m (k0, k1) keys."""
    return [(int(a), int(b)) for a, b in split(key, m).tolist()]


def bits_at(key: Key, index: torch.Tensor) -> torch.Tensor:
    """random_bits of key at the flat indices `index` (int64): b1 ^ b2 of
    threefry2x32(key, (index >> 32, index mod 2^32)), int64."""
    b1, b2 = threefry2x32(key[0], key[1], index >> 32, index & MASK32)
    return b1 ^ b2


def random_bits(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """jax.random.bits(key, shape) (uint32 values in int64)."""
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return bits_at(key, idx).reshape(tuple(shape))


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """jax.random.uniform's float from its bits: (bits >> 9 | 1.0's bits)
    as f32, minus 1, times (maxval - minval), plus minval, floored at
    minval, every step in f32."""
    f = ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def uniform_at(key: Key, index: torch.Tensor, minval: float = 0.0,
               maxval: float = 1.0) -> torch.Tensor:
    """uniform(key, shape, minval, maxval) at the flat indices `index`."""
    return uniform_from_bits(bits_at(key, index), minval, maxval)


def uniform(key: Key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval)."""
    return uniform_from_bits(random_bits(key, shape, device), minval, maxval)


def gumbel_of(u: torch.Tensor) -> torch.Tensor:
    """-log(-log(u)) of f32 uniforms, f32. On the CPU both logs are taken
    in float64 and the result rounded once to f32: the draw is then the
    correctly rounded Gumbel of its uniform (float64's error, about 1e-16,
    moves the rounding only at a tie), whatever path the CPU's f32 log
    would take through its vector code and threads. On the card logf, as
    kernel 16 takes it (csrc/threefry.cuh)."""
    if u.device.type == "cpu":
        return (-torch.log(-torch.log(u.double()))).float()
    return -torch.log(-torch.log(u))


def gumbel_at(key: Key, index: torch.Tensor) -> torch.Tensor:
    """gumbel(key, shape) at the flat indices `index`."""
    return gumbel_of(uniform_at(key, index, TINY, 1.0))


def gumbel(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """jax.random.gumbel(key, shape, float32) (mode "low", JAX's
    default): -log(-log(uniform(minval=tiny)))."""
    return gumbel_of(uniform(key, shape, TINY, 1.0, device))


def uniform_rows_plain(key: Key, out: torch.Tensor) -> torch.Tensor:
    """Kernel 17 in plain PyTorch: out (rows, K) f32 = uniform(key, (rows,
    K))."""
    rows, k = out.shape
    return out.copy_(uniform(key, (rows, k), device=out.device))


def uniform_rows(key: Key, out: torch.Tensor) -> torch.Tensor:
    """Kernel 17 (csrc/threefry_uniform.cu) on a CUDA tensor,
    uniform_rows_plain on a CPU tensor: out (rows, K) f32, contiguous,
    filled with uniform(key, (rows, K)), bit for bit JAX's."""
    if out.device.type == "cpu":
        return uniform_rows_plain(key, out)
    build.require_cuda(out, "uniform_rows")
    rows, k = out.shape
    build.check_cuda(out, "out", torch.float32, (rows, k), out.device)
    build.launch("svt_threefry_uniform", out.device, out.data_ptr(),
                 rows * k, int(key[0]) & MASK32, int(key[1]) & MASK32)
    build.count_launch(uniform_rows, "f32")
    return out


uniform_rows.launches = 0
uniform_rows.forms = {}
