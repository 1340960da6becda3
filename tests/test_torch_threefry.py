"""svinet_torch/ops/threefry.py, JAX's threefry stream without JAX,
against jax.random on the CPU: the keys, fold_in, split, the bits and the
uniforms bit for bit, the Gumbel draws within 2e-6 (each side compared
with the float64 Gumbel of the same uniforms first), and the port's CPU
Gumbels the float64 value rounded once."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng

from svinet_torch.ops import threefry as tf

SEEDS = (0, 11, 2**31 + 5)
SHAPES = ((1,), (7,), (3, 5, 7), (64, 33))


@pytest.mark.parametrize("key,ctr,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0))], ids=["zeros", "ones", "pi"])
def test_threefry_known_answers(key, ctr, want):
    """Random123's known answers for threefry2x32-20, as ints and as
    int64 tensors."""
    assert tuple(int(v) for v in tf.threefry2x32(*key, *ctr)) == want
    got = tf.threefry2x32(*key, *(torch.tensor([c], dtype=torch.int64)
                                  for c in ctr))
    assert tuple(int(g[0]) for g in got) == want


def _jax_threefry(key, c0, c1):
    """jax's threefry2x32 of explicit counter words (c0, c1) under key."""
    out = np.asarray(prng.threefry_2x32(
        jnp.asarray(np.array(key, np.uint32)),
        jnp.asarray(np.concatenate([c0, c1]).astype(np.uint32))),
        np.int64)
    return out[:len(c0)], out[len(c0):]


@pytest.mark.parametrize("seed", SEEDS)
def test_counters_past_two_to_the_32(seed):
    """threefry2x32 on counters whose flat index is at or above 2^32 (a
    high word other than 0), and bits_at there, as jax computes them."""
    key = tf.fold_in(tf.prng_key(seed), 3)
    rng = np.random.default_rng(seed % 1000)
    idx = (np.int64(1) << 32) + rng.integers(0, 1 << 40, 200)
    idx[:3] = [(1 << 32), (1 << 32) + 1, (5 << 32) + 0xFFFFFFFF]
    c0, c1 = idx >> 32, idx & tf.MASK32
    w0, w1 = _jax_threefry(key, c0, c1)
    g0, g1 = tf.threefry2x32(*key, torch.as_tensor(c0), torch.as_tensor(c1))
    assert (g0.numpy() == w0).all() and (g1.numpy() == w1).all()
    assert (tf.bits_at(key, torch.as_tensor(idx)).numpy() == w0 ^ w1).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split(seed):
    """PRNGKey, fold_in (at 0, a row offset and 2^32 - 1) and split (of 1,
    3 and 1,000) equal jax.random's."""
    k = jax.random.PRNGKey(seed)
    kt = tf.prng_key(seed)
    assert tuple(np.asarray(jax.random.key_data(k)).tolist()) == kt
    for d in (0, 4_096, tf.MASK32):
        assert tuple(np.asarray(jax.random.fold_in(k, d)).tolist()) == \
            tf.fold_in(kt, d)
    for m in (1, 3, 1_000):
        want = np.asarray(jax.random.split(k, m), np.int64)
        assert (tf.split(kt, m).numpy() == want).all()
        assert tf.split_keys(kt, m) == [tuple(r) for r in want.tolist()]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniforms_bit_for_bit(seed, shape):
    """random_bits, uniform on [0, 1) and on [tiny, 1) (the Gumbel's, the
    two ranges the JAX package draws) equal jax.random's bit for bit; on a
    shifted, scaled range within 1e-6 (XLA fuses the scale and the shift
    into one multiply-add, rounded once)."""
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
    kt = tf.fold_in(tf.prng_key(seed), 7)
    want = np.asarray(jax.random.bits(k, shape), np.int64)
    assert (tf.random_bits(kt, shape).numpy() == want).all()
    for lo, hi in ((0.0, 1.0), (tf.TINY, 1.0)):
        want = np.asarray(jax.random.uniform(k, shape, jnp.float32, lo, hi))
        got = tf.uniform(kt, shape, lo, hi).numpy()
        assert got.dtype == np.float32
        assert (got.view(np.int32) == want.view(np.int32)).all(), (lo, hi)
    want = np.asarray(jax.random.uniform(k, shape, jnp.float32, -2.5, 3.75))
    got = tf.uniform(kt, shape, -2.5, 3.75).numpy()
    assert np.abs(got.astype(np.float64) - want).max() <= 1e-6


def test_uniform_floor_at_minval():
    """A zero draw: the float is 0 and the uniform its minval, exactly."""
    bits = torch.tensor([0, 511, 1 << 9], dtype=torch.int64)
    u = tf.uniform_from_bits(bits, tf.TINY, 1.0)
    assert float(u[0]) == tf.TINY and float(u[1]) == tf.TINY
    assert float(u[2]) == 2.0 ** -23


def _gumbel_truth(kt, shape):
    """The float64 -log(-log(u)) of the uniforms a Gumbel draw takes
    (bit for bit JAX's, test_bits_and_uniforms_bit_for_bit)."""
    u = tf.uniform(kt, shape, tf.TINY, 1.0).numpy().astype(np.float64)
    return -np.log(-np.log(u))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_close_to_jax(seed):
    """gumbel within 2e-6 absolute of jax.random.gumbel on 120,000 draws,
    each side first compared with the float64 -log(-log(u)) of the
    uniforms both draw, at the same limit: the port's side must hold it,
    and where JAX's strays from it (the reference's logs, not the port)
    the test records that as a warning naming the rows and holds the port
    to the float64 value alone."""
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
    kt = tf.fold_in(tf.prng_key(seed), 1)
    want = np.asarray(jax.random.gumbel(k, (300, 400)))
    got = tf.gumbel(kt, (300, 400)).numpy()
    assert np.isfinite(got).all()
    truth = _gumbel_truth(kt, (300, 400))
    port = np.abs(got - truth)
    ref = np.abs(want - truth)
    assert port.max() <= 2e-6, (
        f"the port's Gumbels moved: {port.max():.3e} from the float64 value "
        f"on rows {np.unique(np.nonzero(port > 2e-6)[0])[:10]} (JAX's "
        f"{ref.max():.3e})")
    if ref.max() > 2e-6:
        warnings.warn(
            f"JAX's Gumbels moved: {ref.max():.3e} from the float64 value on "
            f"rows {np.unique(np.nonzero(ref > 2e-6)[0])[:10]} (the port's "
            f"{port.max():.3e})", RuntimeWarning)
    else:
        assert np.abs(got.astype(np.float64) - want).max() <= 2e-6
    idx = torch.arange(1_000, 2_000, dtype=torch.int64)
    assert torch.equal(tf.gumbel_at(kt, idx),
                       tf.gumbel(kt, (300, 400)).reshape(-1)[1_000:2_000])


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_is_float64_rounded_once(seed):
    """On the CPU every draw is its float64 -log(-log(u)) rounded once to
    f32, bit for bit, at one, three and all intra-op threads and through
    gumbel_at: nothing in it depends on which path the CPU's f32 log
    takes (two f32 logs put many draws a few ulps off that value)."""
    kt = tf.fold_in(tf.prng_key(seed), 1)
    want = _gumbel_truth(kt, (300, 400)).astype(np.float32)
    threads = torch.get_num_threads()
    try:
        for t in sorted({1, 3, threads}):
            torch.set_num_threads(t)
            got = tf.gumbel(kt, (300, 400)).numpy()
            assert (got.view(np.int32) == want.view(np.int32)).all(), t
    finally:
        torch.set_num_threads(threads)
    idx = torch.arange(119_000, 120_000, dtype=torch.int64)
    at = tf.gumbel_at(kt, idx).numpy()
    assert (at.view(np.int32) == want.reshape(-1)[119_000:].view(
        np.int32)).all()


@pytest.mark.parametrize("rows,k", [(1, 1), (37, 20), (256, 129)])
def test_uniform_rows_plain_is_jax_uniform(rows, k):
    """Kernel 17's plain version: the buffer holds jax.random.uniform(key,
    (rows, K)) bit for bit, for a key of split's."""
    k_jax = jax.random.split(jax.random.PRNGKey(9), 4)[2]
    key = tf.split_keys(tf.prng_key(9), 4)[2]
    out = torch.full((rows, k), -1.0)
    assert tf.uniform_rows(key, out) is out
    want = np.asarray(jax.random.uniform(k_jax, (rows, k), jnp.float32))
    assert (out.numpy().view(np.int32) == want.view(np.int32)).all()


def test_uniform_rows_refuses_other_devices():
    """No fallback: a tensor that is neither on the CPU nor on a card is
    refused."""
    with pytest.raises(ValueError):
        tf.uniform_rows((0, 1), torch.empty((2, 3), device="meta"))


@pytest.mark.parametrize("seed,k", [(1, 7), (2**31 + 3, 33)])
def test_linksampling_device_init_matches_jax(seed, k):
    """init_gamma_from_links_device of both packages on a small padded
    edge set (four blocks, the last one part padding), with the same seed
    and block: within 1e-6 relative, the isolated node's row alpha in
    both."""
    from svinet_tpu.svi.linksampling import (
        init_gamma_from_links_device as jinit)
    from svinet_torch.ops.edges import pad_edges
    from svinet_torch.svi.linksampling import init_gamma_from_links_device
    rng = np.random.default_rng(seed % 97)
    n, block = 90, 64
    pairs = rng.integers(0, n - 1, size=(230, 2))
    pairs = pairs[pairs[:, 0] != pairs[:, 1]].astype(np.int32)
    edges, mask = pad_edges(pairs, block)
    blocks = edges.shape[0] // block
    assert blocks == 4 and not mask[-1]
    want = np.asarray(jinit(jax.random.PRNGKey(seed), jnp.asarray(edges),
                            jnp.asarray(mask), n, k, jnp.float32(0.05),
                            blocks))
    got = init_gamma_from_links_device(
        seed, torch.as_tensor(edges), torch.as_tensor(mask), n, k, 0.05,
        blocks).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (got[n - 1] == np.float32(0.05)).all()
