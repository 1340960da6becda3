"""The held-out sums of svinet_torch against the JAX package, on the same
numpy inputs, on the CPU. heldout_sums_rows_plain is the arithmetic of the
CUDA kernel in plain PyTorch (gather the pairs' gamma rows, normalise those
alone); it is held to svinet_tpu.evals.likelihood.heldout_sums_blocked and to
the port's heldout_sums_from_pi at 1e-5 relative on the six sums, with
padding pairs, links only, non-links only and an empty set. The kernel
itself is held to both plain forms on the card by chip_smoke.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from svinet_tpu.evals import likelihood as jlik
from svinet_torch.evals import likelihood as tlik
from svinet_torch.ops.edges import pad_edges

RTOL = 1e-5
EPS = 1e-30


def _t(a):
    return torch.from_numpy(np.array(a))


def _state(n, k, seed):
    """gamma with rows from nearly one community to spread out, so that the
    non-link term meets 1 - inner near 0 and near 1."""
    rng = np.random.default_rng(seed)
    gamma = (0.05 + rng.random((n, k)) ** 6 * 30.0).astype(np.float32)
    home = rng.integers(0, k, size=n)
    sharp = rng.random(n) < 0.5
    gamma[sharp, home[sharp]] += 200.0
    lam = (0.5 + 4.5 * rng.random((k, 2))).astype(np.float32)
    return gamma, lam, home


def _pairs(n, m, kind, seed, home):
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, n, size=(m, 2)).astype(np.int32)
    if m:
        # some pairs within one community: inner near 1
        same = np.flatnonzero(home == home[0])
        pairs[: m // 4] = rng.choice(same, size=(m // 4, 2))
    y = {"mixed": rng.integers(0, 2, size=m), "links": np.ones(m),
         "nonlinks": np.zeros(m)}[kind].astype(np.int32)
    return pairs, y


def _padded(pairs, y, block):
    pp, ww = pad_edges(pairs, block)
    yy = np.zeros(len(pp), np.int32)
    yy[:len(y)] = y
    return pp, yy, ww, len(pp) // block


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= RTOL * np.abs(want)), (got, want)


@pytest.mark.parametrize("kind", ["mixed", "links", "nonlinks"])
@pytest.mark.parametrize("k", [4, 37, 520])
def test_rows_plain_matches_jax_and_from_pi(k, kind):
    n, m, block = 300, 700, 256
    gamma, lam, home = _state(n, k, seed=k)
    pairs, y = _pairs(n, m, kind, seed=k + 1, home=home)
    pp, yy, ww, nb = _padded(pairs, y, block)
    assert len(pp) > m                       # a ragged, padded tail
    want = jlik.heldout_sums_blocked(
        jnp.asarray(gamma), jnp.asarray(lam), jnp.asarray(pp),
        jnp.asarray(yy), jnp.asarray(ww), EPS, nb)
    args = (_t(pp), _t(yy), _t(ww), EPS, nb)
    rows = tlik.heldout_sums_rows_plain(_t(gamma), _t(lam), *args)
    pi, beta = tlik._pi_beta(_t(gamma), _t(lam))
    from_pi = tlik.heldout_sums_from_pi(pi, beta, *args)
    blocked = tlik.heldout_sums_blocked(_t(gamma), _t(lam), *args)
    _close(rows, want)
    _close(rows, from_pi)
    _close(blocked, want)
    counts = rows.numpy()[[1, 3, 5]]
    assert counts[0] == m and counts[1] + counts[2] == m
    assert counts[2] == (m if kind == "links" else
                         0 if kind == "nonlinks" else int(y.sum()))


def test_padding_pairs_add_exactly_zero():
    """Padding has weight 0 and index 0: the sums over a padded set equal
    the sums over the pairs alone, in every bit, blocked alike."""
    n, k, m, block = 200, 12, 256, 256
    gamma, lam, home = _state(n, k, seed=2)
    pairs, y = _pairs(n, m, "mixed", seed=3, home=home)
    pp, yy, ww, nb = _padded(pairs, y, block)
    more = np.zeros((block, 2), np.int32)
    pp2 = np.concatenate([pp, more])
    yy2 = np.concatenate([yy, np.zeros(block, np.int32)])
    ww2 = np.concatenate([ww, np.zeros(block, np.float32)])
    a = tlik.heldout_sums_rows_plain(_t(gamma), _t(lam), _t(pp), _t(yy),
                                     _t(ww), EPS, nb)
    b = tlik.heldout_sums_rows_plain(_t(gamma), _t(lam), _t(pp2), _t(yy2),
                                     _t(ww2), EPS, nb + 1)
    assert torch.equal(a, b)


def test_empty_set():
    """No pair at all: six zeros from the sums, the zero result from
    heldout_stats, as in the JAX package."""
    n, k, block = 50, 5, 64
    gamma, lam, _ = _state(n, k, seed=4)
    pp, yy, ww, nb = _padded(np.zeros((0, 2), np.int32),
                             np.zeros(0, np.int32), block)
    want = jlik.heldout_sums_blocked(
        jnp.asarray(gamma), jnp.asarray(lam), jnp.asarray(pp),
        jnp.asarray(yy), jnp.asarray(ww), EPS, nb)
    got = tlik.heldout_sums_rows_plain(_t(gamma), _t(lam), _t(pp), _t(yy),
                                       _t(ww), EPS, nb)
    assert np.all(np.asarray(want) == 0) and bool((got == 0).all())
    res = tlik.heldout_stats(_t(gamma), _t(lam), _t(pp[:0]), _t(yy[:0]), EPS)
    assert res == tlik.HeldoutResult(0.0, 0, 0.0, 0, 0.0, 0)


@pytest.mark.parametrize("kind", ["mixed", "links", "nonlinks"])
def test_heldout_stats_matches_jax(kind):
    n, k, m = 250, 9, 333
    gamma, lam, home = _state(n, k, seed=6)
    pairs, y = _pairs(n, m, kind, seed=7, home=home)
    want = jlik.heldout_stats(jnp.asarray(gamma), jnp.asarray(lam),
                              jnp.asarray(pairs), jnp.asarray(y), EPS)
    got = tlik.heldout_stats(_t(gamma), _t(lam), _t(pairs), _t(y), EPS)
    assert (got.count, got.count0, got.count1) == (
        want.count, want.count0, want.count1)
    for a, b in ((got.avg, want.avg), (got.avg0, want.avg0),
                 (got.avg1, want.avg1)):
        assert abs(a - b) <= RTOL * abs(b), (a, b)


def test_kernel_wrapper_refuses_cpu_tensors():
    """heldout_sums is the kernel's wrapper: a CPU tensor goes through
    heldout_sums_blocked to the plain version, never to it."""
    gamma, lam, _ = _state(10, 3, seed=8)
    pairs = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="kernel runs on cuda"):
        tlik.heldout_sums(_t(gamma), _t(lam), pairs,
                          torch.zeros(4, dtype=torch.int32), torch.ones(4),
                          EPS)
    assert tlik.heldout_sums.launches == 0
