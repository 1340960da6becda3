"""The layout of -sparse-w's redesigned kernels, on the CPU: Elogpi and the
mean indicators side by side in (n, K, 2) rows, topm beside each node's
list, kernel 3 writing mphi into the rows' odd half, and the selection the
top-W form of kernel 1 makes on the card.

The plain versions take the kernels' arguments; over several sweeps they
are held to the JAX package's sparse sweeps (sparse_union_sweep_body) at
1e-4 abs/rel (its own bound for reordered f32 sums), the ids exactly. The
kernels cannot run here, so the top-W form's selection (threshold from the
lanes' maxima, the ties at it in column order, one sort of the picks) is
modelled in torch with the lanes as a tensor dimension, and the model's
picks are held to jax.lax.top_k exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svinet_tpu.svi.sweep_math as jsm
from svinet_tpu.svi.linksampling import linksampling_sparse_multi_sweep
from svinet_torch.ops.digamma import (
    dirichlet_expectation_plain, dirichlet_expectation_topw)
from svinet_torch.ops.edges import SEG_LEN, build_adjacency, pad_edges
from svinet_torch.svi.linksampling import sparse_multi_sweep
from svinet_torch.svi.sweep_math import (
    LSConsts, mean_indicator_update, sparse_union_sweep, union_rows)

TOL = dict(rtol=1e-4, atol=1e-4)


def _graph(rng, n, n_links, hub_deg):
    """Random links (p < q), plus node 0 joined to nodes 1..hub_deg."""
    p = rng.integers(0, n - 1, n_links)
    q = rng.integers(1, n, n_links)
    q = np.where(q <= p, p + 1, q)
    links = np.stack([p, q], 1)
    links = links[links[:, 0] > 0]
    hub = np.stack([np.zeros(hub_deg, np.int64), np.arange(1, hub_deg + 1)],
                   1)
    return np.concatenate([hub, links]).astype(np.int32)


def _state(rng, n, k):
    """gamma with 60% of its entries tied at alpha = 1/K and a row at alpha
    throughout; lambda; mean indicators of a sweep before."""
    alpha = np.float32(1.0 / k)
    g = rng.gamma(1.0, 2.0, (n, k)).astype(np.float32) + alpha
    g = np.where(rng.uniform(size=(n, k)) < 0.6, alpha, g)
    g[1] = alpha
    lam = rng.uniform(0.5, 3.0, (k, 2)).astype(np.float32)
    mphi = rng.uniform(0, 0.2, (n, k)).astype(np.float32)
    return g, lam, mphi


@pytest.mark.parametrize("k,w", [
    (20, 1), (20, 4), (20, 16),
    (500, 1), (500, 4), (500, 16), (500, 32), (500, 64),
    (640, 1), (640, 4), (640, 16), (640, 32), (640, 64)])
def test_sparse_sweeps_over_rows_match_jax(k, w):
    """Three sparse sweeps through the (n, K, 2) rows (the top-W form
    writing Elogpi into the even half and reading topm from the odd one,
    kernel 7's plain version on the rows, kernel 3 writing mphi into the
    odd half in whole pairs, gamma donated), each held to the JAX package's
    sweep, with a hub cut into segments. Up to W=32 each side carries its
    own state across the three sweeps; at W=64 sums reordered over three
    carried sweeps drift past 1e-4, so there each sweep starts from the
    JAX package's state before it. Then the ids of the last state against
    jax.lax.top_k."""
    rng = np.random.default_rng(k * 100 + w)
    n = SEG_LEN + 64
    links = _graph(rng, n, 600, SEG_LEN + 20)
    state = _state(rng, n, k)
    deg = np.bincount(links.ravel(), minlength=n).astype(np.float32)
    edges, mask = pad_edges(links, 256)
    jc = jsm.LSConsts(jnp.float32(1.0 / k), jnp.asarray([1.0, 1.0],
                                                        jnp.float32),
                      jnp.float32(len(links)), jnp.float32(n))
    z = jnp.zeros(1, jnp.float32)
    adj = build_adjacency(links, n)
    assert len(adj.hub_node) == 1
    consts = LSConsts.make(1.0 / k, 1.0, 1.0, len(links), n)
    # the even half starts as garbage: every sweep writes it before use
    rows = union_rows(torch.full((n, k), 7.0), torch.tensor(state[2]))
    buf = rows.data_ptr()
    carry = w <= 32
    g, l = torch.tensor(state[0]), torch.tensor(state[1])
    for _ in range(3):
        want = [np.asarray(x) for x in linksampling_sparse_multi_sweep(
            *(jnp.asarray(x) for x in state), jnp.asarray(edges),
            jnp.asarray(mask), jnp.asarray(deg), jc, jnp.float32(0.0), z, z,
            z, jnp.float32(1e-30), len(edges) // 256, 1, w, 0)]
        if not carry:
            g, l = torch.tensor(state[0]), torch.tensor(state[1])
            rows[..., 1] = torch.tensor(state[2])
        g, l, rows = sparse_multi_sweep(
            g, l, rows, adj, torch.tensor(deg), consts, False, w, 1,
            donate_gamma=True)
        assert rows.data_ptr() == buf and rows.shape == (n, k, 2)
        for name, got, ref in zip("glm", (g, l, rows[..., 1]), want):
            np.testing.assert_allclose(got.numpy(), ref, err_msg=name, **TOL)
        # kernel 3 cleared the even half (this sweep's Elogpi, dead)
        assert torch.equal(rows[..., 0], torch.zeros(n, k))
        state = want
    _, ids, _, _ = dirichlet_expectation_topw(g, w, torch.zeros(n, k, 2))
    np.testing.assert_array_equal(
        ids.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(g.numpy()), w)[1]))


def test_topw_form_writes_the_even_half_and_reads_topm():
    rng = np.random.default_rng(4)
    gamma, _, mphi = _state(rng, 40, 12)
    g, m = torch.tensor(gamma), torch.tensor(mphi)
    rows = union_rows(torch.zeros(40, 12), m)
    elogpi, ids, topvals, topm = dirichlet_expectation_topw(g, 5, pair=rows)
    assert torch.equal(rows[..., 0], dirichlet_expectation_plain(g))
    assert torch.equal(rows[..., 1], m)
    assert elogpi.data_ptr() == rows.data_ptr()
    assert torch.equal(topvals, rows[..., 0].gather(1, ids.long()))
    assert torch.equal(topm, m.gather(1, ids.long()))
    with pytest.raises(ValueError, match="pair must be"):
        dirichlet_expectation_topw(g, 5, pair=torch.zeros(40, 12))


def test_kernel3_pairs_mphi_out_is_its_contiguous_form():
    """kernel 3's mphi into the rows' odd half equals its mphi into an
    (n, K) array bit for bit; the even half (Elogpi, dead by then) is 0."""
    rng = np.random.default_rng(5)
    n, k = 30, 9
    gacc = torch.tensor(rng.uniform(0, 5, (n, k)).astype(np.float32))
    deg = torch.tensor(rng.integers(0, 6, n).astype(np.float32))
    sumk = gacc.sum(0)
    consts = LSConsts.make(1.0 / k, 1.0, 1.0, 50, n)
    rows = union_rows(torch.tensor(rng.normal(size=(n, k)).astype(
        np.float32)), torch.zeros(n, k))
    for annealing in (False, True):
        want = mean_indicator_update(gacc.clone(), sumk, deg, consts,
                                     annealing)
        got = mean_indicator_update(gacc.clone(), sumk, deg, consts,
                                    annealing, mphi_out=rows)
        assert got.mphi.data_ptr() == rows[..., 1].data_ptr()
        assert torch.equal(rows[..., 1], want.mphi)
        assert torch.equal(rows[..., 0], torch.zeros(n, k))
        assert torch.equal(got.gnext, want.gnext)
    with pytest.raises(ValueError, match="pairs"):
        mean_indicator_update(gacc.clone(), sumk, deg, consts, False,
                              mphi_out=rows, mphi_bf16=True)


def test_donated_gamma_holds_the_new_gamma():
    rng = np.random.default_rng(6)
    n, k, w = 60, 10, 3
    links = _graph(rng, n, 200, 5)
    gamma, lam, mphi = _state(rng, n, k)
    adj = build_adjacency(links, n)
    deg = torch.tensor(np.bincount(links.ravel(), minlength=n).astype(
        np.float32))
    consts = LSConsts.make(1.0 / k, 1.0, 1.0, len(links), n)
    out = []
    for donate in (False, True):
        g = torch.tensor(gamma)
        rows = union_rows(torch.zeros(n, k), torch.tensor(mphi))
        res = sparse_union_sweep(g, torch.tensor(lam), rows, adj, deg,
                                 consts, False, w, donate_gamma=donate)
        # donated, gamma's storage took gacc (on the card it then holds the
        # new gamma: kernel 3 writes gnext over gacc in place)
        assert torch.equal(g, torch.tensor(gamma)) != donate
        out.append(res)
    for a, b in zip(*out):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------
# A model of the top-W form's selection on the card
# (csrc/dirichlet_expectation.cu, select_by_threshold), lanes as a tensor
# dimension: the row layout <VEC, G, N> of csrc/common.cuh (dispatch_row,
# rows on 16-byte boundaries), lane g holding columns (g + jG) VEC + u.

def _layout(k, pairs):
    """(VEC, G, N) of dispatch_row, or of dispatch_pair_row when the form
    writes into (n, K, 2) pairs (units of 2 columns)."""
    vec = (2 if k % 2 == 0 else 1) if pairs else (4 if k % 4 == 0 else 1)
    units = k // vec
    g = 1
    while g < min(units, 32):
        g *= 2
    n_units = 1
    while g * n_units < units:
        n_units *= 2
    return vec, g, n_units


def _select_model(gamma, w, pairs):
    """(ids (rows, w), whether each row took the threshold path). Rows the
    model does not take (W above G, more than 2G values above lo) take the
    general path on the card, modelled here by the stable sort."""
    rows, k = gamma.shape
    vec, grp, n_units = _layout(k, pairs)
    lanes = torch.arange(grp)[:, None, None]
    units = torch.arange(n_units)[None, :, None]
    us = torch.arange(vec)[None, None, :]
    cols = ((lanes + units * grp) * vec + us).reshape(grp, -1)  # (G, L)
    valid = cols < k
    v = torch.where(valid, gamma[:, cols.clamp(max=k - 1)], 0.0)  # (R, G, L)
    # 1. lo: the w-th largest of the lanes' largest values, or above
    # w = G/2 of their two largest each
    top = torch.sort(v, dim=2, descending=True).values
    lane_top = top[:, :, :1] if 2 * w <= grp else top[:, :, :2]
    lane_top = lane_top.reshape(rows, -1)
    lo = torch.sort(lane_top, dim=1, descending=True).values[
        :, min(w, lane_top.shape[1]) - 1]
    above = v > lo[:, None, None]
    tie = (v == lo[:, None, None]) & valid
    n_above = above.sum(dim=(1, 2))
    need = w - n_above
    # 2. the ties in column order: unit j, then lane, then within the unit
    tie_order = tie.reshape(rows, grp, n_units, vec).permute(0, 2, 1, 3)
    rank = (tie_order.reshape(rows, -1).cumsum(1) - 1).reshape(
        rows, n_units, grp, vec).permute(0, 2, 1, 3).reshape(rows, grp, -1)
    pick = above | (tie & (rank < need[:, None, None]))
    n_picks = torch.where(need > 0, w, n_above)
    fast = (n_picks <= 2 * grp) & (w <= 2 * grp)
    assert torch.equal(pick.sum(dim=(1, 2))[fast], n_picks[fast])
    # 3. one sort of the picks' 64-bit keys (gamma's bits, then the
    # column's complement), largest first
    bits = v.contiguous().view(torch.int32).to(torch.int64)
    key = (bits << 32) | (0xFFFFFFFF - cols.to(torch.int64))
    key = torch.where(pick, key, 0).reshape(rows, -1)
    top = torch.sort(key, dim=1, descending=True).values[:, :w]
    ids = (0xFFFFFFFF - (top & 0xFFFFFFFF)).to(torch.int32)
    general = torch.sort(gamma, dim=1, descending=True,
                         stable=True).indices[:, :w].to(torch.int32)
    return torch.where(fast[:, None], ids, general), fast


def _untied(rng, rows, k):
    return rng.gamma(1.0, 2.0, (rows, k)).astype(np.float32) + 1e-3


def _tied(rng, rows, k):
    """60% of the columns at exactly alpha = 1/K, as late in a fit; every
    tenth row at alpha throughout."""
    g = _untied(rng, rows, k)
    g = np.where(rng.uniform(size=(rows, k)) < 0.6, np.float32(1.0 / k), g)
    g[::10] = np.float32(1.0 / k)
    return g


def _late_fit(rng, rows, k):
    """Mass in one column and three random ones, every other column at
    alpha (tools/bench_kernels.py _late_gamma)."""
    g = np.full((rows, k), np.float32(1.0 / k), np.float32)
    r = np.arange(rows)
    g[r, rng.integers(0, k, rows)] += 16.0
    for _ in range(3):
        g[r, rng.integers(0, k, rows)] += rng.uniform(size=rows).astype(
            np.float32)
    return g


@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("make", [_untied, _tied, _late_fit])
@pytest.mark.parametrize("k,w", [(500, 8), (500, 16), (500, 32), (500, 64),
                                 (20, 4), (33, 4), (16, 16)])
def test_threshold_selection_model_picks_jax_top_k(make, k, w, pairs):
    rng = np.random.default_rng(k + w)
    gamma = make(rng, 400, k)
    want = np.asarray(jax.lax.top_k(jnp.asarray(gamma), w)[1])
    ids, fast = _select_model(torch.tensor(gamma), w, pairs)
    np.testing.assert_array_equal(ids.numpy(), want)
    if k == 500 and w <= 32:
        # at the stretch width the threshold path takes (nearly) every row
        assert float(fast.float().mean()) > 0.95, float(fast.float().mean())
