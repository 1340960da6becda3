"""FastAMM (-infset, dense and -fastqueue W) in the port against the JAX
package, on the CPU: the plain versions of the sparse top-W state's
functions (svinet_tpu/ops/sparse_gamma.py), kernel 8's FastAMM form (one
dense step: the whole padded minibatch one block of the exit rule, a rho
a touched row), kernel 10's (one sparse step) and whole CLI runs after
-preprocess, cut and -resume'd, and under -mesh 2.

Both engines draw the splits, the initial state and the minibatches from
one numpy Generator in the same order, so the drawn pairs are bitwise
equal and the states differ only by the sums' rounding: gamma (or the
densified top-W gamma), lambda and the held-out rows are held at 1e-4.
Neither package keeps the Generator in a checkpoint, so a resumed run
draws its minibatches anew; the two packages' resumed runs are held to
each other, the per-node counters restored."""

import filecmp
import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svinet_tpu.cli import main as jax_main
from svinet_tpu.ops import sparse_gamma as jsg
from svinet_tpu.svi import fastamm as jfastamm
from svinet_torch.cli import main as torch_main, parse_args
from svinet_torch.io.checkpoint import load_checkpoint
from svinet_torch.ops import sparse_gamma as sg
from svinet_torch.parallel import mesh
from svinet_torch.svi import fastamm
from svinet_torch.synth import write_planted

TOL = dict(rtol=1e-4, atol=1e-4)
LOG_EPS = float(np.float32(np.log(1e-30)))
N, K, W = 200, 12, 4


@pytest.fixture(autouse=True)
def one_thread():
    """The port's steps are thousands of small tensor operations: on a
    loaded machine, intra-op threads that spin for work slow them tenfold
    and more, so these tests run them on one thread (the results do not
    depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    d = tmp_path_factory.mktemp("planted")
    return write_planted(str(d), 400, 4, 16, 2)


def _dense(seed, n, k, ties=False):
    """A gamma-like (n, K) f32 array; with ties, row 0 all equal and row 1
    with a run of equal values across its W-th place."""
    rng = np.random.default_rng(seed)
    g = rng.gamma(1.0, 1.0, size=(n, k)).astype(np.float32) * 5 + 0.05
    if ties:
        g[0] = 1.0
        g[1, :] = 0.5
        g[1, 1:k:2] = 2.0
    return g


def _state(seed, n=N, k=K, w=W):
    rng = np.random.default_rng(seed + 100)
    ids, vals, rest = (np.asarray(a) for a in jsg.topw_from_dense(
        jnp.asarray(_dense(seed, n, k)), w))
    lam = rng.uniform(1, 20, size=(k, 2)).astype(np.float32)
    return ids, vals, rest, lam


def _t(*arrays):
    return tuple(torch.tensor(np.asarray(a)) for a in arrays)


def test_topw_and_densify_match_jax():
    """topw_from_dense and densify; ids exactly where the W-th and the
    (W+1)-th values differ by more than 1e-4 relative, and on rows of
    ties (both take the lower column first)."""
    g = _dense(0, 64, K, ties=True)
    ji, jv, jr = (np.asarray(a) for a in jsg.topw_from_dense(
        jnp.asarray(g), W))
    ti, tv, tr = (a.numpy() for a in sg.topw_from_dense(torch.tensor(g), W))
    s = -np.sort(-g, axis=1)
    clear = (s[:, W - 1] - s[:, W]) > 1e-4 * s[:, W - 1]
    clear[:2] = True        # the tie rows: the lower columns, in order
    np.testing.assert_array_equal(ti[clear], ji[clear])
    np.testing.assert_array_equal(ti[:2], [[0, 1, 2, 3], [1, 3, 5, 7]])
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_allclose(tr, jr, **TOL)
    d_t = sg.densify(*_t(ji, jv, jr), K).numpy()
    d_j = np.asarray(jsg.densify(jnp.asarray(ji), jnp.asarray(jv),
                                 jnp.asarray(jr), K))
    np.testing.assert_array_equal(d_t, d_j)


def test_slot_helpers_match_jax():
    ids, vals, rest, _ = _state(1)
    p = np.arange(0, 40)
    q = (p * 7 + 3) % N
    slots = np.concatenate([ids[p], ids[q]], 1)
    np.testing.assert_array_equal(
        sg._dup_mask(torch.tensor(slots)).numpy(),
        np.asarray(jsg._dup_mask(jnp.asarray(slots))))
    tail = rest[p] / (K - W)
    np.testing.assert_allclose(
        sg._value_at_slots(*_t(ids[p], vals[p], tail, slots)).numpy(),
        np.asarray(jsg._value_at_slots(jnp.asarray(ids[p]),
                                       jnp.asarray(vals[p]),
                                       jnp.asarray(tail),
                                       jnp.asarray(slots))), rtol=1e-6)


def _jax_fp(ids, vals, rest, elogbeta, p, q, y, max_iters, thresh=1e-5):
    return [np.asarray(a) for a in jsg.sparse_phi_fixed_point(
        jnp.asarray(ids[p]), jnp.asarray(vals[p]), jnp.asarray(rest[p]),
        jnp.asarray(ids[q]), jnp.asarray(vals[q]), jnp.asarray(rest[q]),
        jnp.asarray(elogbeta), jnp.asarray(y), LOG_EPS, K, max_iters,
        thresh)]


@pytest.mark.parametrize("seed,links", [(2, 0.0), (3, 0.0), (2, 0.4)])
def test_union_fixed_point_matches_jax(seed, links):
    """Slots, dead slots and phis at 1e-4, and the rounds: the JAX while
    loop's count is R where stopping at R gives its converged phis and
    stopping at R - 1 does not. Links between random rows (the last case)
    keep some pair in a 2-cycle to max_iters."""
    from scipy.special import digamma
    ids, vals, rest, lam = _state(seed)
    rng = np.random.default_rng(seed)
    m = 48
    p = rng.integers(0, N, m)
    q = rng.integers(0, N, m)
    q[:6] = p[:6]                    # pairs sharing every community
    y = (rng.random(m) < links).astype(np.int32)
    elogbeta = (digamma(lam) - digamma(lam.sum(1, keepdims=True))
                ).astype(np.float32)
    slots, first, phi1, phi2, r = sg.sparse_phi_fixed_point(
        *_t(ids[p], vals[p], rest[p], ids[q], vals[q], rest[q], elogbeta,
            y), LOG_EPS, K, 50, 1e-5)
    js, jf, j1, j2 = _jax_fp(ids, vals, rest, elogbeta, p, q, y, 50)
    np.testing.assert_array_equal(slots.numpy(), js)
    np.testing.assert_array_equal(first.numpy(), jf)
    assert not jf[:6, W:].any()
    np.testing.assert_allclose(phi1.numpy(), j1, **TOL)
    np.testing.assert_allclose(phi2.numpy(), j2, **TOL)
    assert r == 50 if links else 2 < r < 50
    at_r = _jax_fp(ids, vals, rest, elogbeta, p, q, y, r)
    before = _jax_fp(ids, vals, rest, elogbeta, p, q, y, r - 1)
    assert all(np.array_equal(a, b) for a, b in zip(at_r[2:], (j1, j2)))
    assert not np.array_equal(before[2], j1)


def _shared_rows(ids, vals, rng, rows):
    """Rows r + N/2 for r in rows hold row r's communities in another
    order at other values: a pair (r, r + N/2) shares every community."""
    for r in rows:
        perm = rng.permutation(ids.shape[1])
        ids[r + N // 2] = ids[r][perm]
        vals[r + N // 2] = vals[r][perm] * 0.5 + 0.1


@pytest.mark.parametrize("k,w", [(12, 4), (17, 16), (40, 12), (64, 16),
                                 (80, 17), (160, 64)])
def test_pair_scores_and_assignments_match_jax(k, w):
    """Kernel 11's plain versions at widths of one slot register a lane
    and idle lanes (4, 12, 16), K - W = 1 (17, 16), two and four
    registers (17, 64), with pairs (p, p) and pairs sharing every
    community: the scores at 1e-5, the communities equal, their phis at
    1e-4."""
    ids, vals, rest, lam = (a.copy() for a in _state(4, N, k, w))
    rng = np.random.default_rng(4)
    _shared_rows(ids, vals, rng, range(5, 15))
    pairs = rng.integers(0, N, size=(300, 2)).astype(np.int32)
    pairs[:5, 1] = pairs[:5, 0]
    pairs[5:15] = np.stack([np.arange(5, 15), np.arange(5, 15) + N // 2], 1)
    a = sg.sparse_pair_scores(*_t(ids, vals, rest, lam, pairs), k)
    b = jsg.sparse_pair_scores(*(jnp.asarray(x) for x in (ids, vals, rest,
                                                           lam, pairs)),
                               k=k)
    for x, z in zip(a, b):
        np.testing.assert_allclose(x.numpy(), np.asarray(z), rtol=1e-5)
    c, mx = sg.sparse_edge_assignments(*_t(ids, vals, rest, lam, pairs), k)
    jc, jm = jsg.sparse_edge_assignments(
        *(jnp.asarray(x) for x in (ids, vals, rest, lam, pairs)), k=k)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_allclose(mx.numpy(), np.asarray(jm), **TOL)


@pytest.mark.parametrize("k,w", [(12, 4), (40, 12), (64, 16), (160, 64)])
def test_tied_assignments_match_jax(k, w):
    """synth.tied_topw_state: the plain version names JAX's community on
    every link, and it is the first slot's of the tied two (the lower
    place in p's row; both rows hold both at values of equal sums), so
    that a last-slot argmax would name the other on every link."""
    from svinet_torch.synth import tied_topw_state
    ids, vals, rest, lam, links = tied_topw_state(3, k, w, 96, 32)
    jargs = (jnp.asarray(x) for x in (ids, vals, rest, lam, links))
    jc, jm = (np.asarray(x) for x in jsg.sparse_edge_assignments(*jargs,
                                                                 k=k))
    c, mx = sg.sparse_edge_assignments(*_t(ids, vals, rest, lam, links), k)
    np.testing.assert_array_equal(c.numpy(), jc)
    np.testing.assert_allclose(mx.numpy(), jm, **TOL)
    p, q = links[:, 0], links[:, 1]
    at_p = ids[p] == jc[:, None]
    at_q = ids[q] == jc[:, None]
    assert at_p.any(1).all() and at_q.any(1).all()
    # the other tied community: in both rows too, later in p's row
    pair = jc ^ 1
    later = (ids[p] == pair[:, None]).argmax(1) > at_p.argmax(1)
    assert later.all() and (ids[q] == pair[:, None]).any(1).all()
    np.testing.assert_array_equal(vals[p][ids[p] == jc[:, None]] + vals[q][
        ids[q] == jc[:, None]], vals[p][ids[p] == pair[:, None]]
        + vals[q][ids[q] == pair[:, None]])


@pytest.mark.parametrize("k,w,rows", [(12, 4, 64), (40, 12, 256),
                                      (64, 16, 64), (160, 64, 256)])
def test_nan_assignments_match_jax(k, w, rows):
    """synth.nan_topw_state: disjoint rows of rest 0 give every link a NaN
    softmax; the plain version names JAX's community, the link's first
    slot, and its phi is NaN as JAX's."""
    from svinet_torch.synth import nan_topw_state
    ids, vals, rest, lam, links = nan_topw_state(5, k, w, 32, rows)
    jargs = (jnp.asarray(x) for x in (ids, vals, rest, lam, links))
    jc, jm = (np.asarray(x) for x in jsg.sparse_edge_assignments(*jargs,
                                                                 k=k))
    c, mx = sg.sparse_edge_assignments(*_t(ids, vals, rest, lam, links), k)
    np.testing.assert_array_equal(c.numpy(), jc)
    np.testing.assert_array_equal(jc, ids[links[:, 0], 0])
    assert np.isnan(mx.numpy()).all() and np.isnan(jm).all()


def _batch(seed, n, m, pad, with_zero=False):
    """A node's minibatch as the JAX engine gives it (pairs padded to pad
    with (0, 0), the touched list padded to pad + 8 with n, a rho each)
    and as the port's step takes it."""
    rng = np.random.default_rng(seed)
    r = n // 3
    others = rng.choice(np.r_[0:r, r + 1:n], size=m, replace=False)
    if with_zero and m:
        others[-1] = 0
    pairs = np.stack([np.minimum(r, others), np.maximum(r, others)],
                     1).astype(np.int32)
    y = (np.arange(m) < m // 3).astype(np.int32)
    mm = min(m, pad)
    pp = np.zeros((pad, 2), np.int32)
    yy = np.zeros(pad, np.int32)
    ww = np.zeros(pad, np.float32)
    pp[:mm], yy[:mm], ww[:mm] = pairs[:mm], y[:mm], 1.0
    touched = np.full(pad + 8, n, np.int32)
    nodes = np.r_[r, others][:pad + 8]
    touched[:len(nodes)] = nodes
    rho = np.zeros(pad + 8, np.float32)
    rho[:len(nodes)] = rng.uniform(0.05, 0.9, len(nodes))
    rows, rho_rows = fastamm.touched_rows(touched.astype(np.int64), rho, n)
    local = np.searchsorted(rows, pairs[:mm].astype(np.int64))
    return (pp, yy, ww, touched, rho), (rows, rho_rows, local, pairs[:mm],
                                        y[:mm])


@pytest.mark.parametrize("m,pad,with_zero", [
    (40, 64, False), (40, 64, True), (0, 64, False), (80, 64, False)])
def test_dense_step_matches_jax(m, pad, with_zero):
    """Kernel 8's FastAMM form (its plain version): the touched rows and
    node 0 only, the block the padded minibatch, a rho a row; a node
    with no pairs (m = 0) decays toward alpha, and pairs past the pad
    are cut."""
    n, k = 150, 6
    gamma = _dense(5, n, k)
    lam = np.random.default_rng(5).uniform(1, 20, (k, 2)).astype(np.float32)
    eta = np.ones((k, 2), np.float32)
    (pp, yy, ww, touched, rho), (rows, rho_r, local, _, y) = _batch(
        m + pad, n, m, pad, with_zero)
    g_j, l_j = jfastamm.fastamm_step(
        jnp.asarray(gamma), jnp.asarray(lam), jnp.asarray(pp),
        jnp.asarray(yy), jnp.asarray(ww), jnp.asarray(touched),
        jnp.asarray(rho), jnp.float32(0.05), jnp.asarray(eta),
        jnp.float32(n / 2.0), jnp.float32(0.3), jnp.float32(1.0),
        jnp.float32(LOG_EPS), max_iters=50)
    g_t = torch.tensor(gamma)
    l_t = fastamm.fastamm_step(
        g_t, torch.tensor(lam), torch.as_tensor(np.r_[0, rows]),
        torch.as_tensor((local + 1).astype(np.int32).reshape(-1, 2)),
        torch.as_tensor(y), torch.ones(len(y)),
        torch.as_tensor(np.r_[np.float32(0), rho_r]), 0.05,
        torch.tensor(eta), torch.tensor(np.float32(n / 2.0)),
        torch.tensor(np.float32(0.3)), 1.0, LOG_EPS, 50, 1e-5, pad)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), **TOL)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), **TOL)
    untouched = np.setdiff1d(np.arange(n), rows)
    np.testing.assert_array_equal(g_t.numpy()[untouched], gamma[untouched])


@pytest.mark.parametrize("m,pad,n,k,w", [
    (30, 64, N, K, W), (0, 64, N, K, W), (64, 64, N, K, W),
    (300, 512, 400, K, W), (30, 64, N, 160, 96)],
    ids=["30-64", "0-64", "full", "hub", "wide"])
def test_sparse_step_matches_jax(m, pad, n, k, w):
    """Kernel 10's plain version and the update after it: ids, vals, rest
    and lambda after one step. Also a full block (m = pad, no padding
    pair), a start row of more entries than ops/edges.py's SEG_LEN (256:
    the card cuts it into segments) and a width past the narrow form (W =
    96; the card's kernel takes it in registers up to 128)."""
    ids, vals, rest, lam = _state(6, n, k, w)
    eta = np.ones((k, 2), np.float32)
    (pp, yy, ww, touched, rho), (rows, rho_r, local, pairs, y) = _batch(
        7, n, m, pad)
    lp, lq = jfastamm.FastAMM._local_idx(None, pp, touched)
    out_j = jsg.sparse_fastamm_step(
        *(jnp.asarray(a) for a in (ids, vals, rest, lam, pp, yy, ww, lp, lq,
                                   touched, rho)),
        jnp.float32(0.05), jnp.asarray(eta), jnp.float32(n / 2.0),
        jnp.float32(0.3), jnp.float32(1.0), jnp.float32(LOG_EPS), k=k,
        max_iters=50)
    st = [torch.tensor(a) for a in (ids, vals, rest)]
    lam_t = sg.sparse_fastamm_step(
        *st, torch.tensor(lam), torch.as_tensor(pairs), torch.as_tensor(y),
        torch.ones(len(y)), *(torch.as_tensor(local[:, i].astype(np.int32))
                              for i in (0, 1)),
        torch.as_tensor(rows), torch.as_tensor(rho_r), 0.05,
        torch.tensor(eta), torch.tensor(np.float32(n / 2.0)),
        torch.tensor(np.float32(0.3)), 1.0, LOG_EPS, k, 50, 1e-5, pad)
    ids_j, vals_j, rest_j, lam_j = (np.asarray(a) for a in out_j)
    np.testing.assert_array_equal(st[0].numpy(), ids_j)
    np.testing.assert_allclose(st[1].numpy(), vals_j, **TOL)
    np.testing.assert_allclose(st[2].numpy(), rest_j, **TOL)
    np.testing.assert_allclose(lam_t.numpy(), lam_j, **TOL)


# chip_smoke.py's FP_TOL: kernel 10's sums against its plain version, of
# the largest entry
FP_TOL = 1e-4
SIGHT_THRESH = 1e-3


def _sight_batch(seed=8, m=40, pad=64):
    """40 disjoint nonlink pairs of the test state, padded to 64 as the JAX
    engine pads them, each pair end its own row (so that a pair's phis show
    in gamma_hat undiluted), at a threshold where a pair's last rounds
    still move its phis by more than TOL (chip_smoke.py's K10_SIGHT on the
    card)."""
    ids, vals, rest, lam = _state(seed)
    rng = np.random.default_rng(seed)
    nodes = rng.permutation(N)[:2 * m]
    pairs = np.sort(nodes.reshape(m, 2), 1).astype(np.int32)
    pp = np.zeros((pad, 2), np.int32)
    pp[:m] = pairs
    from scipy.special import digamma
    elogbeta = (digamma(lam) - digamma(lam.sum(1, keepdims=True))
                ).astype(np.float32)
    return ids, vals, rest, elogbeta, pairs, pp


def _close_to_max(got, want):
    """max |got - want| over the largest |want| (chip_smoke.py's)."""
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_exit_round_in_sight():
    """The block's R shows in the phis at this state: the port's plain
    fixed point holds JAX's while loop's phis within TOL at its R, and
    parts from them by more than TOL stopped one round early or run one
    round past R, so that a test at TOL sees R."""
    ids, vals, rest, elogbeta, _, pp = _sight_batch()
    p, q = pp[:, 0], pp[:, 1]
    yy = np.zeros(len(pp), np.int32)
    ends = _t(ids[p], vals[p], rest[p], ids[q], vals[q], rest[q], elogbeta,
              yy)
    _, _, p1, p2, r = sg.sparse_phi_fixed_point(*ends, LOG_EPS, K, 50,
                                                SIGHT_THRESH)
    _, _, j1, j2 = _jax_fp(ids, vals, rest, elogbeta, p, q, yy, 50,
                           SIGHT_THRESH)
    assert r >= 2
    np.testing.assert_allclose(p1.numpy(), j1, **TOL)
    np.testing.assert_allclose(p2.numpy(), j2, **TOL)
    for rounds, thresh in ((r - 1, SIGHT_THRESH), (r + 1, -1.0)):
        _, _, a1, a2, got = sg.sparse_phi_fixed_point(*ends, LOG_EPS, K,
                                                      rounds, thresh)
        assert got == rounds
        assert not (np.allclose(a1.numpy(), j1, **TOL)
                    and np.allclose(a2.numpy(), j2, **TOL)), rounds


def test_per_pair_exit_in_sight():
    """A fault the card's check must see: the sums with each pair stopping
    at its own first round below thresh (every pair run alone, a block of
    one) part from JAX's sums, the whole minibatch one block of the exit
    rule, by more than FP_TOL of their largest entry, while the port's
    plain version holds them within it."""
    ids, vals, rest, elogbeta, pairs, pp = _sight_batch()
    m = len(pairs)
    y = np.zeros(m, np.int32)
    w = np.ones(m, np.float32)
    lp = np.arange(0, 2 * m, 2, dtype=np.int32)
    lq = lp + 1
    # JAX's sums from its phis (svinet_tpu/ops/sparse_gamma.py:153-166)
    p, q = pp[:, 0], pp[:, 1]
    yy = np.zeros(len(pp), np.int32)
    js, jf, j1, j2 = _jax_fp(ids, vals, rest, elogbeta, p, q, yy, 50,
                             SIGHT_THRESH)
    wc = jf[:m] * 1.0
    g_j = np.zeros((2 * m, K))
    lam_j = np.zeros((K, 2))
    for i in range(m):
        np.add.at(g_j[lp[i]], js[i], j1[i] * wc[i])
        np.add.at(g_j[lq[i]], js[i], j2[i] * wc[i])
        np.add.at(lam_j[:, 1], js[i], j1[i] * j2[i] * wc[i])
    args = _t(ids, vals, rest, elogbeta)
    g, lam, _ = sg.sparse_fastamm_stats_plain(
        *args, *_t(pairs, y, w, lp, lq), 2 * m, LOG_EPS, 50, SIGHT_THRESH,
        len(pp))
    assert _close_to_max(g.numpy(), g_j) <= FP_TOL
    assert _close_to_max(lam.numpy(), lam_j) <= FP_TOL
    g_f, lam_f = torch.zeros_like(g), torch.zeros_like(lam)
    for i in range(m):
        gi, li, _ = sg.sparse_fastamm_stats_plain(
            *args, *_t(pairs[i:i + 1], y[i:i + 1], w[i:i + 1],
                       lp[i:i + 1], lq[i:i + 1]), 2 * m, LOG_EPS, 50,
            SIGHT_THRESH, 1)
        g_f += gi
        lam_f += li
    assert max(_close_to_max(g_f.numpy(), g_j),
               _close_to_max(lam_f.numpy(), lam_j)) > FP_TOL


def test_workspace_only_grows():
    """Kernel 10's workspace hands out views of buffers that grow, by a
    quarter at least, only when a call asks for more, so that a step of
    sizes seen before allocates nothing."""
    ws = sg.SparseWorkspace("cpu")
    a = ws.take("work", 100, torch.float32)
    assert a.shape == (100,)
    assert ws.take("work", 60, torch.float32).data_ptr() == a.data_ptr()
    b = ws.take("work", 101, torch.float32)
    assert b.shape == (101,) and b.data_ptr() != a.data_ptr()
    assert ws.take("work", 125, torch.float32).data_ptr() == b.data_ptr()
    assert ws.take("rounds", 0, torch.int32).dtype == torch.int32


def test_node_rates_follow_the_jax_loop():
    """A node twice in the touched list: its second place gets the
    counter its first advanced."""
    nodec = np.array([0, 3, 1, 0, 7])
    nodes = np.array([1, 4, 1, 0, 2, 1])
    want, c = [], nodec.copy()
    for a in nodes:
        want.append((1.0 + c[a]) ** -0.5)
        c[a] += 1
    got = fastamm.node_rates(nodes, nodec, 1.0, 0.5)
    np.testing.assert_allclose(got, np.float32(want))
    np.testing.assert_array_equal(nodec, c)


def _cli(main, cwd, net, gt, label, flags, k=4, preprocess=True):
    os.chdir(cwd)
    base = ["-file", net, "-n", "400", "-k", str(k), "-nmi", gt, "-seed",
            "1", "-label", label]
    if preprocess:
        assert main(base + ["-preprocess"]) == 0
    assert main(base + ["-infset", *flags]) == 0
    out = [p for p in pathlib.Path(cwd).iterdir()
           if p.name.startswith(f"n400-k{k}-{label}-seed1")]
    assert len(out) == 1, out
    return out[0]


def _held_to_jax(ours, theirs):
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    for name, ids in (("gamma.txt", 2), ("lambda.txt", 1)):
        a, b = (np.loadtxt(p / name) for p in (ours, theirs))
        np.testing.assert_array_equal(a[:, :ids], b[:, :ids])
        np.testing.assert_allclose(a[:, ids:], b[:, ids:], **TOL)
    a, b = (np.loadtxt(p / "heldout.txt") for p in (ours, theirs))
    assert a.shape == b.shape and len(a) >= 3
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    np.testing.assert_allclose(a[:, 2:], b[:, 2:], **TOL)
    # cmap.txt: the informative sets' sizes, wall time aside
    a, b = (np.loadtxt(p / "cmap.txt") for p in (ours, theirs))
    np.testing.assert_array_equal(a[:, [0, 2, 3]], b[:, [0, 2, 3]])


@pytest.mark.parametrize("k,flags", [
    (4, []), (8, ["-fastqueue", "4"]),
    (160, ["-fastqueue", "96", "-max-iterations", "75", "-rfreq", "25"])],
    ids=["dense", "fastqueue4", "fastqueue96"])
def test_cli_fastamm_matches_jax(planted, tmp_path, monkeypatch, k, flags):
    """Both CLIs after -preprocess: the port's files held to the JAX
    package's; under -fastqueue the community files byte for byte. W = 96
    is past the card kernels' narrow form (W <= 64), where they take their
    wide one; the plain version the CPU runs is the same at every W."""
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    net, gt = planted
    out = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        (tmp_path / name).mkdir()
        out[name] = _cli(main, tmp_path / name, net, gt, name,
                         ["-max-iterations", "300", "-rfreq", "50", *flags],
                         k=k)
    _held_to_jax(out["torch"], out["jax"])
    if flags:
        for name in ("communities.txt", "mcount.txt", "aggregate.txt"):
            assert filecmp.cmp(out["torch"] / name, out["jax"] / name,
                               shallow=False), name


def test_cli_fastamm_resume_continues_the_counters(planted, tmp_path,
                                                   monkeypatch):
    """A dense run cut at iteration 150 with a checkpoint at each report,
    then -resume'd to 300, in both CLIs: the checkpoint holds the per-node
    counters of 151 steps, the resumed run continues them, and its files
    are the JAX package's resumed run's."""
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    net, gt = planted
    base = ["-no-stop", "-rfreq", "50"]
    out = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        cut = tmp_path / name
        cut.mkdir()
        first = _cli(main, cut, net, gt, name,
                     [*base, "-max-iterations", "150", "-checkpoint-freq",
                      "1e-9"])
        if name == "torch":
            state = load_checkpoint(str(first))
            assert state["iteration"] == 151
            # each step touches its start node and every partner
            assert int(state["nodec"].sum()) > 151
        out[name] = _cli(main, cut, net, gt, name,
                         [*base, "-max-iterations", "300", "-resume"],
                         preprocess=False)
        rows = np.loadtxt(out[name] / "heldout.txt")[:, 0]
        np.testing.assert_array_equal(rows, np.arange(50, 301, 50))
    _held_to_jax(out["torch"], out["jax"])


def test_gpu_width_refused_before_the_engine_is_built():
    """The card's kernels take any top-W width the JAX engine takes, 1 <=
    W < K (W = 96 and 128 take their wide form, a region of 20-30 KB a
    pair in shared memory; W = 1,500 one in device scratch); a W of K or
    more, or below 1, is refused before anything launches. The engine no
    longer exits on a wide W (only on W >= K, as the JAX engine does)."""
    for w, k in ((1, 2), (64, 100), (96, 160), (128, 200), (1_500, 3_000)):
        sg._check_width(w, k)
    for w, k in ((0, 8), (160, 160), (200, 160)):
        with pytest.raises(ValueError, match="-fastqueue"):
            sg._check_width(w, k)
    assert not hasattr(sg, "MAX_W")


def test_cli_infset_mesh_runs_one_process(planted, tmp_path, monkeypatch):
    """-infset -mesh 2 runs FastAMM on one device in one process, as the
    JAX CLI does (svinet_tpu/cli.py:403-408): no ranks, the files of the
    run without -mesh."""
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    for flags, want in ((["-infset"], False),
                        (["-infset", "-stratified", "-rnode"], False),
                        (["-infset", "-fastqueue", "2"], False),
                        (["-stratified", "-rnode"], True), ([], True)):
        cfg = parse_args(["-file", "x", "-n", "10", "-k", "4", "-mesh", "2",
                          *flags])
        assert mesh.wants_mesh(cfg) is want, flags

    def no_launch(*args, **kwargs):
        raise AssertionError("-infset spawned mesh ranks")

    monkeypatch.setattr(mesh, "launch", no_launch)
    net, gt = planted
    out = {}
    for name, flags in (("plain", []), ("mesh", ["-mesh", "2"])):
        (tmp_path / name).mkdir()
        out[name] = _cli(torch_main, tmp_path / name, net, gt, "r",
                         ["-max-iterations", "100", "-rfreq", "50", *flags])
    skip = {"infer.log", "param.txt", "time.txt", "mrstats.txt"}
    names = sorted(set(os.listdir(out["plain"])) - skip)
    assert names == sorted(set(os.listdir(out["mesh"])) - skip)
    for name in ("gamma.txt", "lambda.txt", "communities.txt"):
        assert filecmp.cmp(out["plain"] / name, out["mesh"] / name,
                           shallow=False), name
