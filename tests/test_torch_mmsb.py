"""svinet_torch's MMSBInfer (the CLI's default engine) against the JAX
package's, on the CPU: the phi fixed point and its statistics (kernel 8's
plain version), the SVI and batch steps, the ELBO, the minibatch draws,
and whole CLI runs under no engine flag, -rnode, -stratified -rpair,
-batch -logl and -nonuniform -inf.

Both packages stop the fixed point by the JAX block rule: a block of B
pairs (2048 in an engine) runs until the largest change over all its
slots is below the threshold, every slot for the block's rounds, pairs of
weight 0 and the padding of a last partial block included (the port's
padding is one virtual pair (0, 0); the JAX inputs here are padded as the
JAX engine pads them). The port stops a pair's arithmetic at its
bit-stable round, which ends it on the block's bits. So gamma_hat,
lambda_hat, the steps and the ELBO agree to 1e-4 of the largest entry
(ELBO 1e-4 relative) at every K tested, 640 included. Both engines draw
the splits, the training sample, the initial gamma and the minibatches
from one numpy Generator in the same order, so the drawn pairs are
bitwise equal and the report rows agree to 1e-4."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svinet_tpu.cli import main as jax_main
from svinet_tpu.evals.elbo import approx_elbo as jax_elbo
from svinet_tpu.ops.phicomp import phi_fixed_point as jax_fp
from svinet_tpu.svi import mmsb as jmmsb
from svinet_torch.cli import main as torch_main
from svinet_torch.evals.elbo import approx_elbo
from svinet_torch.ops.edges import owner_csr
from svinet_torch.ops.phicomp import (
    NodeUpdate, node_update_plain, pair_block_stats_plain, pair_elbo_plain,
    phi_fixed_point, phi_fixed_point_plain)
from svinet_torch.svi import mmsb
from svinet_torch.synth import write_planted

LOG_EPS = float(np.float32(np.log(1e-30)))
N, K, DEG, GRAPH_SEED = 150, 4, 16, 3
BLOCK = 2048


def _state(seed, n, k, m, links=0.3):
    """Elogpi (n,K), Elogbeta (K,2), pairs, y and weights from a seed."""
    from scipy.special import digamma
    rng = np.random.default_rng(seed)
    gamma = (rng.gamma(1.0, 1.0, size=(n, k)) * 5 + 0.05).astype(np.float32)
    lam = rng.uniform(1, 20, size=(k, 2)).astype(np.float32)
    elogpi = (digamma(gamma) - digamma(gamma.sum(1, keepdims=True))
              ).astype(np.float32)
    elogbeta = (digamma(lam) - digamma(lam.sum(1, keepdims=True))
                ).astype(np.float32)
    pairs = rng.integers(0, n, size=(m, 2)).astype(np.int32)
    y = (rng.random(m) < links).astype(np.int32)
    w = rng.uniform(0.5, 3.0, size=m).astype(np.float32)
    return gamma, lam, elogpi, elogbeta, pairs, y, w


def _jax_padded(pairs, y, w, block=BLOCK):
    """The JAX engine's padding of a minibatch to whole blocks
    (svinet_tpu/svi/mmsb.py:430-438, :467-470): pairs (0, 0), y = 0,
    w = 0. Returns the padded jnp arrays and the number of blocks."""
    m = len(pairs)
    pt = max(block, -(-m // block) * block)
    pp = np.zeros((pt, 2), np.int32)
    yy = np.zeros(pt, np.int32)
    ww = np.zeros(pt, np.float32)
    pp[:m], yy[:m], ww[:m] = pairs, y, w
    return jnp.asarray(pp), jnp.asarray(yy), jnp.asarray(ww), pt // block


def _close_to_max(got, want, tol):
    """|got - want| within tol of the largest |want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), \
        np.abs(got - want).max() / np.abs(want).max()


def _full_loop(ep, eq, elogbeta, y, max_iters=50, thresh=1e-5):
    """One block of the JAX package's rule in the port's arithmetic, every
    round over every row (svinet_tpu/ops/phicomp.py:54-67): (phi1, phi2,
    the block's rounds)."""
    yf = (y == 1)[:, None]
    elogf = torch.where(yf, elogbeta[:, 0], elogbeta[:, 1])
    phi1 = torch.full(ep.shape, 1.0 / ep.shape[1], dtype=ep.dtype)
    phi2 = phi1.clone()
    for i in range(max_iters):
        n1 = torch.softmax(ep + elogf * phi2
                           + torch.where(yf, (1.0 - phi2) * LOG_EPS, 0.0), -1)
        n2 = torch.softmax(eq + elogf * phi1
                           + torch.where(yf, (1.0 - phi1) * LOG_EPS, 0.0), -1)
        change = torch.maximum((n1 - phi1).abs().mean(-1),
                               (n2 - phi2).abs().mean(-1)).max()
        phi1, phi2 = n1, n2
        if not change >= thresh:
            return phi1, phi2, i + 1
    return phi1, phi2, max_iters


def _own_rounds(ep, eq, elogbeta, y):
    """Each pair's rounds as a block of its own."""
    return [_full_loop(ep[i:i + 1], eq[i:i + 1], elogbeta, y[i:i + 1])[2]
            for i in range(ep.shape[0])]


# K = 640: above the 512 columns that kernel 8's first design held in
# registers; there the threshold (a mean over K columns) lets a link pair
# dip below it while its block runs on, so the rule decides where it ends.
@pytest.mark.parametrize("k", [4, 20, 64, 640])
@pytest.mark.parametrize("label", [0, 1])
def test_phi_fixed_point_matches_jax(label, k):
    _, _, elogpi, elogbeta, pairs, _, _ = _state(k + label, 200, k, 512)
    y = np.full(len(pairs), label, np.int32)
    ep, eq = elogpi[pairs[:, 0]], elogpi[pairs[:, 1]]
    j1, j2 = jax_fp(jnp.asarray(ep), jnp.asarray(eq), jnp.asarray(elogbeta),
                    jnp.asarray(y), LOG_EPS)
    tp, tq, tb, ty = (torch.tensor(a) for a in (ep, eq, elogbeta, y))
    # the JAX call is one block of its 512 rows
    t1, t2, rounds = phi_fixed_point_plain(tp, tq, tb, ty, LOG_EPS)
    j1, j2 = np.asarray(j1), np.asarray(j2)
    assert (rounds == rounds[0]).all()
    if k > 512:
        # links at K=640 run the block's 50 rounds without converging, and
        # a few pairs are so ill-conditioned there that f32 itself (the
        # JAX package's or the port's) ends 2e-4 to 1e-3 away from the
        # same rounds in float64: such pairs are counted, at most 1%, and
        # the others held to 2e-4
        d1, d2, _ = phi_fixed_point_plain(tp.double(), tq.double(),
                                          tb.double(), ty, LOG_EPS,
                                          given=rounds)
        f32_err = torch.stack([(a.double() - b).abs().amax(1) for a, b in (
            (t1, d1), (t2, d2), (torch.tensor(j1), d1),
            (torch.tensor(j2), d2))]).amax(0).numpy()
        ok = f32_err <= 2e-4
        assert (~ok).sum() <= 0.01 * len(ok), (~ok).sum()
        t1, t2, j1, j2 = t1[ok], t2[ok], j1[ok], j2[ok]
    np.testing.assert_allclose(t1.numpy(), j1, atol=2e-4)
    np.testing.assert_allclose(t2.numpy(), j2, atol=2e-4)
    np.testing.assert_allclose(t1.sum(-1).numpy(), 1.0, atol=1e-5)
    assert 1 <= int(rounds.min()) and int(rounds.max()) <= 50


@pytest.mark.parametrize("k", [4, 20, 64, 640])
def test_pair_block_stats_matches_jax(k):
    """Random pairs, links and nonlinks, in the JAX package's two blocks
    of 512: pairs that converge in a few rounds and pairs that take all
    50 share a block; the weight-0 pairs iterate with it."""
    _, _, elogpi, elogbeta, pairs, y, w = _state(7 * k, 200, k, 1024)
    w[-30:] = 0.0      # -inf's mask: rounds, nothing added
    jg, jl = jmmsb.pair_block_stats(
        jnp.asarray(elogpi), jnp.asarray(elogbeta), jnp.asarray(pairs),
        jnp.asarray(y), jnp.asarray(w), 2, LOG_EPS, 50, 1e-5)
    args = [torch.tensor(a) for a in (elogpi, elogbeta, pairs, y, w)]
    tg, tl, rounds = pair_block_stats_plain(*args, LOG_EPS, 50, 1e-5,
                                            block=512)
    _close_to_max(tg.numpy(), jg, 1e-4)
    _close_to_max(tl.numpy(), jl, 1e-4)
    r = rounds.numpy().reshape(2, 512)
    assert (r == r[:, :1]).all() and r.min() >= 1


@pytest.mark.parametrize("block,num_blocks", [(512, 2), (256, 4),
                                              (1024, 1)])
def test_block_size_matches_jax_blocks(block, num_blocks):
    """The rule's block is the caller's: 1024 pairs cut at `block` are the
    JAX package's num_blocks blocks, rounds and statistics alike."""
    _, _, elogpi, elogbeta, pairs, y, w = _state(31, 200, 20, 1024)
    jg, jl = jmmsb.pair_block_stats(
        jnp.asarray(elogpi), jnp.asarray(elogbeta), jnp.asarray(pairs),
        jnp.asarray(y), jnp.asarray(w), num_blocks, LOG_EPS, 50, 1e-5)
    args = [torch.tensor(a) for a in (elogpi, elogbeta, pairs, y, w)]
    tg, tl, rounds = pair_block_stats_plain(*args, LOG_EPS, 50, 1e-5,
                                            block=block)
    _close_to_max(tg.numpy(), jg, 1e-4)
    _close_to_max(tl.numpy(), jl, 1e-4)
    ep, eq = args[0][args[2][:, 0].long()], args[0][args[2][:, 1].long()]
    want = [_full_loop(ep[lo:lo + block], eq[lo:lo + block], args[1],
                       args[3][lo:lo + block])[2]
            for lo in range(0, 1024, block)]
    assert rounds.reshape(num_blocks, block).tolist() == [
        [r] * block for r in want]


def test_slow_weight0_pair_sets_its_block_rounds():
    """A pair of weight 0 (a nonlink that -inf masks) still counts in its
    block's rounds: nonlinks that converge in a few rounds share a block
    with the slowest pair, at weight 0, which holds the block to its own
    rounds, as in the JAX package."""
    k = 20
    _, _, elogpi, elogbeta, pairs, y, w = _state(43, 200, k, 512,
                                                 links=0.0)
    ep, eq = torch.tensor(elogpi[pairs[:, 0]]), torch.tensor(
        elogpi[pairs[:, 1]])
    tb = torch.tensor(elogbeta)
    # the slowest of the first 20 pairs taken as a link
    as_link = _own_rounds(ep[:20], eq[:20], tb,
                          torch.ones(20, dtype=torch.int32))
    slow = int(np.argmax(as_link))
    y[slow], w[slow] = 1, 0.0
    own = np.array(_own_rounds(ep, eq, tb, torch.tensor(y)))
    assert own[slow] == max(as_link) > np.delete(own, slow).max()
    jg, jl = jmmsb.pair_block_stats(
        jnp.asarray(elogpi), jnp.asarray(elogbeta), jnp.asarray(pairs),
        jnp.asarray(y), jnp.asarray(w), 1, LOG_EPS, 50, 1e-5)
    args = [torch.tensor(a) for a in (elogpi, elogbeta, pairs, y, w)]
    tg, tl, rounds = pair_block_stats_plain(*args, LOG_EPS, 50, 1e-5,
                                            block=512)
    _close_to_max(tg.numpy(), jg, 1e-4)
    _close_to_max(tl.numpy(), jl, 1e-4)
    assert (rounds == int(own[slow])).all()
    # without it the block would have stopped sooner
    rest = np.delete(np.arange(512), slow)
    _, _, r_rest = phi_fixed_point_plain(ep[rest], eq[rest], tb,
                                         torch.tensor(y[rest]), LOG_EPS)
    assert int(r_rest[0]) < int(own[slow])


def test_virtual_pad_pair_is_the_slowest_slot():
    """The padding of a last partial block is one pair (0, 0), a nonlink,
    that takes part in the block's rounds without being stored: made the
    slowest slot here (node 0's row is one whose nonlink with itself takes
    the most rounds), it sets the last block's rounds, as the JAX
    package's explicit padding does."""
    k, m = 20, 2048 + 300
    _, _, elogpi, elogbeta, pairs, y, w = _state(47, 400, k, m, links=0.0)
    ep_all = torch.tensor(elogpi)
    tb = torch.tensor(elogbeta)
    # node 0 becomes the node whose pair with itself is slowest
    selfs = _own_rounds(ep_all, ep_all, tb, torch.zeros(400,
                                                        dtype=torch.int32))
    slowest = int(np.argmax(selfs))
    elogpi[0] = elogpi[slowest]
    pairs[pairs == 0] = 1
    jp, jy, jw, nb = _jax_padded(pairs, y, w)
    jg, jl = jmmsb.pair_block_stats(
        jnp.asarray(elogpi), jnp.asarray(elogbeta), jp, jy, jw, nb, LOG_EPS,
        50, 1e-5)
    args = [torch.tensor(a) for a in (elogpi, elogbeta, pairs, y, w)]
    tg, tl, rounds = pair_block_stats_plain(*args, LOG_EPS, 50, 1e-5)
    _close_to_max(tg.numpy(), jg, 1e-4)
    _close_to_max(tl.numpy(), jl, 1e-4)
    ep = args[0][args[2][:, 0].long()][2048:]
    eq = args[0][args[2][:, 1].long()][2048:]
    _, _, unpadded = phi_fixed_point_plain(ep, eq, tb, args[3][2048:],
                                           LOG_EPS)
    assert int(rounds[-1]) == max(selfs) > int(unpadded[0])
    assert (rounds[2048:] == rounds[-1]).all()


@pytest.mark.parametrize("k", [8, 64, 640])
def test_bit_stable_stop_equals_full_loop(k):
    """The plain version leaves a pair at its bit-stable round and the
    block's other pairs compacted: the phis are the bits of every pair run
    for the block's rounds."""
    _, _, elogpi, elogbeta, pairs, y, _ = _state(53 + k, 300, k, 1024)
    ep = torch.tensor(elogpi[pairs[:, 0]])
    eq = torch.tensor(elogpi[pairs[:, 1]])
    tb, ty = torch.tensor(elogbeta), torch.tensor(y)
    p1, p2, rounds = phi_fixed_point_plain(ep, eq, tb, ty, LOG_EPS)
    f1, f2, r = _full_loop(ep, eq, tb, ty)
    assert (rounds == r).all()
    assert torch.equal(p1, f1) and torch.equal(p2, f2)
    # the same on given rounds, in float64
    g1, g2, _ = phi_fixed_point_plain(ep.double(), eq.double(), tb.double(),
                                      ty, LOG_EPS, given=rounds)
    h1, h2, _ = _full_loop(ep.double(), eq.double(), tb.double(), ty,
                           max_iters=r, thresh=-1.0)
    assert torch.equal(g1, h1) and torch.equal(g2, h2)


def test_block_with_a_pair_that_never_converges_takes_max_iters():
    """A link pair whose change stays above the threshold for all 50
    rounds holds its block to max_iters; the other pairs of the block take
    those rounds too."""
    k = 64
    _, _, elogpi, elogbeta, pairs, y, w = _state(43, 200, k, 300)
    ep = torch.tensor(elogpi[pairs[:, 0]])
    eq = torch.tensor(elogpi[pairs[:, 1]])
    tb, ty = torch.tensor(elogbeta), torch.tensor(y)
    own = np.array(_own_rounds(ep, eq, tb, ty))
    stuck = np.nonzero(own == 50)[0]
    assert len(stuck) and (own < 50).any()
    # one pair that never converges among pairs that do
    keep = np.concatenate([np.nonzero(own < 50)[0], stuck[:1]])
    jg, jl = jmmsb.pair_block_stats(
        jnp.asarray(elogpi), jnp.asarray(elogbeta),
        jnp.asarray(pairs[keep]), jnp.asarray(y[keep]), jnp.asarray(w[keep]),
        1, LOG_EPS, 50, 1e-5)
    args = [torch.tensor(a) for a in (elogpi, elogbeta, pairs[keep],
                                      y[keep], w[keep])]
    tg, tl, rounds = pair_block_stats_plain(*args, LOG_EPS, 50, 1e-5,
                                            block=len(keep))
    assert (rounds == 50).all()
    _close_to_max(tg.numpy(), jg, 1e-4)
    _close_to_max(tl.numpy(), jl, 1e-4)


def test_endpoint_csr_lists_every_slot_in_order():
    """Kernel 8's CSR of the pairs' ends: slot 2i is pair i's first end,
    2i + 1 its second; each node's slots ascending, a hub in segments."""
    pairs = torch.tensor([[0, 3], [3, 1], [2, 3], [3, 0]], dtype=torch.int32)
    csr = owner_csr(pairs.reshape(-1), 5, seg_len=2)
    rowptr, nbr = csr.rowptr.tolist(), csr.nbr.tolist()
    assert rowptr == [0, 2, 3, 4, 8, 8]
    assert nbr == [0, 7, 3, 4, 1, 2, 5, 6]
    assert csr.hub_node.tolist() == [3]
    assert csr.seg_begin.tolist() == [4, 6] and csr.seg_end.tolist() == [6, 8]


def test_nonuniform_weights_match_jax():
    gamma, _, _, _, pairs, y, _ = _state(11, 100, 6, 3000, links=0.1)
    mask = np.ones(len(pairs), np.float32)
    mask[-50:] = 0.0
    jw, jn = jmmsb.nonuniform_weights(
        jnp.asarray(gamma), jnp.asarray(pairs), jnp.asarray(y),
        jnp.asarray(mask), 0.2)
    tw, tn = mmsb.nonuniform_weights(
        torch.tensor(gamma), torch.tensor(pairs), torch.tensor(y),
        torch.tensor(mask), 0.2)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert int(tn) == int(jn)


def _svi_pair(gamma, lam, pairs, y, w, k, sc=37.5, infthresh=0.0,
              nonuniform=False):
    """One SVI step of each package on the same inputs, the JAX one on the
    engine's padded minibatch: ((jax gamma, lambda), (port's))."""
    alpha, eta = 1.0 / k, np.tile([1.0, 1.0], (k, 1)).astype(np.float32)
    args = (np.float32(sc), np.float32(sc), np.float32(0.7),
            np.float32(0.4), np.float32(1.0))
    jp, jy, jw, nb = _jax_padded(pairs, y, w)
    jg, jl = jmmsb.svi_step(
        jnp.asarray(gamma), jnp.asarray(lam), jp, jy, jw, jnp.float32(alpha),
        jnp.asarray(eta), *(jnp.asarray(a) for a in args),
        jnp.float32(LOG_EPS), num_blocks=nb, max_iters=50,
        infthresh=infthresh, nonuniform=nonuniform)
    tg, tl = mmsb.svi_step(
        torch.tensor(gamma), torch.tensor(lam), torch.tensor(pairs),
        torch.tensor(y), torch.tensor(w), alpha, torch.tensor(eta),
        *(torch.tensor(a) for a in args), LOG_EPS, 50, infthresh=infthresh,
        nonuniform=nonuniform)
    return (jg, jl), (tg, tl)


@pytest.mark.parametrize("infthresh,nonuniform,k",
                         [(0.0, False, 8), (0.2, False, 8), (0.2, True, 8),
                          (0.0, False, 640), (0.002, False, 640),
                          (0.002, True, 640)],
                         ids=["plain", "inf", "nonuniform", "plain-k640",
                              "inf-k640", "nonuniform-k640"])
def test_svi_step_matches_jax(infthresh, nonuniform, k):
    gamma, lam, _, _, pairs, y, w = _state(5, 120, k, 600)
    w[:] = 1.0
    (jg, jl), (tg, tl) = _svi_pair(gamma, lam, pairs, y, w, k,
                                   1.0 if nonuniform else 37.5, infthresh,
                                   nonuniform)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)


def test_batch_step_and_elbo_match_jax():
    _batch_step_and_elbo(5)


def test_batch_step_and_elbo_match_jax_k640():
    _batch_step_and_elbo(640)


def _batch_step_and_elbo(k):
    gamma, lam, _, _, _, _, _ = _state(9, 60, k, 1)
    (jg, jl), (tg, tl), (je, te) = _batch_pair(gamma, lam, k)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    assert float(te) == pytest.approx(float(je), rel=1e-4)


def _batch_pair(gamma, lam, k):
    """-batch's step and the ELBO over all 1,770 pairs of 60 nodes (one
    partial block, padded in the JAX calls as the JAX engine pads it), in
    each package: ((jax gamma, lambda), (port's), (jax ELBO, port's))."""
    iu = np.triu_indices(60, 1)
    pairs = np.stack(iu, 1).astype(np.int32)
    y = (np.random.default_rng(2).random(len(pairs)) < 0.1).astype(np.int32)
    w = np.ones(len(pairs), np.float32)
    alpha, eta = 0.2, np.tile([1.0, 3.0], (k, 1)).astype(np.float32)

    def j():    # fresh arrays: batch_step donates gamma and lambda
        return (jnp.asarray(gamma), jnp.asarray(lam),
                *_jax_padded(pairs, y, w)[:3])

    nb = _jax_padded(pairs, y, w)[3]
    t = [torch.tensor(a) for a in (gamma, lam, pairs, y, w)]
    jg, jl = jmmsb.batch_step(*j(), jnp.float32(alpha), jnp.asarray(eta),
                              jnp.float32(1.0), jnp.float32(LOG_EPS),
                              num_blocks=nb, max_iters=50)
    tg, tl = mmsb.batch_step(*t, alpha, torch.tensor(eta), 1.0, LOG_EPS, 50)
    je = jax_elbo(*j(), jnp.float32(alpha), jnp.asarray(eta),
                  jnp.float32(LOG_EPS), num_blocks=nb)
    te = approx_elbo(*t, alpha, torch.tensor(eta), LOG_EPS)
    return (jg, jl), (tg, tl), (je, te)


@pytest.mark.parametrize("k", [8, 64, 640])
@pytest.mark.parametrize("part", ["pair_block_stats", "svi_step",
                                  "batch_step"])
def test_block_rule_matches_jax(part, k):
    """The port's own path, no `given` and no stand-in, against the JAX
    package's at 1e-4 of the largest entry (the ELBO 1e-4 relative):
    gamma_hat and lambda_hat of 1,500 pairs with weight-0 pairs among
    them in one partial block of 2048; an SVI step; a -batch step and the
    ELBO."""
    def gap(got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        return np.abs(got - want).max() / np.abs(want).max()

    if part == "pair_block_stats":
        _, _, elogpi, elogbeta, pairs, y, w = _state(7 * k, 200, k, 1500)
        w[::7] = 0.0
        jp, jy, jw, nb = _jax_padded(pairs, y, w)
        jg, jl = jmmsb.pair_block_stats(
            jnp.asarray(elogpi), jnp.asarray(elogbeta), jp, jy, jw, nb,
            LOG_EPS, 50, 1e-5)
        args = [torch.tensor(a) for a in (elogpi, elogbeta, pairs, y, w)]
        tg, tl, rounds = pair_block_stats_plain(*args, LOG_EPS, 50, 1e-5)
        assert (rounds == rounds[0]).all()
    elif part == "svi_step":
        gamma, lam, _, _, pairs, y, w = _state(5, 120, k, 600)
        w[:] = 1.0
        (jg, jl), (tg, tl) = _svi_pair(gamma, lam, pairs, y, w, k)
    else:
        gamma, lam, _, _, _, _, _ = _state(9, 60, k, 1)
        (jg, jl), (tg, tl), (je, te) = _batch_pair(gamma, lam, k)
        assert abs(float(te) - float(je)) <= 1e-4 * abs(float(je))
    assert gap(tg, jg) <= 1e-4, gap(tg, jg)
    assert gap(tl, jl) <= 1e-4, gap(tl, jl)


@pytest.mark.parametrize("k", [8, 640])
@pytest.mark.parametrize("batch", [False, True], ids=["svi", "batch"])
def test_node_update_plain_matches_jax_steps(batch, k):
    """The node pass's update in plain PyTorch (ops/phicomp.py:
    node_update_plain) over the plain statistics: the JAX package's
    svi_step and batch_step on the same seeded inputs."""
    gamma, lam, elogpi, elogbeta, pairs, y, w = _state(13, 100, k, 500)
    w[:] = 1.0
    alpha = np.float32(1.0 / k)
    eta = np.tile([1.0, 2.0], (k, 1)).astype(np.float32)
    from scipy.special import digamma
    elogpi = (digamma(gamma) - digamma(gamma.sum(1, keepdims=True))
              ).astype(np.float32)
    args = [torch.tensor(a) for a in (elogpi, elogbeta, pairs, y, w)]
    gacc, _, _ = pair_block_stats_plain(*args, LOG_EPS, 50, 1e-5)
    j = [jnp.asarray(gamma), jnp.asarray(lam), *_jax_padded(pairs, y, w)]
    nb = j.pop()
    if batch:
        jg, _ = jmmsb.batch_step(*j, jnp.float32(alpha), jnp.asarray(eta),
                                 jnp.float32(0.0), jnp.float32(LOG_EPS),
                                 num_blocks=nb, max_iters=50)
        upd = NodeUpdate(None, float(alpha))
    else:
        gs, nr = np.float32(41.5), np.float32(0.6)
        jg, _ = jmmsb.svi_step(*j, jnp.float32(alpha), jnp.asarray(eta),
                               jnp.float32(gs), jnp.float32(gs),
                               jnp.float32(nr), jnp.float32(0.1),
                               jnp.float32(0.0), jnp.float32(LOG_EPS),
                               num_blocks=nb, max_iters=50)
        upd = NodeUpdate(torch.tensor(gamma), float(alpha), torch.tensor(gs),
                         torch.tensor(nr))
    tg = node_update_plain(gacc, upd)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4)
    # the wrapper on the CPU takes the same path
    ug, _, _ = phi_fixed_point(*args, LOG_EPS, 50, 1e-5, update=upd)
    assert torch.equal(ug, tg)


# --- the engine, end to end -----------------------------------------------

MODES = {
    "default": ["-max-iterations", "200", "-rfreq", "10"],
    "rnode": ["-rnode", "-max-iterations", "160", "-rfreq", "10"],
    "stratified": ["-stratified", "-rpair", "-max-iterations", "200",
                   "-rfreq", "10"],
    "batch_logl": ["-batch", "-logl", "-max-iterations", "5"],
    "nonuniform": ["-rnode", "-nonuniform", "-inf", "0.3",
                   "-max-iterations", "60", "-rfreq", "10"],
}


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    d = tmp_path_factory.mktemp("mmsb")
    net, gt = write_planted(str(d), N, K, DEG, GRAPH_SEED)
    return d, net, gt


def _args(net, gt, label, flags):
    return ["-file", net, "-n", str(N), "-k", str(K), "-nmi", gt, "-seed",
            "1", "-label", label, *flags]


def _outdir(root, label):
    d = [p for p in os.listdir(root) if p.startswith(f"n{N}-k{K}-{label}-")]
    assert len(d) == 1, d
    return root / d[0]


@pytest.fixture(scope="module")
def runs(planted):
    """Both CLIs under every mode, each in its own directory."""
    d, net, gt = planted
    out = {}
    cwd = os.getcwd()
    os.environ["SVINET_TORCH_DEVICE"] = "cpu"
    try:
        for mode, flags in MODES.items():
            for name, main in (("jax", jax_main), ("torch", torch_main)):
                run_dir = d / f"{mode}-{name}"
                run_dir.mkdir()
                os.chdir(run_dir)
                assert main(_args(net, gt, name, flags)) == 0
                out[mode, name] = _outdir(run_dir, name)
    finally:
        os.chdir(cwd)
        os.environ.pop("SVINET_TORCH_DEVICE", None)
    return out


def _rows(path, name):
    return np.loadtxt(path / name, ndmin=2)


@pytest.mark.parametrize("mode", list(MODES))
def test_report_rows_match_jax(runs, mode):
    """heldout.txt and validation.txt: iterations and counts equal, the
    likelihood columns to 1e-4 relative; the duration column is wall
    time and is not compared."""
    t, j = runs[mode, "torch"], runs[mode, "jax"]
    for name in ("heldout.txt", "validation.txt", "training.txt"):
        a, b = _rows(t, name), _rows(j, name)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if not len(a):
            continue
        counts = [0, 3, 5, 7]
        np.testing.assert_array_equal(a[:, counts], b[:, counts])
        vals = [c for c in range(2, a.shape[1]) if c not in counts]
        np.testing.assert_allclose(a[:, vals], b[:, vals], rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("mode", list(MODES))
def test_max_modularity_and_nmi_match_jax(runs, mode):
    t, j = runs[mode, "torch"], runs[mode, "jax"]
    tm = open(t / "max.txt").read().split()
    jm = open(j / "max.txt").read().split()
    assert len(tm) == len(jm) == 7, (tm, jm)
    assert tm[0] == jm[0]
    np.testing.assert_allclose([float(x) for x in tm[2:6]],
                               [float(x) for x in jm[2:6]], rtol=1e-4,
                               atol=1e-5)
    a, b = _rows(t, "modularity.txt"), _rows(j, "modularity.txt")
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    np.testing.assert_allclose(a[:, 2:], b[:, 2:], atol=1.5e-5)
    nt = float(open(t / "mutual.txt").read().split()[-1])
    nj = float(open(j / "mutual.txt").read().split()[-1])
    assert abs(nt - nj) <= 0.02, (nt, nj)
    assert sorted(os.listdir(t)) == sorted(os.listdir(j))


def test_logl_and_batch_stop_match_jax(runs):
    t, j = runs["batch_logl", "torch"], runs["batch_logl", "jax"]
    a, b = _rows(t, "logl.txt"), _rows(j, "logl.txt")
    # -batch reports every iteration, 1 to max-iterations + 1
    assert len(a) == len(b) == 6
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    np.testing.assert_allclose(a[:, 2], b[:, 2], rtol=1e-4)


def test_some_run_stops_and_records_validation(runs):
    """The stop guard is min(n, 5000) = 150 iterations: the sampled runs
    pass it, and a new maximum writes an 8-column validation.txt row."""
    v = _rows(runs["default", "torch"], "validation.txt")
    assert v.shape[1] == 8 and len(v) >= 1
    assert int(v[0, 0]) > N


@pytest.mark.parametrize("flags", [[], ["-stratified", "-rpair"],
                                   ["-rnode"], ["-rnode", "-scale", "3"]],
                         ids=["rpair", "stratified", "rnode", "rnode_scale"])
def test_drawn_minibatches_bitwise_equal_jax(planted, tmp_path, monkeypatch,
                                             flags):
    from svinet_tpu.cli import parse_args as jax_parse
    from svinet_tpu.graph import Network as JaxNetwork
    from svinet_torch.cli import parse_args
    from svinet_torch.graph import Network
    _, net, gt = planted
    monkeypatch.chdir(tmp_path)
    engines = []
    for name, parse, network, make in (
            ("jax", jax_parse, JaxNetwork,
             lambda c, nw: jmmsb.MMSBInfer(c, nw)),
            ("torch", parse_args, Network,
             lambda c, nw: mmsb.MMSBInfer(c, nw, torch.device("cpu")))):
        cfg = parse(_args(net, gt, name, flags))
        nw = network(cfg)
        nw.read(cfg.datfname)
        nw.drop_singles()
        engines.append(make(cfg, nw))
    je, te = engines
    np.testing.assert_array_equal(te.gamma.numpy(), np.asarray(je.gamma))
    for it in range(1, 12):
        jb = je._prepare_minibatch(it)
        tb = te._prepare_minibatch(it)
        m = len(tb[0])
        np.testing.assert_array_equal(tb[0], jb[0][:m])
        np.testing.assert_array_equal(tb[1], jb[1][:m])
        np.testing.assert_array_equal(tb[2], jb[2][:m])
        assert not jb[2][m:].any()
        for a, b in zip(tb[3:8], jb[3:8]):
            assert np.float32(a) == np.float32(b)
    te.close()
