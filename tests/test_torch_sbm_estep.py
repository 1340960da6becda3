"""SBM's E-step on CPU tensors: sbm_estep (the plain E-step there) and
the rounds kernel 14's driver makes (_estep_rounds: the round's rows
written apart from its input, a chunk reading the chunks before it from
the round's output and every other row from its input, the two swapped
after the round, phi taking the last round's rows), each chunk through
estep_chunk's plain version, the chunks' column sums renewed in chunk
order. Held to the JAX package's E-step (svinet_tpu/svi/sbm.py:76
sbm_batch_step) at K = 20 and K = 600, phi at 1e-4 on the same rounds,
and to the port's own plain E-step."""

import numpy as np
import pytest
import torch

from svinet_torch.ops.edges import build_adjacency
from svinet_torch.svi import sbm
from svinet_torch.svi.sbm import N_CHUNKS

from test_torch_sbm import TOL, _jax_batch, _problem


@pytest.fixture(autouse=True)
def one_thread():
    """Many small tensor operations: one intra-op thread keeps a loaded
    machine from slowing them tenfold (the results do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _estep_inputs(phi, gamma, lam):
    k = phi.shape[1]
    elogpi, elogbeta = sbm._expectations(torch.tensor(gamma),
                                         torch.tensor(lam))
    da = (elogbeta[:k, 0] - elogbeta[k, 0]).contiguous()
    db = (elogbeta[:k, 1] - elogbeta[k, 1]).contiguous()
    return elogpi.contiguous(), da, db


@pytest.mark.parametrize("k,n", [(20, 300), (600, 700)])
def test_estep_matches_jax(k, n):
    """sbm_estep and the driver's rounds on CPU tensors against the JAX
    batch step's phi at 1e-4: the JAX while loop's count is the port's R
    (stopping at R gives its result, stopping at R - 1 does not); phi
    comes back in the caller's tensor whichever buffer the last round
    wrote."""
    n, e, held, phi, gamma, lam = _problem(k, 3, n)
    eta = np.ones((k + 1, 2), np.float32)
    n_valid = float(n * (n - 1) // 2 - len(held))
    elogpi, da, db = _estep_inputs(phi, gamma, lam)
    la, ha = build_adjacency(e, n), build_adjacency(held, n)
    phi_t = torch.tensor(phi)
    out, r = sbm._estep_rounds(phi_t, elogpi, da, db, la, ha,
                               sbm.ESTEP_ROUNDS, sbm.ESTEP_THRESH,
                               sbm.estep_buffers(n, k, "cpu"))
    assert out is phi_t and 1 < r <= sbm.ESTEP_ROUNDS
    want = _jax_batch(phi, gamma, lam, e, held, eta, n_valid, r)[0]
    np.testing.assert_allclose(phi_t.numpy(), want, **TOL)
    plain, r_p = sbm.sbm_estep(torch.tensor(phi), elogpi, da, db, la, ha)
    assert r_p == r
    np.testing.assert_allclose(plain.numpy(), want, **TOL)
    if r < sbm.ESTEP_ROUNDS:
        more = _jax_batch(phi, gamma, lam, e, held, eta, n_valid,
                          sbm.ESTEP_ROUNDS)[0]
        assert np.array_equal(more, want)
    before = _jax_batch(phi, gamma, lam, e, held, eta, n_valid, r - 1)[0]
    assert not np.array_equal(before, want)


@pytest.mark.parametrize("k", [4, 20])
def test_estep_equals_plain_estep(k):
    """The driver's rounds and sbm_estep_plain (phi in place, tot
    phi.sum(0) before each chunk): the same rounds, phi at 1e-4 (the two
    add tot in other orders, and the rounds carry the difference on).
    After one round (an odd count) phi holds the output buffer's rows,
    bit for bit those of the round's chunks run one by one."""
    n, e, held, phi, gamma, lam = _problem(k, 4, 400)
    elogpi, da, db = _estep_inputs(phi, gamma, lam)
    la, ha = build_adjacency(e, n), build_adjacency(held, n)
    bufs = sbm.estep_buffers(n, k, "cpu")
    got = torch.tensor(phi)
    out, r = sbm._estep_rounds(got, elogpi, da, db, la, ha,
                               sbm.ESTEP_ROUNDS, sbm.ESTEP_THRESH, bufs)
    want, r_p = sbm.sbm_estep_plain(torch.tensor(phi), elogpi, da, db, la,
                                    ha)
    assert out is got and r == r_p
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    got = torch.tensor(phi)
    _, r = sbm._estep_rounds(got, elogpi, da, db, la, ha, 1,
                             sbm.ESTEP_THRESH, bufs)
    src, dst = torch.tensor(phi), torch.empty((n, k))
    sbm.chunk_sums(src, bufs)
    for c in range(N_CHUNKS):
        sbm.estep_chunk(src, dst, elogpi, da, db, la, ha, c, bufs)
    assert r == 1 and torch.equal(got, dst)


def test_chunk_reads_earlier_chunks_from_the_output():
    """estep_chunk(src, dst, ..., c): the rows of chunks before c come
    from dst, every other row from src; only chunk c's rows of dst
    change, src not at all; partial[c] and tot are renewed from the new
    rows in chunk order."""
    k, c = 8, 3
    n, e, held, phi, gamma, lam = _problem(k, 5, 200)
    elogpi, da, db = _estep_inputs(phi, gamma, lam)
    la, ha = build_adjacency(e, n), build_adjacency(held, n)
    rng = np.random.default_rng(6)
    src = torch.tensor(phi)
    dst0 = torch.tensor(rng.dirichlet(np.ones(k), n).astype(np.float32))
    before = (torch.arange(n) % N_CHUNKS < c)[:, None]
    seen = torch.where(before, dst0, src)
    bufs = sbm.estep_buffers(n, k, "cpu")
    sbm.chunk_sums(seen, bufs)
    np.testing.assert_allclose(bufs.tot.numpy(), seen.sum(0).numpy(),
                               rtol=1e-6)
    tot = bufs.tot.clone()
    dst = dst0.clone()
    sbm.estep_chunk(src, dst, elogpi, da, db, la, ha, c, bufs)
    want, ch = sbm.estep_chunk_plain(seen, elogpi, da, db, tot, la, ha, c)
    assert torch.equal(dst[c::N_CHUNKS], want)
    assert torch.equal(bufs.change[c::N_CHUNKS], ch)
    mine = torch.arange(n) % N_CHUNKS == c
    assert torch.equal(dst[~mine], dst0[~mine])
    assert torch.equal(src, torch.tensor(phi))
    # a neighbour's chunk decides its source: read all from src, chunk 3's
    # rows come out otherwise
    other, _ = sbm.estep_chunk_plain(src, elogpi, da, db, tot, la, ha, c)
    assert not torch.equal(other, want)
    assert torch.equal(bufs.partial[c], want.sum(0))
    after = torch.where((torch.arange(n) % N_CHUNKS <= c)[:, None], dst,
                        src)
    np.testing.assert_allclose(bufs.tot.numpy(), after.sum(0).numpy(),
                               rtol=1e-6)
