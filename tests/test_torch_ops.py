"""svinet_torch ops against the JAX package: the Dirichlet expectation
(kernel 1's plain version) and the edge padding/blocking helpers.

Inputs come from numpy with a fixed seed and go to both packages. On the
CPU the port's wrappers take their plain versions; the CUDA kernels are
held against those on the card by chip_smoke.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from svinet_tpu.ops.expectations import dirichlet_expectation as jax_dexp
from svinet_tpu.ops.pallas_digamma import dirichlet_expectation_pallas
from svinet_torch.ops.edges import (
    BLOCK_BUDGET_BYTES, SEG_LEN, build_adjacency, choose_edge_block,
    pad_edges)
from svinet_torch.ops.expectations import (
    dirichlet_expectation, dirichlet_expectation_plain, dirichlet_mean)


def _gamma_like(shape, seed):
    return np.random.default_rng(seed).uniform(0.01, 10.0, size=shape
                                               ).astype(np.float32)


@pytest.mark.parametrize("shape", [(17, 5), (64, 20), (300, 2)])
def test_dirichlet_expectation_matches_jax(shape):
    x = _gamma_like(shape, seed=shape[0])
    got = dirichlet_expectation(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_dexp(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_dirichlet_expectation_matches_pallas_kernel():
    """The TPU kernel (interpreted on the CPU, as its own tests run it)
    against the port's plain version, at the TPU kernel's 5e-5 bar."""
    x = _gamma_like((64, 20), seed=2)
    got = dirichlet_expectation_plain(torch.from_numpy(x)).numpy()
    want = np.asarray(dirichlet_expectation_pallas(jnp.asarray(x)))
    assert np.abs(got - want).max() < 5e-5


def test_dirichlet_mean():
    x = torch.tensor([[1.0, 3.0], [2.0, 2.0]])
    np.testing.assert_allclose(dirichlet_mean(x).numpy(),
                               [[0.25, 0.75], [0.5, 0.5]])


def test_wrapper_refuses_other_devices():
    """A wrapper takes the plain path only for a CPU tensor; any other
    non-CUDA tensor is refused rather than silently moved."""
    with pytest.raises(ValueError, match="cuda"):
        dirichlet_expectation(torch.ones((4, 3), device="meta"))


@pytest.mark.parametrize("n_edges,block", [(0, 64), (1, 64), (100, 64),
                                           (128, 64), (1000, 256)])
def test_pad_edges_invariants(n_edges, block):
    edges = np.random.default_rng(n_edges).integers(
        0, 50, size=(n_edges, 2)).astype(np.int32)
    out, mask = pad_edges(edges, block)
    assert out.dtype == np.int32 and mask.dtype == np.float32
    assert out.shape[0] % block == 0 and out.shape[0] >= max(block, n_edges)
    assert mask.shape == (out.shape[0],)
    np.testing.assert_array_equal(out[:n_edges], edges)
    assert mask[:n_edges].all() and not mask[n_edges:].any()
    assert not out[n_edges:].any()


@pytest.mark.parametrize("n_edges,k", [(1, 4), (100, 4), (190_000, 20),
                                       (2_000_000, 500), (20_000_000, 500),
                                       (5_000, 100_000)])
def test_choose_edge_block_invariants(n_edges, k):
    block = choose_edge_block(n_edges, k)
    assert block >= 64 and block & (block - 1) == 0      # a power of two
    limit = max(8192, BLOCK_BUDGET_BYTES // (4 * k))
    assert block <= limit                                # within budget
    if n_edges <= limit:
        # small edge sets run as one block unless it would pass the budget
        assert block >= n_edges or block * 2 > limit


def _links(n, n_links, seed, hub_deg=0):
    """Unique links p < q over nodes 1..n-6 (node 0 and the last 5 nodes
    get none), plus a hub at node 0 joined to hub_deg others."""
    rng = np.random.default_rng(seed)
    p = rng.integers(1, n - 5, size=n_links)
    q = rng.integers(1, n - 5, size=n_links)
    links = np.stack([np.minimum(p, q), np.maximum(p, q)], 1)[p != q]
    links = np.unique(links, axis=0)
    hub = np.stack([np.zeros(hub_deg, np.int64),
                    np.arange(1, hub_deg + 1)], 1)
    return np.concatenate([hub, links]).astype(np.int32)


@pytest.mark.parametrize("n,n_links,hub_deg,seg_len", [
    (50, 0, 0, SEG_LEN), (50, 1, 0, SEG_LEN), (200, 600, 0, SEG_LEN),
    (200, 600, 150, 16), (200, 600, 150, 150), (200, 600, 150, 149),
    (2000, 9000, 1500, SEG_LEN)])
def test_build_adjacency_invariants(n, n_links, hub_deg, seg_len):
    links = _links(n, n_links, seed=n + n_links, hub_deg=hub_deg)
    # the padded form the engine also holds: padding must not reach adj
    padded, mask = pad_edges(links, 64)
    adj = build_adjacency(padded[mask > 0], n, seg_len=seg_len)
    e = len(links)
    for t in adj.tensors():
        assert t.dtype == torch.int32 and t.is_contiguous()
    rowptr, nbr = adj.rowptr.numpy(), adj.nbr.numpy()
    assert rowptr.shape == (n + 1,) and rowptr[0] == 0
    assert rowptr[-1] == 2 * e == len(nbr)
    deg = np.diff(rowptr)
    np.testing.assert_array_equal(
        deg, np.bincount(links.ravel(), minlength=n))
    assert not deg[-5:].any()                   # isolated: empty lists
    # every link twice, once from each end, lists ascending
    owner = np.repeat(np.arange(n), deg)
    got = set(zip(owner.tolist(), nbr.tolist()))
    want = {(int(a), int(b)) for a, b in links} | {
        (int(b), int(a)) for a, b in links}
    assert got == want and len(got) == 2 * e
    for v in range(n):
        assert (np.diff(nbr[rowptr[v]:rowptr[v + 1]]) > 0).all()
    # hubs: exactly the nodes above seg_len, their lists tiled by segments
    hubs = adj.hub_node.numpy()
    np.testing.assert_array_equal(hubs, np.nonzero(deg > seg_len)[0])
    segptr = adj.hub_segptr.numpy()
    assert segptr[0] == 0 and segptr[-1] == len(adj.seg_node)
    for h, v in enumerate(hubs):
        sl = slice(segptr[h], segptr[h + 1])
        assert (adj.seg_node.numpy()[sl] == v).all()
        b, en = adj.seg_begin.numpy()[sl], adj.seg_end.numpy()[sl]
        assert b[0] == rowptr[v] and en[-1] == rowptr[v + 1]
        np.testing.assert_array_equal(b[1:], en[:-1])
        assert ((en - b) <= seg_len).all() and ((en - b) > 0).all()
        assert len(b) == -(-deg[v] // seg_len)
    if hub_deg > seg_len:
        assert 0 in hubs and len(adj.seg_node) >= 2
    else:
        assert len(hubs) == 0 and len(adj.seg_node) == 0


def test_build_adjacency_refuses_bad_input():
    with pytest.raises(ValueError, match="endpoints"):
        build_adjacency(np.array([[0, 7]]), 7)
    with pytest.raises(ValueError, match="seg_len"):
        build_adjacency(np.array([[0, 1]]), 7, seg_len=0)
