"""The slab form of svinet_torch's s3 pass (svinet_torch/tools/s3_slab.py,
a design kept beside the pull kernel and timed by tools/bench_kernels.py)
against the JAX package, on the same numpy inputs, on the CPU:
s3_pass_slab_plain (the slab kernel's sums in plain PyTorch: slab by slab
over the forward lists) against svinet_tpu.svi.sweep_math.s3_pass at 1e-4
abs/rel (the two sum in different orders in f32), over f32 and bf16 rows,
with and without the -freeze flags, on a graph with hubs; the forward lists
of an adjacency against a numpy construction; and the slab-major layout.
The kernel itself is held to the pull kernel on the card by
tools/bench_kernels.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from svinet_tpu.svi import sweep_math as jsm
from svinet_torch.ops.edges import build_adjacency, pad_edges
from svinet_torch.svi import sweep_math as tsm
from svinet_torch.synth import random_edges
from svinet_torch.tools import s3_slab
from svinet_torch.tools.s3_slab import FWD_CHUNK, forward_lists

TOL = dict(rtol=1e-4, atol=1e-4)
BLOCK = 256


def _t(a):
    return torch.from_numpy(np.array(a))


def _problem(n, k, n_edges, seed, hub_deg=0):
    """Random links (with a hub at node 0 when asked), mean-indicator rows,
    and flags that freeze about half of the nodes, some to the last column
    (flag K), one of them the hub's neighbour."""
    rng = np.random.default_rng(seed)
    links = random_edges(n, n_edges, seed)
    if hub_deg:
        links = links[links[:, 0] > 0]
        hub = np.stack([np.zeros(hub_deg, np.int32),
                        np.arange(1, hub_deg + 1, dtype=np.int32)], 1)
        links = np.concatenate([hub, links])
    edges, mask = pad_edges(links, BLOCK)
    mphi = rng.dirichlet(np.ones(k), size=n).astype(np.float32)
    conv = np.where(rng.random(n) < 0.5, rng.integers(1, k + 1, size=n),
                    0).astype(np.int32)
    conv[1:9] = k
    return dict(links=links, edges=edges, mask=mask, nb=len(edges) // BLOCK,
                mphi=mphi, conv=conv)


def _jax_s3(pb, mphi, conv):
    return np.asarray(jsm.s3_pass(
        jnp.asarray(mphi), jnp.asarray(pb["edges"]), jnp.asarray(pb["mask"]),
        pb["nb"], None if conv is None else jnp.asarray(conv)))


@pytest.mark.parametrize("with_conv", [False, True], ids=["dense", "conv"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [20, 37, 520])
def test_slab_plain_matches_jax(k, bf16, with_conv):
    """Slabs of 32 bytes of a row (8 f32 or 16 bf16 columns): K = 20 and 520
    end on a narrower slab for one of the types, K = 37 for both."""
    n = 300 if k < 100 else 120
    pb = _problem(n, k, 4 * n, seed=k)
    adj = build_adjacency(pb["links"], n)
    conv = pb["conv"] if with_conv else None
    rows = _t(pb["mphi"])
    if bf16:
        rows = rows.to(torch.bfloat16)
    # the JAX pass is given the values the rows hold
    want = _jax_s3(pb, rows.float().numpy(), conv)
    width = 32 // rows.element_size()
    assert k % width != 0 or k == 520 and not bf16
    tconv = None if conv is None else _t(conv)
    got = s3_slab.s3_pass_slab_plain(rows, forward_lists(adj), width, 512,
                                     tconv)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the same sums as the pull form the CPU wrapper takes
    pull = tsm.s3_pass(rows, adj, tconv)
    np.testing.assert_allclose(got.numpy(), pull.numpy(), **TOL)
    if with_conv:
        assert not np.allclose(got.numpy(), _jax_s3(
            pb, rows.float().numpy(), None), **TOL)


@pytest.mark.parametrize("row_bytes", [32, 64, 128])
def test_slab_widths_agree(row_bytes):
    """A wider slab is the same sums in fewer passes."""
    n, k = 200, 37
    pb = _problem(n, k, 900, seed=3)
    adj = build_adjacency(pb["links"], n)
    got = s3_slab.s3_pass_slab_plain(_t(pb["mphi"]), forward_lists(adj),
                                     row_bytes // 4, 300, _t(pb["conv"]))
    np.testing.assert_allclose(got.numpy(),
                               _jax_s3(pb, pb["mphi"], pb["conv"]), **TOL)


def test_slab_plain_frozen_last_column_by_hand():
    """A one-sided link adds the free end's mphi at the frozen column, in
    the slab that holds it and nowhere else: the last column (flag K) lies
    in the ragged last slab."""
    n, k = 150, 37
    pb = _problem(n, k, 700, seed=5)
    adj = build_adjacency(pb["links"], n)
    want = np.zeros(k, np.float64)
    at_last = 0
    for p, q in pb["links"]:
        cp, cq = pb["conv"][p], pb["conv"][q]
        if (cp > 0) != (cq > 0):
            col = max(cp, cq) - 1
            want[col] += pb["mphi"][q if cp > 0 else p, col]
            at_last += col == k - 1
        else:
            want += pb["mphi"][p].astype(np.float64) * pb["mphi"][q]
    assert at_last > 0
    got = s3_slab.s3_pass_slab_plain(_t(pb["mphi"]), forward_lists(adj), 8,
                                     256, _t(pb["conv"]))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("with_conv", [False, True], ids=["dense", "conv"])
def test_slab_plain_on_hub_graph(with_conv):
    """A hub whose list the adjacency cuts into segments: the forward lists
    have no segments (a lane takes a flat entry), and the sums are the
    same."""
    n, k = 400, 20
    pb = _problem(n, k, 1200, seed=9, hub_deg=300)
    adj = build_adjacency(pb["links"], n, seg_len=64)
    assert len(adj.seg_node) >= 5
    conv = pb["conv"] if with_conv else None
    got = s3_slab.s3_pass_slab_plain(_t(pb["mphi"]), forward_lists(adj), 8,
                                     512, None if conv is None else _t(conv))
    np.testing.assert_allclose(got.numpy(), _jax_s3(pb, pb["mphi"], conv),
                               **TOL)


@pytest.mark.parametrize("n,n_edges,hub_deg", [(50, 0, 0), (97, 400, 0),
                                               (500, 3000, 200)])
def test_forward_lists(n, n_edges, hub_deg):
    """ptr / nbr list every link once under its lower end, ascending;
    chunk_owner names the owner of every FWD_CHUNK-th entry and bounds the
    owners of the entries of its chunk."""
    pb = _problem(n, 4, max(n_edges, 1), seed=n, hub_deg=hub_deg)
    links = pb["links"] if n_edges else np.zeros((0, 2), np.int32)
    adj = build_adjacency(links, n)
    fwd = forward_lists(adj)
    lo, hi = links.min(axis=1), links.max(axis=1)
    order = np.lexsort((hi, lo))
    want_nbr = hi[order]
    want_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(lo, minlength=n), out=want_ptr[1:])
    np.testing.assert_array_equal(fwd.ptr.numpy(), want_ptr)
    np.testing.assert_array_equal(fwd.nbr.numpy(), want_nbr)
    assert fwd.ptr.dtype == fwd.nbr.dtype == torch.int32
    assert fwd.chunk_owner.dtype == torch.int32
    e = len(links)
    owner = lo[order]
    chunks = -(-e // FWD_CHUNK)
    got = fwd.chunk_owner.numpy()
    assert got.shape == (chunks + 1,)
    for c in range(chunks):
        assert got[c] == owner[c * FWD_CHUNK]
        mine = owner[c * FWD_CHUNK:(c + 1) * FWD_CHUNK]
        assert got[c] <= mine.min() and mine.max() <= got[c + 1]
    # the owner of an entry is the last node whose list starts at or
    # before it, as the kernel's search finds it
    if e:
        found = np.searchsorted(want_ptr, np.arange(e), side="right") - 1
        np.testing.assert_array_equal(found, owner)
        assert got[-1] == owner[-1]
    # the symmetric lists are unchanged beside them
    assert int(adj.rowptr[-1]) == 2 * e


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_to_slabs_layout(bf16):
    n, k = 11, 37
    rng = np.random.default_rng(1)
    rows = _t(rng.random((n, k)).astype(np.float32))
    if bf16:
        rows = rows.to(torch.bfloat16)
    w = 32 // rows.element_size()
    slabs = s3_slab.to_slabs(rows, 32)
    assert slabs.shape == (-(-k // w), n, w) and slabs.is_contiguous()
    for s in range(slabs.shape[0]):
        have = min(w, k - s * w)
        assert torch.equal(slabs[s, :, :have], rows[:, s * w:s * w + have])
        assert bool((slabs[s, :, have:] == 0).all())


@pytest.mark.parametrize("row_bytes", [32, 64, 128])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_slab_major_sums_match(bf16, row_bytes):
    """The sums taken slab by slab from the slab-major array, each slab's
    rows alone, are those of the row-major array: the zero columns past K
    add nothing."""
    n, k = 90, 37
    pb = _problem(n, k, 400, seed=row_bytes)
    fwd = forward_lists(build_adjacency(pb["links"], n))
    rows = _t(pb["mphi"])
    if bf16:
        rows = rows.to(torch.bfloat16)
    w = row_bytes // rows.element_size()
    slabs = s3_slab.to_slabs(rows, row_bytes)
    got = torch.cat([s3_slab.s3_pass_slab_plain(slab, fwd, w, 128)
                     for slab in slabs])
    assert bool((got[k:] == 0).all())
    want = s3_slab.s3_pass_slab_plain(rows, fwd, w, 128)
    np.testing.assert_allclose(got[:k].numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("n,n_edges", [(40, 150), (200, 2000)])
@pytest.mark.parametrize("with_conv", [False, True], ids=["dense", "conv"])
def test_cpu_wrapper_takes_the_pull_form(with_conv, n, n_edges):
    """s3_pass on a CPU tensor is the pull form in plain PyTorch, whatever
    the shape, and agrees with the JAX pass."""
    k = 12
    pb = _problem(n, k, n_edges, seed=n)
    adj = build_adjacency(pb["links"], n)
    conv = pb["conv"] if with_conv else None
    tconv = None if conv is None else _t(conv)
    got = tsm.s3_pass(_t(pb["mphi"]), adj, tconv)
    want = tsm.s3_pass_pull_plain(_t(pb["mphi"]), adj, 64, tconv)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), _jax_s3(pb, pb["mphi"], conv),
                               **TOL)
