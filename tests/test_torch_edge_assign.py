"""Kernel 9's plain version (the per-link argmax and max of the closed-form
phi) and the host side of log_communities against the JAX package's, on
the CPU. The argmax is the first column among equal phi values, as
jnp.argmax takes it; where the two largest phi of a link are within 1e-6
the f32 softmaxes of the two frameworks may order them otherwise, so the
argmax is held equal on the links whose top two differ by more, and max
phi to 1e-6. The community files of one report are byte-equal."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svinet_tpu.cli import parse_args as jax_parse
from svinet_tpu.graph import Network as JaxNetwork
from svinet_tpu.svi import communities as jcomm
from svinet_tpu.svi.linksampling import LinkSampling as JaxLS
from svinet_torch.cli import parse_args
from svinet_torch.graph import Network
from svinet_torch.ops.edges import owner_csr
from svinet_torch.svi import communities as tcomm
from svinet_torch.svi.linksampling import LinkSampling
from svinet_torch.synth import write_planted


def _gamma_lam(seed, n, k, tied=0):
    rng = np.random.default_rng(seed)
    # gamma >= alpha = 1/K, as in every state of a run
    gamma = (rng.gamma(0.5, 2.0, size=(n, k)) + 1.0 / k).astype(np.float32)
    if tied:
        # rows whose columns all hold one value: every phi ties
        gamma[:tied] = 1.5
    lam = rng.uniform(1.0, 5.0, size=(k, 2)).astype(np.float32)
    lam[:, 0] = 2.0    # Elogbeta[:, 0] the same in every column
    lam[:, 1] = 3.0
    return gamma, lam


@pytest.mark.parametrize("k,tied", [(4, 0), (20, 30), (33, 0), (64, 10),
                                    (640, 20)])
def test_edge_assignments_match_jax(k, tied):
    n = 200
    gamma, lam = _gamma_lam(k, n, k, tied)
    rng = np.random.default_rng(k + 1)
    edges = rng.integers(0, n, size=(3000, 2)).astype(np.int32)
    edges[:50] = rng.integers(0, tied or 1, size=(50, 2))
    mask = np.ones(len(edges), np.float32)
    ja, jm = jcomm.edge_assignments(jnp.asarray(gamma), jnp.asarray(lam),
                                    jnp.asarray(edges), jnp.asarray(mask))
    ta, tm = tcomm.edge_assignments(torch.tensor(gamma), torch.tensor(lam),
                                    torch.tensor(edges), torch.tensor(mask))
    ja, jm = np.asarray(ja), np.asarray(jm)
    np.testing.assert_allclose(tm.numpy(), jm, atol=1e-6)
    # the second largest phi of each link (the plain version's values)
    from svinet_torch.ops.expectations import dirichlet_expectation
    el = dirichlet_expectation(torch.tensor(gamma))
    e0 = dirichlet_expectation(torch.tensor(lam))[:, 0]
    phi = torch.softmax(el[edges[:, 0]] + el[edges[:, 1]] + e0, -1).numpy()
    top2 = np.sort(phi, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-6
    np.testing.assert_array_equal(ta.numpy()[clear], ja[clear])
    if tied:
        # all-tied links take column 0, in both
        both = (edges[:, 0] < tied) & (edges[:, 1] < tied)
        assert both.any()
        assert (ta.numpy()[both] == 0).all() and (ja[both] == 0).all()


def test_assignment_csr_lists_links_by_first_end():
    """Kernel 9's CSR: the links by their first end, in link order."""
    edges = torch.tensor([[0, 1], [0, 2], [1, 2], [0, 3], [2, 3]],
                         dtype=torch.int32)
    csr = owner_csr(edges[:, 0], 4, seg_len=2)
    assert csr.rowptr.tolist() == [0, 3, 4, 5, 5]
    assert csr.nbr.tolist() == [0, 1, 3, 2, 4]
    assert csr.hub_node.tolist() == [0]
    assert csr.seg_begin.tolist() == [0, 2] and csr.seg_end.tolist() == [2, 3]


@pytest.mark.parametrize("lt_min_deg", [0, 1, 3])
def test_extract_communities_matches_jax(lt_min_deg):
    rng = np.random.default_rng(lt_min_deg)
    n, k, e = 300, 12, 5000
    edges = rng.integers(0, n, size=(e, 2)).astype(np.int32)
    argmax = rng.integers(0, k, size=e).astype(np.int32)
    maxval = rng.random(e).astype(np.float32)
    mask = (rng.random(e) < 0.95).astype(np.float32)
    want = jcomm.extract_communities(argmax, maxval, edges, mask, n, k, 0.3,
                                     lt_min_deg)
    got = tcomm.extract_communities(argmax, maxval, edges, mask, n, k, 0.3,
                                    lt_min_deg)
    assert {c: g.tolist() for c, g in got.items()} == want
    assert list(got) == sorted(got)


def test_report_community_files_byte_equal_jax(tmp_path, monkeypatch):
    """One log_communities of each engine on their bit-identical initial
    state: communities.txt, mcount.txt, aggregate.txt and the mutual.txt
    row, byte for byte."""
    monkeypatch.chdir(tmp_path)
    net, gt = write_planted(str(tmp_path), 300, 4, 14, 9)
    engines = []
    for label, parse, network, make in (
            ("jax", jax_parse, JaxNetwork, lambda c, nw: JaxLS(c, nw)),
            ("torch", parse_args, Network,
             lambda c, nw: LinkSampling(c, nw, torch.device("cpu")))):
        cfg = parse(["-file", net, "-n", "300", "-k", "4", "-link-sampling",
                     "-nmi", gt, "-seed", "4", "-lt-min-deg", "1", "-label",
                     label])
        nw = network(cfg)
        nw.read(cfg.datfname)
        nw.drop_singles()
        eng = make(cfg, nw)
        # a few sweeps' worth of structure: the planted blocks, noised
        g = np.full((300, 4), 0.5, np.float32)
        block = np.asarray(nw.seq2id).astype(np.int64) * 4 // 300
        g[np.arange(300), block] += 30.0
        g += np.random.default_rng(1).random((300, 4)).astype(np.float32)
        eng.gamma = (jnp.asarray(g) if label == "jax" else torch.tensor(g))
        eng.log_communities()
        eng._mutual.flush()
        engines.append((eng, cfg.outdir))
    (_, jdir), (teng, tdir) = engines
    for name in ("communities.txt", "mcount.txt", "aggregate.txt",
                 "mutual.txt"):
        a = open(os.path.join(tdir, name)).read()
        b = open(os.path.join(jdir, name)).read()
        assert a == b, name
        assert a, name
    assert float(open(os.path.join(tdir, "mutual.txt")).read().split()[-1]
                 ) > 0.9
    teng.close()
