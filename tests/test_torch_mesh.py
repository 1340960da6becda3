"""svinet_torch's mesh (parallel/mesh.py, torch.distributed) against the
JAX package's shard_map mesh, function by function.

The port's side runs on gloo ranks spawned on the CPU
(tests/mesh_rank_cases.py, which imports the port only); the JAX side on
the first nd of the 8 virtual CPU devices of tests/conftest.py. Both take
the same inputs, made from numpy seeds. Sums cross the ranks in another
order than they cross JAX's devices, so states are held at 1e-4, the
bound of __graft_entry__.dryrun_multichip; the replicated layouts' ranks
must end bit for bit equal."""

import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

import mesh_rank_cases as cases
from svinet_tpu.parallel import mesh as jmesh
from svinet_tpu.svi.sweep_math import LSConsts
from svinet_torch.parallel import mesh

TOL = dict(rtol=1e-4, atol=1e-4)
# -bf16 rows: the two digammas may round a value to neighbouring bf16
# steps (tests/test_torch_lowprec.py's sweep bound)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
SWEEP_CASES = ("rep-plain", "rep-plain-bf16", "rep-fused", "rep-fused-bf16",
               "rs-plain", "rs-fused")


@pytest.fixture(scope="module")
def ranks():
    """{nd: [rank 0's results, rank 1's, ...]} for nd = 2 and 4, the two
    groups run side by side."""
    runs = {}
    for nd in (2, 4):
        d = tempfile.mkdtemp(prefix=f"mesh_cases{nd}_")
        init = "file://" + os.path.join(d, "rendezvous")
        runs[nd] = (d, torch.multiprocessing.start_processes(
            cases.run, args=(nd, init, d), nprocs=nd, join=False,
            start_method="spawn"))
    out = {}
    for nd, (d, ctx) in runs.items():
        while not ctx.join():
            pass
        out[nd] = [torch.load(os.path.join(d, f"rank{r}.pt"))
                   for r in range(nd)]
    return out


def _consts(c):
    alpha, eta0, eta1, ones, n = c
    return LSConsts(alpha=jnp.float32(alpha),
                    eta=jnp.asarray([eta0, eta1], jnp.float32),
                    ones=jnp.float32(ones), n_nodes=jnp.float32(n))


def _jax_sweeps(nd, name, n_batches=0):
    """The JAX package's sharded sweep (or, with n_batches, its mesh trace
    sweep) of case `name` on nd devices: (gamma (n,K), lam, [mphi or
    trace])."""
    edges, deg, gamma0, lam0, consts, vp, vy = cases.sweep_inputs()
    n, k = gamma0.shape
    rowshard, fused = name.startswith("rs"), "fused" in name
    bf16 = name.endswith("bf16")
    jm = jmesh.make_mesh(nd)
    es, ms = jmesh.shard_edges(edges, nd, cases.BLOCK)
    nbs = es.shape[0] // nd // cases.BLOCK
    es_d, ms_d = jmesh.device_put_sharded_edges(jm, es, ms)
    n_pad = -(-n // nd) * nd if rowshard else n
    gam = np.full((n_pad, k), consts[0], np.float32)
    gam[:n] = gamma0
    dg = np.zeros(n_pad, np.float32)
    dg[:n] = deg
    zeros = np.zeros((n_pad, k), np.float32)
    if rowshard:
        row = NamedSharding(jm, P("edges"))
        g_in, d_in, m_in = (jmesh.global_put(a, row) for a in (gam, dg, zeros))
    else:
        g_in, d_in, m_in = jnp.asarray(gam), jnp.asarray(dg), jnp.asarray(
            zeros)
    c, ann, lam = _consts(consts), jnp.float32(1.0), jnp.asarray(lam0)
    if n_batches:
        if rowshard:
            hidx, pp, yy, ww, nb = jmesh.rowshard_heldout_layout(vp, vy,
                                                                 n_pad, nd)
            ho = tuple(jmesh.global_put(a, row) for a in (hidx, pp, yy, ww))
        else:
            pp = np.zeros((64, 2), np.int32)
            pp[:len(vp)] = vp
            yy = np.zeros(64, np.int32)
            yy[:len(vy)] = vy
            ww = np.zeros(64, np.float32)
            ww[:len(vp)] = 1.0
            ho, nb = (jnp.zeros(1, jnp.int32), pp, yy, ww), 1
        fn = jmesh.make_mesh_trace_sweep(jm, nbs, fused=fused,
                                         rowshard=rowshard)
        if not fused:
            m_in = jnp.zeros((1, 1), jnp.float32)
        g, l, _, trace = fn(g_in, lam, m_in, es_d, ms_d, d_in, c, ann,
                            (*ho, jnp.float32(cases.EPS), nb),
                            cases.SWEEPS, n_batches, False)
        return np.asarray(g)[:n], np.asarray(l), np.asarray(trace)
    if fused:
        make = (jmesh.make_rowsharded_fused_multi_sweep if rowshard
                else jmesh.make_sharded_fused_multi_sweep)
        g, l, m = make(jm, nbs)(g_in, lam, m_in, es_d, ms_d, d_in, c, ann,
                                cases.SWEEPS, bf16)
        return np.asarray(g)[:n], np.asarray(l), np.asarray(m)[:n]
    make = (jmesh.make_rowsharded_multi_sweep if rowshard
            else jmesh.make_sharded_multi_sweep)
    g, l = make(jm, nbs)(g_in, lam, es_d, ms_d, d_in, c, ann, cases.SWEEPS,
                         bf16)
    return np.asarray(g)[:n], np.asarray(l)


def _port(results, name):
    """The port's (gamma, lam, mphi or trace) of case `name`: rank 0's
    under the replicated layout; under rowshard gamma and a sweep's mphi
    are the ranks' rows stacked."""
    first = results[0][name]
    if not name.startswith("rs"):
        return tuple(t.numpy() for t in first)

    def rows(i):
        return torch.cat([r[name][i] for r in results])[:cases.N].numpy()

    if "trace" in name:
        return rows(0), first[1].numpy(), first[2].numpy()
    return (rows(0), first[1].numpy()) + ((rows(2),) if "fused" in name
                                          else ())


@pytest.mark.parametrize("nd", [2, 4])
@pytest.mark.parametrize("name", SWEEP_CASES)
def test_sweep_matches_jax(ranks, nd, name):
    """make_sharded_multi_sweep, make_sharded_fused_multi_sweep (f32 and
    bf16 rows), make_rowsharded_multi_sweep and
    make_rowsharded_fused_multi_sweep (n = 61, rows padded): two sweeps
    while annealing."""
    want = _jax_sweeps(nd, name)
    got = _port(ranks[nd], name)
    assert len(got) == len(want)
    tol = BF16_TOL if name.endswith("bf16") else TOL
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("layout", ["rep", "rs"])
@pytest.mark.parametrize("fused", ["plain", "fused"])
@pytest.mark.parametrize("n_batches", [1, 3])
def test_trace_sweep_matches_jax(ranks, layout, fused, n_batches):
    """make_mesh_trace_sweep with its heldout sums at every boundary, at
    n_batches 1 (every mesh report) and 3 (-report-batch), replicated
    and row-sharded (the compact table of heldout-touched rows), nd=2."""
    name = f"{layout}-trace{n_batches}-{fused}"
    want = _jax_sweeps(2, name, n_batches)
    got = _port(ranks[2], name)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)
    assert got[2].shape == (n_batches, 6)


@pytest.mark.parametrize("nd", [2, 4])
def test_replicas_bitwise_equal(ranks, nd):
    """Every rank of a replicated layout ends with the same gamma, lambda
    and heldout sums, bit for bit: the all-reduce hands every rank the
    same bits and the rest runs on identical inputs."""
    res = ranks[nd]
    names = [k for k in res[0] if not k.startswith("rs")
             and k != "nonuniform"]
    assert len(names) >= 6
    for name in names:
        for r in res[1:]:
            for a, b in zip(res[0][name], r[name]):
                assert torch.equal(a, b), (name, nd)


def _jax_svi(name):
    gamma, lam, pairs, y = cases.svi_inputs()
    inf = {"svi": 0.0}.get(name, 0.2)
    nu = name == "svi-nonuniform"
    gs = 1.0 if nu else 50.0
    pt = cases.pad_to(len(pairs), 2)
    pp = np.zeros((pt, 2), np.int32)
    pp[:len(pairs)] = pairs
    yy = np.zeros(pt, np.int32)
    yy[:len(y)] = y
    ww = np.zeros(pt, np.float32)
    ww[:len(y)] = 1.0
    fn = jmesh.make_sharded_svi_multi_step(
        jmesh.make_mesh(2), pt // 2 // cases.BLOCK, cases.MAX_ITERS,
        cases.THRESH, inf, nonuniform=nu)
    f = lambda x: jnp.asarray([x], jnp.float32)
    g, l = fn(jnp.asarray(gamma), jnp.asarray(lam), pp[None], yy[None],
              ww[None], jnp.float32(1.0 / cases.K),
              jnp.ones((cases.K, 2), jnp.float32), f(gs), f(gs), f(0.4),
              f(0.3), f(1.0), jnp.float32(np.log(cases.EPS)), 1)
    return np.asarray(g), np.asarray(l)


@pytest.mark.parametrize("name", ["svi", "svi-inf", "svi-nonuniform"])
def test_sharded_svi_step_matches_jax(ranks, name):
    """make_sharded_svi_multi_step (one step, nd=2, blocks of 64 pairs,
    both shards holding pairs; with -inf and with -nonuniform -inf):
    kernel 8's statistics all-reduced, then gamma's step."""
    want = _jax_svi(name)
    for a, b in zip(_port(ranks[2], name), want):
        np.testing.assert_allclose(a, b, **TOL)


def test_sharded_batch_step_matches_jax(ranks):
    """make_sharded_batch_step over every pair of 40 nodes, nd=2."""
    gamma, lam, pairs, y = cases.batch_inputs()
    pt = cases.pad_to(len(pairs), 2)
    pp = np.zeros((pt, 2), np.int32)
    pp[:len(pairs)] = pairs
    yy = np.zeros(pt, np.int32)
    yy[:len(y)] = y
    ww = np.zeros(pt, np.float32)
    ww[:len(y)] = 1.0
    fn = jmesh.make_sharded_batch_step(jmesh.make_mesh(2),
                                       pt // 2 // cases.BLOCK,
                                       cases.MAX_ITERS, cases.THRESH)
    g, l = fn(jnp.asarray(gamma), jnp.asarray(lam), pp, yy, ww,
              jnp.float32(1.0 / cases.K), jnp.ones((cases.K, 2), jnp.float32),
              jnp.float32(1.0), jnp.float32(np.log(cases.EPS)))
    for a, b in zip(_port(ranks[2], "batch"), (g, l)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_sharded_nonuniform_weights_match_jax(ranks):
    """sharded_nonuniform_weights where shard 0 holds no non-informative
    zero: the single kept one is the globally first, on shard 1, and the
    counts and n_processed are global."""
    gamma, pairs, y, mask, inf = cases.nonuniform_inputs(2)
    pi = gamma / gamma.sum(1, keepdims=True)
    p_i = (pi[pairs[:, 0]] * pi[pairs[:, 1]]).sum(1)
    half = len(pairs) // 2
    assert not ((y[:half] == 0) & (p_i[:half] < inf)).any()
    assert ((y[half:] == 0) & (p_i[half:] < inf) & (mask[half:] > 0)).any()
    f = shard_map(
        lambda gg, pp, yy, mm: jmesh.sharded_nonuniform_weights(
            gg, pp, yy, mm, inf, "edges"),
        mesh=jmesh.make_mesh(2),
        in_specs=(P(), P("edges"), P("edges"), P("edges")),
        out_specs=(P("edges"), P()))
    w, n_proc = f(jnp.asarray(gamma), jnp.asarray(pairs), jnp.asarray(y),
                  jnp.asarray(mask))
    got_w = torch.cat([r["nonuniform"][0] for r in ranks[2]]).numpy()
    np.testing.assert_array_equal(got_w, np.asarray(w))
    for r in ranks[2]:
        assert int(r["nonuniform"][1][0]) == int(n_proc)


@pytest.mark.parametrize("n_edges,nd,block", [(1000, 2, 64), (1000, 4, 64),
                                              (37, 3, 16), (5, 8, 4)])
def test_shard_edges_is_the_jax_layout(n_edges, nd, block):
    rng = np.random.default_rng(n_edges)
    edges = rng.integers(0, 50, (n_edges, 2)).astype(np.int32)
    for a, b in zip(mesh.shard_edges(edges, nd, block),
                    jmesh.shard_edges(edges, nd, block)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,nd,m", [(62, 2, 40), (64, 4, 300), (9, 3, 0)])
def test_rowshard_heldout_layout_is_the_jax_layout(n, nd, m):
    rng = np.random.default_rng(m)
    pairs = rng.integers(0, n, (m, 2)).astype(np.int32)
    y = rng.integers(0, 2, m).astype(np.int32)
    got = mesh.rowshard_heldout_layout(pairs, y, n, nd)
    want = jmesh.rowshard_heldout_layout(pairs, y, n, nd)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)
    assert got[4] == want[4]


def test_mesh_above_the_cards_is_refused(monkeypatch):
    """-mesh N above the visible cards stops with the JAX message
    (svinet_tpu/svi/linksampling.py:553-555)."""
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="-mesh 2 but only 1 devices "
                                         "visible"):
        mesh.default_devices(2)
    assert mesh.default_devices(1) == [torch.device("cuda", 0)]
