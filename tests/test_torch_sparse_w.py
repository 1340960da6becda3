"""-sparse-w in svinet_torch against the JAX package, on the CPU: the top-W
selection, the union pass (kernel 7's plain versions), the sparse sweep
with and without the held-out tail, the engine's rules and the CLI.

Inputs are made with numpy from a seed and handed to both packages. The
union pass sums in another order than JAX's sorted scan, so gacc, sumk and
s3 are held at 1e-4 (the JAX package's own bound for reordered f32 sums);
the sweep at W = K against the dense fused sweep at 2e-5, the bound of
tests/test_parity.py:test_sparse_w_full_width_matches_dense."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svinet_tpu.svi.sweep_math as jsm
from svinet_tpu.cli import main as jax_main
from svinet_tpu.svi.linksampling import linksampling_sparse_multi_sweep
from svinet_torch.cli import main as torch_main
from svinet_torch.ops.digamma import (
    dirichlet_expectation_plain, dirichlet_expectation_topw,
    top_columns_plain)
from svinet_torch.ops.edges import SEG_LEN, build_adjacency, pad_edges
from svinet_torch.svi.linksampling import (
    LinkSampling, from_edges, multi_sweep, sparse_multi_sweep)
from svinet_torch.svi.sweep_math import (
    LSConsts, dirichlet_expectation, sparse_union_pass,
    sparse_union_pass_plain, sparse_union_pass_pull_plain, union_rows)
from svinet_torch.synth import planted_blocks, write_planted

TOL = dict(rtol=1e-4, atol=1e-4)


def _tied_rows(rng, n, k):
    """gamma rows with ties: 60% of the entries at exactly alpha = 1/K,
    a few rows at alpha throughout, and repeated values among the rest."""
    alpha = np.float32(1.0 / k)
    g = rng.choice(np.float32([0.5, 1.0, 2.0, 3.0, 7.5]), (n, k))
    g = np.where(rng.uniform(size=(n, k)) < 0.6, alpha, g)
    g[::7] = alpha
    return g.astype(np.float32)


@pytest.mark.parametrize("w", [1, 2, 3, 5, 6])
def test_top_columns_match_jax_top_k(w):
    """The selection order is jax.lax.top_k's: largest first, the lower
    column first among equal values (torch.topk orders ties otherwise)."""
    rows = np.array([[1, 3, 3, 2, 3, 0.5], [0.5] * 6, [2, 1, 2, 1, 2, 1]],
                    np.float32)
    rows = np.concatenate([rows, _tied_rows(np.random.default_rng(w), 40, 6)])
    want = np.asarray(jax.lax.top_k(jnp.asarray(rows), w)[1])
    got = top_columns_plain(torch.tensor(rows), w)
    np.testing.assert_array_equal(got.numpy(), want)
    if w == 3:
        np.testing.assert_array_equal(got[0].numpy(), [1, 2, 4])


def test_topw_form_on_the_cpu_is_the_plain_version():
    g = torch.tensor(_tied_rows(np.random.default_rng(3), 50, 20))
    m = torch.rand(50, 20, generator=torch.Generator().manual_seed(1))
    rows = union_rows(torch.zeros_like(g), m)
    elogpi, ids, topvals, topm = dirichlet_expectation_topw(g, 8, rows)
    assert torch.equal(elogpi, dirichlet_expectation_plain(g))
    assert torch.equal(ids, top_columns_plain(g, 8))
    assert torch.equal(topvals, elogpi.gather(1, ids.long()))
    assert torch.equal(topm, m.gather(1, ids.long()))
    with pytest.raises(ValueError):
        dirichlet_expectation_topw(g, 21, rows)


def _graph(rng, n, n_links, hub_deg=0):
    """Random links (p < q), plus node 0 joined to nodes 1..hub_deg."""
    p = rng.integers(0, n - 1, n_links)
    q = rng.integers(1, n, n_links)
    q = np.where(q <= p, p + 1, q)
    links = np.stack([p, q], 1)
    if hub_deg:
        links = links[links[:, 0] > 0]
        hub = np.stack([np.zeros(hub_deg, np.int64),
                        np.arange(1, hub_deg + 1)], 1)
        links = np.concatenate([hub, links])
    return links.astype(np.int32)


def _state(rng, n, k):
    gamma = _tied_rows(rng, n, k)
    gamma += rng.gamma(1.0, 1.0, (n, k)).astype(np.float32) * (gamma > 0.4)
    gamma[1] = np.float32(1.0 / k)           # a row at alpha throughout
    lam = rng.uniform(0.5, 3.0, (k, 2)).astype(np.float32)
    mphi = rng.uniform(0, 0.2, (n, k)).astype(np.float32)
    return gamma, lam, mphi


def _jax_union_pass(gamma, lam, mphi, edges, mask, deg, w, monkeypatch):
    """gacc, sumk and s3 of the JAX block function
    (svinet_tpu/svi/sweep_math.py:252-277), read at the calls that follow
    it inside sparse_union_sweep_body."""
    seen = {}
    mean_update, finish = jsm.mean_indicator_update, jsm.finish_lambda

    def keep_mean(gacc, sumk, *args):
        seen["gacc"], seen["sumk"] = np.asarray(gacc), np.asarray(sumk)
        return mean_update(gacc, sumk, *args)

    def keep_finish(s1, s2, s3, *args):
        seen["s3"] = np.asarray(s3)
        return finish(s1, s2, s3, *args)

    monkeypatch.setattr(jsm, "mean_indicator_update", keep_mean)
    monkeypatch.setattr(jsm, "finish_lambda", keep_finish)
    n, k = gamma.shape
    consts = jsm.LSConsts(jnp.float32(1.0 / k),
                          jnp.asarray([1.0, 1.0], jnp.float32),
                          jnp.float32(len(edges)), jnp.float32(n))
    jsm.sparse_union_sweep_body(
        jnp.asarray(gamma), jnp.asarray(lam), jnp.asarray(mphi),
        jnp.asarray(edges), jnp.asarray(mask), jnp.asarray(deg), consts,
        jnp.float32(0.0), 1, w)
    return seen["gacc"], seen["sumk"], seen["s3"]


@pytest.mark.parametrize("k,w,hub", [
    (6, 1, 0), (6, 4, 0), (6, 5, 0), (6, 6, 0),
    (20, 1, 0), (20, 4, SEG_LEN + 40), (20, 19, 0), (20, 20, SEG_LEN + 40),
    (33, 1, 0), (33, 4, 0), (33, 32, SEG_LEN + 1), (33, 33, 0),
    (640, 1, 0), (640, 4, SEG_LEN + 40), (640, 639, 0), (640, 640, 0),
])
def test_union_pass_matches_jax_block_function(k, w, hub, monkeypatch):
    rng = np.random.default_rng(k * 1000 + w)
    n = 320 if hub else 60
    links = _graph(rng, n, 200 if k == 640 else 400, hub)
    gamma, lam, mphi = _state(rng, n, k)
    edges, mask = pad_edges(links, 1 << int(np.ceil(np.log2(len(links)))))
    deg = np.bincount(links.ravel(), minlength=n).astype(np.float32)
    want = _jax_union_pass(gamma, lam, mphi, edges, mask, deg, w, monkeypatch)

    g = torch.tensor(gamma)
    m = torch.tensor(mphi)
    rows = union_rows(torch.zeros_like(g), m)
    elogpi, ids, topvals, topm = dirichlet_expectation_topw(g, w, pair=rows)
    np.testing.assert_array_equal(
        ids.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(gamma), w)[1]))
    elb0 = dirichlet_expectation(torch.tensor(lam))[:, 0].contiguous()
    adj = build_adjacency(links, n)
    assert (len(adj.hub_node) > 0) == bool(hub)
    got_e = sparse_union_pass_plain(rows, ids, topvals, topm, elb0,
                                    torch.tensor(edges), torch.tensor(mask), 1)
    got_p = sparse_union_pass_pull_plain(rows, ids, topvals, topm, elb0, adj,
                                         128)
    got_w = sparse_union_pass(rows, ids, topvals, topm, elb0, adj)
    for got in (got_e, got_p, got_w):
        for name, a, b in zip(("gacc", "sumk", "s3"), got, want):
            np.testing.assert_allclose(a.numpy(), b, err_msg=name, **TOL)
    # the alpha row's picks are ties, resolved to the lowest columns
    np.testing.assert_array_equal(ids[1].numpy(), np.arange(w))


def _sweep_inputs(rng, n=48, k=6, n_links=128):
    links = _graph(rng, n, n_links)
    gamma, lam, mphi = _state(rng, n, k)
    deg = np.bincount(links.ravel(), minlength=n).astype(np.float32)
    return links, gamma, lam, mphi, deg


def test_full_width_sparse_sweep_matches_dense_fused():
    """W = K covers every column once, so two sparse sweeps are two dense
    -fuse-s3 sweeps (tests/test_parity.py:234 in the JAX package), and both
    match the JAX package's sparse sweeps."""
    rng = np.random.default_rng(0)
    links, gamma, lam, mphi, deg = _sweep_inputs(rng)
    n, k = gamma.shape
    adj = build_adjacency(links, n)
    consts = LSConsts.make(1.0 / k, 1.0, 1.0, len(links), n)
    t = (torch.tensor(gamma), torch.tensor(lam))
    d = torch.tensor(deg)
    gd, ld, md, _ = multi_sweep(*t, torch.tensor(mphi), adj, d, consts, False,
                                2, True)
    gs, ls, rs = sparse_multi_sweep(*t, union_rows(torch.zeros(n, k),
                                                   torch.tensor(mphi)),
                                    adj, d, consts, False, k, 2)
    ms = rs[..., 1]
    np.testing.assert_allclose(gs.numpy(), gd.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ls.numpy(), ld.numpy(), rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(ms.numpy(), md.numpy(), rtol=2e-5, atol=2e-5)
    edges, mask = pad_edges(links, 64)
    jc = jsm.LSConsts(jnp.float32(1.0 / k), jnp.asarray([1.0, 1.0],
                                                        jnp.float32),
                      jnp.float32(len(links)), jnp.float32(n))
    z = jnp.zeros(1, jnp.float32)
    jg, jl, jm = linksampling_sparse_multi_sweep(
        jnp.asarray(gamma), jnp.asarray(lam), jnp.asarray(mphi),
        jnp.asarray(edges), jnp.asarray(mask), jnp.asarray(deg), jc,
        jnp.float32(0.0), z, z, z, jnp.float32(1e-30), len(edges) // 64, 2,
        k, 0)
    np.testing.assert_allclose(gs.numpy(), np.asarray(jg), **TOL)
    np.testing.assert_allclose(ms.numpy(), np.asarray(jm), **TOL)


@pytest.mark.parametrize("w", [2, 4])
def test_sparse_multi_sweep_with_heldout_tail_matches_jax(w):
    rng = np.random.default_rng(w)
    links, gamma, lam, mphi, deg = _sweep_inputs(rng, n=80, k=8, n_links=300)
    n, k = gamma.shape
    pairs = np.sort(rng.integers(0, n, (48, 2)), axis=1).astype(np.int32)
    ys = rng.integers(0, 2, 48).astype(np.int32)
    hp, hw = pad_edges(pairs, 64)
    hy = np.zeros(64, np.int32)
    hy[:48] = ys
    edges, mask = pad_edges(links, 128)
    jc = jsm.LSConsts(jnp.float32(1.0 / k), jnp.asarray([1.0, 1.0],
                                                        jnp.float32),
                      jnp.float32(len(links)), jnp.float32(n))
    jg, jl, jm, js = linksampling_sparse_multi_sweep(
        jnp.asarray(gamma), jnp.asarray(lam), jnp.asarray(mphi),
        jnp.asarray(edges), jnp.asarray(mask), jnp.asarray(deg), jc,
        jnp.float32(0.0), jnp.asarray(hp), jnp.asarray(hy), jnp.asarray(hw),
        jnp.float32(1e-30), len(edges) // 128, 3, w, 1)
    consts = LSConsts.make(1.0 / k, 1.0, 1.0, len(links), n)
    g, l, rows, sums = sparse_multi_sweep(
        torch.tensor(gamma), torch.tensor(lam),
        union_rows(torch.zeros(n, k), torch.tensor(mphi)),
        build_adjacency(links, n), torch.tensor(deg), consts, False, w, 3,
        (torch.tensor(hp), torch.tensor(hy), torch.tensor(hw), 1e-30, 1))
    m = rows[..., 1]
    for a, b in ((g, jg), (l, jl), (m, jm)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(sums.numpy(), np.asarray(js), rtol=1e-4)


def _engine(tmp_path, **flags):
    raw, _ = planted_blocks(200, 8, 12, 3)
    return from_edges(raw, 200, 8, torch.device("cpu"), str(tmp_path),
                      seed=2, **flags)


def test_engine_refuses_freeze(tmp_path):
    with pytest.raises(SystemExit, match="-sparse-w does not support -freeze"):
        _engine(tmp_path, sparse_w=4, freeze_converged=True)


def test_engine_runs_dense_at_full_width(tmp_path, capsys):
    eng = _engine(tmp_path, sparse_w=8, fuse_s3=True, prune=True)
    assert "+ -sparse-w 8 >= k=8; running dense" in capsys.readouterr().out
    assert eng.cfg.sparse_w == 0 and eng.cfg.fuse_s3 and eng.cfg.prune
    assert eng.mphi is not None     # the dense -fuse-s3 state
    eng.close()


def test_engine_clears_prune_and_fuse(tmp_path):
    eng = _engine(tmp_path, sparse_w=3, fuse_s3=True, prune=True)
    assert eng.cfg.sparse_w == 3 and not eng.cfg.fuse_s3 and not eng.cfg.prune
    assert eng.mphi is None and eng._sparse_rows is None
    eng.close()


def test_engine_sparse_steps_after_annealing_only(tmp_path, monkeypatch):
    """While annealing the step is the dense unfused sweep; after it the
    sparse sweep, whose first s3 is 0 (mphi starts at zeros); a dense step
    after a sparse one stays unfused."""
    import svinet_torch.svi.linksampling as ls
    eng = _engine(tmp_path, sparse_w=3)
    calls = []
    sparse = ls.sparse_multi_sweep
    monkeypatch.setattr(ls, "sparse_multi_sweep",
                        lambda *a, **kw: calls.append(a[7]) or sparse(*a,
                                                                      **kw))
    eng.step(1)
    assert calls == [] and eng._sparse_rows is None
    eng.annealing = False
    g0, l0 = eng.gamma.clone(), eng.lam.clone()
    eng.step(1)
    assert calls == [3] and eng._ho_res is not None
    # s3 = 0 in the first sparse sweep: lambda1 = eta1 + s1^2 - s2
    from svinet_torch.svi.sweep_math import mean_indicator_update
    rows = union_rows(torch.zeros_like(g0), torch.zeros_like(g0))
    _, ids, topvals, topm = dirichlet_expectation_topw(g0, 3, pair=rows)
    elb0 = dirichlet_expectation(l0)[:, 0].contiguous()
    gacc, sumk, s3 = sparse_union_pass(rows, ids, topvals, topm, elb0,
                                       eng.adj)
    assert float(s3.abs().max()) == 0.0
    out = mean_indicator_update(gacc, sumk, eng.deg, eng.consts, False)
    lam1 = eng.consts.eta1 + out.s1 * out.s1 - out.s2
    torch.testing.assert_close(eng.lam[:, 1], lam1, rtol=1e-5, atol=1e-5)
    assert bool(eng._sparse_rows[..., 1].any())
    eng.annealing = True
    eng.step(1)
    assert eng.mphi is None and calls == [3]
    eng.close()


def test_engine_bf16_does_nothing_under_sparse_w(tmp_path):
    states = []
    for bf16 in (False, True):
        eng = _engine(tmp_path / str(bf16), sparse_w=3, bf16_rows=bf16)
        eng.annealing = False
        eng.step(2)
        states.append((eng.gamma, eng.lam))
        eng.close()
    assert torch.equal(states[0][0], states[1][0])
    assert torch.equal(states[0][1], states[1][1])


def test_engine_report_batch_is_bypassed(tmp_path, monkeypatch):
    eng = _engine(tmp_path, sparse_w=3, report_batch=4, max_iterations=6)
    monkeypatch.setattr(LinkSampling, "_trace_intervals",
                        lambda *a: pytest.fail("-report-batch ran"))
    try:
        eng.infer()
    finally:
        eng.close()
    times = np.loadtxt(os.path.join(eng.cfg.outdir, "time.txt"), ndmin=2)
    assert len(times) == 6


N, K = 400, 4


def test_cli_sparse_w_matches_jax(tmp_path, monkeypatch):
    """-sparse-w 2 through both CLIs: the same stop or one report apart,
    best nshol within 1e-3 relative, NMI within 0.02, the same files."""
    net, gt = write_planted(str(tmp_path), N, K, 16, 2)
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    out = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        assert main(["-file", net, "-n", str(N), "-k", str(K),
                     "-link-sampling", "-nmi", gt, "-seed", "1", "-label",
                     name, "-sparse-w", "2"]) == 0
        out[name] = tmp_path / f"n{N}-k{K}-{name}-seed1-linksampling"
    tm, jm = (open(out[x] / "max.txt").read().split() for x in ("torch",
                                                                  "jax"))
    assert abs(int(tm[0]) - int(jm[0])) <= 1, (tm, jm)
    assert float(tm[4]) == pytest.approx(float(jm[4]), rel=1e-3)
    nmi = {name: float(open(path / "mutual.txt").read().split()[-1])
           for name, path in out.items()}
    assert abs(nmi["torch"] - nmi["jax"]) <= 0.02
    assert sorted(os.listdir(out["torch"])) == sorted(os.listdir(out["jax"]))
    log = open(out["torch"] / "infer.log").read()
    assert "annealing ended at iteration" in log
    assert "sparse union width" in open(out["torch"] / "param.txt").read()
