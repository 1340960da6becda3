"""svinet_torch sweep pieces, heldout sums and community assignment
against the JAX package, on the same numpy inputs.

Tolerance: 1e-4 abs/rel, the bound the JAX package uses for its own
sharded-vs-single checks (__graft_entry__.dryrun_multichip): the two
packages sum in different orders in f32. On the CPU the port's phi_pass
is the plain pull form over the links' adjacency, the kernel's own input
(kernel 2 runs only on the card); the edge-list plain form and the pull
form are held to each other and to JAX at 1e-5, since on the CPU they
differ in summation order only. Kernels 3, 4 and 5 have no CPU form
either: their wrappers take the plain forms here, each of which is held
to the JAX function it stands for, at 1e-4 abs/rel unless a test says
otherwise."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _tiny_problem
from svinet_tpu.config import Config
from svinet_tpu.graph import Network
from svinet_tpu.evals import likelihood as jlik
from svinet_tpu.svi import sweep_math as jsm
from svinet_tpu.svi.communities import edge_assignments as jax_assign
from svinet_tpu.svi.linksampling import (
    linksampling_fused_multi_sweep, linksampling_fused_multi_sweep_ho,
    linksampling_multi_sweep, linksampling_multi_sweep_ho, linksampling_sweep,
    linksampling_sweep_ho_trace)
from svinet_torch.convert import load_state, state_from_numpy, state_to_numpy
from svinet_torch.evals import likelihood as tlik
from svinet_torch.ops.edges import (
    build_adjacency, choose_edge_block, pad_edges)
from svinet_torch.ops.expectations import dirichlet_expectation
from svinet_torch.svi import sweep_math as tsm
from svinet_torch.svi.communities import edge_assignments
from svinet_torch.svi.linksampling import (
    fused_multi_sweep_ho, fused_sweep, init_gamma_from_links,
    init_gamma_from_links_device, multi_sweep_ho, sweep, sweep_ho_trace)
from svinet_torch.synth import planted_blocks

TOL = dict(rtol=1e-4, atol=1e-4)


def _planted(n=300, k=4, seed=3):
    """A planted 4-block graph through the real ingest path."""
    raw, _ = planted_blocks(n, k, 12, seed)
    cfg = Config(n=n, k=k, link_sampling=True)
    cfg.resolve()
    net = Network(cfg)
    net.from_arrays(raw[:, 0], raw[:, 1])
    rng = np.random.default_rng(seed)
    gamma = rng.uniform(0.5, 3.0, size=(n, k)).astype(np.float32)
    deg = net.deg.astype(np.float32)
    return gamma, net.edges, deg


def _tiny():
    gamma, _, edges, deg = _tiny_problem(n=32, k=4, n_edges=64, seed=0)
    return np.asarray(gamma), edges, deg


@pytest.fixture(params=["tiny", "planted"])
def problem(request):
    gamma, edges, deg = _tiny() if request.param == "tiny" else _planted()
    n, k = gamma.shape
    rng = np.random.default_rng(7)
    lam = rng.uniform(0.5, 5.0, size=(k, 2)).astype(np.float32)
    # a block size that leaves a ragged, masked tail
    block = 32 if request.param == "tiny" else 256
    edges_p, mask = pad_edges(edges[:-3], block)
    return dict(gamma=gamma, lam=lam, edges=edges_p, mask=mask, deg=deg,
                adj=build_adjacency(edges[:-3], n),
                nb=edges_p.shape[0] // block, n=n, k=k,
                ones=float(len(edges)))


def _consts(pb):
    k = pb["k"]
    jc = jsm.LSConsts(alpha=jnp.float32(1.0 / k),
                      eta=jnp.asarray([1.0, 1.0], jnp.float32),
                      ones=jnp.float32(pb["ones"]),
                      n_nodes=jnp.float32(pb["n"]))
    tc = tsm.LSConsts.make(1.0 / k, 1.0, 1.0, pb["ones"], pb["n"])
    return jc, tc


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def _elog(pb):
    elogpi = np.asarray(jax_dexp_np(pb["gamma"]))
    elb0 = np.asarray(jax_dexp_np(pb["lam"]))[:, 0]
    return elogpi, elb0


def jax_dexp_np(x):
    from svinet_tpu.ops.expectations import dirichlet_expectation as d
    return np.asarray(d(jnp.asarray(x)))


def test_phi_pass(problem):
    pb = problem
    elogpi, elb0 = _elog(pb)
    jg, js = jsm.phi_pass(jnp.asarray(elogpi), jnp.asarray(elb0),
                          jnp.asarray(pb["edges"]), jnp.asarray(pb["mask"]),
                          pb["nb"])
    tg, ts = tsm.phi_pass(_t(elogpi), _t(elb0), pb["adj"])
    _close(tg, jg)
    _close(ts, js)
    # sumk = 2 sum(phi) = gacc.sum(0): the identity kernel 2 relies on
    _close(ts, tg.sum(0))


@pytest.mark.parametrize("annealing", [False, True])
def test_mean_indicator_update_and_lambda(problem, annealing):
    pb = problem
    jc, tc = _consts(pb)
    elogpi, elb0 = _elog(pb)
    jg, js = jsm.phi_pass(jnp.asarray(elogpi), jnp.asarray(elb0),
                          jnp.asarray(pb["edges"]), jnp.asarray(pb["mask"]),
                          pb["nb"])
    jout = jsm.mean_indicator_update(jg, js, jnp.asarray(pb["deg"]), jc,
                                     jnp.float32(1.0 if annealing else 0.0))
    tout = tsm.mean_indicator_update(_t(np.asarray(jg)), _t(np.asarray(js)),
                                     _t(pb["deg"]), tc, annealing)
    for got, want in zip(tout, jout):
        _close(got, want)
    js3 = jsm.s3_pass(jout[1], jnp.asarray(pb["edges"]),
                      jnp.asarray(pb["mask"]), pb["nb"])
    ts3 = tsm.s3_pass_plain(_t(np.asarray(jout[1])), _t(pb["edges"]),
                            _t(pb["mask"]), pb["nb"])
    _close(ts3, js3)
    _close(tsm.s3_pass(_t(np.asarray(jout[1])), pb["adj"]), js3)
    _, _, s1, s2, lam0 = (np.asarray(a) for a in jout)
    _close(tsm.finish_lambda(_t(s1), _t(s2), ts3, _t(lam0), tc),
           jsm.finish_lambda(s1, s2, js3, lam0, jc))


def test_full_sweep(problem):
    pb = problem
    jc, tc = _consts(pb)
    jgam, jlam = linksampling_sweep(
        jnp.asarray(pb["gamma"]), jnp.asarray(pb["lam"]),
        jnp.asarray(pb["edges"]), jnp.asarray(pb["mask"]),
        jnp.asarray(pb["deg"]), jc, jnp.float32(1.0), pb["nb"])
    tgam, tlam = sweep(_t(pb["gamma"]), _t(pb["lam"]), pb["adj"],
                       _t(pb["deg"]), tc, True)
    _close(tgam, jgam)
    _close(tlam, jlam)


def _ho_pairs(pb, m=40, blk=64):
    rng = np.random.default_rng(11)
    p = rng.integers(0, pb["n"] - 1, size=m)
    q = rng.integers(p + 1, pb["n"])
    pp = np.zeros((blk, 2), np.int32)
    pp[:m] = np.stack([p, q], 1)
    yy = np.zeros(blk, np.int32)
    yy[:m] = rng.integers(0, 2, size=m)
    ww = np.zeros(blk, np.float32)
    ww[:m] = 1.0
    return pp, yy, ww


def test_multi_sweep_with_heldout_tail(problem):
    pb = problem
    jc, tc = _consts(pb)
    pp, yy, ww = _ho_pairs(pb)
    jout = linksampling_multi_sweep_ho(
        jnp.asarray(pb["gamma"]), jnp.asarray(pb["lam"]),
        jnp.asarray(pb["edges"]), jnp.asarray(pb["mask"]),
        jnp.asarray(pb["deg"]), jc, jnp.float32(1.0), jnp.asarray(pp),
        jnp.asarray(yy), jnp.asarray(ww), jnp.float32(1e-30), pb["nb"], 3, 1)
    tout = multi_sweep_ho(
        _t(pb["gamma"]), _t(pb["lam"]), pb["adj"], _t(pb["deg"]), tc, True,
        _t(pp), _t(yy), _t(ww), 1e-30, 3, 1)
    for got, want in zip(tout, jout):
        _close(got, want)


def test_heldout_stats_and_link_probs(problem):
    pb = problem
    pp, yy, _ = _ho_pairs(pb)
    pp, yy = pp[:40], yy[:40]
    jres = jlik.heldout_stats(jnp.asarray(pb["gamma"]),
                              jnp.asarray(pb["lam"]), jnp.asarray(pp),
                              jnp.asarray(yy), 1e-30, block=16)
    tres = tlik.heldout_stats(_t(pb["gamma"]), _t(pb["lam"]), _t(pp),
                              _t(yy), 1e-30, block=16)
    np.testing.assert_allclose(np.array(tres, np.float64),
                               np.array(jres, np.float64), **TOL)
    _close(tlik.link_probs(_t(pb["gamma"]), _t(pb["lam"]), _t(pp), block=16),
           jlik.link_probs(jnp.asarray(pb["gamma"]), jnp.asarray(pb["lam"]),
                           jnp.asarray(pp)))


def test_edge_assignments(problem):
    pb = problem
    ja, jm = jax_assign(jnp.asarray(pb["gamma"]), jnp.asarray(pb["lam"]),
                        jnp.asarray(pb["edges"]), jnp.asarray(pb["mask"]))
    ta, tm = edge_assignments(_t(pb["gamma"]), _t(pb["lam"]),
                              _t(pb["edges"]), _t(pb["mask"]))
    _close(tm, jm)
    # argmax may differ only where the top two phis tie within f32
    differ = ta.numpy() != np.asarray(ja)
    phi = torch.softmax(
        dirichlet_expectation(_t(pb["gamma"]))[_t(pb["edges"][:, 0]).long()]
        + dirichlet_expectation(_t(pb["gamma"]))[_t(pb["edges"][:, 1]).long()]
        + dirichlet_expectation(_t(pb["lam"]))[:, 0], -1).numpy()
    top2 = np.sort(phi, axis=1)[:, -2:]
    assert (top2[differ, 1] - top2[differ, 0] < 1e-5).all()


def test_state_round_trip_continues_jax_run(problem, tmp_path):
    """A JAX state after 3 sweeps, carried over, takes one port sweep and
    lands on JAX's 4th sweep; the text-file path gives the same state."""
    pb = problem
    jc, tc = _consts(pb)
    args = (jnp.asarray(pb["edges"]), jnp.asarray(pb["mask"]),
            jnp.asarray(pb["deg"]), jc, jnp.float32(1.0), pb["nb"])
    g3, l3 = linksampling_multi_sweep(jnp.asarray(pb["gamma"]),
                                      jnp.asarray(pb["lam"]), *args, 3)
    g3, l3 = np.asarray(g3), np.asarray(l3)
    g4, l4 = linksampling_multi_sweep(jnp.asarray(g3), jnp.asarray(l3),
                                      *args, 1)
    tg, tl = state_from_numpy(g3, l3, "cpu")
    back = state_to_numpy(tg, tl)
    np.testing.assert_array_equal(back[0], g3)
    np.testing.assert_array_equal(back[1], l3)
    tg, tl = sweep(tg, tl, pb["adj"], _t(pb["deg"]), tc, True)
    _close(tg, g4)
    _close(tl, l4)

    from svinet_tpu.io.writers import save_model
    save_model(str(tmp_path), g3, l3, np.arange(pb["n"]) + 100)
    fg, fl = load_state(str(tmp_path), "cpu")
    # the text files keep 5 decimals (half a unit of the last one), and
    # reading back rounds each value to f32 (relative 2^-24)
    np.testing.assert_allclose(fg.numpy(), g3, atol=5e-6, rtol=1.2e-7)
    np.testing.assert_allclose(fl.numpy(), l3, atol=5e-6, rtol=1.2e-7)


def test_init_gamma_device_matches_host_stats():
    """The blocked device init must give the host init's row statistics:
    each gamma row sums to the node's degree (each link adds a normalised
    phi to both endpoints), rows without a link hold alpha, and the
    masked pad rows of the ragged last block (which point at node 0) add
    nothing. Its draws are JAX's threefry stream under the seed
    (tests/test_torch_threefry.py holds them to the JAX package's)."""
    _, edges, deg = _planted()
    n, k, alpha, block = len(deg) + 5, 4, 0.25, 256
    e, m = pad_edges(edges, block)
    assert len(e) > len(edges) and len(e) // block > 1
    g_dev = init_gamma_from_links_device(0, _t(e), _t(m), n, k, alpha,
                                         len(e) // block).numpy()
    g_host = init_gamma_from_links(np.random.default_rng(0), edges, n, k,
                                   alpha)
    np.testing.assert_allclose(g_dev[:-5].sum(1), deg, rtol=1e-4)
    np.testing.assert_allclose(g_host[:-5].sum(1), deg, rtol=1e-6)
    np.testing.assert_array_equal(g_dev[-5:], np.float32(alpha))
    np.testing.assert_array_equal(g_host[-5:], alpha)


def test_blocked_passes_match_one_block(problem):
    """The plain passes give the same result whatever the blocking."""
    pb = problem
    elogpi, elb0 = _elog(pb)
    e, m = _t(pb["edges"]), _t(pb["mask"])
    a = tsm.phi_pass_plain(_t(elogpi), _t(elb0), e, m, pb["nb"])
    b = tsm.phi_pass_plain(_t(elogpi), _t(elb0), e, m, 1)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL)
    assert choose_edge_block(len(pb["edges"]), pb["k"]) >= 64


TIGHT = dict(rtol=1e-5, atol=1e-5)


def _pull_problem(k, seed, n=300, n_links=1500, block=256):
    """Numpy-seeded Elogpi-like rows, random links with a ragged masked
    tail, node 0 a hub (joined to every other node), the last 9 nodes
    isolated."""
    rng = np.random.default_rng(seed)
    p = rng.integers(1, n - 10, size=n_links)
    q = rng.integers(1, n - 10, size=n_links)
    keep = p != q
    links = np.stack([np.minimum(p, q), np.maximum(p, q)], 1)[keep]
    links = np.unique(links, axis=0)
    hub = np.stack([np.zeros(n - 10, np.int64), np.arange(1, n - 9)], 1)
    links = np.concatenate([hub, links]).astype(np.int32)
    elogpi = -rng.gamma(2.0, 1.5, size=(n, k)).astype(np.float32)
    elb0 = -rng.gamma(2.0, 0.5, size=k).astype(np.float32)
    edges_p, mask = pad_edges(links, block)
    assert len(edges_p) > len(links)
    return links, elogpi, elb0, edges_p, mask, len(edges_p) // block


@pytest.mark.parametrize("k", [3, 20, 33])
@pytest.mark.parametrize("seg_len", [16, 256, 10_000])
def test_phi_pass_pull_form_matches_jax(k, seg_len):
    """The pull form over the adjacency (hub cut into segments or not)
    against the JAX edge-list phi_pass and the port's edge-list plain
    form, with padding in the edge list."""
    links, elogpi, elb0, edges_p, mask, nb = _pull_problem(k, seed=k)
    n = elogpi.shape[0]
    adj = build_adjacency(links, n, seg_len=seg_len)
    jg, js = jsm.phi_pass(jnp.asarray(elogpi), jnp.asarray(elb0),
                          jnp.asarray(edges_p), jnp.asarray(mask), nb)
    for block in (97, 1 << 20):
        tg, ts = tsm.phi_pass_pull_plain(_t(elogpi), _t(elb0), adj, block)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TIGHT)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
        np.testing.assert_allclose(ts.numpy(), tg.sum(0).numpy(), rtol=1e-4)
    eg, es = tsm.phi_pass_plain(_t(elogpi), _t(elb0), _t(edges_p), _t(mask),
                                nb)
    np.testing.assert_allclose(tg.numpy(), eg.numpy(), **TIGHT)
    np.testing.assert_allclose(ts.numpy(), es.numpy(), rtol=1e-5)
    # the wrapper's CPU path is the pull form; isolated rows stay zero
    wg, ws = tsm.phi_pass(_t(elogpi), _t(elb0), adj)
    np.testing.assert_array_equal(wg.numpy(), tg.numpy())
    assert not wg[-9:].any()


def test_engine_builds_the_adjacency_of_its_training_links(tmp_path):
    """LinkSampling holds the adjacency of exactly its training links,
    and a step through it matches a sweep fed an adjacency built here."""
    from svinet_torch.svi.linksampling import from_edges
    raw, _ = planted_blocks(200, 4, 10, 1)
    eng = from_edges(raw, 200, 4, torch.device("cpu"), str(tmp_path / "o"))
    links = eng.network.training_links
    adj = eng.adj
    assert adj.n == eng.n and int(adj.rowptr[-1]) == 2 * len(links)
    deg = np.diff(adj.rowptr.numpy())
    np.testing.assert_array_equal(deg, eng.network.training_deg)
    want = sweep(eng.gamma, eng.lam, build_adjacency(links, eng.n), eng.deg,
                 eng.consts, True)
    eng.step(1)
    eng.close()
    np.testing.assert_array_equal(eng.gamma.numpy(), want[0].numpy())
    np.testing.assert_array_equal(eng.lam.numpy(), want[1].numpy())


def _mphi_like(pb, seed=5):
    """Numpy-seeded mean indicators: rows on the simplex scaled by 1/2."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(size=(pb["n"], pb["k"])).astype(np.float32)
    return m / m.sum(1, keepdims=True) * np.float32(0.5)


def test_fused_phi_s3_pass_matches_jax(problem):
    """The packed edge-list plain form against the JAX function of the
    same signature, and the wrapper (two arrays, the adjacency) against
    both; tolerance 1e-4 abs/rel (f32 summation order)."""
    pb = problem
    elogpi, elb0 = _elog(pb)
    mphi = _mphi_like(pb)
    packed = np.concatenate([elogpi, mphi], axis=1)
    jout = jsm.fused_phi_s3_pass(jnp.asarray(packed), jnp.asarray(elb0),
                                 jnp.asarray(pb["edges"]),
                                 jnp.asarray(pb["mask"]), pb["nb"])
    tout = tsm.fused_phi_s3_pass_plain(_t(packed), _t(elb0), _t(pb["edges"]),
                                       _t(pb["mask"]), pb["nb"])
    wout = tsm.fused_phi_s3_pass(_t(elogpi), _t(mphi), _t(elb0), pb["adj"])
    for got, wrapped, want in zip(tout, wout, jout):
        _close(got, want)
        _close(wrapped, want)
    # the fused pass is the phi pass and the s3 pass of mphi side by side
    _close(wout[2], tsm.s3_pass(_t(mphi), pb["adj"]))
    _close(wout[0], tsm.phi_pass(_t(elogpi), _t(elb0), pb["adj"])[0])


@pytest.mark.parametrize("k", [3, 20, 33])
@pytest.mark.parametrize("seg_len", [16, 256, 10_000])
def test_s3_and_fused_pull_forms_match_jax(k, seg_len):
    """The pull forms of kernels 4 and 5 over the adjacency (hub cut into
    segments or not) against the JAX edge-list s3_pass and
    fused_phi_s3_pass, with padding in the edge list; 1e-5 abs/rel, since
    on the CPU the forms differ in summation order only."""
    links, elogpi, elb0, edges_p, mask, nb = _pull_problem(k, seed=k)
    n = elogpi.shape[0]
    rng = np.random.default_rng(100 + k)
    mphi = (rng.uniform(size=(n, k)) / k).astype(np.float32)
    mphi[-9:] = 0.0                      # the isolated nodes
    adj = build_adjacency(links, n, seg_len=seg_len)
    js3 = jsm.s3_pass(jnp.asarray(mphi), jnp.asarray(edges_p),
                      jnp.asarray(mask), nb)
    jg, js, jf3 = jsm.fused_phi_s3_pass(
        jnp.asarray(np.concatenate([elogpi, mphi], 1)), jnp.asarray(elb0),
        jnp.asarray(edges_p), jnp.asarray(mask), nb)
    for block in (97, 1 << 20):
        ts3 = tsm.s3_pass_pull_plain(_t(mphi), adj, block)
        np.testing.assert_allclose(ts3.numpy(), np.asarray(js3), **TIGHT)
        fg, fs, f3 = tsm.fused_phi_s3_pass_pull_plain(
            _t(elogpi), _t(mphi), _t(elb0), adj, block)
        np.testing.assert_allclose(fg.numpy(), np.asarray(jg), **TIGHT)
        np.testing.assert_allclose(fs.numpy(), np.asarray(js), rtol=1e-5)
        np.testing.assert_allclose(f3.numpy(), np.asarray(jf3), **TIGHT)
    es3 = tsm.s3_pass_plain(_t(mphi), _t(edges_p), _t(mask), nb)
    np.testing.assert_allclose(ts3.numpy(), es3.numpy(), **TIGHT)
    # the wrappers' CPU paths are the pull forms
    np.testing.assert_array_equal(tsm.s3_pass(_t(mphi), adj).numpy(),
                                  ts3.numpy())
    wg, _, w3 = tsm.fused_phi_s3_pass(_t(elogpi), _t(mphi), _t(elb0), adj)
    np.testing.assert_array_equal(wg.numpy(), fg.numpy())
    np.testing.assert_array_equal(w3.numpy(), f3.numpy())


@pytest.mark.parametrize("annealing", [False, True])
def test_mean_indicator_plain_with_isolated_nodes(annealing):
    """Kernel 3's plain form against JAX on a graph with nodes of degree
    0 (their rows: mphi 0, gnext alpha + gacc, never scaled) and a hub;
    the divisor is 2 deg and the factor n - 2 deg - 1. 1e-4 abs/rel."""
    k = 20
    links, elogpi, elb0, edges_p, mask, nb = _pull_problem(k, seed=9)
    n = elogpi.shape[0]
    deg = np.bincount(links.ravel(), minlength=n).astype(np.float32)
    assert (deg[-9:] == 0).all() and deg[0] == n - 10
    jc = jsm.LSConsts(alpha=jnp.float32(1.0 / k),
                      eta=jnp.asarray([1.0, 1.0], jnp.float32),
                      ones=jnp.float32(len(links)), n_nodes=jnp.float32(n))
    tc = tsm.LSConsts.make(1.0 / k, 1.0, 1.0, len(links), n)
    jg, js = jsm.phi_pass(jnp.asarray(elogpi), jnp.asarray(elb0),
                          jnp.asarray(edges_p), jnp.asarray(mask), nb)
    jout = jsm.mean_indicator_update(jg, js, jnp.asarray(deg), jc,
                                     jnp.float32(1.0 if annealing else 0.0))
    for fn in (tsm.mean_indicator_update_plain, tsm.mean_indicator_update):
        tout = fn(_t(np.asarray(jg)), _t(np.asarray(js)), _t(deg), tc,
                  annealing)
        for got, want in zip(tout, jout):
            _close(got, want)
    gnext, mphi = tout[0].numpy(), tout[1].numpy()
    assert not mphi[-9:].any()
    np.testing.assert_array_equal(gnext[-9:], np.float32(1.0 / k))
    # the hub: mphi = gacc / (2 deg), by hand
    np.testing.assert_allclose(mphi[0], np.asarray(jg)[0] / (2 * deg[0]),
                               rtol=1e-6)


def _fused_args(pb):
    jc, tc = _consts(pb)
    jargs = (jnp.asarray(pb["edges"]), jnp.asarray(pb["mask"]),
             jnp.asarray(pb["deg"]), jc, jnp.float32(1.0))
    return jc, tc, jargs


def test_three_fused_sweeps_from_zero_mphi(problem):
    """-fuse-s3: three sweeps from mphi = 0 with the heldout tail against
    linksampling_fused_multi_sweep_ho (1e-4 abs/rel), and the lag itself:
    the first sweep's s3 is 0, so its lambda1 is eta1 + s1^2 - s2 of the
    mphi it returns."""
    pb = problem
    _, tc, jargs = _fused_args(pb)
    pp, yy, ww = _ho_pairs(pb)
    zeros = np.zeros((pb["n"], pb["k"]), np.float32)
    jout = linksampling_fused_multi_sweep_ho(
        jnp.asarray(pb["gamma"]), jnp.asarray(pb["lam"]), jnp.asarray(zeros),
        *jargs, jnp.asarray(pp), jnp.asarray(yy), jnp.asarray(ww),
        jnp.float32(1e-30), pb["nb"], 3, 1)
    tout = fused_multi_sweep_ho(
        _t(pb["gamma"]), _t(pb["lam"]), _t(zeros), pb["adj"], _t(pb["deg"]),
        tc, True, _t(pp), _t(yy), _t(ww), 1e-30, 3, 1)
    for got, want in zip(tout, jout):
        _close(got, want)
    _, lam1, mphi1 = fused_sweep(_t(pb["gamma"]), _t(pb["lam"]), _t(zeros),
                                 pb["adj"], _t(pb["deg"]), tc, True)
    s1 = mphi1.sum(0)
    _close(lam1[:, 1], 1.0 + s1 * s1 - (mphi1 * mphi1).sum(0))
    # the unfused sweep's lambda1 has the current s3 taken off
    _, lam_u = sweep(_t(pb["gamma"]), _t(pb["lam"]), pb["adj"],
                     _t(pb["deg"]), tc, True)
    _close(lam1[:, 1] - lam_u[:, 1], tsm.s3_pass(mphi1, pb["adj"]))


@pytest.mark.parametrize("fused", [False, True])
def test_sweep_ho_trace_every_row(problem, fused):
    """-report-batch: three boundaries two sweeps apart against
    linksampling_sweep_ho_trace, every one of the (3, 6) rows and the
    final state; 1e-4 abs/rel."""
    pb = problem
    _, tc, jargs = _fused_args(pb)
    pp, yy, ww = _ho_pairs(pb)
    mphi0 = _mphi_like(pb)
    jg, jl, jm, jtrace = linksampling_sweep_ho_trace(
        jnp.asarray(pb["gamma"]), jnp.asarray(pb["lam"]), jnp.asarray(mphi0),
        *jargs, jnp.asarray(pp), jnp.asarray(yy), jnp.asarray(ww),
        jnp.float32(1e-30), pb["nb"], 2, 3, 1, False, fused)
    tg, tl, tm, ttrace = sweep_ho_trace(
        _t(pb["gamma"]), _t(pb["lam"]), _t(mphi0), pb["adj"], _t(pb["deg"]),
        tc, True, _t(pp), _t(yy), _t(ww), 1e-30, 2, 3, 1, fused)
    assert tuple(ttrace.shape) == (3, 6)
    _close(ttrace, jtrace)
    _close(tg, jg)
    _close(tl, jl)
    _close(tm, jm)
    # a row of the trace is the tail of a step that ends there
    _, _, sums = multi_sweep_ho(
        _t(pb["gamma"]), _t(pb["lam"]), pb["adj"], _t(pb["deg"]), tc, True,
        _t(pp), _t(yy), _t(ww), 1e-30, 2, 1)
    if not fused:
        np.testing.assert_array_equal(ttrace[0].numpy(), sums.numpy())


def test_fused_state_round_trip_continues_jax_run(problem):
    """A JAX -fuse-s3 state (gamma, lambda, mphi) after 3 sweeps, carried
    over by convert.py, takes one fused sweep of the port and lands on
    JAX's 4th; without mphi it would not."""
    pb = problem
    _, tc, jargs = _fused_args(pb)
    zeros = jnp.zeros((pb["n"], pb["k"]), jnp.float32)
    g3, l3, m3 = (np.asarray(a) for a in linksampling_fused_multi_sweep(
        jnp.asarray(pb["gamma"]), jnp.asarray(pb["lam"]), zeros, *jargs,
        pb["nb"], 3))
    g4, l4, m4 = linksampling_fused_multi_sweep(
        jnp.asarray(g3), jnp.asarray(l3), jnp.asarray(m3), *jargs,
        pb["nb"], 1)
    tg, tl, tm = state_from_numpy(g3, l3, "cpu", mphi=m3)
    for back, want in zip(state_to_numpy(tg, tl, tm), (g3, l3, m3)):
        np.testing.assert_array_equal(back, want)
    with pytest.raises(ValueError):
        state_from_numpy(g3, l3, "cpu", mphi=m3[:, :-1])
    ng, nl, nm = fused_sweep(tg, tl, tm, pb["adj"], _t(pb["deg"]), tc, True)
    _close(ng, g4)
    _close(nl, l4)
    _close(nm, m4)
    _, cold, _ = fused_sweep(tg, tl, torch.zeros_like(tg), pb["adj"],
                             _t(pb["deg"]), tc, True)
    assert not np.allclose(cold.numpy(), np.asarray(l4), rtol=1e-4, atol=1e-4)


def test_fused_sweep_overwrites_the_mphi_it_is_given(problem):
    """fused_sweep hands its mphi buffer to the mean-indicator update as
    the output, on the CPU as on the card: what comes back is the same
    storage, holding the new mean indicators, and a clone taken before
    gives the same sweep."""
    pb = problem
    _, tc, _ = _fused_args(pb)
    mphi = _t(_mphi_like(pb))
    kept = mphi.clone()
    args = (pb["adj"], _t(pb["deg"]), tc, True)
    g1, l1, m1 = fused_sweep(_t(pb["gamma"]), _t(pb["lam"]), mphi, *args)
    assert m1.data_ptr() == mphi.data_ptr()
    assert not torch.equal(mphi, kept)
    g2, l2, m2 = fused_sweep(_t(pb["gamma"]), _t(pb["lam"]), kept.clone(),
                             *args)
    for a, b in ((g1, g2), (l1, l2), (m1, m2)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # the update itself: without mphi_out it allocates, with it it fills
    # and returns the buffer; the same values either way
    gacc, sumk = _t(pb["gamma"]), _t(pb["gamma"]).sum(0)
    fresh = tsm.mean_indicator_update(gacc.clone(), sumk, _t(pb["deg"]), tc,
                                      True)[1]
    buf = torch.empty_like(gacc)
    given = tsm.mean_indicator_update(gacc.clone(), sumk, _t(pb["deg"]), tc,
                                      True, mphi_out=buf)[1]
    assert given.data_ptr() == buf.data_ptr() != fresh.data_ptr()
    np.testing.assert_array_equal(fresh.numpy(), given.numpy())


@pytest.mark.parametrize("k,links,one_launch", [
    (20, 187_655, True),          # planted n=20k: bound by its launches
    (33, 187_655, True),
    (20, 499_891, True),          # n=50k: the two drew level
    (20, 999_896, False),         # n=100k: the one launch lost by 2%
    (128, 199_911, False),
    (20, 10_000_000, False),      # n=1M shapes: the card is busy
    (256, 10_000_000, False),
    (500, 19_899_599, False),     # the stretch shape
    (640, 1_000, False),          # no fused kernel above K = 512
])
def test_fused_launch_is_chosen_by_size(k, links, one_launch):
    """-fuse-s3 on the card: kernel 5 for launch-sized passes, kernel 2
    then kernel 4 otherwise (the measured sides of FUSED_MAX_WORK)."""
    assert tsm.fused_takes_one_launch(k, 2 * links) == one_launch
