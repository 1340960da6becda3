"""SBM (-single, batch and -infset) in the port against the JAX package, on
the CPU: the chunk lists, the batch step (kernel 14's plain E-step and
the M-step, the same E-step rounds), the stochastic step (a node past the
pad included), the likelihood, the label-propagation init, the state
carried across by svinet_torch.convert, and whole CLI runs: batch and
-infset, cut and -resume'd, and under -mesh 2 (one process, as the JAX
CLI runs them).

Both engines draw the splits, gamma and the minibatches from one numpy
Generator in the same order, and the init is integer label propagation,
so the states start equal and differ only by the sums' order: phi,
gamma, lambda and the held-out rows are held at 1e-4."""

import filecmp
import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svinet_tpu.cli import main as jax_main, parse_args as jparse
from svinet_tpu.graph import Network as JNetwork
from svinet_tpu.ops.edges import pad_edges
from svinet_tpu.svi import sbm as jsbm
from svinet_torch import convert
from svinet_torch.cli import main as torch_main, parse_args
from svinet_torch.graph import Network
from svinet_torch.ops.edges import build_adjacency
from svinet_torch.parallel import mesh
from svinet_torch.svi import sbm
from svinet_torch.synth import planted_blocks, write_planted

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def one_thread():
    """Many small tensor operations: one intra-op thread keeps a loaded
    machine from slowing them tenfold (the results do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    d = tmp_path_factory.mktemp("planted")
    return write_planted(str(d), 400, 4, 16, 2)


def _problem(k, seed=0, n=300):
    """A planted graph's links, random held-out pairs, a phi near the
    planted blocks, gamma, an assortative lambda."""
    rng = np.random.default_rng(seed)
    e, member = planted_blocks(n, k, 8, seed + 1)
    e = np.sort(e, 1)
    e = np.unique(e[e[:, 0] != e[:, 1]], axis=0).astype(np.int32)
    held = rng.integers(0, n, (200, 2)).astype(np.int32)
    held = held[held[:, 0] != held[:, 1]]
    phi = rng.dirichlet(np.ones(k), n).astype(np.float32)
    phi = (0.6 * phi + 0.4 * np.eye(k, dtype=np.float32)[member]).astype(
        np.float32)
    gamma = rng.uniform(1, 50, k).astype(np.float32)
    lam = np.concatenate([np.tile([9.0, 1.0], (k, 1)), [[1.0, 9.0]]])
    lam = (lam * rng.uniform(0.5, 1.5, lam.shape)).astype(np.float32)
    return n, e, held, phi, gamma, lam


def test_chunk_incident_pairs_matches_jax():
    _, e, held, *_ = _problem(4)
    for pairs in (e, held):
        for a, b in zip(sbm.chunk_incident_pairs(pairs),
                        jsbm.chunk_incident_pairs(pairs)):
            np.testing.assert_array_equal(a, b)


def _jax_batch(phi, gamma, lam, e, held, eta, n_valid, rounds):
    pe, pm = pad_edges(e, 64)
    hp, hm = pad_edges(held, 64)
    ce, cm = jsbm.chunk_incident_pairs(e)
    che, chm = jsbm.chunk_incident_pairs(held)
    return [np.asarray(a) for a in jsbm.sbm_batch_step(
        jnp.asarray(phi), jnp.asarray(gamma), jnp.asarray(lam),
        jnp.asarray(pe), jnp.asarray(pm), jnp.asarray(hp), jnp.asarray(hm),
        jnp.asarray(ce), jnp.asarray(cm), jnp.asarray(che), jnp.asarray(chm),
        jnp.float32(0.5), jnp.asarray(eta), jnp.float32(n_valid),
        estep_rounds=rounds)]


@pytest.mark.parametrize("k,seed", [(4, 0), (8, 1)])
def test_batch_step_matches_jax(k, seed):
    """phi, gamma and lambda at 1e-4, and the E-step's rounds: the JAX
    while loop's count is R where stopping at R gives its result and
    stopping at R - 1 does not (K = 4 converges, K = 8 runs to the cap
    of 10)."""
    n, e, held, phi, gamma, lam = _problem(k, seed)
    eta = np.ones((k + 1, 2), np.float32)
    n_valid = float(n * (n - 1) // 2 - len(held))
    phi_t, g_t, l_t, r = sbm.sbm_batch_step(
        torch.tensor(phi), torch.tensor(gamma), torch.tensor(lam),
        build_adjacency(e, n), build_adjacency(held, n), torch.tensor(e),
        torch.tensor(held), 0.5, torch.tensor(eta), n_valid, float(len(e)))
    want = _jax_batch(phi, gamma, lam, e, held, eta, n_valid, 10)
    for got, w in zip((phi_t, g_t, l_t), want):
        np.testing.assert_allclose(got.numpy(), w, **TOL)
    assert 1 < r <= 10 and (r < 10) == (k == 4)
    at_r = _jax_batch(phi, gamma, lam, e, held, eta, n_valid, r)
    before = _jax_batch(phi, gamma, lam, e, held, eta, n_valid, r - 1)
    assert all(np.array_equal(a, b) for a, b in zip(at_r, want))
    assert not np.array_equal(before[0], want[0])


def test_edge_loglik_and_sums_match_jax():
    k = 4
    n, _, held, phi, _, lam = _problem(k, 2)
    y = (np.arange(len(held)) % 3 == 0).astype(np.int32)
    got = sbm.sbm_edge_loglik(torch.tensor(phi), torch.tensor(lam),
                              torch.tensor(held), torch.tensor(y))
    want = jsbm.sbm_edge_loglik(jnp.asarray(phi), jnp.asarray(lam),
                                jnp.asarray(held), jnp.asarray(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    sums = sbm.loglik_sums(torch.tensor(phi), torch.tensor(lam),
                           torch.tensor(held), torch.tensor(y)).numpy()
    ll = np.asarray(want)
    np.testing.assert_allclose(
        sums, [ll.sum(), len(ll), ll[y == 0].sum(), (y == 0).sum(),
               ll[y == 1].sum(), (y == 1).sum()], rtol=1e-5)


@pytest.mark.parametrize("m,pad,informative", [
    (30, 64, True), (80, 64, True), (12, 64, False)])
def test_stoch_step_matches_jax(m, pad, informative):
    """One stochastic step: every touched row blended at its own rate and
    renormalised, the partners past the pad (m > pad) toward 0, a node
    twice in the list at its last place's rate; untouched rows bit for
    bit; gamma and lambda at 1e-4."""
    from svinet_torch.svi.fastamm import node_rates, touched_rows
    k = 4
    n, _, _, phi, gamma, lam = _problem(k, 3)
    rng = np.random.default_rng(m)
    eta = np.ones((k + 1, 2), np.float32)
    r = 17
    others = rng.choice(np.r_[0:r, r + 1:n], m, replace=False)
    others = np.r_[others, others[:2]] if m > pad else others
    ys = (np.arange(len(others)) < m // 3).astype(np.int32)
    scales = ((n / 2.0, 0.5, n / 2.0) if informative else
              (n * n / (2e-3 * k), n / (2e-3 * k), n * n / (2e-3 * k)))
    rhot = 0.2
    nodec = rng.integers(0, 5, n).astype(np.int64)
    touched = np.r_[r, others].astype(np.int64)
    rho_t = node_rates(touched, nodec.copy(), 1024.0, 0.5)
    rows, rho = touched_rows(touched, rho_t, n)
    noderho = np.zeros((n, 1), np.float32)
    c = nodec.copy()
    for a in touched:
        noderho[a, 0] = (1024.0 + c[a]) ** -0.5
        c[a] += 1
    np.testing.assert_array_equal(noderho[rows, 0], rho)
    mm = min(len(others), pad)
    dst, yy, ww = (np.zeros(pad, np.int32), np.zeros(pad, np.int32),
                   np.zeros(pad, np.float32))
    dst[:mm], yy[:mm], ww[:mm] = others[:mm], ys[:mm], 1.0
    p_j, g_j, l_j = (np.asarray(a) for a in jsbm.sbm_stoch_step(
        jnp.asarray(phi), jnp.asarray(gamma), jnp.asarray(lam),
        jnp.int32(r), jnp.asarray(dst), jnp.asarray(yy), jnp.asarray(ww),
        jnp.asarray(noderho), jnp.float32(0.5), jnp.asarray(eta),
        *(jnp.float32(s) for s in scales), jnp.float32(rhot)))
    st = sbm.StochStep(
        r, torch.as_tensor(others[:mm]), torch.as_tensor(ys[:mm]),
        torch.as_tensor(rows), torch.as_tensor(rho),
        int(np.searchsorted(rows, r)),
        torch.as_tensor(np.searchsorted(rows, others[:mm])),
        torch.as_tensor(np.float32([*scales, rhot])))
    phi_t = torch.tensor(phi)
    g_t, l_t = sbm.sbm_stoch_step(phi_t, torch.tensor(gamma),
                                  torch.tensor(lam), st, 0.5,
                                  torch.tensor(eta))
    np.testing.assert_allclose(phi_t.numpy(), p_j, **TOL)
    np.testing.assert_allclose(g_t.numpy(), g_j, **TOL)
    np.testing.assert_allclose(l_t.numpy(), l_j, **TOL)
    untouched = np.setdiff1d(np.arange(n), rows)
    np.testing.assert_array_equal(phi_t.numpy()[untouched], phi[untouched])
    if m > pad:
        past = np.setdiff1d(others[pad:], others[:pad])
        np.testing.assert_allclose(phi_t.numpy()[past],
                                   phi[past] / phi[past].sum(1, keepdims=True),
                                   rtol=1e-6)


def _engines(tmp_path, net, flags=()):
    """The JAX and the port's SBM engine on the same network and seed,
    each in a directory of its own."""
    argv = ["-file", net, "-n", "400", "-k", "4", "-seed", "1", "-label",
            "e", "-single", *flags]
    out = []
    for name, parse, net_cls in (("jax", jparse, JNetwork),
                                 ("torch", parse_args, Network)):
        (tmp_path / name).mkdir()
        os.chdir(tmp_path / name)
        cfg = parse(argv)
        network = net_cls(cfg)
        network.read(net)
        network.drop_singles()
        out.append(jsbm.SBM(cfg, network) if name == "jax" else
                   sbm.SBM(cfg, network, torch.device("cpu")))
    return out


def test_init_and_state_match_jax(planted, tmp_path):
    """The label-propagation phi, gamma, lambda and eta exactly, the
    held-out pairs and their count; then the JAX engine's state, carried
    into the port's engine by convert.set_engine_state, steps to the JAX
    engine's next state at 1e-4."""
    net, _ = planted
    je, te = _engines(tmp_path, net)
    for name in ("phi", "gamma_k", "lam", "eta"):
        np.testing.assert_array_equal(convert.engine_state(te)[name],
                                      np.asarray(getattr(je, name)), name)
    hm = np.asarray(je.held_mask) > 0
    np.testing.assert_array_equal(te._held_pairs.numpy(),
                                  np.asarray(je.held_pairs)[hm])
    assert te.n_valid_pairs == float(je.n_valid_pairs)
    rng = np.random.default_rng(4)
    state = {"phi": rng.dirichlet(np.ones(4), 400).astype(np.float32),
             "gamma_k": rng.uniform(50, 150, 4).astype(np.float32),
             "lam": np.asarray(je.lam) * 3.0, "eta": np.asarray(je.eta)}
    convert.set_engine_state(te, **state)
    want = [np.asarray(a) for a in jsbm.sbm_batch_step(
        jnp.asarray(state["phi"]), jnp.asarray(state["gamma_k"]),
        jnp.asarray(state["lam"]), je.edges, je.mask, je.held_pairs,
        je.held_mask, je.chunk_edges, je.chunk_emask, je.chunk_held,
        je.chunk_hmask, jnp.float32(0.5), je.eta, je.n_valid_pairs)]
    got = sbm.sbm_batch_step(te.phi, te.gamma_k, te.lam, te.links, te.held,
                             te._link_pairs, te._held_pairs, 0.5, te.eta,
                             te.n_valid_pairs, te.n_links)
    for g, w in zip(got[:3], want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    with pytest.raises(ValueError):
        convert.set_engine_state(te, phi=state["phi"][:10])
    te.close()


def _cli(main, cwd, net, gt, label, flags):
    os.chdir(cwd)
    assert main(["-file", net, "-n", "400", "-k", "4", "-nmi", gt, "-seed",
                 "1", "-label", label, "-single", *flags]) == 0
    out = [p for p in pathlib.Path(cwd).iterdir()
           if p.name.startswith(f"n400-k4-{label}-seed1")]
    assert len(out) == 1, out
    return out[0]


def _held_to_jax(ours, theirs):
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    for name in ("heldout.txt", "validation.txt"):
        a, b = (np.loadtxt(p / name, ndmin=2) for p in (ours, theirs))
        assert a.shape == b.shape and len(a) >= 2, name
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        np.testing.assert_allclose(a[:, 2:], b[:, 2:], **TOL)
    for name, ids in (("gamma.txt", 2), ("lambda.txt", 1)):
        a, b = (np.loadtxt(p / name) for p in (ours, theirs))
        np.testing.assert_array_equal(a[:, :ids], b[:, :ids])
        np.testing.assert_allclose(a[:, ids:], b[:, ids:], **TOL)
    # groups.txt's argmax where phi's top two are apart
    a, b = (np.loadtxt(p / "groups.txt") for p in (ours, theirs))
    top = np.sort(b[:, 2:-1], 1)
    clear = top[:, -1] - top[:, -2] > 1e-2
    np.testing.assert_array_equal(a[clear, -1], b[clear, -1])


BATCH = ["-max-iterations", "10", "-no-stop"]
INFSET = ["-infset", "-max-iterations", "1000", "-rfreq", "250", "-no-stop"]


@pytest.mark.parametrize("flags", [BATCH, INFSET], ids=["batch", "infset"])
def test_cli_single_matches_jax(planted, tmp_path, monkeypatch, flags):
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    net, gt = planted
    out = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        (tmp_path / name).mkdir()
        out[name] = _cli(main, tmp_path / name, net, gt, name, flags)
    _held_to_jax(out["torch"], out["jax"])


@pytest.mark.parametrize("first,then", [
    (["-max-iterations", "5", "-no-stop"],
     ["-max-iterations", "10", "-no-stop"]),
    (["-infset", "-max-iterations", "500", "-rfreq", "250", "-no-stop"],
     INFSET)], ids=["batch", "infset"])
def test_cli_single_resume(planted, tmp_path, monkeypatch, first, then):
    """Both CLIs stopped at the first -max-iterations with a checkpoint,
    then -resume'd to the second: the port's resumed run is the JAX
    package's (the -infset run's per-node counters restored; neither
    package checkpoints the Generator); the resumed batch run is the
    uninterrupted one."""
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    net, gt = planted
    out = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        (tmp_path / name).mkdir()
        _cli(main, tmp_path / name, net, gt, name,
             [*first, "-checkpoint-freq", "1e-9"])
        out[name] = _cli(main, tmp_path / name, net, gt, name,
                         [*then, "-resume"])
    _held_to_jax(out["torch"], out["jax"])
    if "-infset" not in first:
        (tmp_path / "whole").mkdir()
        whole = _cli(torch_main, tmp_path / "whole", net, gt, "torch", then)
        a, b = (np.loadtxt(p / "heldout.txt") for p in (out["torch"], whole))
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        np.testing.assert_array_equal(a[:, 2:], b[:, 2:])


def test_single_mesh_runs_one_process(planted, tmp_path, monkeypatch):
    """-single and -single -infset under -mesh 2 run one process on one
    device, as the JAX CLI does (svinet_tpu/cli.py:385-392): the files of
    the run without -mesh."""
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    for flags, want in ((["-single"], False), (["-single", "-infset"], False),
                        (["-single", "-batch"], False),
                        (["-single", "-link-sampling"], True)):
        cfg = parse_args(["-file", "x", "-n", "10", "-k", "4", "-mesh", "2",
                          *flags])
        assert mesh.wants_mesh(cfg) is want, flags

    def no_launch(*args, **kwargs):
        raise AssertionError("-single spawned mesh ranks")

    monkeypatch.setattr(mesh, "launch", no_launch)
    net, gt = planted
    for flags in (["-max-iterations", "3", "-no-stop"],
                  ["-infset", "-max-iterations", "300", "-rfreq", "100"]):
        out = {}
        for name, extra in (("plain", []), ("mesh", ["-mesh", "2"])):
            d = tmp_path / f"{name}{len(flags)}"
            d.mkdir()
            out[name] = _cli(torch_main, d, net, gt, "r", [*flags, *extra])
        for name in ("gamma.txt", "lambda.txt", "communities.txt"):
            assert filecmp.cmp(out["plain"] / name, out["mesh"] / name,
                               shallow=False), name
