"""svinet_torch's full blockmodel (-orig) against the JAX package's, on the
CPU: kernel 15's plain version block by block against the JAX while loop
(the same R_b), a batch iteration, the ELBO, the held-out likelihood, the
initial state, the CLI's files, a resumed run, and -mesh under -orig.

The same numpy-seeded inputs go through both packages. The JAX package
sums its K x K products in XLA's order and the port in index order, so
the values agree to f32 rounding (1e-4 of the largest entry)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svinet_tpu.svi.orig as jorig
from svinet_tpu.cli import main as jax_main
from svinet_torch.cli import main as torch_main
from svinet_torch.ops.orig_phi import (
    elbo_logf_pair, logf_pair, orig_chunk_plain, orig_fixed_point_plain)
from svinet_torch.svi import orig as torig
from svinet_torch.synth import write_planted

N, K = 60, 3


def _state(n, k, seed):
    rng = np.random.default_rng(seed)
    gamma = rng.gamma(2.0, 1.0, size=(n, k)).astype(np.float32) + 0.05
    beta = rng.uniform(0.02, 0.98, size=(k, k)).astype(np.float32)
    beta = ((beta + beta.T) / 2).astype(np.float32)
    return gamma, beta


def _pairs(n, m, seed, block):
    """m random pairs (p < q) with mixed y, padded by pad_edges to whole
    blocks as the JAX engine pads them."""
    from svinet_tpu.ops.edges import pad_edges
    rng = np.random.default_rng(seed)
    p = rng.integers(0, n - 1, size=m)
    q = p + 1 + (rng.random(m) * (n - 1 - p)).astype(np.int64)
    pairs = np.stack([p, q], 1).astype(np.int32)
    y = (rng.random(m) < 0.3).astype(np.int32)
    pp, w = pad_edges(pairs, block)
    yy = np.zeros(len(pp), np.int32)
    yy[:m] = y
    return pairs, y, pp, yy, w


def _jax_rounds(monkeypatch):
    """Swap jax.lax.while_loop for a Python loop that records its
    iterations (the JAX function is called eagerly, block by block)."""
    seen = []

    def loop(cond, body, init):
        state, i = init, 0
        while bool(cond(state)):
            state = body(state)
            i += 1
        seen.append(i)
        return state

    monkeypatch.setattr(jax.lax, "while_loop", loop)
    return seen


@pytest.mark.parametrize("k", [4, 20, 37])
def test_fixed_point_matches_the_jax_while_loop(k, monkeypatch):
    """Block by block (B = 64, the last one with padding pairs (0, 0)):
    the same R_b, phi1 and phi2 within 1e-5."""
    n, m, block = 50, 150, 64
    gamma, beta = _state(n, k, k)
    _, y, pp, yy, _ = _pairs(n, m, k + 1, block)
    g = torch.as_tensor(gamma)
    elogpi = (torch.special.digamma(g)
              - torch.special.digamma(g.sum(1, keepdim=True)))
    lf2 = logf_pair(torch.as_tensor(beta))
    p = torch.as_tensor(pp[:m, 0]).long()
    q = torch.as_tensor(pp[:m, 1]).long()
    phi1, phi2, rounds = orig_fixed_point_plain(
        elogpi[p], elogpi[q], lf2, torch.as_tensor(y), 50, 1e-5, block,
        elogpi[0])
    seen = _jax_rounds(monkeypatch)
    ej = jnp.asarray(elogpi.numpy())
    mixed = 0
    for b in range(len(pp) // block):
        sl = slice(b * block, (b + 1) * block)
        e = jnp.asarray(pp[sl])
        j1, j2 = jorig._phi2_fixed_point(
            ej[e[:, 0]], ej[e[:, 1]], jnp.asarray(lf2[0].numpy()),
            jnp.asarray(lf2[1].numpy()), jnp.asarray(yy[sl]), 50, 1e-5)
        real = slice(b * block, min((b + 1) * block, m))
        n_real = real.stop - real.start
        assert int(rounds[real.start]) == seen[-1], (k, b)
        assert (rounds[real] == seen[-1]).all()
        np.testing.assert_allclose(phi1[real].numpy(),
                                   np.asarray(j1)[:n_real], atol=1e-5)
        np.testing.assert_allclose(phi2[real].numpy(),
                                   np.asarray(j2)[:n_real], atol=1e-5)
        ys = yy[sl][:n_real]
        mixed += bool(ys.any() and not ys.all())
    assert len(seen) == 3 and m % block and mixed == 3
    assert 1 < min(seen) and max(seen) <= 50


def _jax_step(gamma, beta, pp, yy, w, block, alpha):
    return jorig.orig_batch_step(
        jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(pp),
        jnp.asarray(yy), jnp.asarray(w), jnp.float32(alpha),
        num_blocks=len(pp) // block, max_iters=50)


def _chunks(pairs, y, n, k, block, stage_bytes):
    return torig.chunk_pairs(torch.as_tensor(pairs), torch.as_tensor(y), n,
                             k, block, stage_bytes)


@pytest.mark.parametrize("k", [4, 20])
def test_batch_step_matches_jax(k):
    """orig_batch_step over several blocks and several chunks: gamma and
    beta within 1e-4 of the largest entry."""
    n, m, block = 50, 700, 64
    gamma, beta = _state(n, k, 10 + k)
    pairs, y, pp, yy, w = _pairs(n, m, 11 + k, block)
    g_j, b_j = _jax_step(gamma, beta, pp, yy, w, block, 0.1)
    chunks = _chunks(pairs, y, n, k, block, 8 * k * 3 * block)
    assert len(chunks) == 4 and chunks[-1].pad
    g_t, b_t = torig.orig_batch_step(torch.as_tensor(gamma),
                                     torch.as_tensor(beta), chunks, 0.1,
                                     block=block)
    g_j, b_j = np.asarray(g_j), np.asarray(b_j)
    assert np.abs(g_t.numpy() - g_j).max() <= 1e-4 * np.abs(g_j).max()
    assert np.abs(b_t.numpy() - b_j).max() <= 1e-4 * np.abs(b_j).max()


def test_approx_elbo_and_edge_loglik_match_jax():
    """The -logl ELBO within 1e-4 relative; each pair's held-out
    log-likelihood within 1e-5."""
    n, k, m, block = 50, 5, 300, 64
    gamma, beta = _state(n, k, 21)
    pairs, y, pp, yy, w = _pairs(n, m, 22, block)
    g1, b1 = (np.array(a) for a in
              _jax_step(gamma, beta, pp, yy, w, block, 0.2))
    e_j = float(jorig.orig_approx_elbo(
        jnp.asarray(g1), jnp.asarray(gamma), jnp.asarray(beta),
        jnp.asarray(b1), jnp.asarray(pp), jnp.asarray(yy), jnp.asarray(w),
        0.2, num_blocks=len(pp) // block, max_iters=50))
    chunks = _chunks(pairs, y, n, k, block, 8 * k * 2 * block)
    e_t = torig.orig_approx_elbo(
        torch.as_tensor(g1), torch.as_tensor(gamma), torch.as_tensor(beta),
        torch.as_tensor(b1), chunks, 0.2, block=block)
    assert abs(e_t - e_j) <= 1e-4 * abs(e_j), (e_t, e_j)
    ll_j = np.asarray(jorig.orig_edge_loglik(
        jnp.asarray(g1), jnp.asarray(b1), jnp.asarray(pairs),
        jnp.asarray(y)))
    ll_t = torig.orig_edge_loglik(torch.as_tensor(g1), torch.as_tensor(b1),
                                  torch.as_tensor(pairs),
                                  torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(ll_t, ll_j, atol=1e-5)


def test_elbo_terms_of_the_chunk_are_the_plain_terms():
    """The ELBO form's terms are pair_terms_plain of the training form's
    phis (one fixed point, two forms)."""
    n, k, m, block = 40, 6, 200, 64
    gamma, beta = _state(n, k, 31)
    pairs, y, _, _, _ = _pairs(n, m, 32, block)
    g = torch.as_tensor(gamma)
    e = torch.special.digamma(g) - torch.special.digamma(
        g.sum(1, keepdim=True))
    lf2 = logf_pair(torch.as_tensor(beta))
    lfe2 = elbo_logf_pair(torch.as_tensor(beta))
    pt, yt = torch.as_tensor(pairs), torch.as_tensor(y)
    staged, r1 = orig_chunk_plain(e, lf2, pt, yt, 50, 1e-5, block, True)
    terms, r2 = orig_chunk_plain(e, lf2, pt, yt, 50, 1e-5, block, True,
                                 elbo=(e, lfe2))
    assert torch.equal(r1, r2)
    from svinet_torch.ops.orig_phi import pair_terms_plain
    pp = staged.view(m, 2, k)
    want = pair_terms_plain(pp[:, 0], pp[:, 1], e[pt[:, 0].long()],
                            e[pt[:, 1].long()], lfe2, yt)
    assert torch.equal(terms, want)


def test_pair_set_is_the_jax_triangle():
    """all_pairs: np.triu_indices order, the held-out pairs left out,
    their labels from the links."""
    n = 30
    rng = np.random.default_rng(5)
    links = np.unique(np.sort(rng.integers(0, n, size=(80, 2)), 1), axis=0)
    links = links[links[:, 0] < links[:, 1]]
    keys = links[:, 0].astype(np.int64) * n + links[:, 1]
    held = keys[::7]
    pairs, y = torig.all_pairs(n, held, keys, "cpu")
    iu = np.stack(np.triu_indices(n, 1), 1)
    k_all = iu[:, 0] * n + iu[:, 1]
    ok = ~np.isin(k_all, held)
    np.testing.assert_array_equal(pairs.numpy(), iu[ok])
    np.testing.assert_array_equal(y.numpy(), np.isin(k_all[ok], keys))


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    d = tmp_path_factory.mktemp("orig")
    net, gt = write_planted(str(d), N, K, 8, 1)
    return d, net


def _args(net, label, *extra):
    return ["-file", net, "-n", str(N), "-k", str(K), "-orig", "-seed", "2",
            "-label", label, *extra]


@pytest.mark.parametrize("itype", [0, 1])
def test_initial_state_is_the_jax_engines(planted, tmp_path, monkeypatch,
                                          itype):
    """gamma and beta drawn as the JAX engine draws them, bit for bit."""
    from svinet_tpu.cli import parse_args as jparse
    from svinet_tpu.graph import Network as JNetwork
    from svinet_torch.cli import parse_args as tparse
    from svinet_torch.graph import Network as TNetwork
    _, net = planted
    argv = _args(net, f"init{itype}", "-itype", str(itype))
    monkeypatch.chdir(tmp_path)
    states = []
    for parse, network, engine in (
            (jparse, JNetwork, lambda c, w: jorig.MMSBOrig(c, w)),
            (tparse, TNetwork,
             lambda c, w: torig.MMSBOrig(c, w, torch.device("cpu")))):
        cfg = parse(argv + ["-label", f"init{itype}-{len(states)}"])
        nw = network(cfg)
        nw.read(cfg.datfname)
        nw.drop_singles()
        eng = engine(cfg, nw)
        states.append((np.asarray(eng.gamma), np.asarray(eng.beta)))
        getattr(eng, "close", lambda: None)()
    for a, b in zip(*states):
        np.testing.assert_array_equal(a, b)


def _rows(path):
    """A report file's rows without the duration column (the second)."""
    rows = [line.split() for line in open(path) if line.strip()]
    return np.array([[float(v) for j, v in enumerate(r) if j != 1]
                     for r in rows])


def _table(path, skip=0):
    return np.array([[float(v) for v in line.split()[skip:]]
                     for line in open(path) if line.strip()])


@pytest.mark.parametrize("extra", [[], ["-logl", "-itype", "1"]],
                         ids=["orig", "logl_itype1"])
def test_cli_files_match_jax(planted, tmp_path, monkeypatch, extra):
    """Both CLIs on a planted n=60 graph, 4 iterations, a report every
    2: held-out rows, max.txt, gamma.txt, beta.txt, groups.txt and
    logl.txt within 1e-4 (relative where above 1)."""
    _, net = planted
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    out = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        assert main(_args(net, "c", "-max-iterations", "4", "-rfreq", "2",
                          *extra)) == 0
        (out[name],) = [p for p in d.iterdir() if p.name.startswith("n60")]
    for fname, read in (("heldout.txt", _rows), ("validation.txt", _rows),
                        ("max.txt", _rows), ("logl.txt", _rows),
                        ("gamma.txt", lambda p: _table(p, 2)),
                        ("beta.txt", _table),
                        ("groups.txt", lambda p: _table(p, 2))):
        a, b = read(out["torch"] / fname), read(out["jax"] / fname)
        assert a.shape == b.shape, fname
        assert np.all(np.abs(a - b) <= 1e-4 * np.maximum(1.0, np.abs(b))), \
            (fname, np.abs(a - b).max())
    assert len(_rows(out["torch"] / "logl.txt")) == (2 if extra else 0)
    assert sorted(os.listdir(out["torch"])) == sorted(os.listdir(out["jax"]))


def test_cut_and_resumed_run_is_the_uninterrupted_one(planted, tmp_path,
                                                      monkeypatch):
    """A run stopped after iteration 3's step (its checkpoint written at
    the stop) and -resume'd to 6 writes the files of the uninterrupted
    run to 6, bit for bit."""
    _, net = planted
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    ck = ["-checkpoint-freq", "1e-9", "-rfreq", "2"]
    assert torch_main(_args(net, "whole", "-max-iterations", "6",
                            *ck)) == 0
    assert torch_main(_args(net, "cut", "-max-iterations", "3", *ck)) == 0
    assert torch_main(_args(net, "cut", "-max-iterations", "6", "-resume",
                            *ck)) == 0
    whole = tmp_path / "n60-k3-whole-seed2-orig"
    cut = tmp_path / "n60-k3-cut-seed2-orig"
    for fname in ("gamma.txt", "beta.txt", "groups.txt"):
        assert (whole / fname).read_bytes() == (cut / fname).read_bytes()
    assert _rows(whole / "heldout.txt")[:, 1:].tolist() == \
        _rows(cut / "heldout.txt")[:, 1:].tolist()


@pytest.mark.parametrize("flags", [["-mesh", "2"],
                                   ["-link-sampling", "-mesh", "2"]],
                         ids=["mesh2", "linksampling_mesh2"])
def test_orig_under_mesh_runs_one_process(planted, tmp_path, monkeypatch,
                                          flags):
    """-orig wins over -link-sampling and never reads -mesh: one process,
    as the JAX CLI runs it."""
    from svinet_torch.parallel import mesh
    _, net = planted

    def refuse(*a, **kw):
        raise AssertionError("-orig went to the mesh launcher")

    monkeypatch.setattr(mesh, "launch", refuse)
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    assert torch_main(_args(net, "m", "-max-iterations", "1",
                            *flags)) == 0
    # the directory is named as the JAX CLI names it (by -link-sampling
    # where that is given); beta.txt is -orig's
    (out,) = [p for p in tmp_path.iterdir() if p.name.startswith("n60")]
    assert (out / "beta.txt").exists() and (out / "gamma.txt").exists()


def test_state_crosses_between_the_packages(planted, tmp_path, monkeypatch):
    """A JAX MMSBOrig's gamma and beta after one iteration go into the
    port's engine by convert.set_engine_state and back by engine_state
    unchanged; one more iteration in each package agrees within 1e-4 of
    the largest entry."""
    from svinet_tpu.cli import parse_args as jparse
    from svinet_tpu.graph import Network as JNetwork
    from svinet_torch import convert
    from svinet_torch.cli import parse_args as tparse
    from svinet_torch.graph import Network as TNetwork
    _, net = planted
    monkeypatch.chdir(tmp_path)
    engines = []
    for parse, network, make in (
            (jparse, JNetwork, lambda c, w: jorig.MMSBOrig(c, w)),
            (tparse, TNetwork,
             lambda c, w: torig.MMSBOrig(c, w, torch.device("cpu")))):
        cfg = parse(_args(net, f"x{len(engines)}"))
        nw = network(cfg)
        nw.read(cfg.datfname)
        nw.drop_singles()
        engines.append(make(cfg, nw))
    je, te = engines

    def jax_step():
        je.gamma, je.beta = jorig.orig_batch_step(
            je.gamma, je.beta, je.pairs, je.y, je.w,
            jnp.float32(je.cfg.alpha), num_blocks=je.nb, max_iters=50)

    jax_step()
    state = {"gamma": np.array(je.gamma), "beta": np.array(je.beta)}
    convert.set_engine_state(te, **state)
    for name, a in state.items():
        np.testing.assert_array_equal(convert.engine_state(te)[name], a)
    with pytest.raises(ValueError):
        convert.set_engine_state(te, beta=state["beta"][:2])
    jax_step()
    te.step()
    for name in ("gamma", "beta"):
        want = np.asarray(getattr(je, name))
        got = getattr(te, name).numpy()
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), name
    te.close()
