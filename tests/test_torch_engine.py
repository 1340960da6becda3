"""svinet_torch's link-sampling engine and CLI against the JAX package's,
end to end on a planted graph made in-process, plus the numpy modules the
port copies (stopping rule, NMI, AUC) against their originals.

The runs are on the CPU. Both engines draw the heldout split, training
sample and initial gamma from the same numpy Generator in the same order,
so the initial state is bit-identical and the traces agree to f32
summation order (1e-4)."""

import os

import numpy as np
import pytest
import torch

from svinet_tpu.cli import main as jax_main, parse_args
from svinet_tpu.evals.nmi import overlapping_nmi as jax_nmi
from svinet_tpu.evals.precision import auc as jax_auc
from svinet_tpu.evals.stopping import ValidationStop as JaxStop
from svinet_tpu.graph import Network
from svinet_torch.cli import main as torch_main
from svinet_torch.evals.nmi import overlapping_nmi
from svinet_torch.evals.precision import auc
from svinet_torch.evals.stopping import ValidationStop
from svinet_torch.synth import write_planted

N, K, DEG, GRAPH_SEED = 400, 4, 16, 2


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    d = tmp_path_factory.mktemp("planted")
    net, gt = write_planted(str(d), N, K, DEG, GRAPH_SEED)
    return d, net, gt


def _args(net, gt, label):
    return ["-file", net, "-n", str(N), "-k", str(K), "-link-sampling",
            "-nmi", gt, "-seed", "1", "-label", label]


@pytest.fixture(scope="module")
def runs(planted):
    """Both CLIs, each in its own working directory."""
    d, net, gt = planted
    out = {}
    cwd = os.getcwd()
    try:
        for name, main in (("jax", jax_main), ("torch", torch_main)):
            run_dir = d / name
            run_dir.mkdir()
            os.chdir(run_dir)
            os.environ["SVINET_TORCH_DEVICE"] = "cpu"
            assert main(_args(net, gt, name)) == 0
            out[name] = run_dir / f"n{N}-k{K}-{name}-seed1-linksampling"
    finally:
        os.chdir(cwd)
        os.environ.pop("SVINET_TORCH_DEVICE", None)
    return out


def _heldout(path):
    return np.loadtxt(path / "heldout.txt", ndmin=2)


def _max(path):
    return open(path / "max.txt").read().split()


def test_initial_gamma_bit_identical(planted, tmp_path, monkeypatch):
    from svinet_tpu.svi.linksampling import LinkSampling as JaxLS
    from svinet_torch.svi.linksampling import LinkSampling
    _, net, gt = planted
    monkeypatch.chdir(tmp_path)
    engines = []
    for label in ("jax", "torch"):
        cfg = parse_args(_args(net, gt, label))
        nw = Network(cfg)
        nw.read(cfg.datfname)
        nw.drop_singles()
        engines.append(JaxLS(cfg, nw) if label == "jax"
                       else LinkSampling(cfg, nw, torch.device("cpu")))
    g_jax = np.asarray(engines[0].gamma)
    g_torch = engines[1].gamma.numpy()
    assert g_jax.dtype == g_torch.dtype == np.float32
    np.testing.assert_array_equal(g_torch, g_jax)
    np.testing.assert_array_equal(engines[1].lam.numpy(),
                                  np.asarray(engines[0].lam))
    np.testing.assert_array_equal(engines[1].edges.numpy(),
                                  np.asarray(engines[0].edges))
    engines[1].close()


def test_first_heldout_rows_agree(runs):
    t, j = _heldout(runs["torch"]), _heldout(runs["jax"])
    # iteration, count columns exact; likelihood columns to 1e-4 rel
    np.testing.assert_array_equal(t[:5, [0, 3, 5, 7]], j[:5, [0, 3, 5, 7]])
    np.testing.assert_allclose(t[:5, [2, 4, 6, 8, 9, 10]],
                               j[:5, [2, 4, 6, 8, 9, 10]], rtol=1e-4, atol=0)


def test_stop_iteration_and_best_nshol(runs):
    """Same stop iteration, or one report apart: an annealing or stop
    decision compares relative nshol changes with 1e-5/1e-6 thresholds,
    which f32 summation order can tip by one report."""
    t, j = _max(runs["torch"]), _max(runs["jax"])
    assert abs(int(t[0]) - int(j[0])) <= 1, (t, j)
    assert float(t[4]) == pytest.approx(float(j[4]), rel=1e-4)


def test_nmi_against_planted_cover(runs):
    nt = float(open(runs["torch"] / "mutual.txt").read().split()[-1])
    nj = float(open(runs["jax"] / "mutual.txt").read().split()[-1])
    assert abs(nt - nj) <= 0.02, (nt, nj)
    assert nt > 0.5


def test_same_output_files(runs):
    assert sorted(os.listdir(runs["torch"])) == sorted(os.listdir(runs["jax"]))
    g = np.loadtxt(runs["torch"] / "gamma.txt")
    assert g.shape == (N, K + 2) and np.isfinite(g).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stopping_copy_matches_original(seed):
    rng = np.random.default_rng(seed)
    kw = dict(stopthresh=1e-5, min_iter=10, plateau_why=100,
              decline_reports=2)
    a, b = ValidationStop(**kw), JaxStop(**kw)
    h = -0.2
    for it in range(200):
        h += rng.choice([-1e-3, 1e-3, 1e-7, 0.0])
        assert a.update(it, h) == b.update(it, h)
        if it == 60:
            a.reset_after_annealing()
            b.reset_after_annealing()
        assert vars(a) == vars(b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nmi_and_auc_copies_match_originals(seed):
    rng = np.random.default_rng(seed)
    covers = [[list(rng.choice(80, size=rng.integers(3, 30), replace=False))
               for _ in range(rng.integers(1, 8))] for _ in range(2)]
    assert overlapping_nmi(*covers) == jax_nmi(*covers)
    scores = np.round(rng.random(500), 2)       # ties exercise midranks
    y = rng.integers(0, 2, size=500)
    assert auc(scores, y) == jax_auc(scores, y)


def test_sigterm_saves_model_and_continues(planted, tmp_path, monkeypatch):
    """A SIGTERM only sets a flag; the next report saves the model files
    and the run goes on (reference: src/linksampling.cc:763-766)."""
    from svinet_torch.svi.linksampling import LinkSampling
    _, net, gt = planted
    monkeypatch.chdir(tmp_path)
    cfg = parse_args(_args(net, gt, "term") + ["-max-iterations", "4",
                                               "-no-stop"])
    nw = Network(cfg)
    nw.read(cfg.datfname)
    nw.drop_singles()
    eng = LinkSampling(cfg, nw, torch.device("cpu"))
    eng.terminate_requested = True
    try:
        eng.infer()
    finally:
        eng.close()
    log = open(tmp_path / cfg.outdir / "infer.log").read()
    assert "SIGTERM: saving model state at iteration 0" in log
    assert log.count("stopped at iteration") == 2     # the save + the end
    assert len(_heldout(tmp_path / cfg.outdir)) == 5  # iterations 0..4


def test_engine_takes_device_init_above_threshold(tmp_path, monkeypatch):
    """Above DEVICE_INIT_MIN the engine draws its initial gamma on the
    device (the path of the n=1M, K=500 shape); its rows still sum to each
    node's degree, and the engine steps from it."""
    from svinet_torch.svi import linksampling
    from svinet_torch.synth import planted_blocks
    monkeypatch.setattr(linksampling, "DEVICE_INIT_MIN", 0)
    raw, _ = planted_blocks(N, K, DEG, GRAPH_SEED)
    eng = linksampling.from_edges(raw, N, K, torch.device("cpu"),
                                  str(tmp_path / "out"))
    try:
        deg = np.bincount(eng.network.edges.ravel(), minlength=eng.n)
        np.testing.assert_allclose(eng.gamma.sum(1).numpy(), deg, rtol=1e-4)
        eng.step(2)
        assert torch.isfinite(eng.gamma).all()
        assert torch.isfinite(eng.lam).all()
    finally:
        eng.close()


def test_load_continues_from_a_jax_run(runs, planted, tmp_path, monkeypatch):
    """-load reads a JAX run's gamma.txt/lambda.txt as the initial state."""
    from svinet_torch.convert import load_state
    from svinet_torch.svi.linksampling import LinkSampling
    _, net, gt = planted
    monkeypatch.chdir(tmp_path)
    cfg = parse_args(_args(net, gt, "load") + ["-load", str(runs["jax"]),
                                               "-max-iterations", "2"])
    nw = Network(cfg)
    nw.read(cfg.datfname)
    nw.drop_singles()
    eng = LinkSampling(cfg, nw, torch.device("cpu"))
    want, _ = load_state(str(runs["jax"]), "cpu")
    np.testing.assert_array_equal(eng.gamma.numpy(), want.numpy())
    try:
        eng.infer()
    finally:
        eng.close()
    assert (tmp_path / cfg.outdir / "gamma.txt").exists()


@pytest.mark.parametrize("flags", [["-freeze"], ["-prune"],
                                   ["-bf16", "-freeze", "-prune"]],
                         ids=["freeze", "prune", "all_three"])
def test_cli_sweep_flags_match_jax(planted, tmp_path, monkeypatch, flags):
    """-freeze, -prune and the three sweep flags together through both
    CLIs: the same stop or one report apart, best nshol within 1e-3
    relative, NMI within 0.02, the same set of output files. -orig with
    the same flags dispatches to the full blockmodel, as the JAX CLI does
    (it wins over -link-sampling)."""
    _, net, gt = planted
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    out = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        assert main([*_args(net, gt, name), *flags]) == 0
        out[name] = tmp_path / f"n{N}-k{K}-{name}-seed1-linksampling"
    tm, jm = _max(out["torch"]), _max(out["jax"])
    assert abs(int(tm[0]) - int(jm[0])) <= 1, (tm, jm)
    assert float(tm[4]) == pytest.approx(float(jm[4]), rel=1e-3)
    nmi = {name: float(open(path / "mutual.txt").read().split()[-1])
           for name, path in out.items()}
    assert abs(nmi["torch"] - nmi["jax"]) <= 0.02
    assert sorted(os.listdir(out["torch"])) == sorted(os.listdir(out["jax"]))
    assert torch_main([*_args(net, gt, "orig"), *flags, "-orig",
                       "-max-iterations", "1"]) == 0
    orig = tmp_path / f"n{N}-k{K}-orig-seed1-linksampling"
    assert (orig / "beta.txt").exists() and (orig / "gamma.txt").exists()
