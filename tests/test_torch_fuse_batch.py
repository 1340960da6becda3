"""-fuse-s3 and -report-batch of svinet_torch's CLI against the JAX
package's, end to end on a planted graph made in-process, on the CPU.

Both engines draw the heldout split, training sample and initial gamma
from the same numpy Generator in the same order, so the initial state is
bit-identical and the traces agree to f32 summation order: likelihood
columns of heldout.txt within 1e-4 relative, the stop iteration equal or
one report apart, the best nshol within 1e-4 relative, NMI within 0.02
(the bounds of tests/test_torch_engine.py)."""

import os
import re

import numpy as np
import pytest

from svinet_tpu.cli import main as jax_main
from svinet_torch.cli import main as torch_main
from svinet_torch.synth import write_planted

N, K, DEG, GRAPH_SEED = 400, 4, 16, 2
BATCH = 4
FLAGS = {
    "plain": [],
    "batch": ["-report-batch", str(BATCH)],
    "fused": ["-fuse-s3"],
    "fused_batch": ["-fuse-s3", "-report-batch", str(BATCH)],
}
LIKELIHOOD_COLS = [2, 4, 6, 8, 9, 10]
COUNT_COLS = [0, 3, 5, 7]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's CLI under every flag set, and the JAX CLI under the new
    ones, each in its own working directory."""
    d = tmp_path_factory.mktemp("planted")
    net, gt = write_planted(str(d), N, K, DEG, GRAPH_SEED)
    out = {}
    cwd = os.getcwd()
    os.environ["SVINET_TORCH_DEVICE"] = "cpu"
    try:
        for pkg, main in (("torch", torch_main), ("jax", jax_main)):
            for name, flags in FLAGS.items():
                if pkg == "jax" and name == "plain":
                    continue
                label = f"{pkg}-{name}"
                run_dir = d / label
                run_dir.mkdir()
                os.chdir(run_dir)
                assert main(["-file", net, "-n", str(N), "-k", str(K),
                             "-link-sampling", "-nmi", gt, "-seed", "1",
                             "-label", label, *flags]) == 0
                out[label] = run_dir / f"n{N}-k{K}-{label}-seed1-linksampling"
    finally:
        os.chdir(cwd)
        os.environ.pop("SVINET_TORCH_DEVICE", None)
    return out


def _heldout(path):
    return np.loadtxt(path / "heldout.txt", ndmin=2)


def _max(path):
    return open(path / "max.txt").read().split()


def _nmi(path):
    return float(open(path / "mutual.txt").read().split()[-1])


def _annealing_end(path):
    m = re.search(r"annealing ended at iteration (\d+)",
                  open(path / "infer.log").read())
    return int(m.group(1)) if m else None


@pytest.mark.parametrize("name", ["batch", "fused", "fused_batch"])
def test_port_matches_jax_cli(runs, name):
    """The same flags through both CLIs: every heldout row both wrote
    (counts exact, likelihoods 1e-4 relative), the stop, the best nshol,
    the NMI and the set of output files."""
    t, j = runs[f"torch-{name}"], runs[f"jax-{name}"]
    th, jh = _heldout(t), _heldout(j)
    rows = min(len(th), len(jh))
    assert rows > 10
    np.testing.assert_array_equal(th[:rows, COUNT_COLS], jh[:rows, COUNT_COLS])
    np.testing.assert_allclose(th[:rows, LIKELIHOOD_COLS],
                               jh[:rows, LIKELIHOOD_COLS], rtol=1e-4, atol=0)
    tm, jm = _max(t), _max(j)
    assert abs(int(tm[0]) - int(jm[0])) <= 1, (tm, jm)
    assert float(tm[4]) == pytest.approx(float(jm[4]), rel=1e-4)
    assert abs(_nmi(t) - _nmi(j)) <= 0.02
    assert sorted(os.listdir(t)) == sorted(os.listdir(j))


@pytest.mark.parametrize("batched,single", [("batch", "plain"),
                                            ("fused_batch", "fused")])
def test_report_batch_rows_equal_single_reports(runs, batched, single):
    """-report-batch 4 writes a heldout row at every boundary, and they
    are the rows of -report-batch 1 exactly, for as long as both runs have
    made the same decisions: up to the report that ends annealing in the
    unbatched run (a batched run learns of it only at its batch's end and
    sweeps on with the old phase until then)."""
    b, s = _heldout(runs[f"torch-{batched}"]), _heldout(runs[f"torch-{single}"])
    np.testing.assert_array_equal(b[:, 0], np.arange(len(b)))
    end = _annealing_end(runs[f"torch-{single}"])
    same = min(len(b), len(s)) if end is None else end + 1
    assert same > 10
    keep = [c for c in range(b.shape[1]) if c != 1]      # 1 is wall seconds
    np.testing.assert_array_equal(b[:same, keep], s[:same, keep])


@pytest.mark.parametrize("name", ["batch", "fused_batch"])
def test_report_batch_files(runs, name):
    """One time.txt row per batch; the heavy per-report extras
    (communities + NMI, mrstats, training-sample rows, convergence) only
    on a batch's last row and on the report at iteration 0; a stop inside
    a batch leaves the later rows unwritten."""
    out = runs[f"torch-{name}"]
    rows = len(_heldout(out))
    stop = int(_max(out)[0])
    assert rows == stop + 1
    times = np.loadtxt(out / "time.txt", ndmin=2)
    n_batches = -(-stop // BATCH)
    assert len(times) == n_batches
    np.testing.assert_array_equal(
        times[:, 0], BATCH * np.arange(1, n_batches + 1))
    heavy = 1 + stop // BATCH
    for fname in ("mrstats.txt", "training.txt", "convergence.txt"):
        got = np.loadtxt(out / fname, ndmin=2)
        assert len(got) == heavy, fname
        np.testing.assert_array_equal(got[:, 0], BATCH * np.arange(heavy))
    # do_on_stop extracts the communities once more at the stop
    assert len(open(out / "mutual.txt").read().split()) // 2 == heavy + 1


def test_fuse_s3_changes_only_the_transient(runs):
    """s3 lags one sweep under -fuse-s3: the first reports differ from
    the unfused run's (lambda1 of sweep 1 has no s3 at all), the fit they
    converge to does not."""
    f, p = _heldout(runs["torch-fused"]), _heldout(runs["torch-plain"])
    np.testing.assert_array_equal(f[0, 2:], p[0, 2:])   # before any sweep
    assert not np.allclose(f[1:4, 10], p[1:4, 10], rtol=1e-6, atol=0)
    assert float(_max(runs["torch-fused"])[4]) == pytest.approx(
        float(_max(runs["torch-plain"])[4]), rel=5e-3)
    assert abs(_nmi(runs["torch-fused"]) - _nmi(runs["torch-plain"])) <= 0.02


def test_report_batch_without_validation_split_does_nothing(tmp_path,
                                                            monkeypatch):
    """Without validation pairs there are no heldout sums to trace, so
    -report-batch steps one interval at a time, as the JAX engine does."""
    import torch
    from svinet_torch.svi import linksampling
    from svinet_torch.synth import planted_blocks
    raw, _ = planted_blocks(N, K, DEG, GRAPH_SEED)
    eng = linksampling.from_edges(raw, N, K, torch.device("cpu"),
                                  str(tmp_path / "out"), report_batch=BATCH,
                                  max_iterations=6, fuse_s3=True)
    eng._ho = None
    calls = []
    monkeypatch.setattr(eng, "_trace_intervals",
                        lambda *a: calls.append(a) or False)
    try:
        eng.infer()
    finally:
        eng.close()
    assert not calls
    assert len(np.loadtxt(tmp_path / "out" / "time.txt", ndmin=2)) == 6
    assert eng.mphi is not None and eng.mphi.any()


def test_max_iterations_shortens_the_last_batch(tmp_path):
    """b_eff: with -max-iterations 6 and -report-batch 4 the second batch
    holds two intervals, and the run ends at iteration 6 with all seven
    heldout rows."""
    import torch
    from svinet_torch.svi import linksampling
    from svinet_torch.synth import planted_blocks
    raw, _ = planted_blocks(N, K, DEG, GRAPH_SEED)
    eng = linksampling.from_edges(raw, N, K, torch.device("cpu"),
                                  str(tmp_path / "out"), report_batch=BATCH,
                                  max_iterations=6, use_validation_stop=False)
    try:
        eng.infer()
    finally:
        eng.close()
    ho = _heldout(tmp_path / "out")
    np.testing.assert_array_equal(ho[:, 0], np.arange(7))
    times = np.loadtxt(tmp_path / "out" / "time.txt", ndmin=2)
    np.testing.assert_array_equal(times[:, 0], [4, 6])
    assert eng.iteration == 7
