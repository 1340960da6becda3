"""FastAMM2 (-stratified -rnode) in the port against the JAX package:
the numpy copies of svi/sampling.py and evals/precision.py, the CLI runs
on one device, under -resume and under -mesh 2, and -adamic-adar.

The engines draw the same minibatches from the same Generator, so their
states differ only by the sums' rounding: gamma, lambda and the heldout
rows are held at 1e-4. Both rank the precision pairs by f32 link
probabilities of those states; on these graphs their precision files
come out equal, hitcurves included."""

import filecmp
import json
import os
import pathlib

import numpy as np
import pytest

from svinet_tpu.cli import main as jax_main
from svinet_tpu.evals import precision as jprecision
from svinet_tpu.graph import Network as JNetwork
from svinet_tpu.svi import sampling as jsampling
from svinet_torch.cli import main as torch_main, parse_args
from svinet_torch.evals import precision
from svinet_torch.graph import Network
from svinet_torch.parallel import mesh
from svinet_torch.svi import sampling
from svinet_torch.svi.fastamm2 import shared_neighbor_mask
from svinet_torch.synth import write_planted

TOL = dict(rtol=1e-4, atol=1e-4)
# files whose values are wall time, or whose rows carry it (column 2)
_TIMED = {"infer.log", "time.txt", "mrstats.txt", "ckpt"}
_DURATION_COL = {"heldout.txt", "validation.txt", "training.txt",
                 "stats.txt", "max.txt", "modularity.txt", "logl.txt",
                 "precision.txt"}
_PRECISION_FILES = ("adamic_adar.txt", "ad_hitcurve.txt",
                    "adamic-adar-auc.txt", "precision-pairs.txt")


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    d = tmp_path_factory.mktemp("planted")
    return write_planted(str(d), 400, 4, 16, 2)


def _networks(net, n=400):
    """The same graph read by both packages, with FastAMM2's splits."""
    out = []
    for cls in (Network, JNetwork):
        cfg = parse_args(["-file", net, "-n", str(n), "-k", "4",
                          "-stratified", "-rnode"])
        cfg.create_test_precision_sets = True
        nw = cls(cfg)
        nw.read(net)
        nw.drop_singles()
        nw.sample_heldout_sets(np.random.default_rng(5), dual=True)
        out.append(nw)
    return out


@pytest.mark.parametrize("start,want", [(0, 40), (123, 40), (7, 1000)])
def test_ring_scan_matches_jax(planted, start, want):
    """ring_nonlink_scan over nonlink_accept, with and without a reject
    set and the heldout exclusion: the same survivors in the same
    order."""
    ours, theirs = _networks(planted[0])
    shuffled = np.random.default_rng(start).permutation(ours.n)
    reject = np.sort(ours.neighbors(3)[:5]).astype(np.int64)
    for rej, ok in ((None, False), (reject, True)):
        a = sampling.ring_nonlink_scan(
            shuffled, ours.n, start, want,
            sampling.nonlink_accept(ours, 3, rej, ok), batch=64)
        b = jsampling.ring_nonlink_scan(
            shuffled, theirs.n, start, want,
            jsampling.nonlink_accept(theirs, 3, rej, ok), batch=64)
        assert a.dtype == b.dtype and len(a) == min(want, len(a))
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_draws_match_jax(planted, seed):
    ours, theirs = _networks(planted[0])
    a = sampling.random_nonlink_draws(np.random.default_rng(seed), ours,
                                      ours.n, 11, 300, None, 5000)
    b = jsampling.random_nonlink_draws(np.random.default_rng(seed), theirs,
                                       theirs.n, 11, 300, None, 5000)
    np.testing.assert_array_equal(a, b)


def test_precision_functions_match_jax(planted, tmp_path):
    """precision_counts, write_hitcurve and adamic_adar_scores against the
    originals, and the engine's shortcut (only pairs with a neighbour in
    common are scored) against the full scoring."""
    ours, theirs = _networks(planted[0])
    pairs = ours.precision_pairs
    assert len(pairs) > 500
    s = precision.adamic_adar_scores(ours, pairs)
    np.testing.assert_array_equal(
        s, jprecision.adamic_adar_scores(theirs, pairs))
    near = shared_neighbor_mask(ours, pairs)
    assert 0 < near.sum() < len(pairs)
    assert (s[~near] == 0.0).all()
    short = np.zeros(len(pairs))
    short[near] = precision.adamic_adar_scores(ours, pairs[near])
    np.testing.assert_array_equal(short, s)
    a = precision.precision_counts(s, ours.precision_y)
    b = jprecision.precision_counts(s, ours.precision_y)
    assert a[:3] == b[:3]
    np.testing.assert_array_equal(a[3], b[3])
    precision.write_hitcurve(str(tmp_path / "a.txt"), a[3])
    jprecision.write_hitcurve(str(tmp_path / "b.txt"), b[3])
    assert filecmp.cmp(tmp_path / "a.txt", tmp_path / "b.txt",
                       shallow=False)


def _run(main, cwd, net, gt, label, flags):
    os.chdir(cwd)
    assert main(["-file", net, "-n", "400", "-k", "4", "-nmi", gt, "-seed",
                 "1", "-label", label, "-stratified", "-rnode",
                 *flags]) == 0
    out = [p for p in pathlib.Path(cwd).iterdir()
           if p.name.startswith(f"n400-k4-{label}-seed1")]
    assert len(out) == 1, out
    return out[0]


def _strip(path, name):
    lines = open(path / name).read().splitlines()
    if name in _DURATION_COL:
        return [l.split("\t", 2)[0] + "\t" + l.split("\t", 2)[2]
                for l in lines]
    return lines


def _held_to_jax(ours, theirs):
    """gamma, lambda and the heldout rows at 1e-4; the precision rows,
    every hitcurve and the Adamic-Adar files equal; the same files."""
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    for name, ids in (("gamma.txt", 2), ("lambda.txt", 1)):
        a, b = (np.loadtxt(p / name) for p in (ours, theirs))
        np.testing.assert_array_equal(a[:, :ids], b[:, :ids])
        np.testing.assert_allclose(a[:, ids:], b[:, ids:], **TOL)
    a, b = (np.loadtxt(p / "heldout.txt") for p in (ours, theirs))
    assert a.shape == b.shape and len(a) >= 3
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    np.testing.assert_allclose(a[:, 2:], b[:, 2:], **TOL)
    assert _strip(ours, "precision.txt") == _strip(theirs, "precision.txt")
    curves = [n for n in os.listdir(ours) if n.startswith("hitcurve_")]
    assert len(curves) == len(a)
    for name in curves + list(_PRECISION_FILES):
        assert filecmp.cmp(ours / name, theirs / name, shallow=False), name


def test_cli_fastamm2_matches_jax(planted, tmp_path, monkeypatch):
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    net, gt = planted
    flags = ["-max-iterations", "300", "-rfreq", "50"]
    out = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        (tmp_path / name).mkdir()
        out[name] = _run(main, tmp_path / name, net, gt, name, flags)
    _held_to_jax(out["torch"], out["jax"])


def test_cli_fastamm2_mesh_matches_jax(planted, tmp_path, monkeypatch):
    """-mesh 2: every rank draws the minibatch, takes its shard of the
    padded pairs, and kernel 8's sums are all-reduced
    (svinet_tpu/svi/fastamm2.py:76-99); the replicas end bit for bit
    equal."""
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    net, gt = planted
    reports = tmp_path / "ranks"
    reports.mkdir()
    flags = ["-max-iterations", "200", "-rfreq", "50", "-mesh", "2"]
    out = {}
    for name, main in (
            ("jax", jax_main),
            ("torch", lambda argv: mesh.launch(argv, 2,
                                               report_dir=str(reports)))):
        (tmp_path / name).mkdir()
        out[name] = _run(main, tmp_path / name, net, gt, name, flags)
    _held_to_jax(out["torch"], out["jax"])
    ranks = [json.loads((reports / f"rank{r}.json").read_text())
             for r in range(2)]
    for key in ("gamma_sha256", "lam_sha256"):
        assert ranks[0][key] == ranks[1][key], key


def test_cli_fastamm2_resume_continues_the_hitcurves(planted, tmp_path,
                                                     monkeypatch):
    """A run cut at iteration 150 with a checkpoint at each report, then
    -resume'd to 300, in both CLIs: the hitcurve counter is checkpoint
    state, so the resumed run writes hitcurve_3..5 beside the cut run's
    0..2 and appends to precision.txt. Neither package keeps the host
    Generator in its checkpoints, so both resumed runs draw the same
    minibatches, and the port's files are held to the JAX package's."""
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    net, gt = planted
    base = ["-no-stop", "-rfreq", "50"]
    out = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        cut = tmp_path / name
        cut.mkdir()
        first = _run(main, cut, net, gt, name,
                     [*base, "-max-iterations", "150", "-checkpoint-freq",
                      "1e-9"])
        before = {n: (first / n).read_text() for n in os.listdir(first)
                  if n.startswith("hitcurve_")}
        out[name] = _run(main, cut, net, gt, name,
                         [*base, "-max-iterations", "300", "-resume"])
        assert sorted(before) == [f"hitcurve_{i}.txt" for i in range(3)]
        for n, text in before.items():
            assert open(out[name] / n).read() == text, n
        rows = [l.split("\t")[0] for l in
                open(out[name] / "precision.txt").read().splitlines()]
        assert rows == [str(i) for i in range(50, 301, 50)]
    _held_to_jax(out["torch"], out["jax"])


def test_cli_adamic_adar_writes_the_baseline_only(planted, tmp_path,
                                                  monkeypatch):
    """-adamic-adar: the baseline's files, as the JAX CLI writes them, and
    no inference (src/fastamm2.cc:131-134)."""
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    net, gt = planted
    out = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        (tmp_path / name).mkdir()
        out[name] = _run(main, tmp_path / name, net, gt, name,
                         ["-adamic-adar"])
    assert not (out["torch"] / "gamma.txt").exists()
    assert sorted(os.listdir(out["torch"])) == sorted(os.listdir(out["jax"]))
    for name in _PRECISION_FILES:
        assert filecmp.cmp(out["torch"] / name, out["jax"] / name,
                           shallow=False), name
