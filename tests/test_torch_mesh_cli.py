"""`-mesh N` and `-mesh-rowshard` end to end: svinet_torch's CLI spawns
gloo ranks on the CPU (parallel/mesh.py:launch) and its files are held to
the JAX package's `-mesh 2` run of the same flags at the JAX CLI's own
tolerances (tests/test_sharding.py:199, 209), with the same stop. Also:
-mesh 1 is the single-device run, -resume and a SIGTERM under -mesh 2
give the uninterrupted run's files, and -freeze and -sparse-w are refused
under a mesh with the JAX messages."""

import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from svinet_tpu.cli import main as jax_main
from svinet_torch.cli import main as torch_main, parse_args
from svinet_torch.parallel import mesh
from svinet_torch.synth import write_planted

REPO = pathlib.Path(__file__).resolve().parents[1]
GAMMA_TOL = dict(rtol=2e-4, atol=2e-3)
HELDOUT_TOL = dict(rtol=5e-4, atol=5e-4)
# files whose values are wall time, or whose rows carry it
_TIMED = {"infer.log", "time.txt", "mrstats.txt", "ckpt"}
_DURATION_COL = {"heldout.txt", "validation.txt", "training.txt",
                 "stats.txt", "max.txt", "convergence.txt",
                 "modularity.txt", "logl.txt"}


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """Planted graphs: n=400 (link sampling), n=401 (rows that do not
    split over 2 ranks), n=4200 (MMSBInfer minibatches that fill both
    ranks' shards of 2048-pair blocks), n=200 (-batch)."""
    d = tmp_path_factory.mktemp("graphs")
    return {n: write_planted(str(d), n, 4, 16 if n < 1000 else 10, 2)
            for n in (400, 401, 4200, 200)}


def _run(main, cwd, net, gt, n, label, flags):
    os.chdir(cwd)
    assert main(["-file", net, "-n", str(n), "-k", "4", "-nmi", gt,
                 "-seed", "1", "-label", label, *flags]) == 0
    out = [p for p in pathlib.Path(cwd).iterdir()
           if p.name.startswith(f"n{n}-k4-{label}-seed1")]
    assert len(out) == 1, out
    return out[0]


def _both(tmp_path, monkeypatch, graphs, n, flags):
    """The JAX CLI with `flags` (-mesh 2 among them) and the port's
    launcher with them on 2 ranks, each in its own directory. Returns (jax
    outdir, torch outdir); the ranks' final gamma and lambda must be bit
    for bit equal unless gamma is row-sharded."""
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    net, gt = graphs[n]
    reports = tmp_path / "ranks"
    reports.mkdir()

    def launch(argv):
        return mesh.launch(argv, 2, report_dir=str(reports))

    out = []
    for name, main in (("jax", jax_main), ("torch", launch)):
        d = tmp_path / name
        d.mkdir()
        out.append(_run(main, d, net, gt, n, name, flags))
    ranks = [json.loads((reports / f"rank{r}.json").read_text())
             for r in range(2)]
    # on the CPU every wrapper takes its plain version: no launch counted
    for r in ranks:
        assert r["launches"]["phi_pass"]["launches"] == 0
    if "-mesh-rowshard" not in flags:
        for key in ("gamma_sha256", "lam_sha256"):
            assert ranks[0][key] == ranks[1][key], key
    return out


def _rows(path, name):
    return np.loadtxt(path / name, ndmin=2)


def _gamma(path):
    return _rows(path, "gamma.txt")[:, 2:]


@pytest.mark.parametrize("n,flags", [
    (400, ["-link-sampling"]),
    (400, ["-link-sampling", "-fuse-s3", "-report-batch", "4"]),
    (401, ["-link-sampling", "-mesh-rowshard", "-max-iterations", "30"]),
], ids=["default", "fuse-s3-report-batch", "rowshard-odd-n"])
def test_cli_link_sampling_mesh_matches_jax(graphs, tmp_path, monkeypatch, n,
                                            flags):
    jax_out, torch_out = _both(tmp_path, monkeypatch, graphs, n,
                               [*flags, "-mesh", "2"])
    np.testing.assert_allclose(_gamma(torch_out), _gamma(jax_out),
                               **GAMMA_TOL)
    hj, ht = _rows(jax_out, "heldout.txt"), _rows(torch_out, "heldout.txt")
    assert ht.shape == hj.shape
    np.testing.assert_array_equal(ht[:, 0], hj[:, 0])
    np.testing.assert_allclose(ht[:, 2:], hj[:, 2:], **HELDOUT_TOL)
    mj, mt = (open(p / "max.txt").read().split() for p in (jax_out,
                                                           torch_out))
    assert mt[0] == mj[0], (mt, mj)
    assert sorted(os.listdir(torch_out)) == sorted(os.listdir(jax_out))


@pytest.mark.parametrize("n,flags", [
    (4200, ["-max-iterations", "20", "-rfreq", "10"]),
    (4200, ["-rnode", "-max-iterations", "20", "-rfreq", "10"]),
    (4200, ["-rnode", "-nonuniform", "-inf", "0.1", "-max-iterations", "20",
            "-rfreq", "10"]),
    (200, ["-batch", "-logl", "-max-iterations", "3"]),
], ids=["rpair", "rnode", "nonuniform-inf", "batch-logl"])
def test_cli_mmsb_mesh_matches_jax(graphs, tmp_path, monkeypatch, n, flags):
    jax_out, torch_out = _both(tmp_path, monkeypatch, graphs, n,
                               [*flags, "-mesh", "2"])
    np.testing.assert_allclose(_gamma(torch_out), _gamma(jax_out),
                               **GAMMA_TOL)
    for name in ("heldout.txt", "validation.txt") + (
            ("logl.txt",) if "-logl" in flags else ()):
        # validation.txt has rows only at new maxima past the stop guard
        a, b = _rows(torch_out, name), _rows(jax_out, name)
        assert a.shape == b.shape and (len(a) or name == "validation.txt")
        if len(a):
            np.testing.assert_array_equal(a[:, 0], b[:, 0])
            np.testing.assert_allclose(a[:, 2:], b[:, 2:], **HELDOUT_TOL)


def _strip(path, name):
    lines = open(path / name).read().splitlines()
    if name in _DURATION_COL:
        return [l.split("\t", 2)[0] + "\t" + l.split("\t", 2)[2]
                for l in lines]
    if name == "convergence_hosts.txt":
        return [l.rsplit("\t", 1)[0] for l in lines]
    return lines


def _same_files(a, b, skip=()):
    names = sorted(set(os.listdir(a)) - _TIMED - set(skip))
    assert names == sorted(set(os.listdir(b)) - _TIMED - set(skip))
    for name in names:
        assert _strip(a, name) == _strip(b, name), name


@pytest.mark.parametrize("flags", [["-link-sampling"], ["-rnode"]],
                         ids=["link-sampling", "rnode"])
def test_cli_mesh_one_is_the_single_device_run(graphs, tmp_path, monkeypatch,
                                               flags):
    """-mesh 1 alone takes the single-device path, as in the JAX package
    (svinet_tpu/svi/linksampling.py:545-546, svinet_tpu/svi/mmsb.py:314):
    its files are those of the run without the flag, byte for byte
    (wall-time columns aside)."""
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    net, gt = graphs[400]
    it = ["-max-iterations", "20", "-rfreq", "10"]
    a = _run(torch_main, tmp_path, net, gt, 400, "none", [*flags, *it])
    b = _run(torch_main, tmp_path, net, gt, 400, "one",
             [*flags, *it, "-mesh", "1"])
    _same_files(a, b)


def test_cli_mesh_resume_equals_uninterrupted(graphs, tmp_path, monkeypatch):
    """-mesh 2 to iteration 10 with a checkpoint at every report, then
    -resume to 20, against -mesh 2 to 20 in one run: rank 0 saves, every
    rank restores the same state and iteration, and the report files
    append to the same rows."""
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    net, gt = graphs[400]
    base = ["-link-sampling", "-fuse-s3", "-no-stop", "-rfreq", "5",
            "-mesh", "2"]
    (tmp_path / "w").mkdir()
    whole = _run(torch_main, tmp_path / "w", net, gt, 400, "r",
                 [*base, "-max-iterations", "20"])
    cut = tmp_path / "c"
    cut.mkdir()
    _run(torch_main, cut, net, gt, 400, "r",
         [*base, "-max-iterations", "10", "-checkpoint-freq", "1e-9"])
    resumed = _run(torch_main, cut, net, gt, 400, "r",
                   [*base, "-max-iterations", "20", "-resume"])
    assert (resumed / "ckpt" / "latest").exists()
    for name in ("heldout.txt", "validation.txt", "convergence.txt"):
        assert _strip(resumed, name) == _strip(whole, name), name
    for name in ("gamma.txt", "lambda.txt", "communities.txt", "max.txt"):
        assert _strip(resumed, name) == _strip(whole, name), name


@pytest.mark.parametrize("flags,message", [
    (["-freeze"], "-freeze is not supported under -mesh / -mesh-rowshard"),
    (["-sparse-w", "2"], "-sparse-w is single-device; drop -mesh"),
    (["-freeze", "-mesh-rowshard"], "-freeze is not supported under -mesh"),
], ids=["freeze", "sparse-w", "freeze-rowshard"])
def test_cli_mesh_refuses_with_the_jax_message(graphs, tmp_path,
                                               monkeypatch, flags, message):
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    net, gt = graphs[400]
    argv = ["-file", net, "-n", "400", "-k", "4", "-link-sampling",
            "-mesh", "2", *flags]
    with pytest.raises(SystemExit, match=message):
        torch_main(argv)
    with pytest.raises(SystemExit, match=message):
        jax_main(argv)


@pytest.mark.parametrize("flags", [
    ["-link-sampling", "-mesh", "2"], ["-link-sampling", "-mesh-rowshard"],
    ["-link-sampling", "-mesh", "4", "-mesh-rowshard", "-fuse-s3"],
    ["-mesh", "2", "-batch"], ["-rnode", "-mesh", "3"],
    ["-link-sampling", "-mesh-locality"],
    ["-link-sampling", "-mesh", "4", "-mesh-locality", "-bf16"],
    ["-stratified", "-rnode", "-mesh", "2", "-adamic-adar"],
    ["-link-sampling", "-mesh", "2", "-dist-coordinator", "h:1",
     "-dist-nprocs", "2", "-dist-procid", "1"],
    ["-rnode", "-dist-nprocs", "1"],
])
def test_cli_takes_the_mesh_flags(flags):
    """The mesh flags parse, and each run takes the mesh path where the
    JAX engine shards: all but -link-sampling -mesh-rowshard (no -mesh 1)
    and -rnode without -mesh."""
    from svinet_torch.parallel import mesh
    cfg = parse_args(["-file", "absent.txt", "-n", "10", "-k", "2", *flags])
    alone = (["-link-sampling", "-mesh-rowshard"],
             ["-rnode", "-dist-nprocs", "1"])
    assert mesh.wants_mesh(cfg) == (flags not in alone)


def _wait_for(path, text, proc, deadline):
    while time.time() < deadline:
        if path.exists() and text in path.read_text():
            return True
        if proc.poll() is not None:
            return False
        time.sleep(0.02)
    return False


def test_sigterm_under_mesh_saves_and_runs_on(graphs, tmp_path):
    """SIGTERM to a running `-mesh 2` CLI: the launcher forwards it to
    rank 0, every rank agrees on it at the next report boundary, the model
    files and a checkpoint are saved there and the run goes on; it ends
    with status 0 and the files of the uninterrupted run."""
    net, gt = graphs[400]
    env = dict(os.environ, SVINET_TORCH_DEVICE="cpu",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    argv = ["-file", net, "-n", "400", "-k", "4", "-link-sampling", "-nmi",
            gt, "-seed", "1", "-no-stop", "-max-iterations", "200",
            "-rfreq", "20", "-mesh", "2"]
    outs = {}
    for label in ("whole", "term"):
        d = tmp_path / label
        d.mkdir()
        proc = subprocess.Popen(
            [sys.executable, "-m", "svinet_torch", *argv, "-label", label],
            cwd=d, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
        out = d / f"n400-k4-{label}-seed1-linksampling"
        if label == "term":
            assert _wait_for(out / "infer.log", "iteration 20:", proc,
                             time.time() + 600), proc.stderr.read()
            proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err
        outs[label] = out
    log = (outs["term"] / "infer.log").read_text()
    assert "SIGTERM: saving model state" in log
    for name in ("gamma.txt", "lambda.txt", "heldout.txt", "max.txt",
                 "communities.txt"):
        assert _strip(outs["term"], name) == _strip(outs["whole"], name), name
