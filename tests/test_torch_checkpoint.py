"""Native checkpoints and -resume of svinet_torch, on the CPU.

A run is stopped right after the checkpoint of one of its reports, as a
preempted job stops, and resumed with -resume: every output file must
then equal the uninterrupted run's, bit for bit, apart from the columns
and files that hold wall time (the duration column of the report files,
convergence_hosts.txt's first-converged seconds, infer.log, time.txt,
mrstats.txt). Checked for LinkSampling under default flags, -fuse-s3,
-freeze, -sparse-w past annealing and -prune on a compacted state; for
MMSBInfer, whose checkpoint holds the lambda clock and the stratified
family phase but, like the JAX package's, not the numpy Generator, the
resumed run is held to the JAX package's resumed run. Also: the report
files are appended on resume and no iteration-0 report is made, KEEP_LAST
and the atomic `latest` pointer, and the SIGTERM save with and without
-checkpoint-freq."""

import os

import numpy as np
import pytest
import torch

from svinet_tpu.cli import main as jax_main
from svinet_tpu.svi import base as jbase
from svinet_torch.cli import main as torch_main
from svinet_torch.io import checkpoint
from svinet_torch.svi import base as tbase
from svinet_torch.svi.linksampling import from_edges
from svinet_torch.synth import planted_blocks, write_planted

N, K, DEG, GRAPH_SEED = 400, 4, 16, 2
# files whose second column is the run's duration in seconds
DURATION_COL = {"heldout.txt", "validation.txt", "training.txt", "test.txt",
                "stats.txt", "max.txt", "convergence.txt", "modularity.txt",
                "logl.txt"}
TIMED = {"infer.log", "time.txt", "mrstats.txt"}


class Crash(Exception):
    """A run cut off right after a report's checkpoint."""


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    net, gt = write_planted(str(d), N, K, DEG, GRAPH_SEED)
    return d, net, gt


def _args(net, gt, flags):
    return ["-file", net, "-n", str(N), "-k", str(K), "-link-sampling",
            "-nmi", gt, "-seed", "1", "-label", "ck", *flags]


def _crash_after(monkeypatch, base_cls, iteration):
    """Make every engine raise Crash at the end of the report of
    `iteration`, once its checkpoint is written."""
    orig = base_cls._end_of_report

    def cut(self):
        orig(self)
        if self.iteration >= iteration and not getattr(
                self, "_light_report", False):
            raise Crash
    monkeypatch.setattr(base_cls, "_end_of_report", cut)


def _strip(path, name):
    """A file's text without its wall-time parts."""
    lines = open(path / name).read().splitlines()
    if name in DURATION_COL:
        return ["\t".join(l.split("\t")[:1] + l.split("\t")[2:])
                for l in lines]
    if name == "convergence_hosts.txt":
        return [l.rsplit("\t", 1)[0] for l in lines]
    return lines


def _assert_same_outputs(whole, resumed):
    names = sorted(set(os.listdir(whole)) - TIMED)
    assert names == sorted(set(os.listdir(resumed)) - TIMED - {"ckpt"})
    for name in names:
        if os.path.isdir(whole / name):
            continue
        assert _strip(whole, name) == _strip(resumed, name), name


def _cli_crash_resume(root, monkeypatch, main, base_cls, args, at):
    """The uninterrupted run in root/whole; in root/cut a run with a
    checkpoint at every report, cut after the report of `at`, then
    resumed. Returns the two output directories."""
    cwd = os.getcwd()
    out = {}
    try:
        for name in ("whole", "cut"):
            d = root / name
            d.mkdir(exist_ok=True)
            os.chdir(d)
            if name == "whole":
                assert main(args) == 0
            else:
                with monkeypatch.context() as mp:
                    _crash_after(mp, base_cls, at)
                    with pytest.raises(Crash):
                        main([*args, "-checkpoint-freq", "1e-9"])
                cut = [p for p in os.listdir(d) if p.startswith("n")
                       and os.path.isdir(d / p)]
                assert checkpoint.latest_step(str(d / cut[0])) is not None
                assert main([*args, "-resume"]) == 0
            outs = [p for p in os.listdir(d) if p.startswith("n")
                    and os.path.isdir(d / p)]
            out[name] = d / outs[0]
    finally:
        os.chdir(cwd)
    return out["whole"], out["cut"]


@pytest.mark.parametrize("flags,at", [
    ([], 20), (["-fuse-s3"], 20), (["-freeze"], 20),
    (["-sparse-w", "2"], 33)],
    ids=["default", "fuse_s3", "freeze", "sparse_w_past_annealing"])
def test_resumed_link_sampling_equals_uninterrupted(planted, tmp_path,
                                                    monkeypatch, flags, at):
    _, net, gt = planted
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    whole, cut = _cli_crash_resume(tmp_path, monkeypatch, torch_main,
                                   tbase.EngineBase, _args(net, gt, flags),
                                   at)
    _assert_same_outputs(whole, cut)
    log = open(cut / "infer.log").read()
    assert log.count("engine: LinkSampling") == 2
    if flags == ["-sparse-w", "2"]:
        # the checkpoint came after annealing: the (n, K) mphi of the
        # sparse rows was stored and rebuilt into the pairs
        i = int(log.split("annealing ended at iteration ")[1].split()[0])
        assert i < at


def test_resume_appends_and_skips_the_iteration_0_report(planted, tmp_path,
                                                         monkeypatch):
    """Every report file keeps its rows of before the cut: a row for each
    of the reports 0 to 12 and no second iteration-0 row, the
    -load-test-sets trace included."""
    _, net, gt = planted
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    rng = np.random.default_rng(4)
    for name in ("whole", "cut"):
        (tmp_path / name).mkdir()
        pairs = rng.integers(0, N, size=(60, 2))
        np.savetxt(tmp_path / name / "uniform-heldout-pairs.txt",
                   pairs[pairs[:, 0] != pairs[:, 1]], fmt="%d")
    whole, cut = _cli_crash_resume(
        tmp_path, monkeypatch, torch_main, tbase.EngineBase,
        _args(net, gt, ["-max-iterations", "12", "-no-stop",
                        "-load-test-sets"]), 4)
    ho = np.loadtxt(cut / "heldout.txt", ndmin=2)
    np.testing.assert_array_equal(ho[:, 0], np.arange(13))
    for name in ("convergence.txt", "training.txt", "stats.txt",
                 "validation.txt", "mrstats.txt", "uniform-hol.txt"):
        its = np.loadtxt(cut / name, ndmin=2)[:, 0]
        np.testing.assert_array_equal(its, np.arange(13))
    assert len(open(cut / "mutual.txt").read().splitlines()) == len(
        open(whole / "mutual.txt").read().splitlines())
    # time.txt holds a row for every step, before and after the cut
    t = np.loadtxt(cut / "time.txt", ndmin=2)[:, 0]
    np.testing.assert_array_equal(t, np.arange(1, 13))
    log = open(cut / "infer.log").read()
    assert log.count("engine: LinkSampling") == 2


EN, EK = 150, 24


def _pruned_engine(root, **kw):
    """A -prune engine past annealing on a state forced into the
    dead-column regime (tests/test_torch_prune.py's)."""
    raw, _ = planted_blocks(EN, 4, 12, 2)
    eng = from_edges(raw, EN, EK, torch.device("cpu"), str(root), seed=5,
                     max_iterations=16, use_validation_stop=False,
                     reportfreq=4, prune=True, **kw)
    if not kw.get("resume"):
        g = eng.gamma.numpy()
        g2 = np.full_like(g, eng.cfg.alpha)
        g2[:, :5] = g[:, :5] + g[:, 5:10]
        eng.gamma = torch.from_numpy(g2)
        eng.annealing = False
    return eng


def test_resumed_prune_recompacts_where_uninterrupted_does(tmp_path,
                                                           monkeypatch):
    """The checkpoint at a report holds the full layout (a report expands
    first, saves, and compacts last); the resumed engine compacts at once,
    so its next interval sweeps at width 8 as the uninterrupted one."""
    whole = _pruned_engine(tmp_path / "whole")
    widths = []
    step = whole.step
    whole.step = lambda n=1: (widths.append(whole.gamma.shape[1]),
                              step(n))[1]
    whole.infer()
    whole.close()
    cut = _pruned_engine(tmp_path / "cut", checkpoint_freq=1e-9)
    with monkeypatch.context() as mp:
        _crash_after(mp, tbase.EngineBase, 8)
        with pytest.raises(Crash):
            cut.infer()
    cut.close()
    saved = checkpoint.load_checkpoint(str(tmp_path / "cut"))
    assert saved["iteration"] == 9 and saved["gamma"].shape == (EN, EK)
    res = _pruned_engine(tmp_path / "cut", resume=True)
    assert res.iteration == 9 and res.gamma.shape == (EN, 8)
    rwidths = []
    rstep = res.step
    res.step = lambda n=1: (rwidths.append(res.gamma.shape[1]),
                            rstep(n))[1]
    res.infer()
    res.close()
    assert widths == [8, 8, 8, 8] and rwidths == widths[2:]
    _assert_same_outputs(tmp_path / "whole", tmp_path / "cut")


def test_keep_last_and_the_latest_pointer(tmp_path):
    g = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    for step in (3, 5, 8, 13, 21):
        checkpoint.save_checkpoint(str(tmp_path), {
            "gamma": g + step, "iteration": step, "stopper": [1.0, 2.0]},
            step)
    ck = tmp_path / "ckpt"
    assert sorted(os.listdir(ck)) == sorted(
        [f"{s}{x}" for s in (8, 13, 21) for x in (".pt", ".meta.json")]
        + ["latest"])
    assert open(ck / "latest").read() == "21"
    got = checkpoint.load_checkpoint(str(tmp_path))
    assert got["iteration"] == 21 and got["stopper"] == [1.0, 2.0]
    torch.testing.assert_close(got["gamma"], g + 21)
    # a pointer left half-written by a kill falls back to the newest step
    (ck / "latest").write_text("")
    assert checkpoint.latest_step(str(tmp_path)) == 21
    # a truncated newest step falls back to the next older one
    (ck / "21.pt").write_bytes(b"\x00")
    assert checkpoint.load_checkpoint(str(tmp_path))["iteration"] == 13
    with pytest.raises(Exception):
        checkpoint.load_checkpoint(str(tmp_path), step=21)
    assert checkpoint.load_checkpoint(str(tmp_path / "none")) is None


@pytest.mark.parametrize("freq", [0.0, 1e9], ids=["no_freq", "with_freq"])
def test_sigterm_saves_model_and_checkpoint(planted, tmp_path, monkeypatch,
                                            freq):
    """A SIGTERM sets a flag; the next report writes the model files and a
    checkpoint of the next iteration, and the run goes on. With
    -checkpoint-freq the stop writes a last checkpoint too."""
    from svinet_torch.cli import parse_args
    from svinet_torch.graph import Network
    from svinet_torch.svi.linksampling import LinkSampling
    _, net, gt = planted
    monkeypatch.chdir(tmp_path)
    cfg = parse_args(_args(net, gt, ["-max-iterations", "4", "-no-stop"]))
    cfg.checkpoint_freq = freq
    nw = Network(cfg)
    nw.read(cfg.datfname)
    nw.drop_singles()
    eng = LinkSampling(cfg, nw, torch.device("cpu"))
    eng.terminate_requested = True
    saved = []
    orig = checkpoint.save_checkpoint
    monkeypatch.setattr(checkpoint, "save_checkpoint",
                        lambda o, s, st: (saved.append(st), orig(o, s, st))[1])
    try:
        eng.infer()
    finally:
        eng.close()
    log = open(tmp_path / cfg.outdir / "infer.log").read()
    assert "SIGTERM: saving model state at iteration 0" in log
    assert log.count("stopped at iteration") == 2
    # the SIGTERM's checkpoint stores iteration 1; -checkpoint-freq's final
    # one the iteration after the last, 5
    assert saved == ([1] if not freq else [1, 5])
    assert (tmp_path / cfg.outdir / "gamma.txt").exists()


STRAT = ["-stratified", "-rpair", "-max-iterations", "60", "-rfreq", "10"]
SN = 150     # the MMSBInfer runs' planted graph


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt_small")
    net, gt = write_planted(str(d), SN, K, DEG, GRAPH_SEED)
    return d, net, gt


def _mmsb_args(net, gt):
    return ["-file", net, "-n", str(SN), "-k", str(K), "-nmi", gt, "-seed",
            "1", "-label", "ck", *STRAT]


def test_mmsb_state_holds_lambda_clock_and_family(small, tmp_path,
                                                  monkeypatch):
    from svinet_torch.cli import parse_args
    from svinet_torch.graph import Network
    from svinet_torch.svi.mmsb import MMSBInfer
    _, net, gt = small
    monkeypatch.chdir(tmp_path)

    def engine(resume=False):
        cfg = parse_args(_mmsb_args(net, gt) + (["-resume"] if resume
                                                else []))
        nw = Network(cfg)
        nw.read(cfg.datfname)
        nw.drop_singles()
        return MMSBInfer(cfg, nw, torch.device("cpu"))

    eng = engine()
    eng._step_minibatches(7)
    eng.iteration = 7
    eng._lambda_start_iter, eng._delaylearn_reported = 3, True
    assert eng._family == 1
    eng.save_checkpoint()
    eng.close()
    res = engine(resume=True)
    assert (res.iteration, res._lambda_start_iter, res._delaylearn_reported,
            res._family) == (7, 3, True, 1)
    torch.testing.assert_close(res.gamma, eng.gamma, rtol=0, atol=0)
    assert res.stopper.min_iter == SN
    res.close()


def test_mmsb_resume_matches_jax_resume(small, tmp_path, monkeypatch):
    """-stratified -rpair cut after the report of iteration 30 and
    resumed, through both CLIs: neither checkpoint holds the Generator,
    so both resumed runs draw the same pairs; the same stop iteration,
    and the heldout rows at 1e-4."""
    _, net, gt = small
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    outs = {}
    for name, main, base_cls in (("jax", jax_main, jbase.EngineBase),
                                 ("torch", torch_main, tbase.EngineBase)):
        root = tmp_path / name
        root.mkdir()
        outs[name] = _cli_crash_resume(root, monkeypatch, main, base_cls,
                                       _mmsb_args(net, gt), 30)[1]
    t = np.loadtxt(outs["torch"] / "heldout.txt", ndmin=2)
    j = np.loadtxt(outs["jax"] / "heldout.txt", ndmin=2)
    assert t.shape == j.shape and len(t) == 6   # reports 10 to 60
    np.testing.assert_array_equal(t[:, [0, 3, 5, 7]], j[:, [0, 3, 5, 7]])
    np.testing.assert_allclose(t[:, [2, 4, 6, 8, 9, 10]],
                               j[:, [2, 4, 6, 8, 9, 10]], rtol=1e-4)
    tm = open(outs["torch"] / "max.txt").read().split()
    jm = open(outs["jax"] / "max.txt").read().split()
    assert tm[0] == jm[0] and len(tm) == 7
    lt = open(outs["torch"] / "infer.log").read()
    assert lt.count("engine: MMSBInfer") == 2
