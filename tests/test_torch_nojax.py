"""The port runs without JAX and without the JAX package: the machine
with the GPU has no JAX, and the port imports nothing of svinet_tpu.

A subprocess blocks every `jax` and `svinet_tpu` import with a
sys.meta_path finder, imports svinet_torch and runs its CLI on a planted
graph on the CPU. The
CLI's dispatch of every engine flag as the JAX CLI dispatches it, and
its refusal of a CUDA device on a machine without one, are checked here
too."""

import os
import pathlib
import re
import signal
import subprocess
import sys
import textwrap
import time

import pytest
import torch

import svinet_torch
from svinet_torch.cli import main

REPO = pathlib.Path(__file__).resolve().parents[1]

_BLOCKED_RUN = textwrap.dedent("""
    import sys

    class BlockJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "svinet_tpu"):
                raise ImportError(name + " is blocked")
            return None

    sys.meta_path.insert(0, BlockJax())
    sys.path.insert(0, REPO)
    import torch
    # the runs are thousands of tiny CPU ops: one thread, so that the
    # test run's other workers do not starve this process's thread pool
    torch.set_num_threads(1)
    from svinet_torch.synth import write_planted
    from svinet_torch.cli import main
    net, gt = write_planted(".", 200, 4, 12, 5)
    rc = main(["-file", net, "-n", "200", "-k", "4", "-link-sampling",
               "-nmi", gt, "-seed", "3", "-max-iterations", "8",
               "-label", "nojax"])
    assert rc == 0
    for flags in ([], ["-batch", "-logl"]):
        rc = main(["-file", net, "-n", "200", "-k", "4", "-nmi", gt,
                   "-seed", "3", "-max-iterations", "4", "-label", "nojax",
                   "-checkpoint-freq", "1e-9", *flags])
        assert rc == 0
    for flags in (["-preprocess"], ["-infset"],
                  ["-infset", "-fastqueue", "2"]):
        rc = main(["-file", net, "-n", "200", "-k", "4", "-nmi", gt,
                   "-seed", "3", "-max-iterations", "4", "-label",
                   "fastamm", *flags])
        assert rc == 0
    for label, flags in (("findk", ["-findk"]), ("sbm", ["-single"]),
                         ("sbmi", ["-single", "-infset"]),
                         ("orig", ["-orig"]),
                         ("origl", ["-orig", "-logl"])):
        rc = main(["-file", net, "-n", "200", "-k", "4", "-nmi", gt,
                   "-seed", "3", "-max-iterations", "4", "-label", label,
                   *flags])
        assert rc == 0
    for flags in (["-gen"], ["-gen", "-orig"]):
        assert main(["-n", "200", "-k", "4", "-seed", "3", *flags]) == 0
    # the model-reading entries on a small graph of their own (-ppc draws
    # 100 networks), its gamma.txt cut from the -orig run's
    import os
    os.mkdir("model")
    os.chdir("model")
    small, _ = write_planted(".", 40, 4, 6, 5)
    with open("../n200-k4-orig-seed3-orig/gamma.txt") as src, \
            open("gamma.txt", "w") as f:
        f.writelines(line for line in src if int(line.split()[0]) < 40)
    with open("lambda.txt", "w") as f:
        for k in range(4):
            f.write(str(k) + "\\t1.00000\\t9.00000\\n")
    for flag in ("-gml", "-lcstats", "-ppc"):
        rc = main(["-file", small, "-n", "40", "-k", "4", "-seed", "3",
                   flag])
        assert rc == 0
    os.chdir("..")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                    ("jax", "jaxlib", "svinet_tpu"))
    assert not loaded, loaded
    print("OK")
""")


def test_cli_runs_with_jax_blocked(tmp_path):
    env = dict(os.environ, SVINET_TORCH_DEVICE="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", f"REPO = {str(REPO)!r}\n" + _BLOCKED_RUN],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")
    out = tmp_path / "n200-k4-nojax-seed3-linksampling"
    assert (out / "gamma.txt").exists() and (out / "mutual.txt").exists()
    mmsb = [p for p in tmp_path.iterdir()
            if p.name.startswith("n200-k4-nojax-")
            and not p.name.endswith("linksampling")]
    assert len(mmsb) == 2
    for out in mmsb:
        assert (out / "gamma.txt").exists()
        assert (out / "modularity.txt").exists()
        assert (out / "ckpt" / "latest").exists()
    out = tmp_path / "n200-k4-fastamm-seed3-infset"
    for name in ("neighbors.bin", "gamma.txt", "cmap.txt", "heldout.txt"):
        assert (out / name).exists(), name
    for label, names in (("findk", ("communities.txt", "groups.txt")),
                         ("sbm", ("gamma.txt", "lambda.txt")),
                         ("sbmi", ("gamma.txt", "neighbors.bin")),
                         ("orig", ("gamma.txt", "beta.txt")),
                         ("origl", ("logl.txt", "beta.txt"))):
        out = [p for p in tmp_path.iterdir()
               if p.name.startswith(f"n200-k4-{label}-seed3")]
        assert len(out) == 1, out
        for name in names:
            assert (out[0] / name).exists(), (label, name)
    assert (tmp_path / "n200-k4-origl-seed3-orig" / "logl.txt").read_text()
    # -gen and -gen -orig write one directory; the second run adds the
    # full blockmodel's beta matrix
    gen = [p for p in tmp_path.iterdir() if p.name.startswith("gen-")]
    assert len(gen) == 1, gen
    for name in ("network_gen.dat", "pi-gen.txt", "beta-gen-matrix.txt"):
        assert (gen[0] / name).exists(), name
    for name in ("network.gml", "community_stats.txt"):
        assert (tmp_path / "model" / "gml" / name).exists(), name
    assert len(os.listdir(tmp_path / "model" / "ppc")) == 7


# Installed as sitecustomize.py for a subprocess and every rank it spawns:
# an import of jax or of the JAX package fails, and leaves a mark.
_SITE_BLOCKER = textwrap.dedent("""
    import os
    import sys

    class BlockJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "svinet_tpu"):
                marks = os.environ["NOJAX_MARKS"]
                with open(os.path.join(marks, str(os.getpid())), "a") as f:
                    f.write(name + "\\n")
                raise ImportError(name + " is blocked")
            return None

    sys.meta_path.insert(0, BlockJax())
""")


@pytest.mark.parametrize("flags", [
    ["-link-sampling", "-max-iterations", "6"],
    ["-rnode", "-max-iterations", "4"],
    ["-link-sampling", "-mesh-locality", "-max-iterations", "6"],
    ["-stratified", "-rnode", "-max-iterations", "20", "-rfreq", "10"],
], ids=["link-sampling", "rnode", "locality", "fastamm2"])
def test_mesh_ranks_run_with_jax_blocked(tmp_path, flags):
    """`-mesh 2` with jax and svinet_tpu blocked in the CLI's process and
    in both ranks it spawns (the blocker is the interpreter's
    sitecustomize, which the spawned ranks run too): link sampling, its
    locality layout, MMSBInfer and FastAMM2."""
    site, marks = tmp_path / "site", tmp_path / "marks"
    site.mkdir()
    marks.mkdir()
    (site / "sitecustomize.py").write_text(_SITE_BLOCKER)
    env = dict(os.environ, SVINET_TORCH_DEVICE="cpu", NOJAX_MARKS=str(marks),
               PYTHONPATH=os.pathsep.join([str(site), str(REPO)]))
    code = ("import sys\n"
            "from svinet_torch.synth import write_planted\n"
            "from svinet_torch.cli import main\n"
            "net, gt = write_planted('.', 200, 4, 12, 5)\n"
            "rc = main(['-file', net, '-n', '200', '-k', '4', '-nmi', gt,\n"
            "           '-seed', '3', '-label', 'mesh', '-mesh', '2',\n"
            f"           *{flags!r}])\n"
            "assert rc == 0 and 'jax' not in sys.modules\n"
            "print('OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")
    assert not list(marks.iterdir()), [p.read_text() for p in marks.iterdir()]
    out = [p for p in tmp_path.iterdir() if p.name.startswith("n200-k4-mesh")]
    assert len(out) == 1 and (out[0] / "gamma.txt").exists()


def test_dist_processes_run_with_jax_blocked(tmp_path):
    """Two -dist-nprocs processes of `-mesh 2 -mesh-locality`, one rank
    each, meeting at a TCP rendezvous on 127.0.0.1, with jax and
    svinet_tpu blocked in both processes and their ranks; FastAMM2 runs
    alone with them blocked too."""
    import socket
    site, marks = tmp_path / "site", tmp_path / "marks"
    site.mkdir()
    marks.mkdir()
    (site / "sitecustomize.py").write_text(_SITE_BLOCKER)
    env = dict(os.environ, SVINET_TORCH_DEVICE="cpu", NOJAX_MARKS=str(marks),
               PYTHONPATH=os.pathsep.join([str(site), str(REPO)]))
    subprocess.run([sys.executable, "-c",
                    "from svinet_torch.synth import write_planted\n"
                    "write_planted('.', 200, 4, 12, 5)"],
                   cwd=tmp_path, env=env, check=True, timeout=120)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = [sys.executable, "-m", "svinet_torch", "-file",
            "planted-n200-k4.txt", "-n", "200", "-k", "4", "-seed", "3"]
    procs = [subprocess.Popen(
        [*base, "-label", "dist", "-link-sampling", "-mesh", "2",
         "-mesh-locality", "-max-iterations", "6", "-dist-coordinator",
         f"127.0.0.1:{port}", "-dist-nprocs", "2", "-dist-procid", str(i)],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in (0, 1)]
    procs.append(subprocess.Popen(
        [*base, "-label", "fa", "-stratified", "-rnode", "-max-iterations",
         "20", "-rfreq", "10"], cwd=tmp_path, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, out + err
    assert not list(marks.iterdir()), [p.read_text() for p in marks.iterdir()]
    out = [p for p in tmp_path.iterdir() if p.name.startswith("n200-k4-dist")]
    assert len(out) == 1 and (out[0] / "gamma.txt").exists()
    assert (out[0] / "proc1" / "heldout.txt").exists()
    fa = [p for p in tmp_path.iterdir() if p.name.startswith("n200-k4-fa")]
    assert len(fa) == 1 and (fa[0] / "precision.txt").exists()


@pytest.mark.parametrize("flags", [[], ["-mesh", "2"]], ids=["one", "mesh2"])
def test_sigterm_during_setup_exits_0(tmp_path, flags):
    """A SIGTERM that arrives before the engine exists ends the CLI with
    status 0, as svinet_tpu/cli.py:343-353 does: the handler is in place
    before the network is read; under -mesh 2 the launcher ends its ranks
    and exits 0. The input is a FIFO (read through the Python reader,
    -strid), so the CLI (or a rank) is held inside Network.read until the
    signal comes."""
    fifo = tmp_path / "net.fifo"
    os.mkfifo(fifo)
    env = dict(os.environ, SVINET_TORCH_DEVICE="cpu",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "svinet_torch", "-file", str(fifo), "-n",
         "10", "-k", "2", "-link-sampling", "-strid", "-label", "term",
         *flags],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    deadline = time.time() + 120
    fd = None
    while fd is None:
        # opening the write end succeeds once the CLI has opened the read
        # end, that is once it is inside Network.read
        try:
            fd = os.open(fifo, os.O_WRONLY | os.O_NONBLOCK)
        except OSError:
            assert proc.poll() is None, proc.communicate()
            assert time.time() < deadline, "the CLI never opened its input"
            time.sleep(0.02)
    try:
        os.write(fd, b"a\tb\n")
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        os.close(fd)
    assert proc.returncode == 0, (proc.returncode, out, err)
    assert "+ network:" not in out


def test_no_jax_import_in_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|svinet_tpu)\b", re.M)
    files = sorted((REPO / "svinet_torch").rglob("*.py"))
    assert files
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders


def test_chip_smoke_imports_only_the_port():
    """The smoke run imports the port, and neither JAX nor the JAX
    package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|svinet_tpu)\b", re.M)
    text = (REPO / "chip_smoke.py").read_text()
    assert not pat.findall(text), pat.findall(text)
    assert re.search(r"^\s*from\s+svinet_torch", text, re.M)


def test_cuda_without_a_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svinet_torch.resolve_device("cuda")
    monkeypatch.setenv(svinet_torch.DEVICE_ENV, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svinet_torch.resolve_device()
    with pytest.raises(ValueError):
        svinet_torch.resolve_device("meta")


@pytest.mark.parametrize("flags,named", [
    (["-link-sampling", "-mesh-rowshard", "-orig"], "-orig"),
    (["-link-sampling", "-dist-coordinator", "host:1", "-gen"], "-gen"),
    (["-link-sampling", "-sparse-w", "8", "-resume", "-orig"], "-orig"),
    (["-link-sampling", "-bf16", "-freeze", "-prune", "-sparse-w", "8",
      "-checkpoint-freq", "5", "-ppc"], "-ppc"),
    (["-link-sampling", "-mesh-locality", "-lcstats"], "-lcstats"),
    (["-link-sampling", "-dist-procid", "1", "-gml"], "-gml"),
    (["-mesh", "2", "-dist-nprocs", "2", "-infset", "-findk", "-gml"],
     "-gml"),
    (["-infset", "-single", "-lcstats"], "-lcstats"),
    (["-checkpoint-freq", "5", "-mesh-locality", "-single", "-orig"],
     "-orig"),
    (["-rnode", "-resume", "-infset", "-fastqueue", "4", "-orig"],
     "-orig"),
    (["-link-sampling", "-init-communities", "c.txt", "-mesh", "2",
      "-orig"], "-orig"),
    (["-stratified", "-rnode", "-findk", "-ppc"], "-ppc"),
    (["-stratified", "-rnode", "-single", "-orig"], "-orig"),
    (["-single", "-gen"], "-gen"),
    (["-link-sampling", "-orig"], "-orig"),
    (["-stratified", "-rnode", "-mesh", "2", "-gen"], "-gen"),
    (["-findk", "-gml"], "-gml"),
    (["-single", "-infset", "-ppc"], "-ppc"),
])
def test_cli_dispatches_as_the_original(flags, named, tmp_path,
                                        monkeypatch):
    """Each engine flag set through both CLIs with every engine and the
    generator stubbed: the port builds the engine (or runs the generator
    entry) that svinet_tpu/cli.py builds, or stops with its message, and
    runs it in one process as the JAX CLI does: the generator family and
    -orig never read -mesh, and win over -link-sampling. `named` is the
    flag that decides the dispatch."""
    import importlib
    import svinet_tpu.parallel.mesh as jmesh
    from svinet_tpu.cli import main as jax_main
    from svinet_torch.parallel import mesh
    from svinet_torch.synth import write_planted
    calls = []

    def stub(name):
        class Stub:
            def __init__(self, *args, **kwargs):
                self.terminate_requested = False

            def __getattr__(self, method):
                if method.startswith("__"):
                    raise AttributeError(method)
                return lambda *a, **kw: calls.append((name, method))

            def close(self):
                pass

        Stub.__name__ = name
        return Stub

    for pkg in ("svinet_tpu", "svinet_torch"):
        for mod, name in (("gen", "MMSBGen"), ("orig", "MMSBOrig"),
                          ("fastinit", "FastInit"),
                          ("linksampling", "LinkSampling"), ("sbm", "SBM"),
                          ("mmsb", "MMSBInfer"), ("fastamm", "FastAMM"),
                          ("fastamm2", "FastAMM2")):
            m = importlib.import_module(f"{pkg}.svi.{mod}")
            monkeypatch.setattr(m, name, stub(name))
    def bring_up(coordinator, nprocs, procid):
        # jax.distributed.initialize is not brought up here; without a
        # coordinator address it refuses, as the port's CLI does
        if not coordinator:
            raise ValueError("coordinator_address should be defined")

    monkeypatch.setattr(jmesh, "init_distributed", bring_up)
    launched = []
    monkeypatch.setattr(mesh, "launch",
                        lambda *a, **kw: launched.append(a) or 0)
    monkeypatch.setenv(svinet_torch.DEVICE_ENV, "cpu")
    monkeypatch.chdir(tmp_path)
    net, _ = write_planted(str(tmp_path), 40, 2, 6, 1)
    argv = ["-file", net, "-n", "40", "-k", "2", *flags]
    picked = []
    for run in (jax_main, main):
        calls.clear()
        try:
            run(list(argv))
            picked.append(list(calls))
        except (SystemExit, ValueError) as e:
            # a refusal before any engine is built
            picked.append(("refused", str(e)))
    assert not launched, flags
    if isinstance(picked[0], tuple):
        assert isinstance(picked[1], tuple), (flags, picked)
        if "-mesh-locality" in flags:
            assert picked[1] == picked[0], (flags, picked)
        else:
            assert "-dist-coordinator" in picked[1][1], picked
    else:
        assert picked[1] == picked[0], (flags, picked)
        entry = {"-orig": ("MMSBOrig", "batch_infer"),
                 "-gen": ("MMSBGen", "gen"), "-ppc": ("MMSBGen", "ppc"),
                 "-lcstats": ("MMSBGen", "get_lc_stats"),
                 "-gml": ("MMSBGen", "gml")}[named]
        assert picked[0] == [entry], (flags, picked)


@pytest.mark.parametrize("flags", [
    [], ["-rpair"], ["-rnode"], ["-stratified", "-rpair"], ["-batch"],
    ["-logl"], ["-batch", "-logl"], ["-rnode", "-nonuniform", "-inf", "0.1"],
    ["-link-sampling", "-checkpoint-freq", "5"],
    ["-link-sampling", "-resume"], ["-rnode", "-resume"],
    ["-link-sampling", "-batch"], ["-infset"],
    ["-infset", "-fastqueue", "4", "-resume"],
    ["-infset", "-mesh", "2", "-checkpoint-freq", "5"],
    ["-findk"], ["-findk", "-findk-width", "130", "-resume"],
    ["-findk", "-orig"], ["-findk", "-link-sampling", "-mesh", "2"],
    ["-single"], ["-single", "-infset", "-checkpoint-freq", "5"],
    ["-single", "-batch", "-mesh", "2"], ["-single", "-link-sampling"],
])
def test_cli_takes_mmsb_and_checkpoint_flags(flags, monkeypatch):
    """MMSBInfer's modes, FastAMM's (-infset, -fastqueue), FastInit's
    (-findk, which dispatches before -orig) and SBM's (-single, batch and
    -infset), -checkpoint-freq and -resume parse, and the run fails on
    the missing input file."""
    from svinet_torch.cli import parse_args
    argv = ["-file", "absent.txt", "-n", "10", "-k", "2", *flags]
    parse_args(argv)
    monkeypatch.setenv(svinet_torch.DEVICE_ENV, "cpu")
    with pytest.raises(OSError):
        main(argv)


@pytest.mark.parametrize("flags", [
    ["-bf16"], ["-freeze"], ["-prune"], ["-prune", "-prune-frac", "0.25"],
    ["-bf16", "-freeze", "-prune", "-fuse-s3", "-report-batch", "4"],
    ["-sparse-w", "8"], ["-sparse-w", "8", "-bf16", "-report-batch", "4"],
    ["-init-communities", "c.txt"], ["-load-test-sets"], ["-profile", "p"],
    ["-preprocess"],
])
def test_cli_takes_the_ported_sweep_flags(flags, monkeypatch):
    """-bf16, -freeze, -prune, -sparse-w, -init-communities,
    -load-test-sets, -profile and -preprocess parse, alone and together
    with the flags ported before them; the run then fails on the missing
    input file."""
    from svinet_torch.cli import parse_args
    argv = ["-file", "absent.txt", "-n", "10", "-k", "2", "-link-sampling",
            *flags]
    parse_args(argv)
    monkeypatch.setenv(svinet_torch.DEVICE_ENV, "cpu")
    with pytest.raises(OSError):
        main(argv)
