"""-dist-coordinator/-dist-nprocs/-dist-procid in the port: P processes,
each starting its share of the -mesh N ranks, meet at a TCP rendezvous
on 127.0.0.1 (parallel/mesh.py: Dist, launch). Two processes of one gloo
rank each must write the files of the one-process `-mesh 2` run bit for
bit (wall-time columns aside), process 1 under <outdir>/proc1, as the
JAX CLI lays them out (svinet_tpu/cli.py:287-307)."""

import os
import pathlib
import socket
import subprocess
import sys

import pytest

from svinet_torch.cli import main as torch_main, parse_args
from svinet_torch.parallel import mesh
from svinet_torch.synth import write_planted

REPO = pathlib.Path(__file__).resolve().parents[1]
# files whose values are wall time, or whose rows carry it (column 2)
_TIMED = {"infer.log", "time.txt", "mrstats.txt", "ckpt", "proc1"}
_DURATION_COL = {"heldout.txt", "validation.txt", "training.txt",
                 "stats.txt", "max.txt", "convergence.txt",
                 "modularity.txt", "logl.txt", "precision.txt"}


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    d = tmp_path_factory.mktemp("planted")
    return write_planted(str(d), 400, 4, 16, 2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _strip(path, name):
    lines = open(path / name).read().splitlines()
    if name in _DURATION_COL:
        return [l.split("\t", 2)[0] + "\t" + l.split("\t", 2)[2]
                for l in lines]
    if name == "convergence_hosts.txt":
        # its last column is seconds
        return [l.rsplit("\t", 1)[0] for l in lines]
    return lines


def _outdir(cwd, label):
    out = [p for p in cwd.iterdir() if p.name.startswith(f"n400-k4-{label}")]
    assert len(out) == 1, out
    return out[0]


@pytest.mark.parametrize("flags", [
    ["-link-sampling", "-max-iterations", "40"],
    ["-link-sampling", "-mesh-locality", "-max-iterations", "40"],
    ["-stratified", "-rnode", "-max-iterations", "200", "-rfreq", "50"],
], ids=["link-sampling", "locality", "fastamm2"])
def test_two_processes_write_the_one_process_files(planted, tmp_path,
                                                   monkeypatch, flags):
    net, gt = planted
    base = ["-file", net, "-n", "400", "-k", "4", "-nmi", gt, "-seed", "1",
            "-label", "d", "-mesh", "2", *flags]
    env = dict(os.environ, SVINET_TORCH_DEVICE="cpu",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    two = tmp_path / "two"
    two.mkdir()
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "svinet_torch", *base, "-dist-coordinator",
         f"127.0.0.1:{port}", "-dist-nprocs", "2", "-dist-procid", str(i)],
        cwd=two, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in (0, 1)]
    for i, p in enumerate(procs):
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, (i, out, err)
        assert f"+ distributed: process {i} of 2" in out
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    one = tmp_path / "one"
    one.mkdir()
    monkeypatch.chdir(one)
    assert torch_main(base) == 0
    a, b = _outdir(two, "d"), _outdir(one, "d")
    assert (a / "proc1").is_dir() and (a / "proc1" / "heldout.txt").exists()
    assert not (b / "proc1").exists()
    names = sorted(set(os.listdir(a)) - _TIMED)
    assert names == sorted(set(os.listdir(b)) - _TIMED)
    for name in names:
        assert _strip(a, name) == _strip(b, name), name
    # process 1's lead rank wrote its report rows: rank 0's
    assert _strip(a / "proc1", "heldout.txt") == _strip(a, "heldout.txt")


def test_a_process_without_a_mesh_runs_alone(planted, tmp_path, monkeypatch):
    """Without -mesh each process runs the whole single-device engine, as
    each process of the JAX CLI does; process 1 writes under proc1."""
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    net, gt = planted
    argv = ["-file", net, "-n", "400", "-k", "4", "-nmi", gt, "-seed", "1",
            "-label", "alone", "-link-sampling", "-max-iterations", "10"]
    assert torch_main([*argv, "-dist-coordinator", "127.0.0.1:1",
                       "-dist-nprocs", "2", "-dist-procid", "1"]) == 0
    out = _outdir(tmp_path, "alone")
    assert sorted(os.listdir(out)) == ["proc1"]
    assert (out / "proc1" / "gamma.txt").exists()


def _cfg(*flags):
    return parse_args(["-file", "absent.txt", "-n", "10", "-k", "2",
                       "-link-sampling", *flags])


@pytest.mark.parametrize("nprocs", ["0", "1"])
def test_one_process_is_no_dist(nprocs):
    """-dist-nprocs 1 (or less) is one process, as svinet_tpu/cli.py:287
    takes it: no rendezvous, no proc<i> directory."""
    assert mesh.Dist.of(_cfg("-dist-nprocs", nprocs, "-dist-procid", "0",
                             "-dist-coordinator", "h:1")) is None


@pytest.mark.parametrize("nd,procid,want", [
    (2, 0, [0]), (2, 1, [1]), (4, 0, [0, 1]), (4, 1, [2, 3]),
])
def test_each_process_starts_its_share_of_the_ranks(nd, procid, want):
    d = mesh.Dist.of(_cfg("-dist-nprocs", "2", "-dist-procid", str(procid),
                          "-dist-coordinator", "127.0.0.1:9"))
    assert list(d.ranks(nd)) == want
    assert d.outdir("out") == ("out" if procid == 0
                               else os.path.join("out", "proc1"))


@pytest.mark.parametrize("flags,message", [
    (["-dist-nprocs", "2", "-dist-procid", "2", "-dist-coordinator", "h:1"],
     "-dist-procid 2 is not a process of -dist-nprocs 2"),
    (["-dist-nprocs", "2", "-dist-procid", "1"],
     "-dist-nprocs needs -dist-coordinator"),
    (["-dist-nprocs", "2", "-dist-procid", "0", "-dist-coordinator", "h:1",
      "-mesh", "3"], "-mesh 3 does not split into -dist-nprocs 2"),
], ids=["procid", "coordinator", "uneven"])
def test_dist_flags_that_cannot_run(flags, message, monkeypatch):
    monkeypatch.setenv("SVINET_TORCH_DEVICE", "cpu")
    with pytest.raises(SystemExit, match=message):
        torch_main(["-file", "absent.txt", "-n", "10", "-k", "2",
                    "-link-sampling", *flags])
