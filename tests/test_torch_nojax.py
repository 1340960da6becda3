"""The port runs without JAX and without the JAX package: the machine
with the GPU has no JAX, and the port imports nothing of svinet_tpu.

A subprocess blocks every `jax` and `svinet_tpu` import with a
sys.meta_path finder, imports svinet_torch and runs its CLI on a planted
graph on the CPU. The
CLI's refusals of flags outside the ported slice, and of a CUDA device on
a machine without one, are checked here too."""

import os
import pathlib
import re
import subprocess
import sys
import textwrap

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
    (["-link-sampling", "-mesh-rowshard"], "-mesh-rowshard"),
    (["-link-sampling", "-dist-coordinator", "host:1"], "-dist-coordinator"),
    (["-link-sampling", "-sparse-w", "8", "-resume", "-mesh", "2"],
     "-mesh"),
    (["-link-sampling", "-bf16", "-freeze", "-prune", "-sparse-w", "8",
      "-checkpoint-freq", "5", "-dist-nprocs", "2"], "-dist-nprocs"),
    (["-link-sampling", "-mesh-locality"], "-mesh-locality"),
    (["-link-sampling", "-dist-procid", "1"], "-dist-procid"),
    (["-link-sampling", "-mesh", "2"], "-mesh"),
    (["-link-sampling", "-dist-nprocs", "2"], "-dist-nprocs"),
    (["-checkpoint-freq", "5", "-mesh-rowshard"], "-mesh-rowshard"),
    (["-rnode", "-resume", "-dist-coordinator", "h:1"], "-dist-coordinator"),
    (["-link-sampling", "-init-communities", "c.txt", "-mesh", "2"],
     "-mesh"),
    (["-link-sampling", "-load-test-sets", "-dist-nprocs", "2"],
     "-dist-nprocs"),
    (["-link-sampling", "-profile", "p", "-mesh-rowshard"],
     "-mesh-rowshard"),
    (["-single"], "-single"),
    (["-link-sampling", "-findk"], "-findk"),
    (["-stratified", "-rnode"], "-stratified -rnode"),
])
def test_cli_refuses_flags_outside_the_slice(flags, named, monkeypatch):
    monkeypatch.setenv(svinet_torch.DEVICE_ENV, "cpu")
    with pytest.raises(SystemExit, match=re.escape(named)):
        main(["-file", "absent.txt", "-n", "10", "-k", "2", *flags])


@pytest.mark.parametrize("flags", [
    [], ["-rpair"], ["-rnode"], ["-stratified", "-rpair"], ["-batch"],
    ["-logl"], ["-batch", "-logl"], ["-rnode", "-nonuniform", "-inf", "0.1"],
    ["-link-sampling", "-checkpoint-freq", "5"],
    ["-link-sampling", "-resume"], ["-rnode", "-resume"],
    ["-link-sampling", "-batch"],
])
def test_cli_takes_mmsb_and_checkpoint_flags(flags, monkeypatch):
    """MMSBInfer's modes, -checkpoint-freq and -resume pass the slice
    check; the run then fails on the missing input file."""
    from svinet_torch.cli import check_slice, parse_args
    argv = ["-file", "absent.txt", "-n", "10", "-k", "2", *flags]
    check_slice(parse_args(argv))
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
    -load-test-sets, -profile and -preprocess pass the slice check, alone
    and together with the flags ported before them; the run then fails on
    the missing input file, not on a refusal."""
    from svinet_torch.cli import check_slice, parse_args
    argv = ["-file", "absent.txt", "-n", "10", "-k", "2", "-link-sampling",
            *flags]
    check_slice(parse_args(argv))
    monkeypatch.setenv(svinet_torch.DEVICE_ENV, "cpu")
    with pytest.raises(OSError):
        main(argv)
