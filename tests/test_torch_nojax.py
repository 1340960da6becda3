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
    (["-link-sampling", "-bf16"], "-bf16"),
    (["-link-sampling", "-freeze"], "-freeze"),
    (["-link-sampling", "-prune"], "-prune"),
    (["-link-sampling", "-sparse-w", "8"], "-sparse-w"),
    (["-link-sampling", "-mesh", "2"], "-mesh"),
    (["-link-sampling", "-dist-nprocs", "2"], "-dist-nprocs"),
    (["-link-sampling", "-checkpoint-freq", "5"], "-checkpoint-freq"),
    (["-link-sampling", "-resume"], "-resume"),
    (["-link-sampling", "-init-communities", "c.txt"], "-init-communities"),
    (["-link-sampling", "-load-test-sets"], "-load-test-sets"),
    (["-link-sampling", "-profile", "p"], "-profile"),
    (["-batch"], "-batch"),
    (["-link-sampling", "-findk"], "-findk"),
    ([], "-link-sampling"),
])
def test_cli_refuses_flags_outside_the_slice(flags, named, monkeypatch):
    monkeypatch.setenv(svinet_torch.DEVICE_ENV, "cpu")
    with pytest.raises(SystemExit, match=re.escape(named)):
        main(["-file", "absent.txt", "-n", "10", "-k", "2", *flags])
