"""Build and load the package's CUDA kernels (svinet_torch/csrc/*.cu).

The sources have a plain C interface. Each is compiled by its own nvcc,
all started together, and the objects are linked into one shared library,
loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c csrc/<name>.cu -o <name>.o      (in parallel)
    nvcc -shared -o build/svinet_torch/libsvinet_torch_<hash>.so *.o

The library is built on first use into build/svinet_torch/ at the root
of the checkout and rebuilt whenever a hash of the sources and flags
changes. No --use_fast_math: it would change the precision of logf, expf
and division everywhere; the one place that wants an approximate
reciprocal asks for it by name (csrc/dirichlet_expectation.cu).

Every C entry point returns cudaGetLastError() after its launch; `call`
raises when that is not cudaSuccess. Pointers and the stream are passed
as c_void_p (ctypes would otherwise cut them to 32-bit ints).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "svinet_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_F32 = ctypes.c_float
# rows of the (rows, K) scratch a kernel that sums columns across rows is
# given: twice csrc/common.cuh's kReduceBlocks (two sums, or the pass over
# nodes and the pass over hub segments)
REDUCE_SCRATCH_ROWS = 2 * 1056
# entry point -> argument types (pointers, sizes, then the stream)
SIGNATURES = {
    "svt_dirichlet_expectation": (_P, _P, _I64, _I32, _P),
    # elogpi, elb0, the seven adjacency arrays, partial, gacc, n, n_hubs,
    # n_segs, k, seg_len
    "svt_phi_pass": (_P,) * 11 + (_I64, _I64, _I64, _I32, _I32, _P),
    # gacc, deg, sumk, mphi, partial, s12, n, k, alpha, n_nodes, ones,
    # annealing
    "svt_mean_indicator": (_P,) * 6 + (_I64, _I32, _F32, _F32, _F32, _I32,
                                       _P),
    # mphi, rowptr, nbr, seg_node, seg_begin, seg_end, partial, s3, n,
    # n_segs, k, seg_len
    "svt_s3_pass": (_P,) * 8 + (_I64, _I64, _I32, _I32, _P),
    # elogpi, mphi, elb0, the seven adjacency arrays, partial, gacc,
    # s3_partial, s3, n, n_hubs, n_segs, k, seg_len
    "svt_phi_s3_pass": (_P,) * 14 + (_I64, _I64, _I64, _I32, _I32, _P),
}

_lock = threading.Lock()


def sources() -> list:
    """The library's translation units; headers (*.cuh) are only hashed."""
    return sorted(CSRC.glob("*.cu"))


def source_hash(srcs) -> str:
    """Hash of the flags, the given sources and every header."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted([*srcs, *CSRC.glob("*.cuh")]):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [shutil.which("nvcc")]
    cands += [os.path.join(home, "bin", "nvcc")] if home else []
    cands += ["/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


class Library:
    """A loaded kernel library and what its build printed."""

    def __init__(self, path: Path, signatures: dict, build_seconds: float,
                 log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        self._dll = ctypes.CDLL(str(path))
        for name, argtypes in signatures.items():
            fn = getattr(self._dll, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        self._dll.svt_error_string.argtypes = [ctypes.c_int]
        self._dll.svt_error_string.restype = ctypes.c_char_p

    def call(self, name: str, *args) -> None:
        """Launch entry point `name`; raise if the launch was refused."""
        rc = getattr(self._dll, name)(*args)
        if rc != 0:
            msg = self._dll.svt_error_string(rc).decode()
            raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build_library(stem: str, srcs, signatures: dict) -> Library:
    """Compile `srcs` (one nvcc each, started together), link them into
    build/svinet_torch/lib<stem>_<hash>.so unless it is there already,
    and load it with the given entry-point signatures."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path = BUILD_DIR / f"lib{stem}_{source_hash(srcs)}.so"
        if path.exists():
            return Library(path, signatures, 0.0, "")
        t0 = time.perf_counter()
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [os.path.join(tmp, f"{src.stem}.o") for src in srcs]
            with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
                logs = list(pool.map(
                    lambda so: _run([nvcc, *NVCC_FLAGS, "-c", str(so[0]),
                                     "-o", so[1]]), zip(srcs, objs)))
            out = os.path.join(tmp, "lib.so")
            logs.append(_run([nvcc, "-shared", "-o", out, *objs]))
            os.replace(out, path)
        return Library(path, signatures, time.perf_counter() - t0,
                       "".join(logs))


@functools.cache
def library() -> Library:
    """Build (when the sources changed) and load the kernel library."""
    return build_library("svinet_torch", sources(), SIGNATURES)


def check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype,
               shape: tuple, device: torch.device) -> None:
    """Refuse what the kernels do not take: they read dense row-major
    buffers of one dtype on the launching device."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(name: str, device: torch.device, *args) -> None:
    """Launch entry point `name` on `device`, on PyTorch's current stream
    there (passed last). The device guard makes `device` current for the
    launch and restores PyTorch's current device after it."""
    with torch.cuda.device(device):
        library().call(name, *args,
                       torch.cuda.current_stream(device).cuda_stream)


def require_cuda(t: torch.Tensor, what: str) -> None:
    """Wrappers take the plain path only for CPU tensors; anything that is
    neither CPU nor CUDA is refused."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {t.device}; the kernel runs "
                         f"on cuda and the plain version on cpu")
