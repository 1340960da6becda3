"""Build and load the package's CUDA kernels (svinet_torch/csrc/*.cu).

The sources have a plain C interface (kernels 2 and 5 are templates in
csrc/phi_pull.cuh, instantiated for f32 rows by phi_pass.cu and for bf16
rows by phi_pass_bf16.cu). Each is compiled by its own nvcc,
all started together, and the objects are linked into one shared library,
loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c csrc/<name>.cu -o <name>.o      (in parallel)
    nvcc -shared -o build/svinet_torch/libsvinet_torch_<hash>.so *.o

The library is built on first use into build/svinet_torch/ at the root
of the checkout and rebuilt whenever a hash of the sources and flags
changes. No --use_fast_math: it would change the precision of logf, expf
and division everywhere; the places that want an approximate reciprocal
(csrc/dirichlet_expectation.cu) or exponential (kernel 2 over bf16 rows,
csrc/phi_pull.cuh) ask for it by name.

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
from typing import Optional

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
_PHI = (_P,) * 14 + (_I64, _I64, _I64, _I32, _I32, _P)
_PHI_S3 = (_P,) * 16 + (_I64, _I64, _I64, _I32, _I32, _P)
# entry point -> argument types (pointers, sizes, then the stream)
SIGNATURES = {
    # x, out, rows, k, rest, whether out is bf16
    "svt_dirichlet_expectation": (_P, _P, _I64, _I32, _F32, _I32, _P),
    # x, pairs (rows, k, 2), ids, topvals, topm, rows, k, w
    "svt_dirichlet_topw": (_P, _P, _P, _P, _P, _I64, _I32, _I32, _P),
    # elogpi, elb0, conv, the seven adjacency arrays, partial, gacc,
    # sumk_partial, sumk, n, n_hubs, n_segs, k, seg_len; the second over
    # bf16 rows
    "svt_phi_pass": _PHI,
    "svt_phi_pass_bf16": _PHI,
    # gacc, deg, sumk, mphi, its element stride, mphi_bf16, partial, s12,
    # conv_prev, conv_out, count_first, n, k, alpha, n_nodes, ones,
    # annealing
    "svt_mean_indicator": (_P,) * 4 + (_I32,) + (_P,) * 6 + (
        _I64, _I32, _F32, _F32, _F32, _I32, _P),
    # mphi, whether it is bf16, conv, rowptr, nbr, seg_node, seg_begin,
    # seg_end, partial, s3, n, n_segs, k, seg_len
    "svt_s3_pass": (_P, _I32) + (_P,) * 8 + (_I64, _I64, _I32, _I32, _P),
    # gamma, beta, pairs, y, w, partial, out, pairs, k, 1 - epsilon
    "svt_heldout_sums": (_P,) * 7 + (_I64, _I32, _F32, _P),
    # elogpi, mphi, elb0, the seven adjacency arrays, partial, gacc,
    # sumk_partial, sumk, s3_partial, s3, n, n_hubs, n_segs, k, seg_len; the
    # second over bf16 rows
    "svt_phi_s3_pass": _PHI_S3,
    "svt_phi_s3_pass_bf16": _PHI_S3,
    # rows (Elogpi and mphi side by side), ids, topvals, topm, elb0, the
    # seven adjacency arrays, seg_rows, partial, gacc, sumk, s3, n, n_hubs,
    # n_segs, k, w, seg_len
    "svt_sparse_union": (_P,) * 17 + (_I64, _I64, _I64, _I32, _I32, _I32,
                                      _P),
    # k, w, info (3 ints out): no launch, no stream
    "svt_sparse_union_info": (_I32, _I32, _P),
    # elogpi, fr, pairs, y, w, staged, rounds, lam, rows, partial, sums,
    # masks, stop, block_rounds, terms, the seven endpoint-CSR arrays,
    # seg_partial, gamma, gscale, rho, out, n, pairs, n_hubs, n_segs, k,
    # seg_len, max_iters, log_eps, thresh, alpha, mode, elbo, blocks, block
    "svt_phi_fixed_point": (_P,) * 27 + (_I64, _I64, _I64, _I64, _I32, _I32,
                                         _I32, _F32, _F32, _F32, _I32, _I32,
                                         _I32, _I32, _P),
    # k, elbo, pairs, info (7 ints out): no launch, no stream
    "svt_phi_fixed_point_plan": (_I32, _I32, _I64, _P),
    # elogpi, elb0, edges, rowptr, nbr, seg_node, seg_begin, seg_end,
    # argmax, maxval, n, n_segs, k, seg_len
    "svt_edge_assign": (_P,) * 10 + (_I64, _I64, _I32, _I32, _P),
    # ids, vals, rest, elogbeta, pairs, y, w, the seven endpoint-CSR
    # arrays, work, its floats, gacc, lam_sums, rounds, pairs, rows,
    # n_hubs, n_segs, k, w, seg_len, max_iters, log_eps, thresh, block
    "svt_sparse_fastamm": (_P,) * 15 + (_I64,) + (_P,) * 3 + (_I64,) * 4 + (
        _I32,) * 4 + (_F32, _F32, _I32, _P),
    # w, the workspace's floats on this card and where the regions sit (2
    # int64 out): no launch, no stream
    "svt_sparse_fastamm_scratch": (_I32, _P),
    # ids, vals, rest, table, pairs, out0, out1, cid, node, wide scratch,
    # n, pairs, k, w, form
    "svt_sparse_scores": (_P,) * 10 + (_I64, _I64, _I32, _I32, _I32, _P),
    "svt_sparse_scores_scratch": (_I32, _P),
    # labels, rowptr, nbr, hub_node, hub_off, lab_scratch, key_scratch,
    # ids, cnt, n, n_hubs, width
    "svt_fastinit_vote": (_P,) * 9 + (_I64, _I64, _I32, _P),
    # ids, pi, pairs, ssum, maxv, maxid, pairs, n, w, table scratch
    "svt_fastinit_overlap": (_P,) * 6 + (_I64, _I64, _I32, _P, _P),
    # w, the table scratch's ints (1 int64 out): no launch, no stream
    "svt_fastinit_overlap_scratch": (_I32, _P),
    # phi, scratch, ticket, partial, tot, n, k, n_chunks
    "svt_sbm_chunk_sums": (_P,) * 5 + (_I64, _I32, _I32, _P),
    # src, dst, elogpi, da, db, rowptr, nbr, held rowptr, held nbr,
    # change, scratch, ticket, partial, tot, n, k, chunk, n_chunks
    "svt_sbm_estep_chunk": (_P,) * 14 + (_I64, _I32, _I32, _I32, _P),
    # k, the scratch's floats (1 int64 out): no launch, no stream
    "svt_sbm_estep_scratch": (_I32, _P),
    # elogpi, lt, pairs, y, elogpi_e, lte, phi, block_rounds, terms,
    # rowptr, nbr, gacc, n, pairs, k, kp (L's padded row), max_iters,
    # thresh, block, pad, elbo
    "svt_orig_fixed_point": (_P,) * 12 + (_I64, _I64, _I32, _I32, _I32,
                                          _F32, _I32, _I32, _I32, _P),
    # k, info (4 ints out): no launch, no stream
    "svt_orig_layout": (_I32, _P),
    # logits, beta, table, counts, offsets, edges, stats, n, k, row0,
    # row1, row_block, words, eps, umax, key (two words), write
    "svt_gen_pairs": (_P,) * 7 + (_I64, _I32, _I64, _I64, _I64, _I64, _F32,
                                  _F32, _I64, _I64, _I32, _P),
    # out, total, key (two words)
    "svt_threefry_uniform": (_P, _I64, _I64, _I64, _P),
}

_lock = threading.Lock()


def sources() -> list:
    """The library's translation units; headers (*.cuh) are only hashed."""
    return sorted(CSRC.glob("*.cu"))


def source_hash(srcs, flags=NVCC_FLAGS) -> str:
    """Hash of the flags, the given sources and every header."""
    h = hashlib.sha256(" ".join(flags).encode())
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


def build_library(stem: str, srcs, signatures: dict, defines=()) -> Library:
    """Compile `srcs` (one nvcc each, started together), link them into
    build/svinet_torch/lib<stem>_<hash>.so unless it is there already,
    and load it with the given entry-point signatures. `defines` are
    preprocessor names set for this library alone (-DNAME)."""
    flags = (*NVCC_FLAGS, *(f"-D{name}" for name in defines))
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path = BUILD_DIR / f"lib{stem}_{source_hash(srcs, flags)}.so"
        if path.exists():
            return Library(path, signatures, 0.0, "")
        t0 = time.perf_counter()
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [os.path.join(tmp, f"{src.stem}.o") for src in srcs]
            with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
                logs = list(pool.map(
                    lambda so: _run([nvcc, *flags, "-c", str(so[0]),
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
    there (passed last). Where `device` is not the current device, a
    device guard makes it current for the launch and restores PyTorch's
    current device after it."""
    if device.index is None or device.index == torch.cuda.current_device():
        library().call(name, *args,
                       torch.cuda.current_stream(device).cuda_stream)
        return
    with torch.cuda.device(device):
        library().call(name, *args,
                       torch.cuda.current_stream(device).cuda_stream)


def ask(name: str, device: torch.device, w: int, n: int = 1) -> tuple:
    """The n int64 answers of entry point `name`, a kernel's query at width
    w on `device` (no launch)."""
    out = (ctypes.c_int64 * n)()
    with torch.cuda.device(device):
        library().call(name, int(w), out)
    return tuple(out)


def scratch(name: str, w: int, device: torch.device,
            dtype: torch.dtype) -> Optional[torch.Tensor]:
    """The device scratch that entry point `name` (a kernel's scratch
    query) asks for at width w on `device`, by its kernel's own rule: None
    where the kernel needs none."""
    words = ask(name, device, w)[0]
    if words == 0:
        return None
    return torch.empty(words, dtype=dtype, device=device)


def count_launch(wrapper, form: str) -> None:
    """Count one launch of `wrapper`'s kernel, in all (`launches`) and by
    the form launched (`forms`: "f32", "bf16", "f32+conv", ...)."""
    wrapper.launches += 1
    wrapper.forms[form] = wrapper.forms.get(form, 0) + 1


def require_cuda(t: torch.Tensor, what: str) -> None:
    """Wrappers take the plain path only for CPU tensors; anything that is
    neither CPU nor CUDA is refused."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {t.device}; the kernel runs "
                         f"on cuda and the plain version on cpu")
