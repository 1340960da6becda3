"""Time the present kernels beside their earlier and alternative designs,
in one process on one card.

    python -m svinet_torch.tools.bench_kernels [--quick] [--no-stretch]
                                               [--out DIR]

Kernel 1 (Dirichlet expectation): the present csrc/dirichlet_expectation.cu
against its first version (csrc/alt/dirichlet_v1.cu). Kernel 2 (phi pass):
the present pull kernel (csrc/phi_pass.cu) against the first version,
which pushes phi into both endpoint rows with atomics
(csrc/alt/phi_edge_atomic.cu), and against the half-push design
(csrc/alt/phi_half_push.cu), at n=20k, K=20 with 200k uniform random
links and at n=1M, K=500 with 2M and (unless --no-stretch) 20M. Every
design is first held to the plain PyTorch version, then the designs are
timed in turns (a, b, c, c, b, a) with CUDA events. --quick builds,
launches every kernel once at these widths, compares and stops.

Prints the card and its power limit first; writes the compiler's report
to DIR/ptxas.log and the results to DIR/bench_kernels.json (DIR defaults
to build/svinet_torch).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

from svinet_torch.kernels import build
from svinet_torch.ops.digamma import (
    dirichlet_expectation, dirichlet_expectation_plain)
from svinet_torch.ops.edges import (
    build_adjacency, choose_edge_block, pad_edges)
from svinet_torch.svi.sweep_math import phi_pass, phi_pass_pull_plain
from svinet_torch.synth import random_edges

_P, _I64, _I32 = build._P, build._I64, build._I32
ALT_SIGNATURES = {
    "svt_dirichlet_expectation_v1": (_P, _P, _I64, _I32, _P),
    "svt_phi_pass_edge_atomic": (_P, _P, _P, _P, _P, _I64, _I32, _P),
    "svt_phi_half_push": (_P, _P, _P, _P, _P, _I64, _I32, _P),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def alt_library() -> build.Library:
    srcs = sorted((build.CSRC / "alt").glob("*.cu")) + [
        build.CSRC / "runtime.cu"]
    return build.build_library("svinet_torch_alt", srcs, ALT_SIGNATURES)


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def timed(fns: dict, reps: int) -> dict:
    """Mean ms of each fn over reps launches, the fns taken in turns
    forwards then backwards so that none always runs on a warmer card."""
    names = list(fns)
    total = {name: 0.0 for name in names}
    for name in names:
        fns[name]()
    torch.cuda.synchronize()
    for order in (names, names[::-1]):
        for name in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fns[name]()
            end.record()
            torch.cuda.synchronize()
            total[name] += start.elapsed_time(end) / reps / 2
    return total


def bench_dirichlet(lib, alt, quick: bool) -> list:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows_out = []
    for rows, k in ((1_000_000, 500), (17_903, 20), (500, 2)):
        x = 0.01 + 9.99 * torch.rand((rows, k), generator=gen, device="cuda")
        out_v1 = torch.empty_like(x)

        def v1():
            alt.call("svt_dirichlet_expectation_v1", x.data_ptr(),
                     out_v1.data_ptr(), rows, k, stream())

        def present():
            # the entry point itself, as v1 is called: at the small shapes
            # the wrapper's checks and allocation cost more than the kernel
            lib.call("svt_dirichlet_expectation", x.data_ptr(),
                     out_v1.data_ptr(), rows, k, stream())

        v1()
        want = dirichlet_expectation_plain(x)
        got = dirichlet_expectation(x)
        torch.cuda.synchronize()
        errs = {"v1": float((out_v1 - want).abs().max()),
                "present": float((got - want).abs().max())}
        assert max(errs.values()) < 5e-5, errs
        row = {"kernel": "dirichlet_expectation", "shape": [rows, k],
               "max_abs_err_vs_plain": errs}
        if not quick:
            row["ms"] = timed({
                "v1": v1, "present": present,
                "present_wrapper": lambda: dirichlet_expectation(x),
                "plain": lambda: dirichlet_expectation_plain(x)},
                20 if rows * k >= 10**7 else 200)
        log(json.dumps(row))
        rows_out.append(row)
        del x, out_v1, want, got
    return rows_out


def forward_adjacency(links: np.ndarray, n: int):
    """CSR of the links p < q listed under p only (the half-push input)."""
    e = torch.as_tensor(links, device="cuda").long()
    key = torch.sort(e[:, 0] * n + e[:, 1]).values
    owner = key // n
    rowptr = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
    torch.cumsum(torch.bincount(owner, minlength=n), 0, out=rowptr[1:])
    return rowptr.to(torch.int32), (key - owner * n).to(torch.int32)


def bench_phi(alt, n: int, k: int, n_edges: int, quick: bool) -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    links = np.unique(random_edges(n, n_edges, 2), axis=0)
    block = choose_edge_block(len(links), k)
    edges_np, mask_np = pad_edges(links, block)
    edges = torch.as_tensor(edges_np, device="cuda")
    mask = torch.as_tensor(mask_np, device="cuda")
    adj = build_adjacency(links, n, "cuda")
    f_rowptr, f_nbr = forward_adjacency(links, n)
    gamma = 0.01 + 9.99 * torch.rand((n, k), generator=gen, device="cuda")
    elogpi = dirichlet_expectation_plain(gamma)
    del gamma
    lam = 0.5 + 4.5 * torch.rand((k, 2), generator=gen, device="cuda")
    elb0 = dirichlet_expectation_plain(lam)[:, 0].contiguous()

    def edge_atomic():
        gacc = torch.zeros((n, k), dtype=torch.float32, device="cuda")
        alt.call("svt_phi_pass_edge_atomic", elogpi.data_ptr(),
                 elb0.data_ptr(), edges.data_ptr(), mask.data_ptr(),
                 gacc.data_ptr(), edges.shape[0], k, stream())
        return gacc

    def half_push():
        gacc = torch.zeros((n, k), dtype=torch.float32, device="cuda")
        alt.call("svt_phi_half_push", elogpi.data_ptr(), elb0.data_ptr(),
                 f_rowptr.data_ptr(), f_nbr.data_ptr(), gacc.data_ptr(), n,
                 k, stream())
        return gacc

    def pull():
        return phi_pass(elogpi, elb0, adj)[0]

    want, _ = phi_pass_pull_plain(elogpi, elb0, adj, block)
    errs = {}
    for name, fn in (("edge_atomic", edge_atomic), ("half_push", half_push),
                     ("pull", pull)):
        got = fn()
        torch.cuda.synchronize()
        errs[name] = float((got - want).abs().max())
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), (name, errs)
        del got
    row = {"kernel": "phi_pass", "n": n, "k": k, "links": len(links),
           "max_abs_err_vs_plain": errs}
    if not quick:
        gacc = want
        row["ms"] = timed({
            "edge_atomic": edge_atomic, "half_push": half_push,
            "pull": pull,
            # what surrounds the kernels: the zero-fill the push designs
            # need, and the column sum that gives sumk
            "zero_fill": lambda: gacc.zero_(),
            "gacc_sum0": lambda: gacc.sum(dim=0)},
            3 if n * k >= 10**7 else 100)
        row["ms"]["plain"] = timed(
            {"plain": lambda: phi_pass_pull_plain(elogpi, elb0, adj, block)},
            1)["plain"]
    log(json.dumps(row))
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--no-stretch", action="store_true")
    ap.add_argument("--out", default=str(build.BUILD_DIR),
                    help="directory for the result files")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_kernels: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)
    os.makedirs(args.out, exist_ok=True)
    lib, alt = build.library(), alt_library()
    log(f"built in {lib.build_seconds:.1f} s and {alt.build_seconds:.1f} s")
    with open(os.path.join(args.out, "ptxas.log"), "w") as f:
        f.write(lib.log + alt.log)
    for line in (lib.log + alt.log).splitlines():
        if "spill" in line and "0 bytes spill stores" not in line:
            log(f"ptxas: {line.strip()}")
    results = {"card": card, "rows": bench_dirichlet(lib, alt, args.quick)}
    shapes = [(20_000, 20, 200_000), (1_000_000, 500, 2_000_000)]
    if not (args.quick or args.no_stretch):
        shapes.append((1_000_000, 500, 20_000_000))
    for n, k, e in shapes:
        results["rows"].append(bench_phi(alt, n, k, e, args.quick))
        torch.cuda.empty_cache()
    with open(os.path.join(args.out, "bench_kernels.json"), "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
