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
links, at shapes between that one and n=1M (n=50k to 300k, K=20 to 500),
at n=1M with 10M links and K=20, 64, 128 and 256, and at n=1M, K=500
with 2M and (unless --no-stretch) 20M. At the same shapes, the passes that follow kernel 2 in a sweep: kernel 3 (the
mean-indicator update, csrc/mean_indicator.cu) beside its plain version;
kernel 4 (s3, csrc/s3_pass.cu) beside the plain blocked edge-list pass;
and kernel 5 (the fused phi + s3 pass of -fuse-s3) beside kernel 2
followed by kernel 4, which read the same rows in two walks. Every
design is first held to the plain PyTorch version, then the designs are
timed in turns (a, b, c, c, b, a) with CUDA events. Last, one report
interval of the engine (a sweep and the heldout tail) on a planted n=20k,
K=20 graph, default and -fuse-s3, run eagerly and as replays of one
torch.cuda.CUDAGraph: host time per interval of each, whether the two end
in the same bits, and the launch counts a replay does not advance. The
engine captures no graph; this is the measurement behind that. --quick
builds, launches every kernel once at these widths, compares and stops.

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
import tempfile
import time

import numpy as np
import torch

from svinet_torch.kernels import build
from svinet_torch.ops.digamma import (
    dirichlet_expectation, dirichlet_expectation_plain)
from svinet_torch.ops.edges import (
    build_adjacency, choose_edge_block, pad_edges)
from svinet_torch.svi.linksampling import from_edges, sweep_ho_trace
from svinet_torch.svi.sweep_math import (
    LSConsts, fused_phi_s3_pass, fused_phi_s3_pass_pull_plain,
    mean_indicator_update, mean_indicator_update_plain, phi_pass,
    phi_pass_pull_plain, s3_pass, s3_pass_plain, s3_pass_pull_plain)
from svinet_torch.synth import planted_blocks, random_edges

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


def bench_phi(alt, n: int, k: int, n_edges: int, quick: bool) -> list:
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
    del want
    return [row, bench_after_phi(links, n, k, edges, mask, block, adj, elogpi,
                                 elb0, gen, quick)]


def bench_after_phi(links, n, k, edges, mask, block, adj, elogpi, elb0, gen,
                    quick: bool) -> dict:
    """Kernels 3, 4 and 5 on the inputs of bench_phi: gacc and sumk are
    kernel 2's output, mphi is kernel 3's."""
    tol = dict(rtol=1e-4, atol=1e-4)
    nb = edges.shape[0] // block
    deg = torch.as_tensor(
        np.bincount(links.ravel(), minlength=n).astype(np.float32),
        device="cuda")
    consts = LSConsts.make(1.0 / k, 1.0, 1.0, len(links), n)
    gacc, sumk = phi_pass(elogpi, elb0, adj)
    errs = {}
    for annealing in (False, True):
        got = mean_indicator_update(gacc.clone(), sumk, deg, consts, annealing)
        again = mean_indicator_update(gacc.clone(), sumk, deg, consts,
                                      annealing)
        want = mean_indicator_update_plain(gacc.clone(), sumk, deg, consts,
                                           annealing)
        torch.cuda.synchronize()
        for name, a, b, c in zip(("gnext", "mphi", "s1", "s2", "lam0"), got,
                                 again, want):
            assert torch.equal(a, b), (name, "two launches differ")
            errs[f"{name}_anneal{int(annealing)}"] = float(
                ((a - c).abs() / c.abs().clamp_min(1.0)).max())
            assert torch.allclose(a, c, **tol), (name, annealing, errs)
        del again, want
    mphi = got[1].clone()
    del got
    s3_k = s3_pass(mphi, adj)
    assert torch.equal(s3_k, s3_pass(mphi, adj))
    s3_p = s3_pass_pull_plain(mphi, adj, block)
    s3_e = s3_pass_plain(mphi, edges, mask, nb)
    errs["s3_vs_pull_plain"] = float(((s3_k - s3_p).abs() / s3_p.abs()).max())
    assert torch.allclose(s3_k, s3_p, **tol), errs
    assert torch.allclose(s3_k, s3_e, **tol), errs
    f_g, f_s, f_3 = fused_phi_s3_pass(elogpi, mphi, elb0, adj, True)
    f_g2, _, f_32 = fused_phi_s3_pass(elogpi, mphi, elb0, adj, True)
    assert torch.equal(f_g, f_g2) and torch.equal(f_3, f_32)
    del f_g2
    p_g, p_s, p_3 = fused_phi_s3_pass_pull_plain(elogpi, mphi, elb0, adj,
                                                 block)
    errs["fused_gacc"] = float((f_g - p_g).abs().max())
    errs["fused_s3"] = float(((f_3 - p_3).abs() / p_3.abs()).max())
    assert torch.allclose(f_g, p_g, **tol), errs
    assert torch.allclose(f_s, p_s, **tol), errs
    assert torch.allclose(f_3, p_3, **tol), errs
    # kernel 5 against kernel 2 followed by kernel 4
    assert torch.allclose(f_g, gacc, **tol) and torch.allclose(f_3, s3_k, **tol)
    del f_g, p_g
    row = {"kernel": "mean_indicator, s3_pass, fused_phi_s3_pass", "n": n,
           "k": k, "links": len(links), "max_rel_err_vs_plain": errs}
    if not quick:
        big = n * k >= 10**7
        # the update is in place, so repeated launches run on values that
        # grow past f32; the card's arithmetic takes the same time on them
        row["ms"] = timed({
            "mean_indicator": lambda: mean_indicator_update(
                gacc, sumk, deg, consts, True, mphi_out=mphi),
            "mean_indicator_plain": lambda: mean_indicator_update_plain(
                gacc, sumk, deg, consts, True)}, 3 if big else 100)
        mphi = torch.rand((n, k), generator=gen, device="cuda") / k
        row["ms"].update(timed({
            "s3": lambda: s3_pass(mphi, adj),
            "phi": lambda: phi_pass(elogpi, elb0, adj),
            # the one launch, whatever the wrapper would choose
            "fused_phi_s3": lambda: fused_phi_s3_pass(elogpi, mphi, elb0,
                                                      adj, True),
            "phi_then_s3": lambda: (phi_pass(elogpi, elb0, adj),
                                    s3_pass(mphi, adj))},
            3 if big else 100))
        row["ms"]["s3_plain_edge_list"] = timed(
            {"p": lambda: s3_pass_plain(mphi, edges, mask, nb)}, 1)["p"]
    log(json.dumps(row))
    return row


def bench_graph_capture(n: int, k: int, intervals: int) -> list:
    """Report intervals of one sweep and the heldout tail on a planted
    graph from the engine's initial state, eagerly and as replays of one
    CUDA graph captured over fixed state buffers; the device is
    synchronised once, by the copy of all heldout rows, as a batch is."""
    wrappers = (dirichlet_expectation, phi_pass, mean_indicator_update,
                s3_pass, fused_phi_s3_pass)
    raw, _ = planted_blocks(n, k, 20, 7)
    out = []
    for fused in (False, True):
        with tempfile.TemporaryDirectory() as workdir:
            eng = from_edges(raw, n, k, torch.device("cuda", 0), workdir,
                             fuse_s3=fused)
            eng.close()
        net = eng.network
        pairs, w = pad_edges(net.validation_pairs, len(net.validation_pairs))
        ho = [torch.as_tensor(a, device="cuda") for a in
              (pairs, net.validation_y.astype(np.int32), w)]

        def interval(gamma, lam, mphi):
            return sweep_ho_trace(gamma, lam, mphi, eng.adj, eng.deg,
                                  eng.consts, True, *ho, eng.cfg.epsilon, 1,
                                  1, 1, fused)

        def start():
            return (eng.gamma.clone(), eng.lam.clone(),
                    eng.mphi.clone() if fused else None)

        def eager():
            gamma, lam, mphi = start()
            rows = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(intervals):
                gamma, lam, mphi, trace = interval(gamma, lam, mphi)
                rows.append(trace[0])
            rows = torch.stack(rows).cpu()
            ms = (time.perf_counter() - t0) * 1e3 / intervals
            return ms, (gamma, lam, mphi, rows)

        eager()                                    # builds, warms up
        eager_ms, want = eager()
        gamma, lam, mphi = start()
        sums = torch.zeros(6, dtype=torch.float32, device="cuda")
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            # -fuse-s3 updates mphi in place; gamma and lambda are copied
            # back into the buffers the next replay reads
            new_gamma, new_lam, _, trace = interval(gamma, lam, mphi)
            gamma.copy_(new_gamma)
            lam.copy_(new_lam)
            sums.copy_(trace[0])
        torch.cuda.synchronize()
        capture_ms = (time.perf_counter() - t0) * 1e3
        rows = torch.empty((intervals, 6), dtype=torch.float32, device="cuda")
        before = [fn.launches for fn in wrappers]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(intervals):
            graph.replay()
            rows[i].copy_(sums)
        rows = rows.cpu()
        replay_ms = (time.perf_counter() - t0) * 1e3 / intervals
        counted = sum(fn.launches - b for fn, b in zip(wrappers, before))
        eager_ms_again, _ = eager()
        row = {"kernel": "report interval, eager and CUDA graph",
               "flags": "-fuse-s3" if fused else "default", "n": n, "k": k,
               "intervals": intervals,
               "ms_per_interval": {"eager": eager_ms, "replay": replay_ms,
                                   "eager_again": eager_ms_again},
               "capture_ms": capture_ms,
               "bitwise_equal": all(
                   a is None or torch.equal(a, b)
                   for a, b in zip(want, (gamma, lam, mphi, rows))),
               "launches_counted_in_replays": counted}
        log(json.dumps(row))
        out.append(row)
    return out


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
    # the shapes between the first and the last place
    # sweep_math.FUSED_MAX_WORK: where the one fused launch stops beating
    # kernel 2 followed by kernel 4
    shapes = [(20_000, 20, 200_000), (50_000, 20, 500_000),
              (100_000, 20, 1_000_000), (20_000, 128, 200_000),
              (300_000, 20, 3_000_000), (100_000, 64, 1_000_000),
              (20_000, 500, 200_000), (300_000, 64, 3_000_000),
              (1_000_000, 20, 10_000_000),
              (1_000_000, 64, 10_000_000), (1_000_000, 128, 10_000_000),
              (1_000_000, 256, 10_000_000), (1_000_000, 500, 2_000_000)]
    if not (args.quick or args.no_stretch):
        shapes.append((1_000_000, 500, 20_000_000))
    for n, k, e in shapes:
        results["rows"].extend(bench_phi(alt, n, k, e, args.quick))
        torch.cuda.empty_cache()
    if not args.quick:
        results["rows"].extend(bench_graph_capture(20_000, 20, 40))
    with open(os.path.join(args.out, "bench_kernels.json"), "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
