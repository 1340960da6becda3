#!/usr/bin/env python3
"""Chip smoke run of svinet_torch, the PyTorch/CUDA port, on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100. It
builds the CUDA kernels from svinet_torch/csrc, checks each kernel
against its plain PyTorch version at the shapes the main path gives it
(and at shapes that take every other kernel variant: a hub cut into
segments, K not a multiple of 4, K above 512, x up to 1e6), drives
`python -m svinet_torch ... -link-sampling` in-process on a planted
graph at ca-AstroPh scale (n=20,000, K=20, ~200k links), and times
sweeps of the n=1M, K=500, 20M-edge stretch shape. Every phase asserts
what it checks; any failure exits non-zero. Progress goes to stdout; the
line before the last is a JSON summary of the kernels (time, plain
version's time, bound and launch counts) and the last line is
{"ok": true, "device": {...}}. Without CUDA it exits 2 and prints no
result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Tolerances. Kernel 1 is held to the TPU kernel's bar
# (tests/test_ops.py:87-102): 5e-5 abs against float64 scipy and against
# the plain version, over gamma-like inputs in [0.01, 10] and over inputs
# up to 1e6 (gamma grows to thousands while annealing). Below x = 0.01
# the results pass -200, where an f32 ulp is 1.5e-5 and the plain version
# (f32 torch.special.digamma) is itself a few ulps off: there the kernel
# is held to scipy at 5e-5 and to the plain version at twice that, the
# sum of the two errors. Kernel 2 sums in
# another order than its plain version: 1e-4 abs/rel, the JAX package's
# own bound for reorderings of f32 sums
# (__graft_entry__.dryrun_multichip); two launches of it must agree
# bitwise, since no atomic touches gacc.
DEXP_ATOL = 5e-5
PHI_TOL = 1e-4
# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate and f32 rate outside the tensor cores. A kernel's bound is the
# larger of its bytes over the one and its operations over the other.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# Phase 2 is held to the CPU run of the same graph, seed and flags, where
# the port and the JAX package both stop at iteration 52, with NMI
# 0.957061 and 0.957102; the bounds are those of
# tests/test_torch_engine.py: the stop one report (one iteration) apart,
# NMI within 0.02. -lt-min-deg 1 lets a node join a community on its
# second link to it, not its first: with the default 0, each cross-block
# link can add a membership, nodes land in ~1.48 communities and the NMI
# of the same fit reads 0.673.
STOP_ITER_CPU = 52
NMI_CPU = 0.957061
NMI_TOL = 0.02
PLANTED = dict(n=20_000, k=20, avg_deg=20, seed=7)
STRETCH = dict(n=1_000_000, k=500, n_edges=20_000_000)
# kernel shapes; the first of each is the one the JSON summary reports
# (its error, times and bound; every shape is asserted and logged).
# Kernel 1: (rows, K, least x, largest x), x uniform up to 10 and
# log-uniform beyond. Kernel 2: (n, K, random edges, degree of
# a hub planted at node 0); K=33 takes the 4-byte-load layout, K=640 the
# wide kernel (K > 512), and the hubs are cut into segments.
DEXP_SHAPES = ((1_000_000, 500, 0.01, 10.0), (17_903, 20, 0.01, 10.0),
               (500, 2, 0.01, 10.0), (100_000, 500, 1.0, 1e6),
               (100_000, 500, 5e-3, 40.0), (4_096, 640, 0.01, 10.0))
PHI_SHAPES = ((1_000_000, 500, 2_000_000, 0), (20_000, 20, 200_000, 0),
              (1_000_000, 500, 500_000, 50_000), (20_000, 33, 200_000, 0),
              (100_000, 640, 300_000, 2_000))


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase0(dev):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(dev)}, python "
        f"{sys.version.split()[0]}")
    from svinet_torch.kernels import build
    t0 = time.perf_counter()
    lib = build.library()
    log(f"phase 0: kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {lib.build_seconds:.2f} s) -> {lib.path.name}")
    # ptxas -v: one "Used N registers" line per compiled kernel
    regs = [int(w) for line in lib.log.splitlines() if "Used" in line
            for w, nxt in zip(line.split(), line.split()[1:])
            if nxt.startswith("registers") and w.isdigit()]
    spills = [line.strip() for line in lib.log.splitlines()
              if "spill" in line and "0 bytes spill stores, 0 bytes spill "
              "loads" not in line]
    log(f"phase 0: ptxas: {len(regs)} kernels, at most "
        f"{max(regs, default=0)} registers, {len(spills)} with spills")
    for line in spills:
        log(f"  ptxas: {line}")
    return card


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the least time the card could take to move
    n_bytes and do n_ops f32 operations."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_F32_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase1_dirichlet(dev):
    from scipy.special import digamma
    from svinet_torch.ops.digamma import (
        dirichlet_expectation, dirichlet_expectation_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    report = None
    for rows, k, low, top in DEXP_SHAPES:
        u = torch.rand((rows, k), generator=gen, device=dev)
        if top <= 10.0:
            x = low + (top - low) * u
        else:
            x = torch.exp(np.log(low) + (np.log(top) - np.log(low)) * u)
        del u
        plain_atol = DEXP_ATOL if low >= 0.01 else 2 * DEXP_ATOL
        got = dirichlet_expectation(x)
        want = dirichlet_expectation_plain(x)
        torch.cuda.synchronize()
        err_plain = float((got - want).abs().max())
        # float64 scipy on a row sample: rows are independent
        idx = torch.randperm(rows, generator=gen, device=dev)[:4096]
        xs = x[idx].double().cpu().numpy()
        ref = digamma(xs) - digamma(xs.sum(axis=1, keepdims=True))
        err_scipy = float(np.abs(got[idx].cpu().numpy() - ref).max())
        assert np.isfinite(err_plain) and err_plain < plain_atol, err_plain
        assert err_scipy < DEXP_ATOL, err_scipy
        reps = 20 if rows * k >= 10**7 else 200
        ms = cuda_ms(lambda: dirichlet_expectation(x), reps)
        plain_ms = cuda_ms(lambda: dirichlet_expectation_plain(x), reps)
        # each element read once and written once; about 40 f32
        # operations per element (the lift, the series and the log)
        bound_ms, bound_by = bound(8.0 * rows * k, 40.0 * rows * k)
        log(f"phase 1: dirichlet_expectation ({rows}, {k}) x in [{low:g}, "
            f"{top:g}]: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), max abs err vs plain "
            f"{err_plain:.3e}, vs scipy f64 {err_scipy:.3e}")
        if report is None:
            report = dict(max_abs_err=max(err_plain, err_scipy), ms=ms,
                          plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
        del x, got, want
    torch.cuda.empty_cache()
    return report


def _phi_inputs(dev, gen, n, k, n_edges, hub_deg):
    """Random links (plus a hub at node 0 joined to nodes 1..hub_deg) as
    the engine holds them: padded edge list, mask, adjacency; and
    Elogpi / Elogbeta0 of random gamma and lambda."""
    from svinet_torch.ops.digamma import dirichlet_expectation_plain
    from svinet_torch.ops.edges import (
        build_adjacency, choose_edge_block, pad_edges)
    from svinet_torch.synth import random_edges
    # a few edges short of the block, so the padded tail is ragged
    links = random_edges(n, n_edges - 12_345, 2)
    if hub_deg:
        links = links[links[:, 0] > 0]
        hub = np.stack([np.zeros(hub_deg, np.int32),
                        np.arange(1, hub_deg + 1, dtype=np.int32)], 1)
        links = np.concatenate([hub, links])
    block = choose_edge_block(len(links), k)
    edges_np, mask_np = pad_edges(links, block)
    adj = build_adjacency(links, n, dev)
    gamma = 0.01 + 9.99 * torch.rand((n, k), generator=gen, device=dev)
    elogpi = dirichlet_expectation_plain(gamma)
    del gamma
    lam = 0.5 + 4.5 * torch.rand((k, 2), generator=gen, device=dev)
    elb0 = dirichlet_expectation_plain(lam)[:, 0].contiguous()
    return (links, torch.as_tensor(edges_np, device=dev),
            torch.as_tensor(mask_np, device=dev),
            edges_np.shape[0] // block, block, adj, elogpi, elb0)


def phi_bound(n, k, n_links, adj):
    """Elogpi read once and gacc written once, the adjacency read once;
    per link about 8 operations per column (two adds for the logit, max,
    subtract, exp, the sum, the scale, and two accumulations less what
    fuses)."""
    index_bytes = 4.0 * sum(t.numel() for t in adj.tensors())
    return bound(8.0 * n * k + 4.0 * k + index_bytes, 8.0 * n_links * k)


def phase1_phi(dev):
    from svinet_torch.svi.sweep_math import (
        phi_pass, phi_pass_plain, phi_pass_pull_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    report = None
    for n, k, n_edges, hub_deg in PHI_SHAPES:
        links, edges, mask, nb, block, adj, elogpi, elb0 = _phi_inputs(
            dev, gen, n, k, n_edges, hub_deg)
        n_links = len(links)
        assert int(adj.rowptr[-1]) == 2 * n_links
        assert (len(adj.hub_node) > 0) == (hub_deg > adj.seg_len)
        g_k, s_k = phi_pass(elogpi, elb0, adj)
        g_2, _ = phi_pass(elogpi, elb0, adj)
        g_p, s_p = phi_pass_pull_plain(elogpi, elb0, adj, block)
        torch.cuda.synchronize()
        # no atomics into gacc: a second launch gives the same bits
        assert torch.equal(g_k, g_2)
        del g_2
        err = float((g_k - g_p).abs().max())
        # a hub's row holds values near degree/K: relative to the row's top
        rel = float(((g_k - g_p).abs().amax(1)
                     / g_p.abs().amax(1).clamp_min(1.0)).max())
        # sumk is gacc.sum(0) on the kernel path: a torch reduction over n
        # rows of values near 2E/K, so it is compared relative
        rel_s = float(((s_k - s_p).abs() / s_p.abs()).max())
        assert torch.allclose(g_k, g_p, rtol=PHI_TOL, atol=PHI_TOL), err
        assert torch.allclose(s_k, s_p, rtol=PHI_TOL, atol=PHI_TOL), rel_s
        # every link adds a phi (which sums to 1) to both of its ends
        total = float(g_k.double().sum())
        assert abs(total - 2 * n_links) < 1e-3 * total, total
        del g_p
        # the edge-list plain form (the one held against JAX) agrees too
        g_e, s_e = phi_pass_plain(elogpi, elb0, edges, mask, nb)
        assert torch.allclose(g_k, g_e, rtol=PHI_TOL, atol=PHI_TOL)
        assert torch.allclose(s_k, s_e, rtol=PHI_TOL, atol=PHI_TOL)
        del g_k, g_e
        reps = 5 if n * k >= 10**7 else 50
        ms = cuda_ms(lambda: phi_pass(elogpi, elb0, adj), reps)
        plain_ms = cuda_ms(
            lambda: phi_pass_pull_plain(elogpi, elb0, adj, block), reps)
        bound_ms, bound_by = phi_bound(n, k, n_links, adj)
        log(f"phase 1: phi_pass n={n} K={k} links={n_links} hub degree "
            f"{hub_deg} ({len(adj.seg_node)} segments): kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}), max abs err gacc {err:.3e} (relative to the "
            f"row's largest value {rel:.3e}), max rel err sumk "
            f"{rel_s:.3e}, two launches bitwise equal")
        if report is None:
            report = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        del elogpi, edges, mask, adj
        torch.cuda.empty_cache()
    return report


def _run_cli(workdir, net, gt, label, extra):
    from svinet_torch.cli import main
    os.chdir(workdir)
    assert main(["-file", net, "-n", str(PLANTED["n"]), "-k",
                 str(PLANTED["k"]), "-link-sampling", "-nmi", gt, "-seed",
                 "1", "-lt-min-deg", "1", "-label", label, *extra]) == 0
    return os.path.join(
        workdir, f"n{PLANTED['n']}-k{PLANTED['k']}-{label}-seed1-"
                 f"linksampling")


def phase2(workdir):
    from svinet_torch.ops.digamma import dirichlet_expectation
    from svinet_torch.svi.sweep_math import phi_pass
    from svinet_torch.synth import write_planted
    net, gt = write_planted(workdir, PLANTED["n"], PLANTED["k"],
                            PLANTED["avg_deg"], PLANTED["seed"])
    os.environ["SVINET_TORCH_DEVICE"] = "cuda"
    dirichlet_expectation.launches = 0
    phi_pass.launches = 0
    t0 = time.perf_counter()
    out = _run_cli(workdir, net, gt, "gpu", ["-max-iterations", "400"])
    secs = time.perf_counter() - t0
    launches = {"dirichlet_expectation": dirichlet_expectation.launches,
                "phi_pass": phi_pass.launches}
    assert all(v > 0 for v in launches.values()), launches

    files = set(os.listdir(out))
    need = {"gamma.txt", "lambda.txt", "heldout.txt", "max.txt",
            "communities.txt", "mutual.txt", "groups.txt", "auc.txt",
            "convergence.txt", "param.txt", "mrstats.txt", "time.txt"}
    assert need <= files, need - files
    gamma = np.loadtxt(os.path.join(out, "gamma.txt"))
    assert gamma.shape == (PLANTED["n"], PLANTED["k"] + 2), gamma.shape
    assert np.isfinite(gamma).all() and (gamma[:, 2:] > 0).all()
    ho = np.loadtxt(os.path.join(out, "heldout.txt"), ndmin=2)
    assert ho.shape[1] == 11 and np.isfinite(ho).all()
    mx = open(os.path.join(out, "max.txt")).read().split()
    nmi = float(open(os.path.join(out, "mutual.txt")).read().split()[-1])
    assert abs(int(mx[0]) - STOP_ITER_CPU) <= 1, mx
    assert abs(nmi - NMI_CPU) <= NMI_TOL, nmi
    log(f"phase 2: CLI on planted n={PLANTED['n']} K={PLANTED['k']}: "
        f"{secs:.1f} s, stopped at iteration {mx[0]} (why {mx[5]}), best "
        f"nshol {mx[4]}, NMI {nmi:.6f}, heldout rows {len(ho)}, launches "
        f"{launches}")

    # the same run's first reports on the CPU (the plain versions): the
    # trace must agree to f32 summation order
    os.environ["SVINET_TORCH_DEVICE"] = "cpu"
    out_cpu = _run_cli(workdir, net, gt, "cpu",
                       ["-max-iterations", "5", "-no-stop"])
    ho_cpu = np.loadtxt(os.path.join(out_cpu, "heldout.txt"), ndmin=2)
    rel = np.abs(ho[:5, 10] - ho_cpu[:5, 10]) / np.abs(ho_cpu[:5, 10])
    assert (rel < 1e-4).all(), rel
    log(f"phase 2: first 5 heldout nshol, GPU vs CPU: max rel diff "
        f"{rel.max():.3e}")
    os.environ["SVINET_TORCH_DEVICE"] = "cuda"
    return launches


def phase3(dev, workdir):
    from svinet_torch.evals.likelihood import result_from_sums
    from svinet_torch.svi.linksampling import from_edges
    from svinet_torch.synth import random_edges
    n, k = STRETCH["n"], STRETCH["k"]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = from_edges(random_edges(n, STRETCH["n_edges"], 0), n, k, dev,
                     os.path.join(workdir, "stretch"))
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    net = eng.network
    n_train = len(net.training_links)
    # the device init adds a normalised phi to both ends of every link, so
    # each gamma row sums to the node's degree in the whole graph
    deg = np.bincount(net.edges.ravel(), minlength=net.n)
    rows = eng.gamma.sum(dim=1, dtype=torch.float64).cpu().numpy()
    init_err = float(np.abs(rows / deg - 1.0).max())
    assert deg.min() > 0 and init_err < 1e-4, init_err
    eng.step(1)                       # warm-up
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng.step(3)
    res = result_from_sums(eng._ho_res)   # synchronises
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    assert torch.isfinite(eng.gamma).all() and torch.isfinite(eng.lam).all()
    assert np.isfinite(res.avg) and res.count == len(net.validation_pairs)
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"phase 3: n={n} K={k} training links {n_train}: set-up "
        f"{setup:.1f} s, init gamma row sums vs degree max rel err "
        f"{init_err:.3e}, 3 sweeps + heldout tail {dt:.3f} s = "
        f"{3 * n_train / dt:.0f} edges/s, heldout avg {res.avg:.6f}, peak "
        f"device memory {peak / 2**30:.2f} GiB")
    from svinet_torch.ops.edges import build_adjacency
    t2 = time.perf_counter()
    build_adjacency(net.training_links, n, dev)
    torch.cuda.synchronize()
    log(f"phase 3: the adjacency of the training links builds in "
        f"{time.perf_counter() - t2:.2f} s of that set-up")
    # the two kernels alone on this engine's state
    from svinet_torch.ops.digamma import dirichlet_expectation
    from svinet_torch.svi.sweep_math import phi_pass
    d_ms = cuda_ms(lambda: dirichlet_expectation(eng.gamma), 5)
    elogpi = dirichlet_expectation(eng.gamma)
    elb0 = dirichlet_expectation(eng.lam)[:, 0].contiguous()
    p_ms = cuda_ms(lambda: phi_pass(elogpi, elb0, eng.adj), 5)
    p_bound, p_by = phi_bound(n, k, n_train, eng.adj)
    log(f"phase 3: on the stretch state: dirichlet_expectation {d_ms:.4f} "
        f"ms, phi_pass {p_ms:.4f} ms (bound {p_bound:.4f} ms, {p_by})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cwd = os.getcwd()
    phase0(dev)
    d_report = phase1_dirichlet(dev)
    p_report = phase1_phi(dev)
    with tempfile.TemporaryDirectory() as workdir:
        try:
            launches = phase2(workdir)
            phase3(dev, workdir)
        finally:
            os.chdir(cwd)
    # library_ms is null for both: no single PyTorch call computes either
    # function (torch.special.digamma is one part of kernel 1; kernel 2's
    # gather, softmax and index_add_ are its plain version)
    kernels = [
        {"name": "dirichlet_expectation", "route": "cuda",
         "source": "svinet_torch/csrc/dirichlet_expectation.cu",
         "replaces": "svinet_tpu/ops/pallas_digamma.py:68",
         "launches": launches["dirichlet_expectation"],
         "launches_per_sweep": 2, **d_report,
         "library_ms": None},
        {"name": "phi_pass", "route": "cuda",
         "source": "svinet_torch/csrc/phi_pass.cu",
         "replaces": "tools/pallas_gather_bench.py:69",
         "launches": launches["phi_pass"],
         "launches_per_sweep": 1, **p_report,
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
