"""Kernel 10 (csrc/sparse_fastamm.cu) timed, and FastAMM's -fastqueue step.

    python -m svinet_torch.tools.k10_times [--out DIR]
    PYTHONPATH=OLD python3 svinet_torch/tools/k10_times.py [--out DIR]

At FAMM_TIMED's shapes (a node's minibatch at (1M, 8000), W=16; no pair;
(20k, 20), W=8; a hub's 16,000 pairs at W = 16, 64, 128; W = 96, 128 at a
node's minibatch) it logs kernel 10's ms a call over 20 calls back to
back, the host's ms a call, a call split by torch.profiler (host, CUDA
runtime, device time by kernel, gaps), and its device ms with no round,
one and 11 rounds (thresh -1: a round's cost is the slope); then an
informative -fastqueue step on the (1M, 8000) W=16 state, timed and
split, and chip_smoke.py's phase 6 `-k 100 -fastqueue 8` CLI run on
planted-20k, timed twice. The states, minibatches and CLI helpers are
chip_smoke.py's, from this file's checkout.

It times the svinet_torch that comes first on the path. With an older
checkout's root first on PYTHONPATH (the second form) it times that
checkout's package: where an older kernel 10 takes no workspace, or its
engine no segment length for the endpoint CSR, it is called as that
checkout's engine calls it. So a design and its parent are compared in
one call to the card, in turns (parent, change, change, parent). Prints
the card and its power limit first; writes the log to DIR/k10_times.txt
(DIR defaults to build/svinet_torch).
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import os
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import svinet_torch

# chip_smoke.py of this file's checkout, whatever package is on the path
_SMOKE = Path(__file__).resolve().parents[2] / "chip_smoke.py"
_spec = importlib.util.spec_from_file_location("k10_smoke", _SMOKE)
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

# (n, K, W, pairs, padded length): a node's minibatch, its empty minibatch
# and a hub's, narrow and wide
FAMM_TIMED = ((1_000_000, 8_000, 16, 141, 256), (1_000_000, 8_000, 16, 0, 256),
              (20_000, 20, 8, 121, 256),
              (1_000_000, 8_000, 16, 16_000, 16_384),
              (1_000_000, 8_000, 64, 16_000, 16_384),
              (1_000_000, 8_000, 96, 141, 256),
              (1_000_000, 8_000, 128, 141, 256),
              (1_000_000, 8_000, 128, 16_000, 16_384))


def _split_text(sp):
    return (f"host {sp['host']:.4f} ms a call (allocation {sp['alloc']:.4f}, "
            f"other aten ops {sp['ops']:.4f}, CUDA runtime "
            + ", ".join(f"{k} {ms:.4f} x{c:g}" for k, (ms, c) in
                        sorted(sp["runtime"].items(), key=lambda t: -t[1][0]))
            + f"); device busy {sp['busy']:.4f} ms over a span of "
            f"{sp['span']:.4f} (gaps {sp['gaps']:.4f}), first kernel "
            f"{sp['lead']:.4f} ms after the call's start; by kernel: "
            + "; ".join(f"{k} {ms:.4f} ms x{c:g}" for k, (ms, c) in
                        sorted(sp["device"].items(), key=lambda t: -t[1][0])))


def _k10_seg_len():
    """The endpoint CSR's segment length this package's engine gives
    kernel 10 (the CSR's default where it names none)."""
    from svinet_torch.ops import sparse_gamma as sg
    from svinet_torch.ops.edges import SEG_LEN
    return getattr(sg, "K10_SEG_LEN", SEG_LEN)


def _k10_steps(batches, dev):
    """to_device of a -fastqueue engine's steps: their CSRs cut as the
    engine cuts them, where this package's to_device takes a length."""
    from svinet_torch.svi.fastamm import to_device
    if "seg_len" in inspect.signature(to_device).parameters:
        return to_device(batches, dev, _k10_seg_len())
    return to_device(batches, dev)


def _k10_extra(wrapper, dev):
    """The keyword arguments a caller that holds kernel 10's workspace
    across steps passes, where this package's wrapper takes one."""
    from svinet_torch.ops import sparse_gamma as sg
    if "workspace" not in inspect.signature(wrapper).parameters:
        return {}
    return {"workspace": sg.SparseWorkspace(dev)}


def fastamm_round_cost(dev, shapes=FAMM_TIMED):
    """Kernel 10's device ms (torch.profiler) at each shape with no round
    (its matching and sums) and with 1 and 11 rounds forced (thresh -1),
    so that a round's cost is the slope. Logs each."""
    from svinet_torch.ops.digamma import dirichlet_expectation
    from svinet_torch.ops.edges import owner_csr
    from svinet_torch.ops.sparse_gamma import sparse_fastamm_stats
    log_eps = float(np.float32(np.log(1e-30)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    for n, k, wt, m, pad in shapes:
        ids, vals, rest = cs._sparse_state(dev, gen, n, k, wt)
        lam = 1.0 + 19.0 * torch.rand((k, 2), generator=gen, device=dev)
        elogbeta = dirichlet_expectation(lam)
        pairs, y, w, nodes = cs._minibatch(dev, gen, n, m, min(m, 21))
        rows, local = cs._local(pairs, nodes, False)
        lp, lq = local[:, 0].contiguous(), local[:, 1].contiguous()
        t = rows.shape[0]
        csr = owner_csr(local.reshape(-1), t, _k10_seg_len())
        extra = _k10_extra(sparse_fastamm_stats, dev)
        ms = {}
        for rounds in (0, 1, 11):
            ms[rounds] = cs._trace_split(lambda: sparse_fastamm_stats(
                ids, vals, rest, elogbeta, pairs, y, w, lp, lq, t, log_eps,
                rounds, -1.0, pad, csr, **extra), 5)["busy"]
        cs.log(f"kernel 10 at n={n} K={k} W={wt}, {m} pairs padded to "
               f"{pad}: device {ms[0]:.4f} ms with no round, {ms[1]:.4f} "
               f"with one, {ms[11]:.4f} with 11: a round "
               f"{(ms[11] - ms[1]) / 10:.4f} ms")
        del ids, vals, rest, csr, extra
        torch.cuda.empty_cache()


def fastamm_times(dev, workdir, cli=True):
    """Kernel 10 through sparse_fastamm_stats at FAMM_TIMED: device ms of
    20 calls back to back with the endpoint CSR made once (as the engine
    makes it; at the first shape also made in each call), the host's ms a
    call, and a call split by torch.profiler; then an informative
    -fastqueue step on the (1M, 8000) W=16 state, timed and split, and the
    -k 100 -fastqueue 8 CLI run on planted-20k in workdir (with cli).
    Logs each."""
    from svinet_torch.ops.digamma import dirichlet_expectation
    from svinet_torch.ops.edges import owner_csr
    from svinet_torch.ops.sparse_gamma import (sparse_fastamm_stats,
                                               sparse_fastamm_step)
    from svinet_torch.svi.fastamm import Batch
    log_eps = float(np.float32(np.log(1e-30)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    for n, k, wt, m, pad in FAMM_TIMED:
        ids, vals, rest = cs._sparse_state(dev, gen, n, k, wt)
        lam = 1.0 + 19.0 * torch.rand((k, 2), generator=gen, device=dev)
        elogbeta = dirichlet_expectation(lam)
        pairs, y, w, nodes = cs._minibatch(dev, gen, n, m, min(m, 21))
        rows, local = cs._local(pairs, nodes, False)
        lp, lq = local[:, 0].contiguous(), local[:, 1].contiguous()
        t = rows.shape[0]
        csr = owner_csr(local.reshape(-1), t, _k10_seg_len())
        args = (ids, vals, rest, elogbeta, pairs, y, w, lp, lq, t, log_eps,
                50, 1e-5, pad)
        extra = _k10_extra(sparse_fastamm_stats, dev)

        def run():
            return sparse_fastamm_stats(*args, csr, **extra)

        r = run()[2]
        rounds = int(r[0]) if m else 0
        ms = cs.cuda_ms(run, 20)
        host = []
        for _ in range(50):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        tag = (f"kernel 10 timed at n={n} K={k} W={wt}, {m} pairs padded to "
               f"{pad}, {t} rows, R {rounds}")
        more = ""
        if (n, k, wt, m) == FAMM_TIMED[0][:4]:
            made = cs.cuda_ms(lambda: sparse_fastamm_stats(*args, **extra),
                              20)
            more = f", {made:.4f} ms with the CSR made in each call"
        cs.log(f"{tag}: {ms:.4f} ms a call over 20 back to back{more}; host "
               f"{np.median(host):.4f} ms a call (median of 50)")
        cs.log(f"{tag}: split: {_split_text(cs._trace_split(run, 10))}")
        del ids, vals, rest, csr, extra
        torch.cuda.empty_cache()
    # an informative -fastqueue step, as phase6_steps makes it
    n, kk = cs.STRETCH["n"], 8_000
    ids, vals, rest = cs._sparse_state(dev, gen, n, kk, 16)
    lam = 1.0 + 19.0 * torch.rand((kk, 2), generator=gen, device=dev)
    eta = torch.ones((kk, 2), device=dev)
    pairs_g, y, w, nodes = cs._minibatch(dev, gen, n, 121, 21)
    rows, local = cs._local(pairs_g, nodes, False)
    rho = torch.rand(rows.shape[0], generator=gen, device=dev)
    host = [a.cpu().numpy() for a in (rows, pairs_g, y, w,
                                      local.reshape(-1).long(), rho)]
    reps = 100
    steps = _k10_steps([Batch(*host, n / 2.0, 0.01)] * reps, dev)
    extra = _k10_extra(sparse_fastamm_step, dev)

    def step(st):
        sparse_fastamm_step(
            ids, vals, rest, lam, st.pairs, st.y, st.w, st.lp, st.lq,
            st.rows, st.rho, 0.002, eta, st.scale, st.rhot, 1.0, log_eps,
            kk, 50, 1e-5, 256, st.csr, **extra)

    step(steps[0])
    torch.cuda.synchronize()
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        for st in steps:
            step(st)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / reps)
    sp = cs._trace_split(lambda: step(steps[0]), 10)
    tag = (f"-fastqueue step timed, informative (121 pairs, "
           f"{rows.shape[0]} rows) at n={n} K={kk} W=16")
    cs.log(f"{tag}: " + ", ".join(f"{v:.4f}" for v in walls)
           + f" ms wall a step over {reps} steps")
    cs.log(f"{tag}: split: {_split_text(sp)}")
    del ids, vals, rest, steps
    torch.cuda.empty_cache()
    if not cli:
        return
    # the -fastqueue CLI run of phase 6
    from svinet_torch.synth import write_planted
    net, gt = write_planted(workdir, cs.PLANTED["n"], cs.PLANTED["k"],
                            cs.PLANTED["avg_deg"], cs.PLANTED["seed"])
    pre = cs._famm_cli(workdir, net, gt, "famm-pre", ["-preprocess"])
    # -infset reads neighbors.bin from the working directory
    here = os.getcwd()
    os.chdir(workdir)
    try:
        os.symlink(os.path.join(pre, "neighbors.bin"), "neighbors.bin")
        secs = []
        for i in range(2):
            t0 = time.perf_counter()
            cs._run_engine_cli(
                workdir, net, gt, cs.PLANTED["n"], cs.FAMM_K_SPARSE,
                f"famm-fq-timed{i}",
                ["-fastqueue", str(cs.FAMM_W_SPARSE), *cs.FAMM_FLAGS])
            secs.append(time.perf_counter() - t0)
    finally:
        os.chdir(here)
    cs.log(f"-infset -k {cs.FAMM_K_SPARSE} -fastqueue {cs.FAMM_W_SPARSE} on "
           f"planted-20k ({cs.FAMM_STEPS + 1} steps): "
           + ", ".join(f"{s:.2f}" for s in secs) + " s wall")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/svinet_torch")
    ap.add_argument("--skip-cli", action="store_true",
                    help="leave out the -fastqueue CLI runs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k10_times needs a CUDA card")
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    lines = []
    log = cs.log

    def keep(msg):
        lines.append(msg)
        log(msg)

    cs.log = keep
    try:
        keep(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip())
        keep(f"package: {os.path.dirname(svinet_torch.__file__)}")
        dev = torch.device("cuda", 0)
        with tempfile.TemporaryDirectory() as tmp:
            fastamm_times(dev, tmp, cli=not args.skip_cli)
        fastamm_round_cost(dev)
    finally:
        cs.log = log
        with open(os.path.join(out, "k10_times.txt"), "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
