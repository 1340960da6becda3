#!/usr/bin/env python3
"""Chip smoke run of svinet_torch, the PyTorch/CUDA port, on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100. It
builds the CUDA kernels from svinet_torch/csrc, checks each kernel
against its plain PyTorch version at the shapes the main path gives it
(and at shapes that take every other kernel variant: a hub cut into
segments, K not a multiple of 4, K above 512, x up to 1e6), drives
`python -m svinet_torch ... -link-sampling` in-process on a planted
graph at ca-AstroPh scale (n=20,000, K=20, ~200k links), with default
flags, with `-fuse-s3 -report-batch 4`, with `-bf16`, with `-freeze -bf16`
and with `-bf16 -fuse-s3 -report-batch 4`, runs a `-prune` engine on a
state forced into the dead-column regime against the dense engine, and
times sweeps of the n=1M, K=500, 20M-edge stretch shape, default,
`-bf16`, `-fuse-s3` and both. The forms those flags add to the kernels
(bf16 rows in and out, frozen-node flags, the scalar rest of a compacted
gamma) are each held to their plain versions like the kernels themselves,
and so are the launches of a compacted sweep (pad columns at alpha with
-1e30 logits, K_pad from 8 to 256), whose pad columns must come out exact;
the -prune engine's state is looked at while it is still compacted.
The held-out sums kernel is held to the plain tail it replaces and to its
own arithmetic in plain PyTorch. MMSBInfer's per-pair phi fixed point
(kernel 8, with its ELBO form, under the JAX package's block rule) is held
pair by pair to its plain version in float64 on the kernel's rounds, at
K = 20, 500, 1024, 2000 and 8000, and the edge assignments (kernel 9) to
theirs and to PR 8's design bit for bit; MMSBInfer runs through the CLI
with no engine flag, -rnode, -stratified -rpair, -batch -logl and at
K=640, its rows held to the CPU port's (`python3 chip_smoke.py
--record-cpu` prints them); the default link-sampling run, cut after a
report and -resume'd, must write the uninterrupted run's files bit for
bit; phase 3 holds an MMSBInfer step (kernel 8 writing the next gamma) to
the plain step and times it and a report's community extraction at the
stretch shape. Phase 4 drives the mesh (-mesh N, -mesh-rowshard;
svinet_torch/parallel/mesh.py) through the launcher on two gloo ranks
sharing the card (link sampling default, -fuse-s3 -report-batch 4 and
row-sharded, MMSBInfer with no engine flag and -batch -logl) and, on one
NCCL rank, every layout (-bf16 row-sharded too), each run held to the
single-card run of its flags (stop, NMI, heldout rows, and gamma and
lambda where the fit does not amplify the reordered sums: see
MESH_RTOL) with the replicas bit for bit equal, then times the stretch
step under both layouts, the collectives alone on (n, K) rows and a
sharded MMSBInfer step there. Phase 5 drives -mesh-locality on two gloo
ranks sharing the card, held to the single card's -fuse-s3 run on the same
permuted network (to the stop, and after 20 sweeps), and alone on one NCCL
rank, bit for bit -mesh 1 -mesh-rowshard -fuse-s3 on the same order;
-dist-nprocs 2 as two processes of one gloo rank each, bit for bit the
one-process run; FastAMM2 (-stratified -rnode) on the card and on two gloo
ranks, held to the CPU port's rows (precision counts equal up to score
ties); kernel 8 at FastAMM2's block of 512 pairs against its plain version;
then times the stretch -fuse-s3 step under the locality and row-sharded
layouts at one NCCL rank, FastAMM2's steps on that state, and the host's
locality order and layout at d = 1, 2, 4, 8 on a planted n=100k graph
(`python3 chip_smoke.py
--phase5` runs phase 5 alone and prints no result). Phase 6 holds
FastAMM's kernels to their plain versions with the same rounds and two
launches bitwise equal (kernel 8's FastAMM form, a rho a row and the
whole padded minibatch one block; kernel 10, the union-slot fixed point
on the top-W state; kernel 11's held-out scores and edge assignments, the
latter on stretch's 20M links, a third launch into the first's workspace
allocating nothing, on K11_TIES' states, whose links tie exactly,
the plain version's community on every link where a last-slot argmax
parts from it, and on K11_NAN's, whose phis are NaN, the first slot's),
drives `-preprocess`, `-infset` and
`-infset -k 100 -fastqueue 8` on planted-20k held to the CPU port's rows
(`python3 chip_smoke.py --record-cpu famm`), cuts the dense run and
resumes it, and times both steps on stretch-shaped states (`--phase6`
runs it alone and prints no result). Phase 7 does the same for FastInit
and SBM (kernels 12-14, `--phase7`). Phase 8 holds kernel 15 (the full
blockmodel's coupled K x K fixed point, both forms) to its plain version
in float64 on its rounds and to its f32 rounds block by block, kernel 16
(the generator's pair draw) to its plain version bit for bit, drives
`-orig` and `-orig -logl -itype 1` held to the CPU port's rows, cuts and
resumes an -orig run, drives `-gen`, `-gen -orig`, `-gml`, `-lcstats`
and `-ppc` on the card and on the CPU with every file byte for byte (the
generated network apart only at Gumbel near-ties: both draw on JAX's
threefry stream, and the logs are the frameworks'), and times one -orig
iteration at n=10,000, K=50 (`--phase8` runs it alone). Kernel 17 (JAX's
uniforms, LinkSampling's device init) is counted in phase 3's stretch
engine build and held to its plain version bit for bit; phases 6 and 7
also take kernels 10, 11 and 13 past their former width limits (W = 96
and 128, a `-k 200 -fastqueue 128` CLI run; widths 4,097 and 8,192, a
`-findk -findk-width 4100` run).
Every phase asserts what it checks; any failure exits non-zero. Progress goes to stdout; the
line before the last is a JSON summary of the kernels (time, plain
version's time, bound and launch counts) and the last line is
{"ok": true, "device": {...}}. Without CUDA it exits 2 and prints no
result.
"""

from __future__ import annotations

import json
import os
import re
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
# bitwise, since no atomic touches gacc. Kernels 3, 4 and 5 (the
# mean-indicator update, the s3 pass, the fused phi + s3 pass) are held
# to their plain versions at the same 1e-4 abs/rel for the same reason
# (their column sums cross rows in another order; kernel 3 multiplies by
# 1 / (2 deg) where the plain version divides), and two launches of each
# must agree bitwise: their sums across blocks use no atomics either.
# The forms over bf16 rows are given the same bf16 bits as their plain
# versions and widen them to f32 exactly, so the same 1e-4 holds (kernel
# 2 over bf16 rows takes exp as ex2.approx of a scaled argument, under 3e-7
# off on a term of phi). A compacted sweep's launches (-prune: the scalar
# rest, -1e30 logits in the pad columns) are held to the same bounds, and
# their pad columns to exact values.
# Kernel 1's bf16 output must equal its own f32 output rounded to nearest
# even bit for bit; against the plain version's bf16 output the 5e-5
# between the two f32 results can cross a rounding boundary, so that
# comparison allows one bf16 step, 2^-7 of the value. The converged flags
# and the bf16 copy of mphi that kernel 3 makes must equal converged_of and
# a cast of the gnext and mphi it wrote, exactly. Kernel 6 (the held-out
# sums) divides each gathered row by its own sum as the plain version
# divides every row, and adds the pairs' terms in another order: its six
# sums are held to 1e-5 relative, the bound of tests/test_torch_heldout.py.
DEXP_ATOL = 5e-5
PHI_TOL = 1e-4
HELDOUT_RTOL = 1e-5
# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate and f32 rate outside the tensor cores. A kernel's bound is the
# larger of its bytes over the one and its operations over the other.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# Exponentials and logarithms go to the special-function units: 16 results
# an SM a clock on Hopper (4 in each of its 4 partitions), 132 SMs at the
# 1.98 GHz boost clock of the H100 SXM, the clock the f32 peak above
# assumes (132 SMs * 128 lanes * 2 * 1.98 GHz = 66.9 TFLOP/s).
PEAK_SFU_S = 132 * 16 * 1.98e9
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
# The same graph and seed with -fuse-s3 -report-batch 4 -lt-min-deg 1 on
# the CPU: the port and the JAX package both stop at iteration 50 (in the
# batch of iterations 49-52) with NMI 0.963742. A batched run replays its
# stop decisions after the batch, so the card may stop one batch (4
# reports) apart.
REPORT_BATCH = 4
STOP_ITER_CPU_FUSED = 50
NMI_CPU_FUSED = 0.963742
# -sparse-w 4 on the same graph, seed and -lt-min-deg on the CPU: the port
# and the JAX package both stop at iteration 52, with NMI 0.957061 and
# 0.957102, after 10 sparse sweeps (annealing sweeps are the dense ones, so
# the run is the default run's until annealing ends at iteration 42)
STOP_ITER_CPU_SPARSE = 52
NMI_CPU_SPARSE = 0.957061
SPARSE_W_PLANTED = 4
# Floors of the stretch step (3 sweeps + heldout tail, training edges/s),
# one per row type, a little under the lowest reading of three runs on
# three machines (H100 80GB HBM3, 700 W, chip_smoke.py at the tree of
# 2f7a12d): 401.3-418.7 M over f32 rows, 631.3-648.4 M over bf16 rows
STRETCH_MIN_EDGES_S = 360e6
STRETCH_MIN_EDGES_S_BF16 = 570e6
# -sparse-w's width on the stretch shape (phase 3) and the floor of its
# step(3) (training edges/s), a little under the reading of the present
# kernels, 583.4 M (H100 80GB HBM3, 700 W, chip_smoke.py at the tree that
# added it; the first designs of the two sparse kernels: 495.8-497.1 M)
SPARSE_W_STRETCH = 16
STRETCH_MIN_EDGES_S_SPARSE = 520e6
PLANTED = dict(n=20_000, k=20, avg_deg=20, seed=7)
# MMSBInfer (kernel 8): the planted graph's runs of phase 2, held to the
# port's CPU rows (`python3 chip_smoke.py --record-cpu` prints them);
# kernel 8's shapes in phase 1 (n, K, pairs; -1 is one -rnode minibatch,
# the n - 1 pairs of one node), its ELBO form on all pairs of a planted
# n=2,000 graph, and the stretch step of phase 3 (s = 500,000 pairs).
MMSB_RUNS = {"mmsb": [], "mmsb-rnode": ["-rnode"],
             "mmsb-strat": ["-stratified", "-rpair"]}
MMSB_FLAGS = ["-max-iterations", "60", "-rfreq", "20"]
BATCH_PLANTED = dict(n=2_000, k=20, avg_deg=20, seed=7)
BATCH_FLAGS = ["-batch", "-logl", "-max-iterations", "3"]
# MMSBInfer above K = 512 (the rows of kernel 8 in shared memory): no
# engine flag on the planted n=2,000 graph at K=640
MMSB_WIDE_K = 640
MMSB_WIDE_FLAGS = ["-max-iterations", "10", "-rfreq", "5"]
FP_SHAPES = ((20_000, 20, 10_000), (20_000, 20, -1),
             (1_000_000, 500, 500_000), (1_000_000, 500, -1),
             (20_000, 2_000, 10_000), (20_000, 1_024, -1),
             (20_000, 8_000, 10_000))
# widest K of FP_SHAPES whose rows kernel 8 keeps in shared memory; at
# K = 8,000 fewer than four pairs' rows fit an SM and they go to device
# memory (csrc/phi_fixed_point.cu: kDeviceRows)
FP_SHARED_MAX_K = 2_000
MMSB_STRETCH_S = 500_000
# max |kernel - plain| over the largest |plain| (gamma_hat, lambda_hat), and
# relative for the ELBO sum: the plain version runs each pair for the
# rounds the kernel gave its block, in float64, and sums in other orders
FP_TOL = 1e-4
# a pair's phi in the kernel and in the plain version (f64, the same
# rounds) further apart than FP_SPLIT_PHI has gone to another attractor;
# at most FP_SPLIT_SHARE of the pairs may
FP_SPLIT_PHI = 1e-3
FP_SPLIT_SHARE = 1e-4
# the CPU rows of phase 2's MMSB runs, at 1e-4 relative: heldout.txt's
# (iteration, avg, avg0, avg1, zeros_prob*avg0, ones_prob*avg1, nshol),
# validation.txt's (none: no run passes the min(n, 5000) guard) and
# logl.txt's, as `python3 chip_smoke.py --record-cpu` printed them
MMSB_ROW_RTOL = 1e-4
MMSB_CPU_ROWS = {
    "mmsb": {
        "heldout": [
            [20, -1.857216614, -0.025314481, -3.689118635, -0.02528942,
             -0.003652226, -0.028941646],
            [40, -1.857174772, -0.025315893, -3.68903347, -0.02529083,
             -0.003652141, -0.028942972],
            [60, -1.857200815, -0.025316101, -3.689085063, -0.025291039,
             -0.003652192, -0.028943231],
        ],
        "validation": [],
        "logl": [],
    },
    "mmsb-rnode": {
        "heldout": [
            [20, -1.857109479, -0.025318356, -3.688900414, -0.025293291,
             -0.00365201, -0.0289453],
            [40, -1.857121328, -0.025316101, -3.688926334, -0.025291039,
             -0.003652035, -0.028943074],
            [60, -1.857091582, -0.025315816, -3.688867582, -0.025290753,
             -0.003651977, -0.02894273],
        ],
        "validation": [],
        "logl": [],
    },
    "mmsb-strat": {
        "heldout": [
            [20, -1.857066032, -0.025323598, -3.688808584, -0.025298527,
             -0.003651919, -0.028950446],
            [40, -1.857071093, -0.025324032, -3.688818211, -0.025298961,
             -0.003651928, -0.028950889],
            [60, -1.857078128, -0.025324336, -3.688832035, -0.025299265,
             -0.003651942, -0.028951207],
        ],
        "validation": [],
        "logl": [],
    },
    "mmsb-batch": {
        "heldout": [
            [1, -3.194748092, -0.001678791, -6.387817383, -0.001663497,
             -0.058193368, -0.059856865],
            [2, -3.124369862, -0.001928199, -6.246811416, -0.001910633,
             -0.056908796, -0.058819429],
            [3, -3.075157082, -0.002122422, -6.148192018, -0.002103087,
             -0.056010368, -0.058113455],
            [4, -3.03656576, -0.002286343, -6.070845049, -0.002265515,
             -0.055305732, -0.057571247],
        ],
        "validation": [],
        "logl": [
            [1, -1267418.0],
            [2, -1237762.0],
            [3, -1210853.0],
            [4, -1185473.0],
        ],
    },
    "mmsb-wide": {
        "heldout": [
            [5, -3.577688364, -0.00078157, -7.154594673, -0.00077445,
             -0.065178751, -0.065953201],
            [10, -3.577682998, -0.000781577, -7.154583941, -0.000774457,
             -0.065178653, -0.065953111],
        ],
        "validation": [],
        "logl": [],
    },
}
STRETCH = dict(n=1_000_000, k=500, n_edges=20_000_000)
# kernel shapes; the first of each is the one the JSON summary reports
# (its error, times and bound; every shape is asserted and logged).
# Kernel 1: (rows, K, least x, largest x), x uniform up to 10 and
# log-uniform beyond. Kernel 2: (n, K, random edges, degree of
# a hub planted at node 0); K=33 takes the 4-byte-load layout, K=640 the
# wide kernel (K > 512), and the hubs are cut into segments. Kernels 3,
# 4 and 5 run at the same shapes, on kernel 2's output; at K=640 kernels 3
# and 4 run as column tiles and the fused pass is kernel 2 then kernel 4.
DEXP_SHAPES = ((1_000_000, 500, 0.01, 10.0), (17_903, 20, 0.01, 10.0),
               (500, 2, 0.01, 10.0), (100_000, 500, 1.0, 1e6),
               (100_000, 500, 5e-3, 40.0), (4_096, 640, 0.01, 10.0))
PHI_SHAPES = ((1_000_000, 500, 2_000_000, 0), (20_000, 20, 200_000, 0),
              (1_000_000, 500, 500_000, 50_000), (20_000, 33, 200_000, 0),
              (100_000, 640, 300_000, 2_000))
# the forms of -bf16, -freeze and -prune run at the main shape, at
# planted-20k's, at K=33 with a hub (one load per value, segments), at
# K=640 (the wide kernel and column tiles) and at K=16, a compacted width
# at which two rows share a warp
FORM_SHAPES = ((1_000_000, 500, 2_000_000, 0), (20_000, 20, 200_000, 0),
               (20_000, 33, 200_000, 3_000), (100_000, 640, 300_000, 2_000),
               (20_000, 16, 200_000, 0))
# kernel 6: (n, K, held-out pairs); K=640 takes the wide kernel. The pairs
# are padded to whole blocks with weight 0, as the engine pads them
HELDOUT_SHAPES = ((1_000_000, 500, 400_000), (20_000, 20, 4_000),
                  (100_000, 640, 50_000))
# compacted sweeps (-prune): (n, full K, K_pad, active columns, random
# edges). The first is what phase 2's forced dead-column engine sweeps
# (K_pad = 8: four rows share a warp); then K_pad = 16, 64 and 256, and the
# stretch shape with 40 of its 500 columns alive
COMPACT_SHAPES = ((20_000, 20, 8, 5, 200_000), (20_000, 500, 16, 9, 200_000),
                  (1_000_000, 500, 64, 40, 2_000_000),
                  (100_000, 500, 256, 130, 300_000))
# -sparse-w: the top-W form of kernel 1 and kernel 7 at (n, K, W, random
# edges, degree of a hub at node 0). The first is the reported one; W = 8,
# 16, 32 at K=500 (32 with a hub cut into segments), W = 64 (two slots a
# lane), K=20 (planted-20k's width), K=640 and K=2000 (wider than the
# register layouts), and W = K (kernel 7's general path at K=500) against
# kernel 2 then kernel 4 with SPARSE_FULL_SHAPES. In every gamma, 60% of
# the columns sit at exactly alpha = 1/K, where the top-W picks are ties
SPARSE_SHAPES = ((1_000_000, 500, 16, 2_000_000, 0),
                 (1_000_000, 500, 8, 2_000_000, 0),
                 (1_000_000, 500, 32, 2_000_000, 50_000),
                 (100_000, 500, 64, 500_000, 0),
                 (20_000, 20, 4, 200_000, 3_000),
                 (100_000, 640, 16, 300_000, 2_000),
                 (20_000, 2_000, 32, 200_000, 0))
SPARSE_FULL_SHAPES = ((20_000, 20, 20, 200_000, 3_000),
                      (5_000, 500, 500, 50_000, 0))


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


def _index_bytes(adj):
    return 4.0 * sum(t.numel() for t in adj.tensors())


def phi_bound(n, k, n_links, adj, row_bytes=4, conv=False):
    """Elogpi read once (row_bytes a value: 4, or 2 as bf16) and gacc
    written once, the adjacency read once, with -freeze the flags too; per
    link about 8 operations per column (two adds for the logit, max,
    subtract, exp, the sum, the scale, and two accumulations less what
    fuses)."""
    return bound((row_bytes + 4.0) * n * k + 4.0 * k + _index_bytes(adj)
                 + 4.0 * n * conv, 8.0 * n_links * k)


def mean_bound(n, k, mphi_bytes=4, conv=False):
    """gacc read once, gnext written once and mphi once (mphi_bytes a
    value: 4 as f32, 2 as bf16, 6 as both), deg and sumk read, s1 and s2
    written, with -freeze the flags read and written; about 6 operations an
    element (the quotient, two sums, the add, the correction, the
    scale)."""
    return bound((8.0 + mphi_bytes) * n * k + 4.0 * n + 12.0 * k
                 + 8.0 * n * conv, 6.0 * n * k)


def s3_bound(n, k, n_links, adj, row_bytes=4, conv=False):
    """mphi read once, the adjacency read once, s3 written; a multiply
    and an add per link and column."""
    return bound(row_bytes * n * k + 4.0 * k + _index_bytes(adj)
                 + 4.0 * n * conv, 2.0 * n_links * k)


def fused_bound(n, k, n_links, adj, row_bytes=4):
    """Elogpi and mphi read once, gacc written once, the adjacency read
    once, s3 written; kernel 2's operations and kernel 4's."""
    return bound((2.0 * row_bytes + 4.0) * n * k + 8.0 * k
                 + _index_bytes(adj), 10.0 * n_links * k)


def gather_floor_ms(n, k, n_links, rows_per_link, row_bytes, other_bytes):
    """The least time for a pass over links whose gathered rows are never
    found in cache (random endpoints, arrays far larger than the 50 MB
    L2): rows_per_link rows of k values from device memory per link, plus
    other_bytes an element of (n, k) for what is read or written once in
    order. A second bound beside bound(): that one counts each row once."""
    n_bytes = (rows_per_link * n_links * k * row_bytes + other_bytes * n * k)
    return n_bytes / PEAK_BYTES_S * 1e3


def _dexp_close(got, want, times: float = 1.0) -> bool:
    """Kernel 1's bar: DEXP_ATOL, or 2^-22 of the value where that is more,
    which it is beyond -209 (two to four f32 units in the last place): a
    pad column of a compacted gamma holds alpha = 1/K, and psi(0.002) is
    near -500, where one unit is 3e-5. `times` widens both for a
    comparison of two f32 results."""
    want = torch.as_tensor(want, dtype=torch.float64, device=got.device)
    bar = (want.abs() * 2.0**-22).clamp_min(DEXP_ATOL) * times
    return bool(((got.double() - want).abs() <= bar).all())


def _report(err, ms, plain_ms, bnd):
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd[0],
                bound_by=bnd[1])


def _rel_err(got, want):
    """Largest error relative to max(1, |want|): the measure of
    allclose(rtol=atol)."""
    return float(((got - want).abs() / want.abs().clamp_min(1.0)).max())


def phase1_sweep_passes(dev):
    """Kernels 2, 3, 4 and 5 at every shape of PHI_SHAPES, each on the
    output of the one before it, as a sweep runs them."""
    from svinet_torch.svi.sweep_math import (
        LSConsts, fused_phi_s3_pass, fused_phi_s3_pass_pull_plain,
        mean_indicator_update, mean_indicator_update_plain, phi_pass,
        phi_pass_plain, phi_pass_pull_plain, s3_pass, s3_pass_plain,
        s3_pass_pull_plain)
    tol = dict(rtol=PHI_TOL, atol=PHI_TOL)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    reports = None
    for n, k, n_edges, hub_deg in PHI_SHAPES:
        links, edges, mask, nb, block, adj, elogpi, elb0 = _phi_inputs(
            dev, gen, n, k, n_edges, hub_deg)
        n_links = len(links)
        shape = (f"n={n} K={k} links={n_links} hub degree {hub_deg} "
                 f"({len(adj.seg_node)} segments)")
        assert int(adj.rowptr[-1]) == 2 * n_links
        assert (len(adj.hub_node) > 0) == (hub_deg > adj.seg_len)
        reps = 5 if n * k >= 10**7 else 50

        # ---- kernel 2
        g_k, s_k = phi_pass(elogpi, elb0, adj)
        g_2, s_2 = phi_pass(elogpi, elb0, adj)
        g_p, s_p = phi_pass_pull_plain(elogpi, elb0, adj, block)
        torch.cuda.synchronize()
        # no atomics into gacc or sumk: a second launch gives the same bits
        assert torch.equal(g_k, g_2) and torch.equal(s_k, s_2)
        del g_2
        err = float((g_k - g_p).abs().max())
        # a hub's row holds values near degree/K: relative to the row's top
        rel = float(((g_k - g_p).abs().amax(1)
                     / g_p.abs().amax(1).clamp_min(1.0)).max())
        # sumk comes out of the kernel's own per-block column sums: held to
        # the plain version's and to the plain column sum of the gacc the
        # kernel wrote, relative (values near 2E/K)
        rel_s = float(((s_k - s_p).abs() / s_p.abs()).max())
        rel_g = _rel_err(s_k, g_k.sum(dim=0))
        assert torch.allclose(g_k, g_p, **tol), err
        assert torch.allclose(s_k, s_p, **tol), rel_s
        assert torch.allclose(s_k, g_k.sum(dim=0), **tol), rel_g
        # every link adds a phi (which sums to 1) to both of its ends
        total = float(g_k.double().sum())
        assert abs(total - 2 * n_links) < 1e-3 * total, total
        del g_p
        # the edge-list plain form (the one held against JAX) agrees too
        g_e, s_e = phi_pass_plain(elogpi, elb0, edges, mask, nb)
        assert torch.allclose(g_k, g_e, **tol)
        assert torch.allclose(s_k, s_e, **tol)
        del g_e
        ms = cuda_ms(lambda: phi_pass(elogpi, elb0, adj), reps)
        plain_ms = cuda_ms(
            lambda: phi_pass_pull_plain(elogpi, elb0, adj, block), reps)
        bnd = phi_bound(n, k, n_links, adj)
        log(f"phase 1: phi_pass {shape}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms "
            f"({bnd[1]}), max abs err gacc {err:.3e} (relative to the "
            f"row's largest value {rel:.3e}), max rel err sumk "
            f"{rel_s:.3e} (against gacc.sum(0) {rel_g:.3e}), two launches "
            f"bitwise equal")
        rep_phi = _report(err, ms, plain_ms, bnd)

        # ---- kernel 3, on kernel 2's gacc and sumk; the update is in
        # place, so every call gets its own copy
        deg = torch.as_tensor(
            np.bincount(links.ravel(), minlength=n).astype(np.float32),
            device=dev)
        consts = LSConsts.make(1.0 / k, 1.0, 1.0, n_links, n)
        err3 = 0.0
        for annealing in (False, True):
            got = mean_indicator_update(g_k.clone(), s_k, deg, consts,
                                        annealing)
            again = mean_indicator_update(g_k.clone(), s_k, deg, consts,
                                          annealing)
            want = mean_indicator_update_plain(g_k.clone(), s_k, deg, consts,
                                               annealing)
            torch.cuda.synchronize()
            for name, a, b, c in zip(("gnext", "mphi", "s1", "s2", "lam0"),
                                     got, again, want):
                assert torch.equal(a, b), (name, "two launches differ")
                assert torch.allclose(a, c, **tol), (name, annealing,
                                                     _rel_err(a, c))
                err3 = max(err3, _rel_err(a, c))
            del again, want
        mphi = got[1]
        del got
        scratch = g_k.clone()
        # repeated in place the values pass f32's range; the card's
        # arithmetic takes the same time on them
        ms = cuda_ms(lambda: mean_indicator_update(scratch, s_k, deg, consts,
                                                   True), reps)
        plain_ms = cuda_ms(lambda: mean_indicator_update_plain(
            scratch, s_k, deg, consts, True), reps)
        del scratch
        bnd = mean_bound(n, k)
        log(f"phase 1: mean_indicator_update {shape}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), "
            f"max err (relative to max(1, |plain|)) over gnext, mphi, s1, "
            f"s2 with and without annealing {err3:.3e}, two launches "
            f"bitwise equal")
        rep_mean = _report(err3, ms, plain_ms, bnd)

        # ---- kernel 4, on kernel 3's mphi
        s3_k = s3_pass(mphi, adj)
        assert torch.equal(s3_k, s3_pass(mphi, adj))
        s3_p = s3_pass_pull_plain(mphi, adj, block)
        s3_e = s3_pass_plain(mphi, edges, mask, nb)
        torch.cuda.synchronize()
        err4 = _rel_err(s3_k, s3_p)
        assert torch.allclose(s3_k, s3_p, **tol), err4
        assert torch.allclose(s3_k, s3_e, **tol), _rel_err(s3_k, s3_e)
        assert float(s3_k.min()) > 0.0
        ms = cuda_ms(lambda: s3_pass(mphi, adj), reps)
        plain_ms = cuda_ms(lambda: s3_pass_pull_plain(mphi, adj, block), reps)
        bnd = s3_bound(n, k, n_links, adj)
        log(f"phase 1: s3_pass {shape}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), max err "
            f"(relative to max(1, |plain|)) {err4:.3e}, two launches "
            f"bitwise equal")
        rep_s3 = _report(err4, ms, plain_ms, bnd)

        # ---- kernel 5: the one launch wherever it has a form (K <= 512).
        # Left to itself the wrapper takes it only for launch-sized passes
        # and kernel 2 then kernel 4 otherwise; here it is forced so that
        # it is checked and timed at the main shape too
        def fused():
            return fused_phi_s3_pass(elogpi, mphi, elb0, adj,
                                     one_launch=k <= 512)

        before = fused_phi_s3_pass.launches
        f_g, f_s, f_3 = fused()
        f_g2, _, f_32 = fused()
        assert fused_phi_s3_pass.launches - before == (2 if k <= 512 else 0)
        p_g, p_s, p_3 = fused_phi_s3_pass_pull_plain(elogpi, mphi, elb0, adj,
                                                     block)
        torch.cuda.synchronize()
        assert torch.equal(f_g, f_g2) and torch.equal(f_3, f_32)
        del f_g2
        err5 = max(float((f_g - p_g).abs().max()), _rel_err(f_3, p_3))
        assert torch.allclose(f_g, p_g, **tol), err5
        assert torch.allclose(f_s, p_s, **tol)
        assert torch.allclose(f_3, p_3, **tol), err5
        # the same as kernel 2 followed by kernel 4
        assert torch.allclose(f_g, g_k, **tol)
        assert torch.allclose(f_3, s3_k, **tol)
        del f_g, p_g, g_k
        ms = cuda_ms(fused, reps)
        ms_24 = cuda_ms(lambda: (phi_pass(elogpi, elb0, adj),
                                 s3_pass(mphi, adj)), reps)
        plain_ms = cuda_ms(lambda: fused_phi_s3_pass_pull_plain(
            elogpi, mphi, elb0, adj, block), reps)
        bnd = fused_bound(n, k, n_links, adj)
        log(f"phase 1: fused_phi_s3_pass {shape}: "
            f"{'kernel' if k <= 512 else 'kernel 2 then kernel 4'} "
            f"{ms:.4f} ms, kernel 2 then kernel 4 {ms_24:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), "
            f"uncached-gather floor (3 rows a link) "
            f"{gather_floor_ms(n, k, n_links, 3, 4, 12):.4f} ms, max err "
            f"gacc (abs) and s3 (relative) {err5:.3e}, two launches bitwise "
            f"equal")
        rep_fused = _report(err5, ms, plain_ms, bnd)
        if reports is None:
            reports = dict(phi_pass=rep_phi, mean_indicator_update=rep_mean,
                           s3_pass=rep_s3, fused_phi_s3_pass=rep_fused)
        del elogpi, mphi, edges, mask, adj
        torch.cuda.empty_cache()
    return reports


def _random_conv(gen, n, k, dev):
    """Converged flags for about 40% of the nodes, each frozen to a random
    column; the last column (flag K) is among them."""
    col = torch.randint(1, k + 1, (n,), generator=gen, device=dev)
    frozen = torch.rand(n, generator=gen, device=dev) < 0.4
    conv = torch.where(frozen, col, 0).to(torch.int32)
    conv[:: max(n // 64, 1)] = k
    return conv


def phase1_forms(dev):
    """The forms -bf16, -freeze and -prune add to kernels 1-5, each against
    its plain version on the same inputs (bf16 forms on identical bf16
    bits) at PHI_TOL, two launches bitwise equal, at every shape of
    FORM_SHAPES; times at each shape beside the f32 form's."""
    from svinet_torch.ops.digamma import (
        dirichlet_expectation, dirichlet_expectation_plain)
    from svinet_torch.svi.sweep_math import (
        LSConsts, converged_of, fused_phi_s3_pass,
        fused_phi_s3_pass_pull_plain, mean_indicator_update,
        mean_indicator_update_plain, phi_pass, phi_pass_pull_plain, s3_pass,
        s3_pass_pull_plain)
    tol = dict(rtol=PHI_TOL, atol=PHI_TOL)
    bf = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    reports = None
    for n, k, n_edges, hub_deg in FORM_SHAPES:
        links, _, _, _, block, adj, elogpi, elb0 = _phi_inputs(
            dev, gen, n, k, n_edges, hub_deg)
        n_links = len(links)
        shape = f"n={n} K={k} links={n_links} hub degree {hub_deg}"
        reps = 5 if n * k >= 10**7 else 50
        rep = {}

        def check(name, got, again, want, how=_rel_err):
            assert torch.equal(got, again), (name, shape, "launches differ")
            assert torch.allclose(got, want, **tol), (name, shape,
                                                      how(got, want))
            return how(got, want)

        # ---- kernel 1: bf16 out, and the scalar rest
        gamma = 0.01 + 9.99 * torch.rand((n, k), generator=gen, device=dev)
        f32 = dirichlet_expectation(gamma)
        got = dirichlet_expectation(gamma, out_dtype=bf)
        want = dirichlet_expectation_plain(gamma, out_dtype=bf)
        torch.cuda.synchronize()
        # the same arithmetic as the f32 form, rounded to nearest even in
        # the store: bit for bit the f32 result cast to bf16
        assert got.dtype == bf and torch.equal(got, f32.to(bf))
        # against the plain version a 5e-5 difference before the rounding
        # can move a value to the neighbouring bf16: one unit, 2^-7 of it
        err_b = float((got.float() - want.float()).abs().max())
        assert torch.allclose(got.float(), want.float(), rtol=2.0**-7,
                              atol=DEXP_ATOL), err_b
        rest = 0.25 * k
        got_r = dirichlet_expectation(gamma, rest=rest)
        want_r = dirichlet_expectation_plain(gamma, rest=rest)
        torch.cuda.synchronize()
        err_r = float((got_r - want_r).abs().max())
        assert err_r < DEXP_ATOL, err_r
        ms_f = cuda_ms(lambda: dirichlet_expectation(gamma), reps)
        ms_b = cuda_ms(lambda: dirichlet_expectation(gamma, out_dtype=bf),
                       reps)
        ms_cast = cuda_ms(lambda: dirichlet_expectation(gamma).to(bf), reps)
        plain_b = cuda_ms(lambda: dirichlet_expectation_plain(
            gamma, out_dtype=bf), reps)
        ms_r = cuda_ms(lambda: dirichlet_expectation(gamma, rest=rest), reps)
        plain_r = cuda_ms(lambda: dirichlet_expectation_plain(
            gamma, rest=rest), reps)
        rep["dirichlet_expectation:bf16"] = _report(
            err_b, ms_b, plain_b, bound(6.0 * n * k, 40.0 * n * k))
        rep["dirichlet_expectation:f32+rest"] = _report(
            err_r, ms_r, plain_r, bound(8.0 * n * k, 40.0 * n * k))
        log(f"phase 1: dirichlet_expectation forms ({n}, {k}): bf16 out "
            f"{ms_b:.4f} ms (f32 out {ms_f:.4f} ms, f32 out then a cast "
            f"{ms_cast:.4f} ms, plain {plain_b:.4f} ms), equal bit for bit "
            f"to the f32 result rounded to nearest even, max abs err vs "
            f"plain bf16 {err_b:.3e}; with rest {ms_r:.4f} ms (plain "
            f"{plain_r:.4f} ms), max abs err {err_r:.3e}")
        del gamma, f32, got, want, got_r, want_r

        conv = _random_conv(gen, n, k, dev)
        elogpi_b = elogpi.to(bf)

        # ---- kernel 2: bf16 rows, frozen nodes, both
        g_f32 = None
        for name, rows, cv in (("bf16", elogpi_b, None),
                               ("f32+conv", elogpi, conv),
                               ("bf16+conv", elogpi_b, conv)):
            g_k, s_k = phi_pass(rows, elb0, adj, cv)
            g_2, _ = phi_pass(rows, elb0, adj, cv)
            g_p, s_p = phi_pass_pull_plain(rows, elb0, adj, block, cv)
            torch.cuda.synchronize()
            err = check(f"phi_pass:{name}", g_k, g_2, g_p,
                        lambda a, b: float((a - b).abs().max()))
            assert torch.allclose(s_k, s_p, **tol)
            total = float(g_k.double().sum())
            assert abs(total - 2 * n_links) < 1e-3 * total, total
            del g_2, g_p
            ms = cuda_ms(lambda: phi_pass(rows, elb0, adj, cv), reps)
            plain_ms = cuda_ms(lambda: phi_pass_pull_plain(
                rows, elb0, adj, block, cv), reps)
            rep[f"phi_pass:{name}"] = _report(
                err, ms, plain_ms, phi_bound(
                    n, k, n_links, adj, 2 if rows.dtype == bf else 4,
                    cv is not None))
            if name == "f32+conv":
                g_f32 = g_k
        ms_f = cuda_ms(lambda: phi_pass(elogpi, elb0, adj), reps)
        floors = {name: gather_floor_ms(n, k, n_links, 2, rb, rb + 4)
                  for name, rb in (("f32", 4), ("bf16", 2))}
        log(f"phase 1: phi_pass forms {shape}: f32 {ms_f:.4f} ms, " + ", ".join(
            f"{name} {rep[f'phi_pass:{name}']['ms']:.4f} ms (plain "
            f"{rep[f'phi_pass:{name}']['plain_ms']:.4f}, bound "
            f"{rep[f'phi_pass:{name}']['bound_ms']:.4f}, max abs err "
            f"{rep[f'phi_pass:{name}']['max_abs_err']:.3e})"
            for name in ("bf16", "f32+conv", "bf16+conv"))
            + f"; uncached-gather floor f32 {floors['f32']:.4f} ms, bf16 "
            f"{floors['bf16']:.4f} ms; two launches bitwise equal")

        # ---- kernel 3: the bf16 copy of mphi and the converged flags, on
        # a gacc where every third row has one column that holds all of its
        # mass, so that flags are set
        deg = torch.as_tensor(
            np.bincount(links.ravel(), minlength=n).astype(np.float32),
            device=dev)
        consts = LSConsts.make(1.0 / k, 1.0, 1.0, n_links, n)
        gacc = g_f32
        sumk = gacc.sum(0)
        lone = torch.randint(0, k, (n,), generator=gen, device=dev)
        lone[:: max(n // 64, 1) * 3] = k - 1
        third = torch.arange(0, n, 3, device=dev)
        gacc[third] = 0.0
        gacc[third, lone[third]] = deg[third]
        k3_forms = (("bf16", dict(mphi_f32=False, mphi_bf16=True)),
                    ("f32+bf16", dict(mphi_bf16=True)),
                    ("f32+conv", dict(conv=conv)),
                    ("bf16+conv", dict(mphi_f32=False, mphi_bf16=True,
                                       conv=conv)),
                    ("f32+bf16+conv", dict(mphi_bf16=True, conv=conv)))
        err3 = {name: 0.0 for name, _ in k3_forms}
        for annealing in (False, True):
            want = mean_indicator_update_plain(gacc.clone(), sumk, deg,
                                               consts, annealing)
            want_b = want[1].to(bf)
            for name, kw in k3_forms:
                got = mean_indicator_update(gacc.clone(), sumk, deg, consts,
                                            annealing, **kw)
                again = mean_indicator_update(gacc.clone(), sumk, deg, consts,
                                              annealing, **kw)
                torch.cuda.synchronize()
                for part, a, b, c in zip(("gnext", "mphi", "s1", "s2", "lam0"),
                                         got, again, want):
                    if a is None:       # this form writes no f32 mphi
                        assert part == "mphi" and not kw["mphi_f32"]
                        continue
                    err3[name] = max(err3[name], check(
                        f"mean_indicator_update:{name} {part}", a, b, c))
                if "bf16" in name:
                    # the bf16 rows are the f32 mphi rounded to nearest
                    # even: exactly, where this launch wrote both; within
                    # one bf16 step of the plain version's otherwise
                    assert torch.equal(got.mphi_bf16, again.mphi_bf16)
                    if got.mphi is not None:
                        assert torch.equal(got.mphi_bf16, got.mphi.to(bf))
                    assert torch.allclose(got.mphi_bf16.float(),
                                          want_b.float(), rtol=2.0**-7,
                                          atol=PHI_TOL), name
                else:
                    assert got.mphi_bf16 is None
                if "conv" in name:
                    # the flags are those of the gnext the kernel wrote
                    assert torch.equal(got.conv, again.conv)
                    assert torch.equal(got.conv, converged_of(
                        got.gnext, consts.alpha, conv))
                    if not annealing:   # the scale can lift a second column
                        fresh = int((got.conv != conv).sum())
                        assert fresh > 0 and int((got.conv == k).sum()) > 0, \
                            fresh
                else:
                    assert got.conv is None
                if name == "f32+bf16+conv":
                    mphi = got.mphi
                del got, again
            del want, want_b
        scratch = gacc.clone()
        timings = {"f32": cuda_ms(lambda: mean_indicator_update(
            scratch, sumk, deg, consts, True), reps)}
        for name, kw in k3_forms[:4]:
            timings[name] = cuda_ms(lambda: mean_indicator_update(
                scratch, sumk, deg, consts, True, **kw), reps)
        plain_ms = cuda_ms(lambda: mean_indicator_update_plain(
            scratch, sumk, deg, consts, True), reps)
        plain_cv = cuda_ms(lambda: converged_of(scratch, consts.alpha, conv),
                           reps)
        plain_cast = cuda_ms(lambda: mphi.to(bf), reps)
        del scratch
        for name in timings:
            if name == "f32":
                continue
            extra = ((plain_cast if "bf16" in name else 0.0)
                     + (plain_cv if "conv" in name else 0.0))
            rep[f"mean_indicator_update:{name}"] = _report(
                err3[name], timings[name], plain_ms + extra, mean_bound(
                    n, k, {"bf16": 2, "f32+bf16": 6, "f32+conv": 4,
                           "bf16+conv": 2}[name], "conv" in name))
        log(f"phase 1: mean_indicator_update forms {shape}: " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in timings.items())
            + f"; plain update {plain_ms:.4f} ms, plain converged_of "
            f"{plain_cv:.4f} ms, plain cast to bf16 {plain_cast:.4f} ms; max "
            f"err of each form against the plain version, with and without "
            f"annealing: " + ", ".join(
                f"{name} {e:.3e}" for name, e in err3.items())
            + f"; {fresh} flags changed; bf16 mphi and flags exact, two "
            f"launches bitwise equal")
        del gacc, g_f32

        # ---- kernel 4: bf16 rows, frozen nodes (the frozen column K
        # included), both
        mphi_b = mphi.to(bf)
        for name, rows, cv in (("bf16", mphi_b, None),
                               ("f32+conv", mphi, conv),
                               ("bf16+conv", mphi_b, conv)):
            s3_k = s3_pass(rows, adj, cv)
            s3_2 = s3_pass(rows, adj, cv)
            s3_p = s3_pass_pull_plain(rows, adj, block, cv)
            torch.cuda.synchronize()
            err = check(f"s3_pass:{name}", s3_k, s3_2, s3_p)
            ms = cuda_ms(lambda: s3_pass(rows, adj, cv), reps)
            plain_ms = cuda_ms(lambda: s3_pass_pull_plain(
                rows, adj, block, cv), reps)
            rep[f"s3_pass:{name}"] = _report(
                err, ms, plain_ms, s3_bound(
                    n, k, n_links, adj, 2 if rows.dtype == bf else 4,
                    cv is not None))
        ms_f = cuda_ms(lambda: s3_pass(mphi, adj), reps)
        floors = {name: gather_floor_ms(n, k, n_links, 1, rb, rb)
                  for name, rb in (("f32", 4), ("bf16", 2))}
        log(f"phase 1: s3_pass forms {shape}: f32 {ms_f:.4f} ms, " + ", ".join(
            f"{name} {rep[f's3_pass:{name}']['ms']:.4f} ms (plain "
            f"{rep[f's3_pass:{name}']['plain_ms']:.4f}, bound "
            f"{rep[f's3_pass:{name}']['bound_ms']:.4f}, max err "
            f"{rep[f's3_pass:{name}']['max_abs_err']:.3e})"
            for name in ("bf16", "f32+conv", "bf16+conv"))
            + f"; uncached-gather floor f32 {floors['f32']:.4f} ms, bf16 "
            f"{floors['bf16']:.4f} ms; two launches bitwise equal")

        # ---- kernel 5 over bf16 rows, in one launch where it has a form
        def fused(e=elogpi_b, m=mphi_b):
            return fused_phi_s3_pass(e, m, elb0, adj, one_launch=k <= 512)

        f_g, f_s, f_3 = fused()
        f_g2, _, f_32 = fused()
        p_g, p_s, p_3 = fused_phi_s3_pass_pull_plain(elogpi_b, mphi_b, elb0,
                                                     adj, block)
        torch.cuda.synchronize()
        err5 = max(check("fused gacc", f_g, f_g2, p_g,
                         lambda a, b: float((a - b).abs().max())),
                   check("fused s3", f_3, f_32, p_3))
        assert torch.allclose(f_s, p_s, **tol)
        del f_g, f_g2, p_g
        ms = cuda_ms(fused, reps)
        ms_24 = cuda_ms(lambda: (phi_pass(elogpi_b, elb0, adj),
                                 s3_pass(mphi_b, adj)), reps)
        ms_f = cuda_ms(lambda: fused(elogpi, mphi), reps)
        plain_ms = cuda_ms(lambda: fused_phi_s3_pass_pull_plain(
            elogpi_b, mphi_b, elb0, adj, block), reps)
        rep["fused_phi_s3_pass:bf16"] = _report(
            err5, ms, plain_ms, fused_bound(n, k, n_links, adj, 2))
        log(f"phase 1: fused_phi_s3_pass over bf16 rows {shape}: "
            f"{'kernel' if k <= 512 else 'kernel 2 then kernel 4'} "
            f"{ms:.4f} ms (f32 rows {ms_f:.4f} ms, kernel 2 then kernel 4 "
            f"over bf16 rows {ms_24:.4f} ms, plain {plain_ms:.4f} ms), max "
            f"err {err5:.3e}, two launches bitwise equal")
        if reports is None:
            reports = rep
        del elogpi, elogpi_b, mphi, mphi_b, adj
        torch.cuda.empty_cache()
    return reports


def phase1_compact(dev):
    """A compacted sweep's launches of kernels 1 to 4 (-prune) at every
    shape of COMPACT_SHAPES: gamma with its pad columns at alpha and the
    scalar rest, Elogbeta0 = -1e30 in the pad columns. Each kernel against
    its plain version on the same inputs (kernel 1 also against float64
    scipy, both by _dexp_close; the others at PHI_TOL), two launches
    bitwise equal, and the pad columns exact:
    phi sums 0, mphi 0, s3 0, gnext alpha, lambda eta. Then kernels 2, 3
    and 4 with frozen-node flags over the compacted columns."""
    from scipy.special import digamma
    from svinet_torch.ops.digamma import (
        dirichlet_expectation, dirichlet_expectation_plain)
    from svinet_torch.svi.linksampling import PAD_LOGIT
    from svinet_torch.svi.sweep_math import (
        LSConsts, converged_of, finish_lambda, mean_indicator_update,
        mean_indicator_update_plain, phi_pass, phi_pass_pull_plain, s3_pass,
        s3_pass_pull_plain)
    from svinet_torch.ops.edges import build_adjacency, choose_edge_block
    from svinet_torch.synth import random_edges
    tol = dict(rtol=PHI_TOL, atol=PHI_TOL)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    for n, k_full, kpad, ka, n_edges in COMPACT_SHAPES:
        links = random_edges(n, n_edges, 5)
        n_links = len(links)
        adj = build_adjacency(links, n, dev)
        block = choose_edge_block(n_links, kpad)
        deg = torch.as_tensor(
            np.bincount(links.ravel(), minlength=n).astype(np.float32),
            device=dev)
        consts = LSConsts.make(1.0 / k_full, 1.0, 1.0, n_links, n)
        alpha = consts.alpha
        rest = float(np.float32((k_full - kpad) * alpha))
        shape = (f"n={n} K={k_full} compacted to K_pad={kpad} ({ka} active) "
                 f"links={n_links}")
        reps = 5 if n * kpad >= 10**7 else 50
        gamma = torch.full((n, kpad), alpha, device=dev)
        gamma[:, :ka] += 5.0 * torch.rand((n, ka), generator=gen, device=dev)
        lam = torch.ones((kpad, 2), device=dev)
        lam[:ka] += 4.0 * torch.rand((ka, 2), generator=gen, device=dev)
        real = torch.arange(kpad, device=dev) < ka

        def pads(t, value, what):
            """The pad columns (the last axis) hold `value` exactly."""
            assert bool((t[..., ka:] == value).all()), (what, shape)

        # ---- kernel 1 with rest
        elogpi = dirichlet_expectation(gamma, rest=rest)
        want = dirichlet_expectation_plain(gamma, rest=rest)
        torch.cuda.synchronize()
        assert torch.equal(elogpi, dirichlet_expectation(gamma, rest=rest))
        err1 = float((elogpi - want).abs().max())
        # the plain version is f32 too: twice the bar between the two
        assert _dexp_close(elogpi, want, 2.0), (err1, shape)
        idx = torch.randperm(n, generator=gen, device=dev)[:4096]
        xs = gamma[idx].double().cpu().numpy()
        ref = digamma(xs) - digamma(xs.sum(axis=1, keepdims=True) + rest)
        err1_f64 = float(np.abs(elogpi[idx].cpu().numpy() - ref).max())
        assert _dexp_close(elogpi[idx], ref), (err1_f64, shape)
        # rest is in the normalizer: without it psi of the row sum differs
        assert not torch.allclose(dirichlet_expectation(gamma), elogpi,
                                  rtol=0.0, atol=1e-4)
        ms1 = cuda_ms(lambda: dirichlet_expectation(gamma, rest=rest), reps)
        elb0 = torch.where(
            real, dirichlet_expectation(lam)[:, 0].contiguous(), PAD_LOGIT)
        del want

        # ---- kernel 2 on -1e30 pad logits
        g_k, s_k = phi_pass(elogpi, elb0, adj)
        g_2, _ = phi_pass(elogpi, elb0, adj)
        g_p, s_p = phi_pass_pull_plain(elogpi, elb0, adj, block)
        torch.cuda.synchronize()
        assert torch.equal(g_k, g_2), (shape, "launches differ")
        assert torch.isfinite(g_k).all(), shape
        err2 = float((g_k - g_p).abs().max())
        assert torch.allclose(g_k, g_p, **tol), (err2, shape)
        assert torch.allclose(s_k, s_p, **tol), shape
        pads(g_k, 0.0, "gacc")
        pads(s_k, 0.0, "sumk")
        total = float(g_k.double().sum())
        assert abs(total - 2 * n_links) < 1e-3 * total, (total, shape)
        ms2 = cuda_ms(lambda: phi_pass(elogpi, elb0, adj), reps)
        plain2 = cuda_ms(lambda: phi_pass_pull_plain(elogpi, elb0, adj,
                                                     block), reps)
        del g_2, g_p

        # ---- kernel 3 (a compacted sweep never anneals)
        got = mean_indicator_update(g_k.clone(), s_k, deg, consts, False)
        again = mean_indicator_update(g_k.clone(), s_k, deg, consts, False)
        want = mean_indicator_update_plain(g_k.clone(), s_k, deg, consts,
                                           False)
        torch.cuda.synchronize()
        err3 = 0.0
        for part, a, b, c in zip(("gnext", "mphi", "s1", "s2", "lam0"), got,
                                 again, want):
            assert torch.equal(a, b), (part, shape, "launches differ")
            assert torch.allclose(a, c, **tol), (part, shape, _rel_err(a, c))
            err3 = max(err3, _rel_err(a, c))
        pads(got.gnext, alpha, "gnext")
        pads(got.mphi, 0.0, "mphi")
        scratch = g_k.clone()
        ms3 = cuda_ms(lambda: mean_indicator_update(scratch, s_k, deg, consts,
                                                    False), reps)
        del again, want, scratch

        # ---- kernel 4
        s3_k = s3_pass(got.mphi, adj)
        s3_p = s3_pass_pull_plain(got.mphi, adj, block)
        torch.cuda.synchronize()
        assert torch.equal(s3_k, s3_pass(got.mphi, adj)), shape
        err4 = _rel_err(s3_k, s3_p)
        assert torch.allclose(s3_k, s3_p, **tol), (err4, shape)
        pads(s3_k, 0.0, "s3")
        ms4 = cuda_ms(lambda: s3_pass(got.mphi, adj), reps)
        # the sweep's lambda: its pad rows are (eta0, eta1) exactly
        lam_next = finish_lambda(got.s1, got.s2, s3_k, got.lam0, consts)
        pads(lam_next[:, 0], consts.eta0, "lambda 0")
        pads(lam_next[:, 1], consts.eta1, "lambda 1")

        # ---- -freeze over compacted columns: flags 1..ka, none on a pad
        conv = torch.where(
            torch.rand(n, generator=gen, device=dev) < 0.4,
            torch.randint(1, ka + 1, (n,), generator=gen, device=dev),
            0).to(torch.int32)
        c_k, _ = phi_pass(elogpi, elb0, adj, conv)
        c_p, _ = phi_pass_pull_plain(elogpi, elb0, adj, block, conv)
        torch.cuda.synchronize()
        assert torch.equal(c_k, phi_pass(elogpi, elb0, adj, conv)[0]), shape
        err2c = float((c_k - c_p).abs().max())
        assert torch.allclose(c_k, c_p, **tol), (err2c, shape)
        pads(c_k, 0.0, "gacc with flags")
        del c_p
        out = mean_indicator_update(c_k, c_k.sum(0), deg, consts, False,
                                    conv=conv)
        assert torch.equal(out.conv, converged_of(out.gnext, alpha, conv))
        pads(out.gnext, alpha, "gnext with flags")
        s3_c = s3_pass(out.mphi, adj, conv)
        s3_cp = s3_pass_pull_plain(out.mphi, adj, block, conv)
        torch.cuda.synchronize()
        assert torch.equal(s3_c, s3_pass(out.mphi, adj, conv)), shape
        err4c = _rel_err(s3_c, s3_cp)
        assert torch.allclose(s3_c, s3_cp, **tol), (err4c, shape)
        pads(s3_c, 0.0, "s3 with flags")
        log(f"phase 1: compacted sweep {shape}: kernel 1 with rest "
            f"{ms1:.4f} ms (max abs err vs plain {err1:.3e}, vs scipy f64 "
            f"{err1_f64:.3e}), kernel 2 on -1e30 pad "
            f"logits {ms2:.4f} ms (plain {plain2:.4f} ms, max abs err "
            f"{err2:.3e}; with flags {err2c:.3e}), kernel 3 {ms3:.4f} ms (max "
            f"err {err3:.3e}), kernel 4 {ms4:.4f} ms (max err {err4:.3e}; "
            f"with flags {err4c:.3e}); pad columns exact (phi sums, mphi and "
            f"s3 0, gnext alpha, lambda eta), all finite, two launches "
            f"bitwise equal")
        del gamma, elogpi, g_k, got, out, c_k, adj
        torch.cuda.empty_cache()


def _tied_gamma(gen, n, k, dev):
    """gamma with 60% of its entries at exactly alpha = 1/K (tied), the
    rest in [0.01, 10] skewed low; every 97th row at alpha throughout."""
    alpha = 1.0 / k
    u = torch.rand((n, k), generator=gen, device=dev)
    g = torch.where(u < 0.6, alpha, 0.01 + 10.0 * (u - 0.6) ** 2 / 0.16)
    g[::97] = alpha
    return g.contiguous()


def topw_bound(n, k, w):
    """gamma read once, Elogpi written once, ids, topvals and topm written
    once and the mean indicators read at the picks; kernel 1's 40
    operations an element and, per row, the selection's bitonic sort of
    the group's maxima and of the picks (15 steps of a 32-lane group, about
    8 operations a lane each, twice) and its counts (about 6 a column)."""
    return bound(8.0 * n * k + 16.0 * n * w,
                 40.0 * n * k + 2 * 15 * 8 * 32.0 * n + 6.0 * n * k)


def _union_counts(ids, adj, k):
    """What kernel 7 reads on these inputs, from the lists themselves:
    (distinct (node, column) values of Elogpi it needs, distinct values of
    mphi it needs, kept slots of q's lists over the links (each link once),
    p-side and q-side slots met over the directed entries)."""
    from svinet_torch.svi.sweep_math import _pull_entries
    n, w = ids.shape
    need_e = torch.zeros(n * k, dtype=torch.bool, device=ids.device)
    need_m = torch.zeros(n * k, dtype=torch.bool, device=ids.device)
    kept_links = 0
    for p, q in _pull_entries(adj, 1 << 18):
        idp, idq = ids[p].long(), ids[q].long()
        in_p = torch.zeros((p.shape[0], k), dtype=torch.bool, device=p.device)
        in_p.scatter_(1, idp, True)
        kept = ~in_p.gather(1, idq)
        need_e[(q[:, None] * k + idp).flatten()] = True
        need_e[(p[:, None] * k + idq)[kept]] = True
        low = q > p
        kept_links += int(kept[low].sum())
        for node in (p[low, None], q[low, None]):
            need_m[(node * k + idp[low]).flatten()] = True
            need_m[(node * k + idq[low])[kept[low]]] = True
    return int(need_e.sum()), int(need_m.sum()), kept_links


def union_bound_floor(n, k, w, n_links, adj, counts, layout="rows"):
    """(bound, floor, sectors) of kernel 7 on these inputs.

    Bound: each value it needs read once at 4 bytes (the distinct Elogpi
    and mphi values, ids, topvals and topm, the adjacency), gacc written
    once; per slot of a directed entry about 8 operations (two adds, max,
    subtract, exp, sum, divide, add) and 2 per s3 term.

    Floor: one 32-byte sector per gathered value, plus what is read or
    written once in order. `layout` "rows", the present kernel: Elogpi
    and the mean indicators side by side in (n, K, 2) rows, so the pair at
    the owner's W columns of the neighbour's row is one sector (2E W), the
    neighbour's ids and topvals are read in sectors beside each other a
    directed entry and its topm a link (2 * 2E + E sectors of 4W bytes
    rounded up); the owner's pairs at the neighbour's columns come from
    its own row, read once (8 bytes an element), and gacc is written once
    (4). At n=1M, K=500, 19.9M links, W=16: 2E W + 2E 4 + 2E, about 0.84 G
    sectors. "apart", the first design (csrc/alt/sparse_union_v1.cu):
    Elogpi and mphi apart, so W sectors of the neighbour's Elogpi a
    directed entry, W of its mphi at the owner's columns and the kept slots
    of its mphi at its own columns a link, its ids and topvals a directed
    entry; about 1.42 G sectors there. Random sectors come at about 32 G/s
    on an H100 (tools/bench_kernels.py --only sectors), not at the 3.35
    TB/s the floor divides by."""
    need_e, need_m, kept = counts
    entries = 2 * n_links
    lists = 3 if layout == "rows" else 2
    b = bound(4.0 * (need_e + need_m) + 4.0 * lists * n * w + 4.0 * n * k
              + _index_bytes(adj) + 12.0 * k,
              8.0 * entries * 2 * w + 2.0 * (n_links * w + kept))
    list_sectors = -(-4 * w // 32)
    if layout == "rows":
        sectors = (entries * w + 2 * entries * list_sectors
                   + n_links * list_sectors)
    else:
        sectors = (entries * w + n_links * w + kept
                   + 2 * entries * list_sectors)
    floor = (32.0 * sectors + 12.0 * n * k) / PEAK_BYTES_S * 1e3
    return b, floor, sectors


def phase1_sparse(dev):
    """-sparse-w's two kernels at every shape of SPARSE_SHAPES: the top-W
    form of kernel 1, writing Elogpi into the (n, K, 2) rows of the sparse
    sweep and reading topm from them, against
    dirichlet_expectation_topw_plain (ids and topm exactly equal, values at
    kernel 1's bar); kernel 3 writing mphi into the rows' odd half (whole
    pairs, 0 in the even half) against its contiguous form, bit for bit;
    then kernel 7 on the form's output
    against sparse_union_pass_pull_plain and the edge-list form held to JAX
    (PHI_TOL abs/rel), two launches of each bitwise equal; at W = K
    (SPARSE_FULL_SHAPES) kernel 7 against kernel 2 then kernel 4. Returns
    the reports of the first shape."""
    from svinet_torch.ops.digamma import (
        dirichlet_expectation_topw, dirichlet_expectation_topw_plain)
    from svinet_torch.svi.sweep_math import (
        LSConsts, mean_indicator_update, phi_pass, s3_pass,
        sparse_union_occupancy, sparse_union_pass, sparse_union_pass_plain,
        sparse_union_pass_pull_plain)
    tol = dict(rtol=PHI_TOL, atol=PHI_TOL)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    reports = None
    for n, k, w, n_edges, hub_deg in SPARSE_SHAPES + SPARSE_FULL_SHAPES:
        links, edges, mask, nb, block, adj, _, elb0 = _phi_inputs(
            dev, gen, n, k, n_edges, hub_deg)
        n_links = len(links)
        shape = (f"n={n} K={k} W={w} links={n_links} hub degree {hub_deg} "
                 f"({len(adj.seg_node)} segments)")
        reps = 5 if n * k >= 10**7 else 50
        gamma = _tied_gamma(gen, n, k, dev)
        mphi = 0.2 * torch.rand((n, k), generator=gen, device=dev)

        # ---- the top-W form of kernel 1, into the rows kernel 7 gathers
        rows = torch.empty((n, k, 2), device=dev)
        rows[..., 1] = mphi
        rows_2 = rows.clone()
        e_k, i_k, v_k, m_k = dirichlet_expectation_topw(gamma, w, pair=rows)
        _, i_2, v_2, m_2 = dirichlet_expectation_topw(gamma, w, pair=rows_2)
        rows_p = rows_2.clone()
        e_p, i_p, v_p, m_p = dirichlet_expectation_topw_plain(gamma, w,
                                                              pair=rows_p)
        torch.cuda.synchronize()
        assert torch.equal(rows, rows_2) and torch.equal(i_k, i_2)
        assert torch.equal(v_k, v_2) and torch.equal(m_k, m_2)
        assert torch.equal(rows[..., 1], mphi), "the odd half was written"
        assert torch.equal(i_k, i_p), (shape, "ids differ",
                                       int((i_k != i_p).sum()))
        assert torch.equal(m_k, m_p), (shape, "topm differs")
        # the values are the kernel's own Elogpi at the picked columns
        assert torch.equal(v_k, e_k.gather(1, i_k.long()))
        assert _dexp_close(e_k, e_p) and _dexp_close(v_k, v_p), shape
        err_t = max(float((e_k - e_p).abs().max()),
                    float((v_k - v_p).abs().max()))
        del rows_2, rows_p, i_2, v_2, m_2, e_p, i_p, v_p, m_p
        t_ms = cuda_ms(lambda: dirichlet_expectation_topw(gamma, w,
                                                          pair=rows), reps)
        rows_t = rows.clone()
        t_plain = cuda_ms(lambda: dirichlet_expectation_topw_plain(
            gamma, w, pair=rows_t), reps)
        del rows_t
        # a yardstick only: torch.topk orders ties otherwise, so it is not
        # the same function and the port never calls it
        topk_ms = cuda_ms(lambda: torch.topk(gamma, w, dim=1), reps)
        t_bnd = topw_bound(n, k, w)
        log(f"phase 1: dirichlet_expectation_topw {shape}: kernel "
            f"{t_ms:.4f} ms, plain (sort) {t_plain:.4f} ms, torch.topk alone "
            f"{topk_ms:.4f} ms, bound {t_bnd[0]:.4f} ms ({t_bnd[1]}), ids "
            f"and topm equal, max abs err {err_t:.3e}, two launches bitwise "
            f"equal")

        # ---- kernel 7 on the form's output
        g_k, s_k, t3_k = sparse_union_pass(rows, i_k, v_k, m_k, elb0, adj)
        g_2, s_2, t3_2 = sparse_union_pass(rows, i_k, v_k, m_k, elb0, adj)
        g_p, s_p, t3_p = sparse_union_pass_pull_plain(
            rows, i_k, v_k, m_k, elb0, adj, block)
        torch.cuda.synchronize()
        assert (torch.equal(g_k, g_2) and torch.equal(s_k, s_2)
                and torch.equal(t3_k, t3_2)), (shape, "two launches differ")
        del g_2
        err7 = max(float((g_k - g_p).abs().max()), _rel_err(s_k, s_p),
                   _rel_err(t3_k, t3_p))
        assert torch.allclose(g_k, g_p, **tol), (shape, err7)
        assert torch.allclose(s_k, s_p, **tol), (shape, _rel_err(s_k, s_p))
        assert torch.allclose(t3_k, t3_p, **tol), (shape,
                                                   _rel_err(t3_k, t3_p))
        total = float(g_k.double().sum())
        assert abs(total - 2 * n_links) < 1e-3 * total, total
        assert torch.allclose(s_k, g_k.sum(0), **tol)
        del g_p
        g_e, s_e, t3_e = sparse_union_pass_plain(rows, i_k, v_k, m_k, elb0,
                                                 edges, mask, nb)
        assert torch.allclose(g_k, g_e, **tol) and torch.allclose(
            s_k, s_e, **tol) and torch.allclose(t3_k, t3_e, **tol), shape
        del g_e
        if w == k:
            # the union of two full lists is every column once: the dense
            # pass, kernel 2 then kernel 4 on the same mphi
            g_d, s_d = phi_pass(e_k.contiguous(), elb0, adj)
            t3_d = s3_pass(mphi, adj)
            assert torch.allclose(g_k, g_d, **tol), float(
                (g_k - g_d).abs().max())
            assert torch.allclose(s_k, s_d, **tol)
            assert torch.allclose(t3_k, t3_d, **tol), _rel_err(t3_k, t3_d)
            del g_d
        ms = cuda_ms(lambda: sparse_union_pass(rows, i_k, v_k, m_k, elb0,
                                               adj), reps)
        plain_ms = cuda_ms(lambda: sparse_union_pass_pull_plain(
            rows, i_k, v_k, m_k, elb0, adj, block), max(1, reps // 5))
        e_c = e_k.contiguous()
        dense_ms = cuda_ms(lambda: (phi_pass(e_c, elb0, adj),
                                    s3_pass(mphi, adj)), reps)
        del e_c
        counts = _union_counts(i_k, adj, k)
        bnd, floor, sectors = union_bound_floor(n, k, w, n_links, adj,
                                                counts)
        occ = sparse_union_occupancy(k, w)
        log(f"phase 1: sparse_union_pass {shape}: kernel {ms:.4f} ms "
            f"(with the top-W form {ms + t_ms:.4f} ms; kernel 2 then kernel "
            f"4 on the same state {dense_ms:.4f} ms), plain {plain_ms:.4f} "
            f"ms, bound {bnd[0]:.4f} ms ({bnd[1]}), floor (a 32-byte sector "
            f"a gathered value or pair) {floor:.4f} ms ({sectors / 1e9:.4f} "
            f"G sectors), values needed: "
            f"Elogpi {counts[0]}, mphi {counts[1]}, kept q-side slots "
            f"{counts[2]} of {n_links * w}; {occ['registers']} registers, "
            f"{occ['smem_per_warp']} B of shared memory a warp, "
            f"{occ['warps_per_sm']} warps an SM; max err gacc (abs), sumk "
            f"and s3 (relative) {err7:.3e}, two launches bitwise equal"
            + (", equal to kernel 2 then kernel 4" if w == k else ""))

        # ---- kernel 3 writing mphi into the rows' odd half, whole pairs
        deg = (adj.rowptr[1:] - adj.rowptr[:-1]).float()
        consts = LSConsts.make(1.0 / k, 1.0, 1.0, n_links, n)
        want = mean_indicator_update(g_k.clone(), s_k, deg, consts, True)
        got = mean_indicator_update(g_k.clone(), s_k, deg, consts, True,
                                    mphi_out=rows)
        torch.cuda.synchronize()
        assert torch.equal(rows[..., 1], want.mphi), shape
        assert not rows[..., 0].any(), (shape, "even half not cleared")
        assert torch.equal(got.gnext, want.gnext), shape
        # s1 and s2 are summed in units of 2 columns here and of 4 there, so
        # in another order where the group of lanes a row takes differs
        assert torch.allclose(got.s1, want.s1, **tol) and torch.allclose(
            got.s2, want.s2, **tol), shape
        del want, got
        if reports is None:
            gc = g_k.clone()
            m3 = torch.empty_like(mphi)
            m3_ms = cuda_ms(lambda: mean_indicator_update(
                gc, s_k, deg, consts, False, mphi_out=m3), reps)
            m3s_ms = cuda_ms(lambda: mean_indicator_update(
                gc, s_k, deg, consts, False, mphi_out=rows), reps)
            log(f"phase 1: mean_indicator_update {shape}: mphi into the "
                f"rows' odd half (whole pairs) {m3s_ms:.4f} ms, into an (n, "
                f"K) array {m3_ms:.4f} ms (bound {mean_bound(n, k)[0]:.4f} "
                f"ms, {mean_bound(n, k, 8)[0]:.4f} with the pairs); equal "
                f"bit for bit, the even half 0")
            del gc, m3
        else:
            log(f"phase 1: mean_indicator_update {shape}: mphi into the "
                f"rows' odd half equal to the (n, K) form bit for bit, the "
                f"even half 0")
        if reports is None:
            # the form gathers nothing at random: its floor is its bound
            reports = {"dirichlet_expectation:topw": dict(
                       _report(err_t, t_ms, t_plain, t_bnd),
                       floor_ms=t_bnd[0]),
                       "sparse_union_pass": dict(
                           _report(err7, ms, plain_ms, bnd), floor_ms=floor)}
        del gamma, rows, e_k, i_k, v_k, m_k, mphi, adj, edges, mask, g_k
        torch.cuda.empty_cache()
    return reports


def heldout_bound(k, n_pairs, padded):
    """The two gamma rows of every real pair read once, the padded pairs,
    labels and weights read once, beta read; per pair and column two
    divisions, three products and five additions."""
    return bound(8.0 * n_pairs * k + 16.0 * padded + 4.0 * k,
                 10.0 * n_pairs * k)


def phase1_heldout(dev):
    """Kernel 6 at every shape of HELDOUT_SHAPES, on pairs padded with
    weight 0: its six sums against the plain tail it replaces (the (n,K) pi,
    then heldout_sums_from_pi) and against its own arithmetic in plain
    PyTorch at HELDOUT_RTOL relative, two launches bitwise equal, the same
    sums without the padding; heldout_stats through the kernel against the
    plain sums."""
    from svinet_torch.evals.likelihood import (
        _pi_beta, heldout_stats, heldout_sums, heldout_sums_from_pi,
        heldout_sums_rows_plain, result_from_sums)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    report = None
    eps = 1e-30
    for n, k, m in HELDOUT_SHAPES:
        # rows from nearly one community to spread out, so that 1 - inner
        # of a non-link is met near 0 and near 1
        gamma = 0.002 + torch.rand((n, k), generator=gen, device=dev) ** 8 * 40
        home = torch.randint(0, 8, (n,), generator=gen, device=dev)
        gamma[torch.arange(0, n, 2, device=dev), home[::2]] += 300.0
        lam = 0.5 + 4.5 * torch.rand((k, 2), generator=gen, device=dev)
        block = min(1 << 17, max(64, 1 << int(np.ceil(np.log2(m)))))
        padded = -(-m // block) * block
        nb = padded // block
        pairs = torch.zeros((padded, 2), dtype=torch.int32, device=dev)
        pairs[:m] = torch.randint(0, n, (m, 2), generator=gen, device=dev)
        y = torch.zeros(padded, dtype=torch.int32, device=dev)
        y[:m:2] = 1
        w = (torch.arange(padded, device=dev) < m).float()

        def plain_tail():
            pi, beta = _pi_beta(gamma, lam)
            return heldout_sums_from_pi(pi, beta, pairs, y, w, eps, nb)

        got = heldout_sums(gamma, lam, pairs, y, w, eps)
        again = heldout_sums(gamma, lam, pairs, y, w, eps)
        bare = heldout_sums(gamma, lam, pairs[:m], y[:m], w[:m], eps)
        want = plain_tail()
        rows = heldout_sums_rows_plain(gamma, lam, pairs, y, w, eps, nb)
        torch.cuda.synchronize()
        assert torch.equal(got, again), (n, k, "two launches differ")
        # padding adds exactly 0; the launch shape (and with it the order of
        # the additions) depends on the number of pairs, hence allclose
        assert torch.allclose(got, bare, rtol=HELDOUT_RTOL, atol=0.0)
        assert got.tolist()[1::2] == [m, m - (m + 1) // 2, (m + 1) // 2], got
        assert torch.isfinite(got).all() and float(got[0]) < 0.0
        err = max(float(((got - ref) / ref).abs().max())
                  for ref in (want, rows))
        assert err < HELDOUT_RTOL, (n, k, err, got, want, rows)
        res = heldout_stats(gamma, lam, pairs[:m], y[:m], eps)
        ref = result_from_sums(want)
        assert (res.count, res.count0, res.count1) == (
            ref.count, ref.count0, ref.count1)
        assert abs(res.avg - ref.avg) <= HELDOUT_RTOL * abs(ref.avg)
        reps = 5 if n * k >= 10**7 else 50
        ms = cuda_ms(lambda: heldout_sums(gamma, lam, pairs, y, w, eps), reps)
        plain_ms = cuda_ms(plain_tail, reps)
        rows_ms = cuda_ms(lambda: heldout_sums_rows_plain(
            gamma, lam, pairs, y, w, eps, nb), reps)
        bnd = heldout_bound(k, m, padded)
        log(f"phase 1: heldout_sums n={n} K={k} pairs={m} (padded to "
            f"{padded}): kernel {ms:.4f} ms, plain tail (the (n,K) pi, then "
            f"the blocked sums) {plain_ms:.4f} ms, its arithmetic in plain "
            f"PyTorch {rows_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), "
            f"max rel err of the six sums {err:.3e}, padding adds 0, two "
            f"launches bitwise equal")
        if report is None:
            report = _report(err, ms, plain_ms, bnd)
        del gamma, pairs
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


def _wrappers():
    """The kernel wrappers by name, each counting its launches."""
    from svinet_torch.evals.likelihood import heldout_sums
    from svinet_torch.ops.digamma import dirichlet_expectation
    from svinet_torch.ops.phicomp import phi_fixed_point
    from svinet_torch.ops.sparse_gamma import (sparse_fastamm_stats,
                                               union_scores)
    from svinet_torch.svi.communities import edge_assignments
    from svinet_torch.svi.fastinit import overlap_stats, vote_topk
    from svinet_torch.ops.orig_phi import orig_chunk
    from svinet_torch.ops.threefry import uniform_rows
    from svinet_torch.svi.gen import gen_pairs
    from svinet_torch.svi.sbm import estep_chunk
    from svinet_torch.svi.sweep_math import (
        fused_phi_s3_pass, mean_indicator_update, phi_pass, s3_pass,
        sparse_union_pass)
    return {"dirichlet_expectation": dirichlet_expectation,
            "phi_fixed_point": phi_fixed_point,
            "edge_assignments": edge_assignments,
            "phi_pass": phi_pass,
            "mean_indicator_update": mean_indicator_update,
            "s3_pass": s3_pass, "fused_phi_s3_pass": fused_phi_s3_pass,
            "heldout_sums": heldout_sums,
            "sparse_union_pass": sparse_union_pass,
            "sparse_fastamm_stats": sparse_fastamm_stats,
            "union_scores": union_scores,
            "vote_topk": vote_topk, "overlap_stats": overlap_stats,
            "estep_chunk": estep_chunk, "orig_chunk": orig_chunk,
            "gen_pairs": gen_pairs, "uniform_rows": uniform_rows}


def _zero_counts():
    """Set every wrapper's launch counts to 0, in all and by form."""
    for fn in _wrappers().values():
        fn.launches = 0
        fn.forms = {}


def _read_counts():
    """(launches by wrapper, launches by "wrapper:form")."""
    wrappers = _wrappers()
    return ({name: fn.launches for name, fn in wrappers.items()},
            {f"{name}:{form}": count for name, fn in wrappers.items()
             for form, count in fn.forms.items()})


def _counted_cli(workdir, net, gt, label, extra):
    """Set every launch count to 0, drive the CLI, read the counts.
    Returns (output directory, seconds, launches, launches by form)."""
    _zero_counts()
    t0 = time.perf_counter()
    out = _run_cli(workdir, net, gt, label, extra)
    secs = time.perf_counter() - t0
    return (out, secs, *_read_counts())


def _annealing_end(out):
    """The iteration whose report ended annealing, from infer.log."""
    for line in open(os.path.join(out, "infer.log")):
        if "annealing ended at iteration" in line:
            return int(line.split("annealing ended at iteration")[1].split()[0])
    raise AssertionError(f"{out}: annealing never ended")


def _check_outputs(out):
    """The files of a finished run; returns (heldout rows, max.txt, NMI)."""
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
    return ho, mx, nmi


def _sweeps_run(out):
    """The sweeps a finished run made: the iteration of time.txt's last
    row (a batched run writes one row per batch, at the batch's end, and
    leaves its state there even when it stops inside the batch)."""
    return int(np.loadtxt(os.path.join(out, "time.txt"), ndmin=2)[-1, 0])


def phase2(workdir):
    from svinet_torch.synth import write_planted
    net, gt = write_planted(workdir, PLANTED["n"], PLANTED["k"],
                            PLANTED["avg_deg"], PLANTED["seed"])
    os.environ["SVINET_TORCH_DEVICE"] = "cuda"
    out, secs, launches, forms = _counted_cli(workdir, net, gt, "gpu",
                                              ["-max-iterations", "400"])
    # default flags launch the f32 forms only
    assert all(name.endswith(":f32") for name in forms), forms
    # the default sweep is kernels 1, 2, 3, 4 and 6; a report's
    # communities kernel 9; no other kernel
    path = ("dirichlet_expectation", "phi_pass", "mean_indicator_update",
            "s3_pass", "heldout_sums", "edge_assignments")
    assert all(launches[name] > 0 for name in path), launches
    assert not any(v for name, v in launches.items()
                   if name not in path), launches
    ho, mx, nmi = _check_outputs(out)
    assert abs(int(mx[0]) - STOP_ITER_CPU) <= 1, mx
    assert abs(nmi - NMI_CPU) <= NMI_TOL, nmi
    sweeps = _sweeps_run(out)
    assert sweeps == int(mx[0]), (sweeps, mx)
    # a sweep launches kernels 2, 3 and 4 once each and kernel 1 twice
    # (gamma and lambda); a report's community extraction launches kernel
    # 1 twice more, so its count per sweep depends on -rfreq
    for name in ("phi_pass", "mean_indicator_update", "s3_pass"):
        assert launches[name] == sweeps, (launches, sweeps)
    assert launches["dirichlet_expectation"] >= 2 * sweeps, launches
    # kernel 6: the tail of every step (one sweep each here, its sums are
    # the report's validation row), and a launch for each further row a
    # report writes (test set, training sample)
    assert launches["heldout_sums"] >= sweeps, launches
    per_sweep = {name: v / sweeps for name, v in launches.items()}
    log(f"phase 2: CLI on planted n={PLANTED['n']} K={PLANTED['k']}: "
        f"{secs:.1f} s, stopped at iteration {mx[0]} (why {mx[5]}), best "
        f"nshol {mx[4]}, NMI {nmi:.6f}, heldout rows {len(ho)}, {sweeps} "
        f"sweeps, launches {launches}")

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
    phase2_resume(workdir, net, gt, out)

    # -fuse-s3 -report-batch 4: kernels 1, 3 and 5 (a pass of this size
    # takes the one fused launch), four report intervals per host round
    # trip
    out_f, secs_f, launches_f, _ = _counted_cli(
        workdir, net, gt, "gpu-fused",
        ["-max-iterations", "400", "-fuse-s3", "-report-batch",
         str(REPORT_BATCH)])
    for name in ("dirichlet_expectation", "mean_indicator_update",
                 "fused_phi_s3_pass", "heldout_sums"):
        assert launches_f[name] > 0, launches_f
    assert launches_f["phi_pass"] == launches_f["s3_pass"] == 0, launches_f
    ho_f, mx_f, nmi_f = _check_outputs(out_f)
    stop_f = int(mx_f[0])
    assert abs(stop_f - STOP_ITER_CPU_FUSED) <= REPORT_BATCH, mx_f
    assert abs(nmi_f - NMI_CPU_FUSED) <= NMI_TOL, nmi_f
    # a heldout row at every boundary up to the stop, none after it
    assert (ho_f[:, 0] == np.arange(stop_f + 1)).all(), ho_f[:, 0]
    times = np.loadtxt(os.path.join(out_f, "time.txt"), ndmin=2)
    assert len(times) == -(-stop_f // REPORT_BATCH), (len(times), stop_f)
    sweeps_f = _sweeps_run(out_f)
    assert sweeps_f == len(times) * REPORT_BATCH, (sweeps_f, len(times))
    for name in ("mean_indicator_update", "fused_phi_s3_pass"):
        assert launches_f[name] == sweeps_f, (launches_f, sweeps_f)
    # a heldout row at every boundary of a batch comes from the kernel
    assert launches_f["heldout_sums"] >= sweeps_f, launches_f
    log(f"phase 2: CLI with -fuse-s3 -report-batch {REPORT_BATCH}: "
        f"{secs_f:.1f} s (default flags {secs:.1f} s), stopped at iteration "
        f"{mx_f[0]} (why {mx_f[5]}), best nshol {mx_f[4]}, NMI {nmi_f:.6f}, "
        f"heldout rows {len(ho_f)}, time.txt rows {len(times)}, {sweeps_f} "
        f"sweeps, launches {launches_f}")
    launches["fused_phi_s3_pass"] = launches_f["fused_phi_s3_pass"]
    per_sweep["fused_phi_s3_pass"] = (launches_f["fused_phi_s3_pass"]
                                      / sweeps_f)
    forms_all, forms_per_sweep = phase2_flags(workdir, net, gt, out, ho, nmi)
    launches.update(forms_all)
    per_sweep.update(forms_per_sweep)
    sparse_all, sparse_per_sweep = phase2_sparse(workdir, net, gt, out)
    launches.update(sparse_all)
    per_sweep.update(sparse_per_sweep)
    phase2_surface(workdir, net, gt)
    return launches, per_sweep


def phase2_sparse(workdir, net, gt, out_default):
    """The planted CLI run with -sparse-w: dense unfused sweeps while
    annealing, then per sweep the top-W form of kernel 1, kernel 7 and
    kernel 3, and no launch of kernel 2 or 4. Returns the launches of the
    two new kernels, in all and per sweep of the run."""
    out_s, secs_s, launches_s, forms_s = _counted_cli(
        workdir, net, gt, "gpu-sparse",
        ["-max-iterations", "400", "-sparse-w", str(SPARSE_W_PLANTED)])
    ho_s, mx_s, nmi_s = _check_outputs(out_s)
    end = _annealing_end(out_s)
    assert end == _annealing_end(out_default), end
    sweeps = _sweeps_run(out_s)
    assert sweeps > end, (sweeps, end)
    for name in ("phi_pass", "s3_pass"):
        assert forms_s[f"{name}:f32"] == end, (name, forms_s, end)
    assert launches_s["sparse_union_pass"] == sweeps - end, launches_s
    assert forms_s["dirichlet_expectation:topw"] == sweeps - end, forms_s
    assert launches_s["mean_indicator_update"] == sweeps, launches_s
    assert launches_s["fused_phi_s3_pass"] == 0, launches_s
    # -report-batch is bypassed and a validation row comes from every step
    assert launches_s["heldout_sums"] >= sweeps, launches_s
    assert abs(int(mx_s[0]) - STOP_ITER_CPU_SPARSE) <= 1, mx_s
    assert abs(nmi_s - NMI_CPU_SPARSE) <= NMI_TOL, nmi_s
    log(f"phase 2: CLI with -sparse-w {SPARSE_W_PLANTED}: {secs_s:.1f} s, "
        f"annealing ended at iteration {end} (dense sweeps until then), "
        f"then {sweeps - end} sparse sweeps; stopped at iteration {mx_s[0]} "
        f"(why {mx_s[5]}), best nshol {mx_s[4]}, NMI {nmi_s:.6f} (CPU: "
        f"stop {STOP_ITER_CPU_SPARSE}, NMI {NMI_CPU_SPARSE}), heldout rows "
        f"{len(ho_s)}, launches {launches_s}, by form {forms_s}")
    counted = {"sparse_union_pass": launches_s["sparse_union_pass"],
               "dirichlet_expectation:topw":
                   forms_s["dirichlet_expectation:topw"]}
    return counted, {name: v / sweeps for name, v in counted.items()}


def phase2_surface(workdir, net, gt):
    """Short planted runs of -init-communities, -load-test-sets and
    -profile, checked for their files; the -profile trace must name kernels
    2 and 3."""
    n = PLANTED["n"]
    # the planted cover as one community a line of external ids
    comms = {}
    for line in open(gt):
        node, c = line.split()
        comms.setdefault(int(c), []).append(node)
    init = os.path.join(workdir, "init-communities.txt")
    with open(init, "w") as f:
        for _, members in sorted(comms.items()):
            f.write("\t".join(members) + "\n")
    out = _run_cli(workdir, net, gt, "gpu-init",
                   ["-init-communities", init, "-max-iterations", "3"])
    rows = open(os.path.join(out, "init_memberships.txt")).read().splitlines()
    assert len(rows) == n, len(rows)
    ho = np.loadtxt(os.path.join(out, "heldout.txt"), ndmin=2)
    assert len(ho) == 4 and np.isfinite(ho).all()
    nmi0 = float(open(os.path.join(out, "mutual.txt")).readline().split()[-1])
    log(f"phase 2: -init-communities from the planted cover: "
        f"init_memberships.txt {len(rows)} rows, NMI at iteration 0 "
        f"{nmi0:.6f}, heldout nshol {ho[0, 10]:.6f} -> {ho[-1, 10]:.6f} in 3 "
        f"sweeps")

    # -load-test-sets: the pair files are read from the cwd
    ids = np.unique(np.loadtxt(net, dtype=np.int64).ravel())
    rng = np.random.default_rng(4)
    sizes = {"uniform": 3000, "biased": 2000}
    for name, m in sizes.items():
        pairs = rng.choice(ids, (m, 2))
        np.savetxt(os.path.join(workdir, f"{name}-heldout-pairs.txt"),
                   pairs[pairs[:, 0] != pairs[:, 1]], fmt="%d")
    _zero_counts()
    out = _run_cli(workdir, net, gt, "gpu-tests",
                   ["-load-test-sets", "-max-iterations", "4"])
    launches = _read_counts()[0]
    for name in sizes:
        hol = np.loadtxt(os.path.join(out, f"{name}-hol.txt"), ndmin=2)
        assert hol.shape == (5, 11) and np.isfinite(hol).all(), hol.shape
        auc = np.loadtxt(os.path.join(out, f"{name}_auc.txt"), ndmin=2)
        pairs = np.loadtxt(os.path.join(out, f"{name}-test-pairs.txt"),
                           ndmin=2)
        assert len(auc) == len(pairs) > 0
    # per report: the validation tail or row, and one per test set
    assert launches["heldout_sums"] >= 5 * 3, launches
    log(f"phase 2: -load-test-sets: uniform-hol.txt and biased-hol.txt 5 "
        f"rows each, {{uniform,biased}}_auc.txt and -test-pairs.txt written, "
        f"heldout_sums launches {launches['heldout_sums']}")

    # -profile: a Chrome trace of the training loop
    trace_dir = os.path.join(workdir, "profile")
    out = _run_cli(workdir, net, gt, "gpu-profile",
                   ["-profile", trace_dir, "-max-iterations", "3"])
    events = json.load(open(os.path.join(
        trace_dir, "svinet_torch_trace.json")))["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    for kernel in ("phi_pull_kernel", "mean_indicator_kernel"):
        n_k = sum(kernel in name for name in kernels)
        assert n_k >= 3, (kernel, n_k, sorted(set(kernels))[:30])
    log(f"phase 2: -profile: {len(kernels)} kernel events in the trace, "
        f"every sweep's kernel 2 and kernel 3 among them")


def phase2_flags(workdir, net, gt, out_default, ho_default, nmi_default):
    """The planted CLI run with -bf16, with -freeze (and -bf16, so that
    both row types meet frozen nodes) and with -bf16 -fuse-s3
    -report-batch, and a -prune engine on a forced dead-column state
    against the dense engine. Returns the launches of every form these
    runs took, in all and per sweep."""
    launched, per_sweep = {}, {}

    def keep(forms, sweeps):
        for name, count in forms.items():
            if name not in launched:
                launched[name] = count
                per_sweep[name] = count / sweeps

    # ---- -bf16: the default run bit for bit until annealing ends, bf16
    # rows in every sweep after it
    end = _annealing_end(out_default)
    out_b, secs_b, _, forms_b = _counted_cli(
        workdir, net, gt, "gpu-bf16", ["-max-iterations", "400", "-bf16"])
    ho_b, mx_b, nmi_b = _check_outputs(out_b)
    assert _annealing_end(out_b) == end, (_annealing_end(out_b), end)
    keep_cols = [c for c in range(ho_b.shape[1]) if c != 1]   # 1: seconds
    assert np.array_equal(ho_b[:end + 1, keep_cols],
                          ho_default[:end + 1, keep_cols])
    sweeps_b = _sweeps_run(out_b)
    assert sweeps_b > end
    for name in ("phi_pass", "mean_indicator_update", "s3_pass"):
        assert forms_b[f"{name}:f32"] == end, (name, forms_b, end)
        assert forms_b[f"{name}:bf16"] == sweeps_b - end, (name, forms_b)
    assert forms_b["dirichlet_expectation:bf16"] == sweeps_b - end, forms_b
    assert abs(nmi_b - nmi_default) <= NMI_TOL, (nmi_b, nmi_default)
    keep(forms_b, sweeps_b)
    log(f"phase 2: CLI with -bf16: {secs_b:.1f} s, annealing ended at "
        f"iteration {end} as in the default run, heldout rows equal to its "
        f"rows up to there, then {sweeps_b - end} sweeps over bf16 rows; "
        f"stopped at iteration {mx_b[0]} (why {mx_b[5]}), best nshol "
        f"{mx_b[4]}, NMI {nmi_b:.6f} (default {nmi_default:.6f}), launches "
        f"by form {forms_b}")

    # ---- -freeze -bf16: every pass over links takes its frozen-node form,
    # over f32 rows while annealing and bf16 rows after
    out_z, secs_z, _, forms_z = _counted_cli(
        workdir, net, gt, "gpu-freeze",
        ["-max-iterations", "400", "-freeze", "-bf16"])
    _, mx_z, nmi_z = _check_outputs(out_z)
    sweeps_z = _sweeps_run(out_z)
    end_z = _annealing_end(out_z)
    for name in ("phi_pass", "mean_indicator_update", "s3_pass"):
        assert forms_z[f"{name}:f32+conv"] == end_z, (name, forms_z, end_z)
        assert forms_z[f"{name}:bf16+conv"] == sweeps_z - end_z, (name,
                                                                  forms_z)
    frozen = np.loadtxt(os.path.join(out_z, "convergence.txt"), ndmin=2)[-1, 2]
    assert frozen > 0 and abs(nmi_z - nmi_default) <= 0.05, (frozen, nmi_z)
    keep(forms_z, sweeps_z)
    log(f"phase 2: CLI with -freeze -bf16: {secs_z:.1f} s, annealing ended "
        f"at iteration {end_z}, stopped at iteration {mx_z[0]} (why "
        f"{mx_z[5]}), best nshol {mx_z[4]}, NMI {nmi_z:.6f}, {int(frozen)} "
        f"nodes converged at the last report, launches by form {forms_z}")

    # ---- -bf16 -fuse-s3 -report-batch: kernel 5 over bf16 rows, kernel 3
    # writing the carried f32 mphi and its bf16 rows
    out_fb, secs_fb, _, forms_fb = _counted_cli(
        workdir, net, gt, "gpu-fused-bf16",
        ["-max-iterations", "400", "-bf16", "-fuse-s3", "-report-batch",
         str(REPORT_BATCH)])
    _, mx_fb, nmi_fb = _check_outputs(out_fb)
    sweeps_fb = _sweeps_run(out_fb)
    n_bf16 = forms_fb["fused_phi_s3_pass:bf16"]
    assert 0 < n_bf16 < sweeps_fb
    assert forms_fb["fused_phi_s3_pass:f32"] == sweeps_fb - n_bf16, forms_fb
    assert forms_fb["mean_indicator_update:f32+bf16"] == n_bf16, forms_fb
    assert abs(nmi_fb - NMI_CPU_FUSED) <= NMI_TOL, nmi_fb
    keep(forms_fb, sweeps_fb)
    log(f"phase 2: CLI with -bf16 -fuse-s3 -report-batch {REPORT_BATCH}: "
        f"{secs_fb:.1f} s, stopped at iteration {mx_fb[0]}, best nshol "
        f"{mx_fb[4]}, NMI {nmi_fb:.6f}, {n_bf16} of {sweeps_fb} sweeps over "
        f"bf16 rows, launches by form {forms_fb}")

    # ---- -prune on a state forced into the dead-column regime (all mass
    # in 5 of the 20 columns), against the dense engine on the same state
    from svinet_torch.svi.linksampling import from_edges
    from svinet_torch.synth import planted_blocks
    raw, _ = planted_blocks(PLANTED["n"], PLANTED["k"], PLANTED["avg_deg"],
                            PLANTED["seed"])
    dev = torch.device("cuda", 0)
    ends = {}
    compacted = []      # what each report of the pruned engine found
    for label, prune in (("dense", False), ("pruned", True)):
        eng = from_edges(raw, PLANTED["n"], PLANTED["k"], dev,
                         os.path.join(workdir, f"prune-{label}"), seed=5,
                         prune=prune, max_iterations=12,
                         use_validation_stop=False, reportfreq=4)
        forced = torch.full_like(eng.gamma, eng.consts.alpha)
        forced[:, :5] = eng.gamma[:, :5] + eng.gamma[:, 5:10]
        eng.gamma = forced
        eng.annealing = False
        if prune:
            # every report expands the state first: look at it while it is
            # still compacted, after the interval's sweeps at width K_pad
            expand = eng._expand_if_compacted

            def checked_expand(eng=eng, expand=expand):
                c = eng._compact
                if c is not None:
                    ka = c["ka"]
                    compacted.append((
                        eng.iteration, tuple(eng.gamma.shape), ka,
                        bool((eng.gamma[:, ka:] == eng.consts.alpha).all()),
                        bool((eng.lam[ka:, 0] == eng.consts.eta0).all()
                             and (eng.lam[ka:, 1] == eng.consts.eta1).all()),
                        bool(torch.isfinite(eng.gamma).all())))
                expand()

            eng._expand_if_compacted = checked_expand
        _zero_counts()
        t0 = time.perf_counter()
        try:
            eng.infer()
        finally:
            eng.close()
        torch.cuda.synchronize()
        ends[label] = (eng, time.perf_counter() - t0, _read_counts()[1])
    dense, pruned = ends["dense"][0], ends["pruned"][0]
    line = (f"prune: 5/{PLANTED['k']} active communities, sweeping at "
            f"width 8")
    assert line in open(pruned.cfg.file_str("infer.log")).read()
    tol = dict(rtol=2e-3, atol=2e-3)
    assert pruned.gamma.shape == dense.gamma.shape
    assert torch.allclose(pruned.gamma, dense.gamma, **tol)
    assert torch.allclose(pruned.lam, dense.lam, **tol)
    # the three intervals of 4 sweeps each ran at (n, 8) with 5 active
    # columns, and left the 3 pad columns at (alpha, eta) exactly
    n_nodes = pruned.gamma.shape[0]
    assert [c[0] for c in compacted][:3] == [4, 8, 12], compacted
    assert all(c[1:] == ((n_nodes, 8), 5, True, True, True)
               for c in compacted), compacted
    forms_p = ends["pruned"][2]
    # every sweep of the run was a compacted one, over f32 rows
    assert {name: forms_p.get(name) for name in (
        "phi_pass:f32", "mean_indicator_update:f32", "s3_pass:f32")} == {
        "phi_pass:f32": 12, "mean_indicator_update:f32": 12,
        "s3_pass:f32": 12}, forms_p
    assert forms_p["dirichlet_expectation:f32+rest"] == 12, forms_p
    keep({"dirichlet_expectation:f32+rest":
          forms_p["dirichlet_expectation:f32+rest"]}, 12)
    log(f"phase 2: -prune on a forced dead-column state: '{line}', 12 "
        f"sweeps at width 8 in {ends['pruned'][1]:.2f} s (dense, width "
        f"{PLANTED['k']}: {ends['dense'][1]:.2f} s), at each of its 3 "
        f"reports the state still (n, 8) with its 3 pad columns at (alpha, "
        f"eta) exactly; after expansion gamma and lambda "
        f"within 2e-3 of the dense engine's, max abs diff gamma "
        f"{float((pruned.gamma - dense.gamma).abs().max()):.3e}, launches "
        f"by form {forms_p}")
    return launched, per_sweep


def phase3(dev, workdir):
    """The stretch shape: steps of three sweeps and the heldout tail under
    each flag set, the launches counted by form."""
    from svinet_torch.evals.likelihood import result_from_sums
    from svinet_torch.svi.linksampling import from_edges
    from svinet_torch.synth import random_edges
    n, k = STRETCH["n"], STRETCH["k"]
    raw = random_edges(n, STRETCH["n_edges"], 0)
    _zero_counts()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = from_edges(raw, n, k, dev, os.path.join(workdir, "stretch"))
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    init_launches = _read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    net = eng.network
    uniform_report = phase3_uniform(dev, eng, init_launches)
    n_train = len(net.training_links)
    # the device init adds a normalised phi to both ends of every link, so
    # each gamma row sums to the node's degree in the whole graph
    deg = np.bincount(net.edges.ravel(), minlength=net.n)
    rows = eng.gamma.sum(dim=1, dtype=torch.float64).cpu().numpy()
    init_err = float(np.abs(rows / deg - 1.0).max())
    assert deg.min() > 0 and init_err < 1e-4, init_err
    eng.step(1)                       # warm-up
    torch.cuda.synchronize()
    wrappers = _wrappers()
    # what three sweeps at this size launch, with and without -fuse-s3:
    # kernel 1 for gamma and lambda, kernels 2, 3 and 4 once a sweep, and
    # kernel 5 never (the fused pass of a card this busy is kernel 2 then
    # kernel 4 on the lagged mphi)
    three_sweeps = {"dirichlet_expectation": 6, "phi_pass": 3,
                    "mean_indicator_update": 3, "s3_pass": 3,
                    "fused_phi_s3_pass": 0, "heldout_sums": 1,
                    "sparse_union_pass": 0, "phi_fixed_point": 0,
                    "edge_assignments": 0, "sparse_fastamm_stats": 0,
                    "union_scores": 0, "vote_topk": 0, "overlap_stats": 0,
                    "estep_chunk": 0, "orig_chunk": 0, "gen_pairs": 0,
                    "uniform_rows": 0}
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    _zero_counts()
    t1 = time.perf_counter()
    eng.step(3)
    res = result_from_sums(eng._ho_res)   # synchronises
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    counted, forms = _read_counts()
    assert counted == three_sweeps, counted
    assert forms == {"dirichlet_expectation:f32": 6, "phi_pass:f32": 3,
                     "mean_indicator_update:f32": 3,
                     "s3_pass:f32": 3, "heldout_sums:f32": 1}, forms
    step_peak = torch.cuda.max_memory_allocated(dev)
    peak = max(peak, step_peak)
    assert torch.isfinite(eng.gamma).all() and torch.isfinite(eng.lam).all()
    assert np.isfinite(res.avg) and res.count == len(net.validation_pairs)
    rate = 3 * n_train / dt
    log(f"phase 3: n={n} K={k} training links {n_train}: set-up "
        f"{setup:.1f} s, init gamma row sums vs degree max rel err "
        f"{init_err:.3e}, 3 sweeps + heldout tail {dt:.3f} s = "
        f"{rate:.0f} edges/s, heldout avg {res.avg:.6f}, peak "
        f"device memory {peak / 2**30:.2f} GiB since set-up began, "
        f"{step_peak / 2**30:.2f} GiB in these steps ({held / 2**30:.2f} "
        f"GiB held as they began), launches by form "
        f"{forms}")
    assert rate >= STRETCH_MIN_EDGES_S, rate
    # the same engine past its annealing, with -bf16 (what the engine does
    # under the flag once a report has ended annealing): the sweeps gather
    # bf16 rows. An f32 step of the same phase beside it
    eng.annealing = False
    eng.step(1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng.step(3)
    res = result_from_sums(eng._ho_res)
    torch.cuda.synchronize()
    dt_post = time.perf_counter() - t1
    eng.cfg.bf16_rows = True
    eng.step(1)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    t1 = time.perf_counter()
    eng.step(3)
    res_b = result_from_sums(eng._ho_res)
    torch.cuda.synchronize()
    dt_b = time.perf_counter() - t1
    peak_b = torch.cuda.max_memory_allocated(dev)
    counted, forms_b = _read_counts()
    assert counted == three_sweeps, counted
    assert forms_b == {"dirichlet_expectation:bf16": 3,
                       "dirichlet_expectation:f32": 3, "phi_pass:bf16": 3,
                       "mean_indicator_update:bf16": 3,
                       "s3_pass:bf16": 3, "heldout_sums:f32": 1}, forms_b
    assert torch.isfinite(eng.gamma).all() and torch.isfinite(eng.lam).all()
    assert np.isfinite(res_b.avg) and res_b.count == res.count
    assert 3 * n_train / dt_b >= STRETCH_MIN_EDGES_S_BF16, 3 * n_train / dt_b
    log(f"phase 3: -bf16 on the same engine, annealing over: 3 sweeps over "
        f"bf16 rows + heldout tail {dt_b:.3f} s = {3 * n_train / dt_b:.0f} "
        f"edges/s (f32 rows, same phase: {dt_post:.3f} s = "
        f"{3 * n_train / dt_post:.0f} edges/s), heldout avg {res_b.avg:.6f} "
        f"(f32 before: {res.avg:.6f}), peak device memory in these steps "
        f"{peak_b / 2**30:.2f} GiB, launches "
        f"by form {forms_b}")
    eng.cfg.bf16_rows = False
    eng.annealing = True
    # -fuse-s3 on the same engine (what LinkSampling.__init__ does under
    # the flag): the set-up above is over a minute of host time, so the
    # network and the state are reused
    eng.cfg.fuse_s3 = True
    eng.mphi = torch.zeros_like(eng.gamma)
    eng.step(1)                       # warm-up; fills mphi
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    t1 = time.perf_counter()
    eng.step(3)
    res_f = result_from_sums(eng._ho_res)
    torch.cuda.synchronize()
    dt_f = time.perf_counter() - t1
    peak_f = torch.cuda.max_memory_allocated(dev)
    counted, forms_f = _read_counts()
    assert counted == three_sweeps, counted
    # the fused pass of a shape this size is kernel 2 then kernel 4
    assert forms_f["s3_pass:f32"] == forms_f["phi_pass:f32"] == 3, forms_f
    assert torch.isfinite(eng.gamma).all() and torch.isfinite(eng.lam).all()
    assert torch.isfinite(eng.mphi).all() and bool(eng.mphi.any())
    assert np.isfinite(res_f.avg)
    log(f"phase 3: -fuse-s3 on the same engine: 3 sweeps + heldout tail "
        f"{dt_f:.3f} s = {3 * n_train / dt_f:.0f} edges/s, heldout avg "
        f"{res_f.avg:.6f}, peak device memory in these steps "
        f"{peak_f / 2**30:.2f} GiB, launches "
        f"by form {forms_f}")
    # -fuse-s3 with -bf16 past annealing: kernel 3 writes the carried f32
    # mphi and its bf16 rows, kernels 2 and 4 gather bf16 rows
    eng.cfg.bf16_rows = True
    eng.annealing = False
    eng.step(1)                       # warm-up; the one cast of mphi
    torch.cuda.synchronize()
    _zero_counts()
    t1 = time.perf_counter()
    eng.step(3)
    res_fb = result_from_sums(eng._ho_res)
    torch.cuda.synchronize()
    dt_fb = time.perf_counter() - t1
    counted, forms_fb = _read_counts()
    assert counted == three_sweeps, counted
    assert forms_fb == {"dirichlet_expectation:bf16": 3,
                        "dirichlet_expectation:f32": 3, "phi_pass:bf16": 3,
                        "mean_indicator_update:f32+bf16": 3,
                        "s3_pass:bf16": 3, "heldout_sums:f32": 1}, forms_fb
    assert torch.equal(eng._mphi_bf16, eng.mphi.to(torch.bfloat16))
    assert torch.isfinite(eng.gamma).all() and np.isfinite(res_fb.avg)
    log(f"phase 3: -fuse-s3 -bf16, annealing over: 3 sweeps + heldout tail "
        f"{dt_fb:.3f} s = {3 * n_train / dt_fb:.0f} edges/s, heldout avg "
        f"{res_fb.avg:.6f}, the bf16 rows of mphi equal the carried f32 "
        f"mphi rounded once, launches by form {forms_fb}")
    eng.cfg.bf16_rows = False
    eng._mphi_bf16 = None
    # -sparse-w past annealing on the same engine (what the engine does
    # under the flag once a report has ended annealing; it clears
    # -fuse-s3 and drops its mphi): the top-W form of kernel 1, kernel 7
    # and kernel 3 each sweep, kernels 2 and 4 never; the warm-up step is
    # the first sparse one, whose s3 is 0
    eng.mphi = None
    eng.cfg.fuse_s3 = False
    eng.cfg.sparse_w = SPARSE_W_STRETCH
    eng.step(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    _zero_counts()
    t1 = time.perf_counter()
    eng.step(3)
    res_s = result_from_sums(eng._ho_res)
    torch.cuda.synchronize()
    dt_s = time.perf_counter() - t1
    # read before the checks below: torch.isfinite on the (n, K) state
    # holds temporaries of 3.3 GB, more than these steps do
    sparse_peak = torch.cuda.max_memory_allocated(dev)
    counted, forms_s = _read_counts()
    assert forms_s == {"dirichlet_expectation:topw": 3,
                       "dirichlet_expectation:f32": 3,
                       "sparse_union_pass:f32": 3,
                       "mean_indicator_update:f32": 3,
                       "heldout_sums:f32": 1}, forms_s
    assert torch.isfinite(eng.gamma).all() and torch.isfinite(eng.lam).all()
    assert np.isfinite(res_s.avg) and res_s.count == res.count
    rate_s = 3 * n_train / dt_s
    log(f"phase 3: -sparse-w {SPARSE_W_STRETCH}, annealing over: 3 sweeps + "
        f"heldout tail {dt_s:.3f} s = {rate_s:.0f} edges/s, "
        f"heldout avg {res_s.avg:.6f}, peak device memory in these steps "
        f"{sparse_peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB held as "
        f"they began), launches by form {forms_s}")
    assert rate_s >= STRETCH_MIN_EDGES_S_SPARSE, rate_s
    # kernel 7 and the top-W form alone on the engine's own stretch state,
    # beside kernel 7's bound and its floor in this layout and in the first
    # design's (Elogpi and mphi apart)
    from svinet_torch.ops.digamma import (
        dirichlet_expectation, dirichlet_expectation_topw)
    from svinet_torch.svi.sweep_math import sparse_union_pass
    w, rows = SPARSE_W_STRETCH, eng._sparse_rows
    elb0 = dirichlet_expectation(eng.lam)[:, 0].contiguous()
    _, ids, tv, tm = dirichlet_expectation_topw(eng.gamma, w, pair=rows)
    k7_ms = cuda_ms(lambda: sparse_union_pass(rows, ids, tv, tm, elb0,
                                              eng.adj), 3)
    tw_ms = cuda_ms(lambda: dirichlet_expectation_topw(eng.gamma, w,
                                                       pair=rows), 3)
    counts = _union_counts(ids, eng.adj, k)
    b7, f7, s7 = union_bound_floor(n, k, w, n_train, eng.adj, counts)
    b6, f6, s6 = union_bound_floor(n, k, w, n_train, eng.adj, counts, "apart")
    log(f"phase 3: on the stretch state at W={w}: sparse_union_pass "
        f"{k7_ms:.4f} ms, bound {b7[0]:.4f} ms ({b7[1]}), floor {f7:.4f} ms "
        f"({s7 / 1e9:.4f} G sectors; Elogpi and mphi apart: bound {b6[0]:.4f} "
        f"ms, "
        f"floor {f6:.4f} ms, {s6 / 1e9:.4f} G sectors), values "
        f"needed: Elogpi {counts[0]}, mphi {counts[1]}, kept q-side slots "
        f"{counts[2]} of {n_train * w}; dirichlet_expectation_topw "
        f"{tw_ms:.4f} ms (bound {topw_bound(n, k, w)[0]:.4f} ms)")
    del ids, tv, tm, counts
    # the checks below take the mean indicators the sparse steps carried
    eng.cfg.sparse_w = 0
    eng.mphi = rows[..., 1].contiguous()
    eng._sparse_rows = rows = None
    eng.annealing = True
    # kernel 4 at the full 19.9M links, on the mean indicators the engine
    # carries, against its plain version (PHI_TOL abs/rel)
    from svinet_torch.ops.edges import build_adjacency, choose_edge_block
    from svinet_torch.svi.sweep_math import s3_pass, s3_pass_pull_plain
    s3_k = s3_pass(eng.mphi, eng.adj)
    s3_p = s3_pass_pull_plain(eng.mphi, eng.adj,
                              choose_edge_block(2 * n_train, k))
    torch.cuda.synchronize()
    assert torch.equal(s3_k, s3_pass(eng.mphi, eng.adj))
    assert torch.allclose(s3_k, s3_p, rtol=PHI_TOL, atol=PHI_TOL), \
        _rel_err(s3_k, s3_p)
    log(f"phase 3: s3_pass on the engine's mphi, {n_train} links: max err "
        f"vs plain (relative to max(1, |plain|)) {_rel_err(s3_k, s3_p):.3e}, "
        f"two launches bitwise equal")
    del s3_k, s3_p
    t2 = time.perf_counter()
    build_adjacency(net.training_links, n, dev)
    torch.cuda.synchronize()
    log(f"phase 3: the adjacency of the training links builds in "
        f"{time.perf_counter() - t2:.2f} s of that set-up")
    # the kernels alone on this engine's state
    from svinet_torch.ops.digamma import dirichlet_expectation
    from svinet_torch.svi.sweep_math import (
        fused_phi_s3_pass, mean_indicator_update, phi_pass)
    d_ms = cuda_ms(lambda: dirichlet_expectation(eng.gamma), 5)
    elogpi = dirichlet_expectation(eng.gamma)
    elb0 = dirichlet_expectation(eng.lam)[:, 0].contiguous()
    p_ms = cuda_ms(lambda: phi_pass(elogpi, elb0, eng.adj), 5)
    p_bound, p_by = phi_bound(n, k, n_train, eng.adj)
    s_ms = cuda_ms(lambda: s3_pass(eng.mphi, eng.adj), 5)
    s_bound, s_by = s3_bound(n, k, n_train, eng.adj)
    f_ms = cuda_ms(lambda: fused_phi_s3_pass(elogpi, eng.mphi, elb0, eng.adj,
                                             one_launch=True), 5)
    f_bound, f_by = fused_bound(n, k, n_train, eng.adj)
    # the bf16 forms of the passes over links on the same state, beside
    # their bound (each byte once) and the floor of uncached row gathers
    bf = torch.bfloat16
    elogpi_b = dirichlet_expectation(eng.gamma, out_dtype=bf)
    mphi_b = eng.mphi.to(bf)
    pb_ms = cuda_ms(lambda: phi_pass(elogpi_b, elb0, eng.adj), 5)
    sb_ms = cuda_ms(lambda: s3_pass(mphi_b, eng.adj), 5)
    fb_ms = cuda_ms(lambda: fused_phi_s3_pass(elogpi_b, mphi_b, elb0, eng.adj,
                                              one_launch=True), 5)
    s3_b = s3_pass(mphi_b, eng.adj)
    s3_bp = s3_pass_pull_plain(mphi_b, eng.adj,
                               choose_edge_block(2 * n_train, k))
    torch.cuda.synchronize()
    assert torch.allclose(s3_b, s3_bp, rtol=PHI_TOL, atol=PHI_TOL), \
        _rel_err(s3_b, s3_bp)
    log(f"phase 3: on the stretch state over bf16 rows: phi_pass "
        f"{pb_ms:.4f} ms (bound "
        f"{phi_bound(n, k, n_train, eng.adj, 2)[0]:.4f} ms, uncached-gather "
        f"floor {gather_floor_ms(n, k, n_train, 2, 2, 6):.4f} ms; f32 rows: "
        f"floor {gather_floor_ms(n, k, n_train, 2, 4, 8):.4f} ms), s3_pass "
        f"{sb_ms:.4f} ms (bound {s3_bound(n, k, n_train, eng.adj, 2)[0]:.4f} "
        f"ms, floor {gather_floor_ms(n, k, n_train, 1, 2, 2):.4f} ms; f32 "
        f"rows: floor {gather_floor_ms(n, k, n_train, 1, 4, 4):.4f} ms; "
        f"{_rel_err(s3_b, s3_bp):.3e} from its plain version), "
        f"fused_phi_s3_pass in one launch {fb_ms:.4f} ms (bound "
        f"{fused_bound(n, k, n_train, eng.adj, 2)[0]:.4f} ms, floor "
        f"{gather_floor_ms(n, k, n_train, 3, 2, 8):.4f} ms; f32 rows: floor "
        f"{gather_floor_ms(n, k, n_train, 3, 4, 12):.4f} ms), kernel 2 then "
        f"kernel 4 {pb_ms + sb_ms:.4f} ms")
    del elogpi_b, mphi_b
    gacc, sumk = phi_pass(elogpi, elb0, eng.adj)
    del elogpi
    m_ms = cuda_ms(lambda: mean_indicator_update(
        gacc, sumk, eng.deg, eng.consts, True, mphi_out=eng.mphi), 5)
    m_bound, m_by = mean_bound(n, k)
    log(f"phase 3: on the stretch state: dirichlet_expectation {d_ms:.4f} "
        f"ms, phi_pass {p_ms:.4f} ms (bound {p_bound:.4f} ms, {p_by}), "
        f"mean_indicator_update {m_ms:.4f} ms (bound {m_bound:.4f} ms, "
        f"{m_by}), s3_pass {s_ms:.4f} ms (bound {s_bound:.4f} ms, {s_by}), "
        f"fused_phi_s3_pass in one launch {f_ms:.4f} ms (bound "
        f"{f_bound:.4f} ms, {f_by}), kernel 2 then kernel 4 "
        f"{p_ms + s_ms:.4f} ms")
    del gacc, sumk
    torch.cuda.empty_cache()
    return phase3_mmsb(dev, eng), eng, uniform_report


def uniform_bound(rows, k):
    """Kernel 17's bound: the (rows, K) floats written once; about 100
    integer instructions an element (threefry2x32-20, the xor of its words
    and the float), each an operation at the f32 rate of the table (the
    card's 32-bit integer rate is half that)."""
    return bound(4.0 * rows * k, 100.0 * rows * k)


def phase3_uniform(dev, eng, init_launches):
    """Kernel 17 on the stretch engine's device init: one launch a padded
    edge block in the engine's build (init_launches, counted around it),
    bit for bit its plain version at the block's shape and across two
    launches, timed; the init alone timed again and held to the engine's
    gamma (1e-5 relative: the adds into the rows are atomics). Returns the
    kernel's report at the block's shape."""
    from svinet_torch.ops import threefry
    from svinet_torch.ops.edges import choose_edge_block, pad_edges
    from svinet_torch.svi.linksampling import init_gamma_from_links_device
    net, cfg = eng.network, eng.cfg
    n, k = net.n, eng.k
    block = choose_edge_block(len(net.training_links), k)
    ie, im = pad_edges(net.edges, block)
    num_blocks = ie.shape[0] // block
    counted, forms = init_launches
    assert counted["uniform_rows"] == num_blocks, (counted, num_blocks)
    assert forms["uniform_rows:f32"] == num_blocks, forms
    key = threefry.split_keys(threefry.prng_key(cfg.seed),
                              num_blocks)[num_blocks // 2]
    out = torch.empty((block, k), device=dev)
    threefry.uniform_rows(key, out)
    want = threefry.uniform_rows_plain(key, torch.empty_like(out))
    again = threefry.uniform_rows(key, torch.empty_like(out))
    torch.cuda.synchronize()
    assert torch.equal(out, want) and torch.equal(out, again)
    ms = cuda_ms(lambda: threefry.uniform_rows(key, out), 10)
    plain_ms = cuda_ms(lambda: threefry.uniform_rows_plain(key, out), 3)
    bnd = uniform_bound(block, k)
    edges = torch.as_tensor(ie, device=dev)
    mask = torch.as_tensor(im, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gamma = init_gamma_from_links_device(cfg.seed, edges, mask, n, k,
                                         cfg.alpha, num_blocks)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    err = _close_to_max(gamma, eng.gamma)
    assert err <= 1e-5, err
    log(f"phase 3: uniform_rows (kernel 17) at the stretch block "
        f"({block}, {k}): {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bnd[0]:.4f} ms ({bnd[1]}); bit for bit the plain version's and "
        f"JAX's stream, two launches bitwise equal; the engine's device "
        f"init launched it {num_blocks} times (one a padded edge block of "
        f"{net.edges.shape[0]} links); the init alone {init_s * 1e3:.1f} ms"
        f", its gamma within {err:.2e} of the engine's")
    del gamma, edges, mask, out, want, again
    torch.cuda.empty_cache()
    return dict(_report(0.0, ms, plain_ms, bnd), launches=num_blocks)


# ---------------------------------------------------------------------------
# Kernel 8 (the per-pair phi fixed point of MMSBInfer) and kernel 9 (the
# edge assignments of the community extraction)

def fp_bound(n, k, m, active, rounds_sum, elbo=False, update=False):
    """Kernel 8's bound from this run's rounds: the two gathered rows of
    every pair that iterates, the pairs, labels and weights, Elogbeta, and
    the outputs (gamma_hat, or with the step's update folded into the node
    pass gamma read and the next gamma written, and lacc; the ELBO form one
    value), against the f32 operations (about 10 a column a softmax of a
    round, 6 a column a pair for the outputs) and the exponentials (2K a
    round; the ELBO form adds 2K logarithms a pair) at the special-function
    rate."""
    n_bytes = (8.0 * active * k + 16.0 * m + 8.0 * k + 4.0 * m
               + (4.0 if elbo else (8.0 if update else 4.0) * n * k
                  + 8.0 * k))
    ops = 20.0 * k * rounds_sum + 6.0 * k * active
    sfu = 2.0 * k * rounds_sum + (2.0 * k * active if elbo else 0.0)
    t = {"bytes": n_bytes / PEAK_BYTES_S * 1e3,
         "operations": max(ops / PEAK_F32_S, sfu / PEAK_SFU_S) * 1e3}
    by = max(t, key=t.get)
    return t[by], by


def fp_floor_ms(n, k, active, elbo=False, update=False):
    """Kernel 8's floor: the 2 rows of each pair that iterates gathered
    from device memory in whole 32-byte sectors (random pairs of a 2 GB
    array find nothing in the L2), and for the training form gamma_hat
    written once, or with the step's update gamma read and the next gamma
    written once, as an SVI step does whichever design runs it, at
    3.35 TB/s."""
    row = -(-4 * k // 32) * 32
    out = 0.0 if elbo else (8.0 if update else 4.0) * n * k
    return (2.0 * active * row + out) / PEAK_BYTES_S * 1e3


def _fp_state(dev, gen, n, k):
    """Elogpi and Elogbeta of a mid-fit-like state: gamma rows spread from
    near-uniform to near one community."""
    from svinet_torch.ops.digamma import dirichlet_expectation_plain
    gamma = 0.05 + torch.rand((n, k), generator=gen, device=dev) ** 4 * 10.0
    lam = 1.0 + 19.0 * torch.rand((k, 2), generator=gen, device=dev)
    return (dirichlet_expectation_plain(gamma),
            dirichlet_expectation_plain(lam))


def _fp_pairs(dev, gen, n, m):
    """m random pairs (10% links, 5% of weight 0 as -inf masks them), or
    with m = -1 one -rnode minibatch: node n // 3 with every other."""
    if m < 0:
        r = n // 3
        other = torch.cat([torch.arange(r, device=dev),
                           torch.arange(r + 1, n, device=dev)])
        pairs = torch.stack([other.clamp(max=r), other.clamp(min=r)], 1)
        m = n - 1
    else:
        pairs = torch.randint(0, n, (m, 2), generator=gen, device=dev)
    y = (torch.rand(m, generator=gen, device=dev) < 0.1).to(torch.int32)
    w = torch.where(torch.rand(m, generator=gen, device=dev) < 0.05, 0.0,
                    0.5 + torch.rand(m, generator=gen, device=dev))
    return pairs.to(torch.int32).contiguous(), y, w


def _split_pairs(elogpi, elogbeta, pairs, y, w, rounds, staged, log_eps):
    """The pairs whose phi (from the kernel's staging rows) differs from
    the plain version's in float64 on the same rounds by more than
    FP_SPLIT_PHI, and the largest difference over the others (pairs of
    weight 0 have no staging rows and are left out)."""
    from svinet_torch.ops.phicomp import _plain_blocks, phi_fixed_point_plain
    split = torch.zeros(pairs.shape[0], dtype=torch.bool,
                        device=pairs.device)
    worst = 0.0
    for lo, hi in _plain_blocks(pairs.shape[0], elogpi.shape[1]):
        p, q = pairs[lo:hi, 0].long(), pairs[lo:hi, 1].long()
        live = w[lo:hi] != 0
        p1, p2, _ = phi_fixed_point_plain(
            elogpi[p].double(), elogpi[q].double(), elogbeta.double(),
            y[lo:hi], log_eps, 50, 1e-5, given=rounds[lo:hi])
        d = torch.maximum(
            (staged[2 * lo:2 * hi:2].double() - p1).abs().amax(1),
            (staged[2 * lo + 1:2 * hi:2].double() - p2).abs().amax(1))
        bad = (d > FP_SPLIT_PHI) & live
        split[lo:hi] = bad
        ok = d[(~bad) & live]
        if ok.numel():
            worst = max(worst, float(ok.max()))
    return split, worst


def _block_rounds_differ(r_k, r_p):
    """Blocks of the rule whose rounds on the card (r_k, each pair's R_b)
    and in the plain version (r_p) differ: a block whose largest change
    sits within an f32 unit of the threshold can end a round apart.
    Returns (blocks, blocks that differ, the largest difference)."""
    from svinet_torch.ops.phicomp import BLOCK
    bk, bp = r_k[::BLOCK].long(), r_p[::BLOCK].long()
    return (bk.numel(), int((bk != bp).sum()),
            int((bk - bp).abs().max()) if bk.numel() else 0)


def _close_to_max(got, want):
    """max |got - want| over the largest |want|."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def phase1_phi_fixed_point(dev):
    """Kernel 8 at every shape of FP_SHAPES against its plain version run
    in float64 for the rounds the kernel gave each pair's block, two
    launches bitwise equal, every pair of a block (weight 0 too) on the
    block's rounds; then its ELBO form on all pairs of a planted n=2,000,
    K=20 graph, each pair's term held to the plain one. Each pair's phi
    (the kernel's staging rows) is held to the plain version's: a few
    pairs whose iteration has two attractors end in different ones in f32
    and in f64 (in one -rnode minibatch at n=1M, a pair moved an entry of
    gamma_hat and of lambda_hat by 1.1 out of 16,000); their share is
    logged and held under FP_SPLIT_SHARE, and gamma_hat and lambda_hat
    of a second launch with those pairs at weight 0 are held to FP_TOL of
    their largest entry. The plain version left to the rule itself is
    logged beside, with the blocks whose rounds differ from the kernel's.
    Returns the reports of the training form (at the stretch random-pair
    shape) and of the ELBO form."""
    from svinet_torch.ops.edges import owner_csr
    from svinet_torch.ops.phicomp import (
        BLOCK, fixed_point_plan, pair_block_stats_plain, pair_elbo_plain,
        pair_elbo_terms, phi_fixed_point, phi_fixed_point_plain)
    log_eps = float(np.float32(np.log(1e-30)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    report = None
    for n, k, m in FP_SHAPES:
        elogpi, elogbeta = _fp_state(dev, gen, n, k)
        pairs, y, w = _fp_pairs(dev, gen, n, m)
        m = pairs.shape[0]
        csr = owner_csr(pairs.reshape(-1), n)

        def run():
            return phi_fixed_point(elogpi, elogbeta, pairs, y, w, log_eps,
                                   50, 1e-5, csr=csr)

        def plain(given=None, dt=torch.float32):
            return pair_block_stats_plain(elogpi.to(dt), elogbeta.to(dt),
                                          pairs, y, w.to(dt), log_eps, 50,
                                          1e-5, given=given)

        g_k, l_k, r_k, staged, stop = phi_fixed_point(
            elogpi, elogbeta, pairs, y, w, log_eps, 50, 1e-5, csr=csr,
            keep_staged=True)
        g_2, l_2, r_2 = run()
        torch.cuda.synchronize()
        assert (torch.equal(g_k, g_2) and torch.equal(l_k, l_2)
                and torch.equal(r_k, r_2)), (n, k, m, "two launches differ")
        del g_2
        # every pair of a block on the block's rounds
        blk = torch.arange(m, device=dev) // BLOCK
        assert torch.equal(r_k, r_k[::BLOCK][blk]), (n, k, m)
        assert int(r_k.min()) >= 1 and int(r_k.max()) <= 50
        g_p, l_p, _ = plain(r_k, torch.float64)
        err_all = max(_close_to_max(g_k, g_p), _close_to_max(l_k, l_p))
        del g_p
        split, phi_err = _split_pairs(elogpi, elogbeta, pairs, y, w, r_k,
                                      staged, log_eps)
        del staged
        n_split = int(split.sum())
        assert n_split <= FP_SPLIT_SHARE * m, (n, k, m, n_split)
        unconv = r_k >= 50
        w_c = torch.where(split, 0.0, w)
        g_c, l_c, r_c = phi_fixed_point(elogpi, elogbeta, pairs, y, w_c,
                                        log_eps, 50, 1e-5, csr=csr)
        # weights enter only the sums: the same rounds
        assert torch.equal(r_c, r_k), (n, k, m)
        g_p, l_p, _ = pair_block_stats_plain(
            elogpi.double(), elogbeta.double(), pairs, y, w_c.double(),
            log_eps, 50, 1e-5, given=r_k)
        err = max(_close_to_max(g_c, g_p), _close_to_max(l_c, l_p))
        assert err <= FP_TOL, (n, k, m, err)
        assert torch.isfinite(g_k).all() and torch.isfinite(l_k).all()
        del g_c
        g_f, l_f, r_p = plain()
        err_free = max(_close_to_max(g_k, g_f), _close_to_max(l_k, l_f))
        del g_f
        n_blocks, n_differ, r_gap = _block_rounds_differ(r_k, r_p)
        # pass 1's rounds to each pair's final phis; those past R_b ran
        # again for R_b in pass 2
        reruns = int(((stop > r_k) & (w != 0)).sum())
        # each pair (and the padding slot) its block's R_b rounds
        needed = float(torch.minimum(stop, r_k).double().sum())
        big = n * k >= 10**7
        ms = cuda_ms(run, 3 if big else 20)
        plain_ms = cuda_ms(plain, 1 if big else 3)
        bnd = fp_bound(n, k, m, m, needed)
        floor = fp_floor_ms(n, k, m)
        plan = fixed_point_plan(k, False, m, dev)
        assert plan["layout"] == ("shared rows" if k <= FP_SHARED_MAX_K
                                  else "device rows"), (k, plan)
        shape = (f"n={n} K={k} pairs={m}"
                 + (" (one -rnode minibatch)" if m == n - 1 else ""))
        log(f"phase 1: phi_fixed_point {shape}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), floor "
            f"{floor:.4f} ms (gathers, gamma_hat written); launch "
            f"{plan['blocks']} blocks of {plan['groups_per_block']} pairs, "
            f"{plan['blocks_per_sm']} blocks an SM, {plan['lanes']} lanes a "
            f"pair, {plan['layout']} ({plan['smem_bytes']} bytes a block), "
            f"{plan['registers']} registers; {n_blocks} blocks of "
            f"{BLOCK}, R_b mean {float(r_k[::BLOCK].double().mean()):.2f}"
            f" ({int(unconv.sum())} pairs at 50); pass 1 rounds to the final "
            f"phis mean {float(stop.double().mean()):.2f}, needed within R_b "
            f"{needed / m:.2f} a pair, {reruns} pairs run again in pass 2; "
            f"on the kernel's rounds phi within {phi_err:.3e} of the plain "
            f"version's on all but {n_split} pairs (other attractor), err "
            f"(of the largest entry) {err:.3e} without them ({err_all:.3e} "
            f"with them); the plain version under the rule itself: R_b "
            f"differs on {n_differ} of {n_blocks} blocks (by at most "
            f"{r_gap}), err {err_free:.3e}; two launches bitwise equal")
        if (n, k, m) == (1_000_000, 500, 500_000):
            report = dict(_report(err, ms, plain_ms, bnd), floor_ms=floor)
        del g_k, g_p, elogpi, csr
        torch.cuda.empty_cache()
    # the ELBO form on every pair of a planted graph, links as in the graph
    from svinet_torch.synth import planted_blocks
    n, k = BATCH_PLANTED["n"], BATCH_PLANTED["k"]
    raw, _ = planted_blocks(n, k, BATCH_PLANTED["avg_deg"],
                            BATCH_PLANTED["seed"])
    iu = torch.triu_indices(n, n, 1, device=dev).t().to(torch.int32)
    lo = np.minimum(raw[:, 0], raw[:, 1])
    hi = np.maximum(raw[:, 0], raw[:, 1])
    keys = torch.as_tensor(lo * n + hi, device=dev)
    y = torch.isin(iu[:, 0].long() * n + iu[:, 1].long(), keys).to(
        torch.int32)
    w = torch.ones(iu.shape[0], dtype=torch.float32, device=dev)
    elogpi, elogbeta = _fp_state(dev, gen, n, k)

    def run_elbo():
        return phi_fixed_point(elogpi, elogbeta, iu, y, w, log_eps, 50, 1e-5,
                               elbo=True)

    e_k, r_k, terms, stop = phi_fixed_point(elogpi, elogbeta, iu, y, w,
                                            log_eps, 50, 1e-5, elbo=True,
                                            keep_staged=True)
    e_2, r_2 = run_elbo()
    e_p, _ = pair_elbo_plain(elogpi.double(), elogbeta.double(), iu, y,
                             w.double(), log_eps, 50, 1e-5, given=r_k)
    torch.cuda.synchronize()
    assert torch.equal(e_k, e_2) and torch.equal(r_k, r_2)
    err_e = abs(float(e_k) - float(e_p)) / abs(float(e_p))
    assert err_e <= FP_TOL, err_e
    # each pair's term on the kernel's rounds, in float64 (relative, or
    # absolute under 1): a pair whose phi went to another attractor in f32
    # (further than FP_SPLIT_PHI) is counted as in the training form, the
    # others held to FP_TOL
    term_err, n_split = 0.0, 0
    for lo_, hi_ in _spans(iu.shape[0], 1 << 20):
        p, q = iu[lo_:hi_, 0].long(), iu[lo_:hi_, 1].long()
        ep, eq = elogpi[p].double(), elogpi[q].double()
        p1, p2, _ = phi_fixed_point_plain(ep, eq, elogbeta.double(),
                                          y[lo_:hi_], log_eps,
                                          given=r_k[lo_:hi_])
        t = pair_elbo_terms(p1, p2, ep, eq, elogbeta.double(), y[lo_:hi_],
                            log_eps)
        d = (terms[lo_:hi_].double() - t).abs() / t.abs().clamp_min(1.0)
        bad = d > FP_SPLIT_PHI
        n_split += int(bad.sum())
        if (~bad).any():
            term_err = max(term_err, float(d[~bad].max()))
    assert n_split <= FP_SPLIT_SHARE * iu.shape[0], n_split
    assert term_err <= FP_TOL, term_err
    _, r_p = pair_elbo_plain(elogpi, elogbeta, iu, y, w, log_eps, 50, 1e-5)
    n_blocks, n_differ, r_gap = _block_rounds_differ(r_k, r_p)
    ms = cuda_ms(run_elbo, 5)
    plain_ms = cuda_ms(lambda: pair_elbo_plain(elogpi, elogbeta, iu, y, w,
                                               log_eps, 50, 1e-5), 2)
    needed = float(torch.minimum(stop, r_k).double().sum())
    bnd = fp_bound(n, k, iu.shape[0], iu.shape[0], needed, True)
    floor = fp_floor_ms(n, k, iu.shape[0], elbo=True)
    log(f"phase 1: phi_fixed_point ELBO form, all {iu.shape[0]} pairs of a "
        f"planted n={n} K={k} graph ({int(y.sum())} links): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms "
        f"({bnd[1]}), floor {floor:.4f} ms, R_b mean "
        f"{float(r_k[::BLOCK].double().mean()):.2f} max {int(r_k.max())}, "
        f"needed within R_b {needed / iu.shape[0]:.2f} a pair; sum "
        f"{float(e_k):.6e} against {float(e_p):.6e} (rel err {err_e:.3e}), "
        f"each pair's term within {term_err:.3e} (relative, or absolute "
        f"under 1) but {n_split} (other attractor); the plain version "
        f"under the rule itself: R_b differs on {n_differ} of {n_blocks} "
        f"blocks (by at most {r_gap}); two launches bitwise equal")
    return report, dict(_report(err_e, ms, plain_ms, bnd), floor_ms=floor)


def _spans(m, size):
    for lo in range(0, m, size):
        yield lo, min(lo + size, m)


def assign_bound(n, k, e, n_owners):
    """Kernel 9: Elogpi read once, Elogbeta0, the links and their CSR read
    once, argmax and max written; per link and column about 6 f32
    operations and an exponential (at the special-function rate). Also the
    floors of uncached 2 KB-row gathers: E + (nodes with links) rows as
    the kernel reads them, and 2E."""
    n_bytes = 4.0 * n * k + 4.0 * k + 8.0 * e + 4.0 * (n + 1 + e) + 8.0 * e
    t = {"bytes": n_bytes / PEAK_BYTES_S * 1e3,
         "operations": max(6.0 * e * k / PEAK_F32_S,
                           1.0 * e * k / PEAK_SFU_S) * 1e3}
    by = max(t, key=t.get)
    floor = (e + n_owners) * k * 4.0 / PEAK_BYTES_S * 1e3
    floor2 = 2.0 * e * k * 4.0 / PEAK_BYTES_S * 1e3
    return (t[by], by), floor, floor2


def _assign_v1(elogpi, elb0, edges, csr):
    """PR 8's kernel 9 (csrc/alt/edge_assign_v1.cu, built on first use
    beside the library, off the path) on the wrapper's inputs: (argmax,
    max phi)."""
    from svinet_torch.kernels import build
    global _ASSIGN_V1
    if _ASSIGN_V1 is None:
        _ASSIGN_V1 = build.build_library(
            "svinet_torch_assign_v1",
            [build.CSRC / "alt" / "edge_assign_v1.cu",
             build.CSRC / "runtime.cu"],
            {"svt_edge_assign_v1": build.SIGNATURES["svt_edge_assign"]})
    e = edges.shape[0]
    argmax = torch.empty(e, dtype=torch.int32, device=edges.device)
    maxval = torch.empty(e, dtype=torch.float32, device=edges.device)
    _ASSIGN_V1.call("svt_edge_assign_v1", elogpi.data_ptr(), elb0.data_ptr(),
                    edges.data_ptr(), csr.rowptr.data_ptr(),
                    csr.nbr.data_ptr(), csr.seg_node.data_ptr(),
                    csr.seg_begin.data_ptr(), csr.seg_end.data_ptr(),
                    argmax.data_ptr(), maxval.data_ptr(), elogpi.shape[0],
                    csr.seg_node.shape[0], elogpi.shape[1], csr.seg_len,
                    torch.cuda.current_stream().cuda_stream)
    return argmax, maxval


_ASSIGN_V1 = None


def check_edge_assign(dev, gamma, lam, edges, mask, csr, label):
    """Kernel 9 against its plain version on one state: argmax equal on
    every link whose two largest phi differ by more than 1e-6, max phi to
    1e-6, two launches bitwise equal; and against PR 8's design
    (csrc/alt/edge_assign_v1.cu) bit for bit, both timed with Elogpi and
    Elogbeta given and with kernel 1 on gamma and lambda (the wrapper).
    Returns its report."""
    from svinet_torch.ops.expectations import dirichlet_expectation
    from svinet_torch.svi.communities import (
        edge_assignments, edge_assignments_plain)
    a_k, m_k = edge_assignments(gamma, lam, edges, mask, csr=csr)
    a_2, m_2 = edge_assignments(gamma, lam, edges, mask, csr=csr)
    elogpi = dirichlet_expectation(gamma)
    elb0 = dirichlet_expectation(lam)[:, 0].contiguous()
    a_p, m_p = edge_assignments_plain(elogpi, elb0, edges)
    a_1, m_1 = _assign_v1(elogpi, elb0, edges, csr)
    torch.cuda.synchronize()
    assert torch.equal(a_k, a_2) and torch.equal(m_k, m_2), label
    assert torch.equal(a_k, a_1) and torch.equal(m_k, m_1), (
        label, "not PR 8's bits", int((a_k != a_1).sum()),
        float((m_k - m_1).abs().max()))
    # the gap between the two largest phi of each link, blocked
    e, k = edges.shape[0], gamma.shape[1]
    block = max(1, (1 << 26) // k)
    clear = torch.empty(e, dtype=torch.bool, device=dev)
    for lo in range(0, e, block):
        b = edges[lo:lo + block].long()
        top = torch.softmax(elogpi[b[:, 0]] + elogpi[b[:, 1]] + elb0,
                            -1).topk(2, dim=-1).values
        clear[lo:lo + block] = top[:, 0] - top[:, 1] > 1e-6
    agree = bool(torch.equal(a_k[clear], a_p[clear]))
    err = float((m_k - m_p).abs().max())
    share = float((a_k == a_p).float().mean())
    assert agree and err <= 1e-6, (label, agree, err)
    n = gamma.shape[0]
    reps = 3 if e * k > 10**9 else 20
    ms = cuda_ms(lambda: edge_assignments(gamma, lam, edges, mask, csr=csr),
                 reps)
    alone = {name: cuda_ms(fn, reps) for name, fn in (
        ("v1", lambda: _assign_v1(elogpi, elb0, edges, csr)),
        ("new", lambda: _assign_v2(elogpi, elb0, edges, csr)),
        ("v1 again", lambda: _assign_v1(elogpi, elb0, edges, csr)),
        ("new again", lambda: _assign_v2(elogpi, elb0, edges, csr)))}
    plain_ms = cuda_ms(lambda: edge_assignments_plain(elogpi, elb0, edges),
                       1 if e * k > 10**9 else 5)
    owners = int((csr.rowptr[1:] > csr.rowptr[:-1]).sum())
    bnd, floor, floor2 = assign_bound(n, k, e, owners)
    new_ms = min(alone["new"], alone["new again"])
    v1_ms = min(alone["v1"], alone["v1 again"])
    log(f"phase {label}: edge_assignments n={n} K={k} links={e}: kernel "
        f"{ms:.4f} ms (with kernel 1 on gamma and lambda), kernel alone "
        f"{alone['new']:.4f} / {alone['new again']:.4f} ms against PR 8's "
        f"{alone['v1']:.4f} / {alone['v1 again']:.4f} (bit for bit equal), "
        f"plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), floor "
        f"of E + {owners} uncached rows {floor:.4f} ms ({floor / new_ms:.0%}"
        f" reached; PR 8's {floor / v1_ms:.0%}; 2E rows: {floor2:.4f} ms), "
        f"argmax equal to the plain version's on {share:.6%} of the links "
        f"and on every link whose top two phi differ by more than 1e-6 "
        f"({int(clear.sum())}), max phi err {err:.3e}, two launches bitwise "
        f"equal")
    return dict(_report(err, ms, plain_ms, bnd), floor_ms=floor,
                kernel_alone_ms=new_ms, pr8_ms=v1_ms)


def _assign_v2(elogpi, elb0, edges, csr):
    """The library's kernel 9 on the wrapper's inputs, Elogpi and Elogbeta
    given (its launch as edge_assignments makes it, uncounted)."""
    from svinet_torch.kernels import build
    e = edges.shape[0]
    argmax = torch.empty(e, dtype=torch.int32, device=edges.device)
    maxval = torch.empty(e, dtype=torch.float32, device=edges.device)
    build.launch("svt_edge_assign", edges.device, elogpi.data_ptr(),
                 elb0.data_ptr(), edges.data_ptr(), csr.rowptr.data_ptr(),
                 csr.nbr.data_ptr(), csr.seg_node.data_ptr(),
                 csr.seg_begin.data_ptr(), csr.seg_end.data_ptr(),
                 argmax.data_ptr(), maxval.data_ptr(), elogpi.shape[0],
                 csr.seg_node.shape[0], elogpi.shape[1], csr.seg_len)
    return argmax, maxval


# kernel 9 on planted-20k's links beside its K=20 state: wide states (the
# sparse crossover's widths)
ASSIGN_WIDE_K = (2_000, 8_000)


def phase1_edge_assign(dev, workdir):
    """Kernel 9 on planted-20k's training links and initial state, as the
    CLI run of phase 2 holds them, then on the same links at K = 2000 and
    8000 (gamma spread as _fp_state spreads it)."""
    from svinet_torch.ops.edges import owner_csr
    from svinet_torch.svi.linksampling import from_edges
    from svinet_torch.synth import planted_blocks
    raw, _ = planted_blocks(PLANTED["n"], PLANTED["k"], PLANTED["avg_deg"],
                            PLANTED["seed"])
    eng = from_edges(raw, PLANTED["n"], PLANTED["k"], dev,
                     os.path.join(workdir, "assign"), seed=1)
    csr = owner_csr(eng.edges[:, 0], eng.n)
    report = check_edge_assign(dev, eng.gamma, eng.lam, eng.edges, eng.mask,
                               csr, "1")
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    for k in ASSIGN_WIDE_K:
        gamma = 0.05 + torch.rand((eng.n, k), generator=gen,
                                  device=dev) ** 4 * 10.0
        lam = 1.0 + 19.0 * torch.rand((k, 2), generator=gen, device=dev)
        check_edge_assign(dev, gamma, lam, eng.edges, eng.mask, csr, "1")
        del gamma
    eng.close()
    return report


def _run_engine_cli(workdir, net, gt, n, k, label, extra):
    """The port's CLI with no -link-sampling (MMSBInfer); returns its
    output directory."""
    from svinet_torch.cli import main
    os.chdir(workdir)
    assert main(["-file", net, "-n", str(n), "-k", str(k), "-nmi", gt,
                 "-seed", "1", "-lt-min-deg", "1", "-label", label,
                 *extra]) == 0
    outs = [d for d in os.listdir(workdir)
            if d.startswith(f"n{n}-k{k}-{label}-seed1")]
    assert len(outs) == 1, outs
    return os.path.join(workdir, outs[0])


def _mmsb_rows(out):
    """The rows phase 2 holds to the CPU: heldout.txt's likelihood columns
    at each report, validation.txt's (at new maxima; none before the
    min(n, 5000) guard), logl.txt's."""
    def rows(name, cols):
        path = os.path.join(out, name)
        if not os.path.exists(path) or not os.path.getsize(path):
            return []
        a = np.loadtxt(path, ndmin=2)
        return [[int(r[0])] + [float(r[c]) for c in cols] for r in a]
    return {"heldout": rows("heldout.txt", (2, 4, 6, 8, 9, 10)),
            "validation": rows("validation.txt", (2, 4, 6)),
            "logl": rows("logl.txt", (2,))}


def _mmsb_runs(workdir, record):
    """MMSBInfer's CLI runs of phase 2 (no engine flag, -rnode, -stratified
    -rpair on planted-20k; -batch -logl, and no engine flag at K=640, on a
    planted n=2,000 graph).
    Returns ({label: rows}, {label: (out, seconds, launches, forms)})."""
    from svinet_torch.synth import write_planted
    net, gt = write_planted(workdir, PLANTED["n"], PLANTED["k"],
                            PLANTED["avg_deg"], PLANTED["seed"])
    bnet, bgt = write_planted(workdir, BATCH_PLANTED["n"],
                              BATCH_PLANTED["k"], BATCH_PLANTED["avg_deg"],
                              BATCH_PLANTED["seed"])
    runs = [(label, net, gt, PLANTED, [*flags, *MMSB_FLAGS])
            for label, flags in MMSB_RUNS.items()]
    runs.append(("mmsb-batch", bnet, bgt, BATCH_PLANTED, BATCH_FLAGS))
    runs.append(("mmsb-wide", bnet, bgt, dict(BATCH_PLANTED, k=MMSB_WIDE_K),
                 MMSB_WIDE_FLAGS))
    rows, info = {}, {}
    for label, nt, g, shape, flags in runs:
        label = label + ("-cpu" if record else "")
        if not record:
            _zero_counts()
        t0 = time.perf_counter()
        out = _run_engine_cli(workdir, nt, g, shape["n"], shape["k"], label,
                              flags)
        secs = time.perf_counter() - t0
        rows[label.replace("-cpu", "")] = _mmsb_rows(out)
        if not record:
            info[label] = (out, secs, *_read_counts())
    return rows, info


def record_cpu(which=("mmsb", "fa", "famm", "fk", "sbm", "orig")) -> int:
    """--record-cpu [mmsb|fa|famm|fk|sbm|orig]: run phase 2's MMSBInfer
    runs, phase 5's FastAMM2 run, phase 6's FastAMM runs, phase 7's
    FastInit and SBM runs and phase 8's -orig runs on the CPU (the plain
    versions) and print the rows MMSB_CPU_ROWS, FA_CPU_ROWS,
    FAMM_CPU_ROWS, FK_CPU, SBM_CPU_ROWS and ORIG_CPU_ROWS hold."""
    os.environ["SVINET_TORCH_DEVICE"] = "cpu"
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as workdir:
        try:
            if "mmsb" in which:
                rows, _ = _mmsb_runs(workdir, record=True)
                print("MMSB_CPU_ROWS = " + json.dumps(rows))
            if "fa" in which:
                net, gt, _ = _planted_graphs(workdir)["planted"]
                out = _fa_cli(workdir, net, gt, "fa-cpu", FA_FLAGS)
                print("FA_CPU_ROWS = " + json.dumps({"fa": _fa_rows(out)}))
            if "famm" in which:
                rows, _ = _famm_runs(workdir, record=True)
                print("FAMM_CPU_ROWS = " + json.dumps(
                    {k: v for k, v in rows.items() if "before" not in k}))
            if "fk" in which or "sbm" in which:
                rows, _ = _p7_runs(workdir, record=True)
                print("FK_CPU = " + json.dumps(rows["fk"]))
                print("SBM_CPU_ROWS = " + json.dumps(
                    {k: rows[k] for k in ("sbm", "sbmi")}))
            if "orig" in which:
                rows, _, _, _ = _orig_runs(workdir, record=True)
                print("ORIG_CPU_ROWS = " + json.dumps(rows))
        finally:
            os.chdir(cwd)
    return 0


def _rows_close(got, want, label):
    for name in want:
        g, w = got[name], want[name]
        assert len(g) == len(w), (label, name, len(g), len(w))
        for a, b in zip(g, w):
            assert a[0] == b[0], (label, name, a, b)
            np.testing.assert_allclose(a[1:], b[1:], rtol=MMSB_ROW_RTOL,
                                       err_msg=f"{label} {name}")


def phase2_mmsb(workdir):
    """MMSBInfer through the CLI on the card: every run's rows held to the
    CPU port's, kernel 8 launched once a step and its ELBO form once a
    -logl report, kernel 9 once a report. Returns (launches by name and
    form, launches per step)."""
    rows, info = _mmsb_runs(workdir, record=False)
    launches = {}
    for label, (out, secs, counted, forms) in info.items():
        _rows_close(rows[label], MMSB_CPU_ROWS[label], label)
        held = (f"rows {_rows_gap(rows[label], MMSB_CPU_ROWS[label]):.3e} "
                f"from the CPU port's (limit {MMSB_ROW_RTOL:g})")
        mx = open(os.path.join(out, "max.txt")).read().split()
        assert len(mx) == 7, mx
        nmi = float(open(os.path.join(out, "mutual.txt")).read().split()[-1])
        steps = int(mx[0]) + (0 if label == "mmsb-batch" else 1)
        reports = len(rows[label]["heldout"])
        assert counted["phi_fixed_point"] == forms[
            "phi_fixed_point:f32"] + forms.get("phi_fixed_point:elbo", 0)
        assert forms["phi_fixed_point:f32"] == steps, (label, forms, steps)
        # a report's communities, and do_on_stop's
        assert counted["edge_assignments"] == reports + 1, (label, counted)
        if label == "mmsb-batch":
            assert forms["phi_fixed_point:elbo"] == reports, forms
        for name, v in counted.items():
            launches[name] = launches.get(name, 0) + v
        for name, v in forms.items():
            launches[name] = launches.get(name, 0) + v
        flags = {"mmsb-batch": " ".join(BATCH_FLAGS[:2]),
                 "mmsb-wide": f"no engine flag, n=2,000, K={MMSB_WIDE_K}"
                 }.get(label, " ".join(MMSB_RUNS.get(label, [])))
        log(f"phase 2: MMSBInfer {label} ({flags or 'no engine flag'}): "
            f"{secs:.1f} s, {steps} steps, {reports} reports, {held}, last "
            f"heldout nshol "
            f"{rows[label]['heldout'][-1][-1]:.6f}, max.txt {mx}, NMI "
            f"{nmi:.6f}, launches {forms}")
    return launches


def _rows_gap(got, want):
    """The largest relative difference of got's rows from want's, the
    measure MMSB_ROW_RTOL bounds."""
    worst = 0.0
    for name in want:
        for a, b in zip(got[name], want[name]):
            a, b = np.asarray(a[1:], float), np.asarray(b[1:], float)
            worst = max(worst, float((np.abs(a - b) / np.abs(b)).max()))
    return worst


def _crash_after(iteration):
    """Patch EngineBase._end_of_report to raise after the report of
    `iteration` is done and checkpointed; returns the undo."""
    from svinet_torch.svi.base import EngineBase
    orig = EngineBase._end_of_report

    class Cut(Exception):
        pass

    def cut(self):
        orig(self)
        if self.iteration >= iteration and not self._light_report:
            raise Cut

    EngineBase._end_of_report = cut
    return Cut, lambda: setattr(EngineBase, "_end_of_report", orig)


# files of a run whose values are wall time: not compared
_TIMED = {"infer.log", "time.txt", "mrstats.txt", "ckpt"}
_DURATION_COL = {"heldout.txt", "validation.txt", "training.txt",
                 "stats.txt", "max.txt", "convergence.txt",
                 "modularity.txt", "logl.txt", "precision.txt"}


def _strip(path, name):
    lines = open(os.path.join(path, name)).read().splitlines()
    if name in _DURATION_COL:
        return [l.split("\t", 2)[0] + "\t" + l.split("\t", 2)[2]
                for l in lines]
    if name == "convergence_hosts.txt":
        return [l.rsplit("\t", 1)[0] for l in lines]
    return lines


def phase2_resume(workdir, net, gt, out_whole):
    """The default CLI run cut after the report of iteration 30, with a
    checkpoint at every report, then -resume'd: it stops where the
    uninterrupted run (`out_whole`) stopped, and every model and report
    file equals that run's bit for bit (wall-time columns aside). Then an
    MMSBInfer -stratified -rpair run cut and resumed across a report, its
    lambda clock and family phase restored."""
    from svinet_torch.io.checkpoint import load_checkpoint
    Cut, undo = _crash_after(30)
    try:
        _run_cli(workdir, net, gt, "gpu-cut",
                 ["-max-iterations", "400", "-checkpoint-freq", "1e-9"])
        raise AssertionError("the cut run was not cut")
    except Cut:
        pass
    finally:
        undo()
    cut = _run_cli(workdir, net, gt, "gpu-cut", ["-max-iterations", "400",
                                                 "-resume"])
    names = sorted(set(os.listdir(out_whole)) - _TIMED)
    assert names == sorted(set(os.listdir(cut)) - _TIMED), names
    differ = [nm for nm in names
              if _strip(out_whole, nm) != _strip(cut, nm)]
    assert not differ, differ
    mx = open(os.path.join(cut, "max.txt")).read().split()
    nmi = float(open(os.path.join(cut, "mutual.txt")).read().split()[-1])
    assert abs(int(mx[0]) - STOP_ITER_CPU) <= 1 and abs(
        nmi - NMI_CPU) <= NMI_TOL, (mx, nmi)
    log(f"phase 2: -resume: the default run cut after the report of "
        f"iteration 30 and resumed stops at {mx[0]} with NMI {nmi:.6f}; "
        f"{len(names)} model and report files equal the uninterrupted "
        f"run's bit for bit (duration columns aside)")
    # MMSBInfer: the lambda clock (-nodelay: learning from step 0) and the
    # stratified family phase (odd after 15 steps) cross the cut
    flags = ["-stratified", "-rpair", "-nodelay", "-max-iterations", "45",
             "-rfreq", "15"]
    Cut, undo = _crash_after(15)
    try:
        _run_engine_cli(workdir, net, gt, PLANTED["n"], PLANTED["k"],
                        "mmsb-cut", [*flags, "-checkpoint-freq", "1e-9"])
        raise AssertionError("the cut run was not cut")
    except Cut:
        pass
    finally:
        undo()
    outs = [d for d in os.listdir(workdir) if d.startswith(
        f"n{PLANTED['n']}-k{PLANTED['k']}-mmsb-cut-")]
    saved = load_checkpoint(os.path.join(workdir, outs[0]))
    assert saved["iteration"] == 15 and saved["lambda_clock"] == [0, 1, 1], \
        saved["lambda_clock"]
    from svinet_torch.cli import parse_args
    from svinet_torch.graph import Network
    from svinet_torch.svi.mmsb import MMSBInfer
    os.chdir(workdir)
    cfg = parse_args(["-file", net, "-n", str(PLANTED["n"]), "-k",
                      str(PLANTED["k"]), "-nmi", gt, "-seed", "1",
                      "-lt-min-deg", "1", "-label", "mmsb-cut", *flags,
                      "-resume"])
    nw = Network(cfg)
    nw.read(cfg.datfname)
    nw.drop_singles()
    from svinet_torch import resolve_device
    eng = MMSBInfer(cfg, nw, resolve_device())
    clock = [eng._lambda_start_iter, int(eng._delaylearn_reported),
             eng._family]
    assert eng.iteration == 15 and clock == [0, 1, 1], clock
    eng.infer()
    eng.close()
    ho = np.loadtxt(os.path.join(cfg.outdir, "heldout.txt"), ndmin=2)
    assert ho[:, 0].tolist() == [15, 30, 45] and np.isfinite(ho).all()
    log(f"phase 2: MMSBInfer -stratified -rpair -nodelay cut after the "
        f"report of iteration 15 and resumed: lambda clock (start, learning, "
        f"family) {clock} restored, heldout rows at {ho[:, 0].tolist()}, "
        f"last nshol {ho[-1, 10]:.6f}")


def phase3_mmsb(dev, eng):
    """On the stretch engine's graph and state: one MMSBInfer step of
    s = 500,000 random pairs (kernel 1 twice, kernel 8 with the update of
    gamma in its node pass, lambda's update) held to the plain step,
    its time, peak memory and kernel 8's share of it; kernel 9 against its plain version over the
    19.9M training links; log_communities timed, kernel 9 and the host
    side. Returns kernel 9's report."""
    from svinet_torch.ops.expectations import dirichlet_expectation
    from svinet_torch.ops.edges import owner_csr
    from svinet_torch.ops.phicomp import (
        BLOCK, NodeUpdate, node_update_plain, pair_block_stats_plain,
        phi_fixed_point)
    from svinet_torch.svi.mmsb import svi_step
    n, k = eng.n, eng.k
    net = eng.network
    rng = np.random.default_rng(3)
    s = MMSB_STRETCH_S
    a = rng.integers(0, n, size=2 * s)
    b = rng.integers(0, n, size=2 * s)
    ok = (a != b) & net.edge_ok_mask(np.minimum(a, b), np.maximum(a, b))
    lo = np.minimum(a, b)[ok][:s]
    hi = np.maximum(a, b)[ok][:s]
    y = torch.as_tensor(net.y(lo, hi).astype(np.int32), device=dev)
    pairs = torch.as_tensor(np.stack([lo, hi], 1).astype(np.int32),
                            device=dev)
    w = torch.ones(s, dtype=torch.float32, device=dev)
    eta = torch.tensor([[1.0, 1.0]], device=dev).repeat(k, 1)
    scale = float(net.total_pairs) / s
    log_eps = float(np.float32(np.log(1e-30)))
    gamma, lam = eng.gamma.clone(), eng.lam.clone()
    alpha = float(np.float32(1.0 / k))
    gs, nr, rt = (torch.tensor(v, dtype=torch.float32, device=dev)
                  for v in (scale, 0.7, 0.01))

    def step():
        return svi_step(gamma, lam, pairs, y, w, alpha, eta, gs, gs, nr, rt,
                        1.0, log_eps, 50, 1e-5)

    step()
    torch.cuda.synchronize()
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    g2, l2 = step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    counted = _read_counts()[0]
    assert counted["phi_fixed_point"] == 1 and counted[
        "dirichlet_expectation"] == 2, counted
    assert torch.isfinite(g2).all() and torch.isfinite(l2).all()
    step_dev_ms = cuda_ms(step, 3)
    # the plain step on the same inputs, in float64 for the kernel's rounds
    # (a block whose largest change sits at the threshold may end a round
    # apart in f32 on the card and in the plain version: those blocks are
    # counted below)
    elogpi = dirichlet_expectation(gamma)
    elogbeta = dirichlet_expectation(lam)
    csr = owner_csr(pairs.reshape(-1), n)
    upd = NodeUpdate(gamma, alpha, gs, nr)
    _, _, rounds, _, stop = phi_fixed_point(
        elogpi, elogbeta, pairs, y, w, log_eps, 50, 1e-5, csr=csr, update=upd,
        keep_staged=True)
    _, _, r_p = pair_block_stats_plain(elogpi, elogbeta, pairs, y, w,
                                       log_eps, 50, 1e-5)
    n_blocks, n_differ, r_gap = _block_rounds_differ(rounds, r_p)
    del r_p
    g_p, l_p, _ = pair_block_stats_plain(
        elogpi.double(), elogbeta.double(), pairs, y, w.double(), log_eps, 50,
        1e-5, given=rounds)
    g_p = node_update_plain(g_p, NodeUpdate(
        gamma.double(), alpha, gs.double(), nr.double()))
    l_p = (1.0 - rt.double()) * lam.double() + rt.double() * (
        eta.double() + gs.double() * l_p)
    err = max(_close_to_max(g2, g_p), _close_to_max(l2, l_p))
    assert err <= FP_TOL, ("svi_step against the plain step", err)
    # the rows of nodes in no pair take (1 - rho) gamma + rho alpha: the
    # plain update's bits in f32 (their rows are a few tens, where the
    # largest entry above is of s gamma_hat, s near 1e6); each row with a slot
    # logged against its own largest entry
    free = torch.bincount(pairs.reshape(-1).long(), minlength=n) == 0
    g_free = node_update_plain(torch.zeros_like(gamma[free]), NodeUpdate(
        gamma[free], alpha, gs, nr))
    assert torch.equal(g2[free], g_free), "rows with no slot"
    row_err = float(((g2[~free].double() - g_p[~free]).abs().amax(1)
                     / g_p[~free].abs().amax(1)).max())
    n_free = int(free.sum())
    del g_p, g_free, free
    k8_ms = cuda_ms(lambda: phi_fixed_point(
        elogpi, elogbeta, pairs, y, w, log_eps, 50, 1e-5, csr=csr,
        update=upd), 3)
    needed = float(torch.minimum(stop, rounds).double().sum())
    reruns = int((stop > rounds).sum())
    bnd = fp_bound(n, k, s, s, needed, update=True)
    floor = fp_floor_ms(n, k, s, update=True)
    log(f"phase 3: one MMSBInfer step on the stretch graph and state (n={n} "
        f"K={k}, s={s} random pairs, {int(y.sum())} links): {step_ms:.2f} "
        f"ms wall, {step_dev_ms:.4f} ms on the card, peak {peak:.3f} GiB "
        f"above the state; gamma and lambda within {err:.3e} of the plain "
        f"step's (float64, the kernel's rounds; each row with a slot within "
        f"{row_err:.3e} of its largest entry), the {n_free} rows of nodes "
        f"in no pair bitwise the plain f32 update's; kernel 8 with the update "
        f"{k8_ms:.4f} ms with its CSR given ({k8_ms / step_dev_ms:.1%} of "
        f"the step), bound {bnd[0]:.4f} ms ({bnd[1]}), floor {floor:.4f} ms, "
        f"{n_blocks} blocks of {BLOCK}, R_b mean "
        f"{float(rounds[::BLOCK].double().mean()):.2f} max "
        f"{int(rounds.max())}, needed within R_b {needed / s:.2f} a pair, "
        f"{reruns} pairs run again in pass 2; the plain version under the "
        f"rule: R_b differs on {n_differ} blocks (by at most {r_gap})")
    del elogpi, csr, g2, gamma
    torch.cuda.empty_cache()
    # kernel 9 at 19.9M links, and the report's community extraction
    edges, mask, acsr = eng._community_edges()
    report = check_edge_assign(dev, eng.gamma, eng.lam, edges, mask, acsr,
                               "3")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.log_communities()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"phase 3: log_communities on the stretch state: {secs:.2f} s "
        f"(kernel 9 {report['ms']:.1f} ms of it), {len(eng._communities)} "
        f"communities")
    return report


# ---------------------------------------------------------------------------
# Phase 4: the mesh (svinet_torch/parallel/mesh.py: -mesh N, -mesh-rowshard).
# One card holds one NCCL rank ("Duplicate GPU detected" refuses a second),
# so two gloo ranks share cuda:0 (gloo stages CUDA tensors through the
# host; on torch 2.11 it carries the tiled all_gather and reduce_scatter of
# them too), and every layout runs on one NCCL rank in this process. Each
# run is held to a single-card run of the same flags: the same stop, the
# NMI within NMI_TOL, its heldout (and -logl) rows within a relative bound,
# and gamma and lambda within a bound of their largest entry, or where
# that bound is None their gaps logged. Two ranks sum gamma_hat in another
# order than one card, and two kinds of run amplify that: once annealing
# ends a link-sampling fit moves along flat directions (a node split
# between two communities shifts between them with the heldout likelihood
# nearly unchanged), and a -batch step's link pairs in 2-cycles end where
# the last bits of their logits put them (PERF.md section 6, PR 10). So the
# two-rank link-sampling runs to their stop are held on their rows at
# MESH_LONG_RTOL, the JAX package's bound for its own -mesh CLI runs
# (tests/test_sharding.py:209), with gamma and lambda held at MESH_RTOL
# after SHORT_FLAGS' 20 sweeps instead; the -batch run on its rows at
# MESH_RTOL; every other run on both at MESH_RTOL, and the -bf16
# row-sharded run at MESH_BF16_RTOL (PERF.md section 2). The ranks of a
# replicated layout end bit for bit equal. Nothing here asserts a speed:
# the stretch readings are logged.
MESH_RTOL = 1e-4
MESH_BF16_RTOL = 1e-3
MESH_LONG_RTOL = 5e-4
LS_FLAGS = ["-max-iterations", "400"]
FUSED_FLAGS = ["-fuse-s3", "-report-batch", str(REPORT_BATCH)]
SHORT_FLAGS = ["-max-iterations", "20", "-no-stop"]
# (label, engine, flags, the label of the single-card run it is held to,
# the bound on gamma and lambda, the bound on the rows): the single-card
# runs are phase 2's, and "gpu-short" is made here
GLOO_RUNS = (("mesh2-default", "ls", LS_FLAGS + ["-mesh", "2"], "gpu", None,
              MESH_LONG_RTOL),
             ("mesh2-fused", "ls", LS_FLAGS + FUSED_FLAGS + ["-mesh", "2"],
              "gpu-fused", None, MESH_LONG_RTOL),
             ("mesh2-short", "ls", SHORT_FLAGS + ["-mesh", "2"], "gpu-short",
              MESH_RTOL, MESH_RTOL),
             ("mesh2-rs", "ls",
              SHORT_FLAGS + ["-mesh", "2", "-mesh-rowshard"], "gpu-short",
              MESH_RTOL, MESH_RTOL),
             ("mesh2-mmsb", "mmsb", MMSB_FLAGS + ["-mesh", "2"], "mmsb",
              MESH_RTOL, MESH_RTOL),
             ("mesh2-batch", "batch", BATCH_FLAGS + ["-mesh", "2"],
              "mmsb-batch", None, MESH_RTOL))
NCCL_RUNS = (("nccl1-rep", "ls", LS_FLAGS + ["-mesh", "1"], "gpu",
              MESH_RTOL, MESH_RTOL),
             ("nccl1-rs", "ls", LS_FLAGS + ["-mesh", "1", "-mesh-rowshard"],
              "gpu", MESH_RTOL, MESH_RTOL),
             ("nccl1-rs-fused", "ls",
              LS_FLAGS + FUSED_FLAGS + ["-mesh", "1", "-mesh-rowshard"],
              "gpu-fused", MESH_RTOL, MESH_RTOL),
             ("nccl1-rs-bf16", "ls",
              LS_FLAGS + ["-bf16", "-mesh", "1", "-mesh-rowshard"],
              "gpu-bf16", MESH_BF16_RTOL, MESH_BF16_RTOL),
             ("nccl1-mmsb", "mmsb", MMSB_FLAGS + ["-mesh", "1"], "mmsb",
              MESH_RTOL, MESH_RTOL))
# what a rank of each engine launches on the mesh path (rank 0 alone
# extracts the communities, and evaluates -logl's ELBO)
MESH_PATH = {"ls": ("dirichlet_expectation", "phi_pass",
                    "mean_indicator_update", "s3_pass", "heldout_sums"),
             "ls-fused": ("dirichlet_expectation", "mean_indicator_update",
                          "fused_phi_s3_pass", "heldout_sums"),
             "mmsb": ("dirichlet_expectation", "phi_fixed_point",
                      "heldout_sums"),
             "batch": ("dirichlet_expectation", "phi_fixed_point",
                       "heldout_sums")}


def _outdir(workdir, label):
    outs = [d for d in os.listdir(workdir)
            if re.match(rf"n\d+-k\d+-{re.escape(label)}-seed1", d)]
    assert len(outs) == 1, (label, outs)
    return os.path.join(workdir, outs[0])


def _mesh_argv(engine, label, flags, graphs):
    net, gt, shape = graphs["batch" if engine == "batch" else "planted"]
    return ["-file", net, "-n", str(shape["n"]), "-k", str(shape["k"]),
            "-nmi", gt, "-seed", "1", "-lt-min-deg", "1", "-label", label,
            *(["-link-sampling"] if engine == "ls" else []), *flags]


def _held_to(out, ref, label, state_rtol, rows_rtol):
    """out's gamma and lambda (unless state_rtol is None), heldout
    (validation, -logl) rows, stop and NMI against ref's; returns the
    largest gaps."""
    gaps = {}
    for name in ("gamma.txt", "lambda.txt"):
        a = np.loadtxt(os.path.join(out, name), ndmin=2)
        b = np.loadtxt(os.path.join(ref, name), ndmin=2)
        cols = slice(2, None) if name == "gamma.txt" else slice(None)
        assert a.shape == b.shape, (label, name, a.shape, b.shape)
        gap = float(np.abs(a[:, cols] - b[:, cols]).max()
                    / np.abs(b[:, cols]).max())
        assert state_rtol is None or gap <= state_rtol, (label, name, gap)
        gaps[name] = gap
    for name in ("heldout.txt", "validation.txt", "logl.txt"):
        pa, pb = os.path.join(out, name), os.path.join(ref, name)
        if not os.path.exists(pb) or not os.path.getsize(pb):
            assert not os.path.exists(pa) or not os.path.getsize(pa), name
            continue
        a, b = np.loadtxt(pa, ndmin=2), np.loadtxt(pb, ndmin=2)
        assert a.shape == b.shape, (label, name, a.shape, b.shape)
        assert (a[:, 0] == b[:, 0]).all(), (label, name)
        gap = float((np.abs(a[:, 2:] - b[:, 2:])
                     / np.maximum(np.abs(b[:, 2:]), 1e-30)).max())
        assert gap <= rows_rtol, (label, name, gap)
        gaps[name] = gap
    mx_a = open(os.path.join(out, "max.txt")).read().split()
    mx_b = open(os.path.join(ref, "max.txt")).read().split()
    assert mx_a[0] == mx_b[0], (label, mx_a, mx_b)
    gaps["stop"] = int(mx_a[0])
    nmi = [float(open(os.path.join(d, "mutual.txt")).read().split()[-1])
           for d in (out, ref)]
    assert abs(nmi[0] - nmi[1]) <= NMI_TOL, (label, nmi)
    gaps["nmi"] = nmi[0]
    return gaps


def _path_launched(counts, engine, flags, primary, label):
    """Every kernel of the path launched on a rank; the communities'
    kernel 9 on rank 0 alone."""
    path = MESH_PATH["ls-fused" if "-fuse-s3" in flags else engine]
    missing = [name for name in path if not counts.get(name)]
    assert not missing, (label, missing, counts)
    assert bool(counts.get("edge_assignments")) == primary, (label, counts)


def _rank_reports(reports, ranks):
    """The launcher's report (rank<r>.json) of each rank in `ranks`."""
    out = []
    for r in ranks:
        with open(os.path.join(reports, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _rank_counts(rep):
    """A rank report's (launches by kernel, launches by "kernel:form")."""
    counts = {k: v["launches"] for k, v in rep["launches"].items()}
    forms = {f"{k}:{form}": c for k, v in rep["launches"].items()
             for form, c in v["forms"].items()}
    return counts, forms


def phase4(dev, workdir, stretch_eng):
    """The mesh on one card: both layouts on two gloo ranks, every layout
    on one NCCL rank, then the stretch shape on one NCCL rank. Returns the
    launches of phase 4's runs by kernel and "kernel:form"."""
    from svinet_torch.cli import main as cli_main
    from svinet_torch.parallel import mesh
    from svinet_torch.synth import write_planted
    graphs = {"planted": (*write_planted(
                  workdir, PLANTED["n"], PLANTED["k"], PLANTED["avg_deg"],
                  PLANTED["seed"]), PLANTED),
              "batch": (*write_planted(
                  workdir, BATCH_PLANTED["n"], BATCH_PLANTED["k"],
                  BATCH_PLANTED["avg_deg"], BATCH_PLANTED["seed"]),
                  BATCH_PLANTED)}
    launched = {}

    def add(counts, forms):
        for name, v in counts.items():
            launched[name] = launched.get(name, 0) + v
        for name, v in forms.items():
            launched[name] = launched.get(name, 0) + v

    torch.cuda.empty_cache()
    # the single-card run the 20-sweep mesh runs are held to
    _run_cli(workdir, graphs["planted"][0], graphs["planted"][1], "gpu-short",
             SHORT_FLAGS)
    for label, engine, flags, ref, state_rtol, rows_rtol in GLOO_RUNS:
        reports = os.path.join(workdir, f"{label}-ranks")
        os.makedirs(reports)
        os.chdir(workdir)
        t0 = time.perf_counter()
        assert mesh.launch(_mesh_argv(engine, label, flags, graphs), 2,
                           backend="gloo", devices=[dev, dev],
                           report_dir=reports) == 0
        secs = time.perf_counter() - t0
        ranks = _rank_reports(reports, (0, 1))
        # lambda is replicated in every layout, gamma unless row-sharded
        replicated = "-mesh-rowshard" not in flags
        assert ranks[0]["lam_sha256"] == ranks[1]["lam_sha256"], label
        assert replicated == (ranks[0]["gamma_sha256"]
                              == ranks[1]["gamma_sha256"]), label
        for r, rep in enumerate(ranks):
            counts, forms = _rank_counts(rep)
            _path_launched(counts, engine, flags, r == 0, label)
            add(counts, forms)
        out = _outdir(workdir, label)
        gaps = _held_to(out, _outdir(workdir, ref), label, state_rtol,
                        rows_rtol)
        log(f"phase 4: {label} ({' '.join(flags)}) on two gloo ranks on "
            f"{dev}: {secs:.1f} s, held to {ref}: {gaps}, ranks' "
            f"{'gamma and ' if replicated else ''}lambda bit for bit equal, "
            f"launches rank 0 "
            f"{ {k: v['launches'] for k, v in ranks[0]['launches'].items()} }"
            f", rank 1 "
            f"{ {k: v['launches'] for k, v in ranks[1]['launches'].items()} }")
    g = mesh.init_group(0, 1, dev, "nccl")
    try:
        for label, engine, flags, ref, state_rtol, rows_rtol in NCCL_RUNS:
            _zero_counts()
            os.chdir(workdir)
            t0 = time.perf_counter()
            assert cli_main(_mesh_argv(engine, label, flags, graphs),
                            g) == 0
            secs = time.perf_counter() - t0
            g.engine = None
            counts, forms = _read_counts()
            _path_launched(counts, engine, flags, True, label)
            add(counts, forms)
            gaps = _held_to(_outdir(workdir, label), _outdir(workdir, ref),
                            label, state_rtol, rows_rtol)
            log(f"phase 4: {label} ({' '.join(flags)}) on one NCCL rank: "
                f"{secs:.1f} s, held to {ref} at {state_rtol:g}: {gaps}, "
                f"launches by form {forms}")
        phase4_stretch(dev, stretch_eng, g)
    finally:
        mesh.shutdown()
    return launched


def phase4_stretch(dev, eng, g):
    """The stretch engine's state on one NCCL rank: step(3) under the
    replicated and the row-sharded layouts beside the single-card step
    from the same state, their peak memory, the collectives alone on
    (n, K) rows, and an MMSBInfer step of s = 500,000 pairs sharded beside
    the single-card step. At one rank the layouts hold the state as it
    is; what changes is the collectives and, under rowshard, the compact
    heldout table (rowshard_heldout_layout)."""
    from svinet_torch.evals.likelihood import result_from_sums
    from svinet_torch.ops.expectations import dirichlet_expectation
    from svinet_torch.parallel import mesh
    from svinet_torch.parallel.mesh import LOCAL, MeshComm
    from svinet_torch.svi.mmsb import svi_step
    n, k = eng.n, eng.k
    net = eng.network
    n_train = len(net.training_links)
    eng.mphi = eng._mphi_bf16 = None
    eng.cfg.fuse_s3 = eng.cfg.bf16_rows = False
    eng.annealing = True
    g0, l0 = eng.gamma.clone(), eng.lam.clone()
    single_ho = eng._ho
    hidx, pp, yy, ww, nb = mesh.rowshard_heldout_layout(
        net.validation_pairs, net.validation_y.astype(np.int32), n, 1)
    rs_ho = tuple(torch.as_tensor(a, device=dev) for a in (pp, yy, ww)) + (
        nb,)
    rs_comm = MeshComm(g, True, torch.as_tensor(hidx.astype(np.int64),
                                                device=dev))
    layouts = {"single card": (None, LOCAL, single_ho),
               "replicated": (g, MeshComm(g, False), single_ho),
               "row-sharded": (g, rs_comm, rs_ho)}
    three = {"dirichlet_expectation": 6, "phi_pass": 3,
             "mean_indicator_update": 3, "s3_pass": 3, "heldout_sums": 1}
    res = {}
    for name, (grp, comm, ho) in layouts.items():
        eng._group, eng._comm, eng._ho = grp, comm, ho
        eng.gamma, eng.lam = g0.clone(), l0.clone()
        eng.step(1)                       # warm-up
        eng.gamma, eng.lam = g0.clone(), l0.clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        _zero_counts()
        t0 = time.perf_counter()
        eng.step(3)
        sums = result_from_sums(eng._ho_res)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {key: v for key, v in _read_counts()[0].items() if v}
        assert counts == three, (name, counts)
        assert torch.isfinite(eng.gamma).all()
        res[name] = dict(rate=3 * n_train / dt, ms=dt * 1e3,
                         peak=torch.cuda.max_memory_allocated(dev) / 2**30,
                         held=held / 2**30, avg=sums.avg,
                         gamma=eng.gamma, lam=eng.lam)
    ref = res["single card"]
    for name in ("replicated", "row-sharded"):
        r = res[name]
        gap = float((r["gamma"] - ref["gamma"]).abs().max()
                    / ref["gamma"].abs().max())
        lgap = float((r["lam"] - ref["lam"]).abs().max()
                     / ref["lam"].abs().max())
        assert gap <= MESH_RTOL and lgap <= MESH_RTOL, (name, gap, lgap)
        assert abs(r["avg"] - ref["avg"]) <= MESH_RTOL * abs(ref["avg"])
        r["gap"] = max(gap, lgap)
    for name, r in res.items():
        log(f"phase 4: stretch step(3) {name}: {r['ms']:.1f} ms = "
            f"{r['rate']:.0f} edges/s, peak device memory "
            f"{r['peak']:.2f} GiB ({r['held']:.2f} GiB held as it began), "
            f"heldout avg {r['avg']:.6f}"
            + (f", gamma and lambda {r['gap']:.2e} of their largest entry "
               f"from the single-card step" if "gap" in r else ""))
    eng._group, eng._comm, eng._ho = None, LOCAL, single_ho
    eng.gamma, eng.lam = g0, l0
    del res, ref
    torch.cuda.empty_cache()
    # the collectives alone on the stretch rows
    buf = torch.zeros((n, k), dtype=torch.float32, device=dev)
    ar_ms = cuda_ms(lambda: mesh.all_reduce(buf), 5)
    rs_ms = cuda_ms(lambda: mesh.reduce_scatter(buf, g), 5)
    del buf
    elogpi = dirichlet_expectation(g0)
    ag_ms = cuda_ms(lambda: mesh.all_gather(elogpi, g), 5)
    elogpi_b = elogpi.to(torch.bfloat16)
    del elogpi
    ag_b_ms = cuda_ms(lambda: mesh.all_gather(elogpi_b, g), 5)
    del elogpi_b
    log(f"phase 4: NCCL at one rank on ({n}, {k}) rows: all_reduce of "
        f"gamma_hat (f32, {n * k * 4 / 1e9:.1f} GB) {ar_ms:.3f} ms, "
        f"reduce_scatter {rs_ms:.3f} ms, all_gather of Elogpi f32 "
        f"{ag_ms:.3f} ms, bf16 {ag_b_ms:.3f} ms")
    # MMSBInfer: one step of s = 500,000 random pairs (phase 3's inputs),
    # sharded on the one rank beside the single-card step
    rng = np.random.default_rng(3)
    s = MMSB_STRETCH_S
    a = rng.integers(0, n, size=2 * s)
    b = rng.integers(0, n, size=2 * s)
    ok = (a != b) & net.edge_ok_mask(np.minimum(a, b), np.maximum(a, b))
    lo, hi = np.minimum(a, b)[ok][:s], np.maximum(a, b)[ok][:s]
    y = torch.as_tensor(net.y(lo, hi).astype(np.int32), device=dev)
    pairs = torch.as_tensor(np.stack([lo, hi], 1).astype(np.int32),
                            device=dev)
    w = torch.ones(s, dtype=torch.float32, device=dev)
    eta = torch.tensor([[1.0, 1.0]], device=dev).repeat(k, 1)
    gs, nr, rt = (torch.tensor(v, dtype=torch.float32, device=dev)
                  for v in (float(net.total_pairs) / s, 0.7, 0.01))
    args = (g0, l0, pairs, y, w, float(np.float32(1.0 / k)), eta, gs, gs, nr,
            rt, 1.0, float(np.float32(np.log(1e-30))), 50, 1e-5)
    out = {}
    for name, grp in (("single card", None), ("sharded", g)):
        svi_step(*args, group=grp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        _zero_counts()
        t0 = time.perf_counter()
        gg, ll = svi_step(*args, group=grp)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = _read_counts()[0]
        assert counts["phi_fixed_point"] == 1, counts
        out[name] = (gg, ll, wall, cuda_ms(lambda: svi_step(*args, group=grp),
                                           3),
                     (torch.cuda.max_memory_allocated(dev) - held) / 2**30)
    (g1, l1, w1, d1, p1), (g2, l2, w2, d2, p2) = out.values()
    gap = float((g2 - g1).abs().max() / g1.abs().max())
    lgap = float((l2 - l1).abs().max() / l1.abs().max())
    assert gap <= MESH_RTOL and lgap <= MESH_RTOL, (gap, lgap)
    log(f"phase 4: MMSBInfer step at stretch, s = {s}: single card {w1:.2f} "
        f"ms wall ({d1:.2f} on the card, peak {p1:.2f} GiB above the state), "
        f"sharded on one NCCL rank (kernel 8 without its update, the "
        f"all-reduces, gamma's step in plain PyTorch) {w2:.2f} ms wall "
        f"({d2:.2f} on the card, peak {p2:.2f} GiB); gamma and lambda "
        f"{max(gap, lgap):.2e} of their largest entry apart")


# ---------------------------------------------------------------------
# Phase 5: -mesh-locality, -dist-* and FastAMM2 (-stratified -rnode).

# FastAMM2 on planted-20k: two reports, held to the CPU port's rows
# (`python3 chip_smoke.py --record-cpu` prints FA_CPU_ROWS): heldout.txt's
# columns as MMSB_CPU_ROWS holds them, and precision.txt's counts at
# 10/100/1000
FA_FLAGS = ["-stratified", "-rnode", "-max-iterations", "200", "-rfreq",
            "100"]
FA_CPU_ROWS = {
    "fa": {
        "heldout": [
            [100, -3.908597354, -0.0004385, -7.816756292, -0.000438065,
             -0.007738585, -0.00817665],
            [200, -3.978008089, -0.000382368, -7.955633551, -0.000381989,
             -0.007876073, -0.008258062],
        ],
        "validation": [],
        "logl": [],
        "precision": [[100, 0, 1, 2], [200, 0, 0, 2]],
    },
}
# a precision count on the card may differ from the CPU port's only where
# the pair at its cutoff lies in a run of scores this close together
# across the cutoff (the card's link probabilities differ from the CPU's
# in their last bits)
PRECISION_TIE = 1e-6
# kernel 8 at FastAMM2's block (512 pairs): (n, K, pairs, y) of one
# minibatch: one node's links, and n/10 nonlinks of one node at n=20k and
# at n=1M, K=500
FA_FP_SHAPES = ((20_000, 20, 20, 1), (20_000, 20, 2_000, 0),
                (1_000_000, 500, 100_000, 0))
# the ranks of the layouts whose locality order and collective bytes are
# timed (on a planted n=100k graph: one reorder of stretch's uniform random
# links takes over two minutes of host time, tools/locality_order.py)
LOCALITY_D = (1, 2, 4, 8)


def _planted_graphs(workdir):
    from svinet_torch.synth import write_planted
    return {"planted": (*write_planted(
                workdir, PLANTED["n"], PLANTED["k"], PLANTED["avg_deg"],
                PLANTED["seed"]), PLANTED)}


def _permuted_run(workdir, argv, d, dev, group=None):
    """The CLI's link-sampling run of argv with no mesh of its own (one
    card, or the rank `group`), on the network permuted by
    reorder_locality(d) as the -mesh-locality runs permute it. Returns its
    output directory."""
    from svinet_torch.cli import parse_args
    from svinet_torch.graph import Network
    from svinet_torch.svi.linksampling import LinkSampling
    os.chdir(workdir)
    cfg = parse_args(argv)
    net = Network(cfg)
    net.read(cfg.datfname)
    net.drop_singles()
    net.reorder_locality(d)
    eng = LinkSampling(cfg, net, dev, group)
    try:
        eng.infer()
    finally:
        eng.close()
    return os.path.abspath(cfg.outdir)


# the model and report files of a link-sampling run that two layouts of
# the same sweeps write alike (param.txt logs the layout)
_MODEL_FILES = ("gamma.txt", "lambda.txt", "heldout.txt", "validation.txt",
                "max.txt", "communities.txt", "mutual.txt", "groups.txt",
                "training.txt", "convergence.txt")


def _same_files(a, b, names=None):
    """Files of two runs bit for bit (wall-time columns aside): `names`,
    or every file both hold (process 1's proc1/ aside), which must be the
    same set. Returns how many were compared."""
    if names is None:
        skip = _TIMED | {"proc1"}
        names = sorted(set(os.listdir(a)) - skip)
        assert names == sorted(set(os.listdir(b)) - skip), (a, b)
    differ = [nm for nm in names if _strip(a, nm) != _strip(b, nm)]
    assert not differ, (a, b, differ)
    return len(names)


def phase5_locality(dev, workdir, graphs, launched):
    """-mesh-locality: two gloo ranks on cuda:0 against the single card's
    -fuse-s3 run on the same permuted network (to the stop, and 20 sweeps),
    then one NCCL rank against -mesh 1 -mesh-rowshard -fuse-s3 on the same
    order, bit for bit."""
    from svinet_torch.cli import main as cli_main
    from svinet_torch.parallel import mesh
    out = {}
    for label, flags, state_rtol, rows_rtol in (
            ("loc2", LS_FLAGS, None, MESH_LONG_RTOL),
            ("loc2-short", SHORT_FLAGS, MESH_RTOL, MESH_RTOL)):
        reports = os.path.join(workdir, f"{label}-ranks")
        os.makedirs(reports)
        os.chdir(workdir)
        t0 = time.perf_counter()
        assert mesh.launch(_mesh_argv("ls", label, [*flags, "-mesh", "2",
                                                    "-mesh-locality"],
                                      graphs), 2, backend="gloo",
                           devices=[dev, dev], report_dir=reports) == 0
        secs = time.perf_counter() - t0
        ranks = _rank_reports(reports, (0, 1))
        assert ranks[0]["lam_sha256"] == ranks[1]["lam_sha256"], label
        assert ranks[0]["order_sha256"] == ranks[1]["order_sha256"], label
        for r, rep in enumerate(ranks):
            counts, forms = _rank_counts(rep)
            _path_launched(counts, "ls", ["-fuse-s3"], r == 0, label)
            for name, v in {**counts, **forms}.items():
                launched[name] = launched.get(name, 0) + v
        ref = _permuted_run(workdir, _mesh_argv(
            "ls", f"{label}-ref", [*flags, "-fuse-s3"], graphs), 2, dev)
        loc = _outdir(workdir, label)
        gaps = _held_to(loc, ref, label, state_rtol, rows_rtol)
        params = open(os.path.join(loc, "param.txt")).read()
        frac = re.search(r"locality internal frac\S*\s+(\S+)", params)
        rows = re.search(r"locality boundary rows\S*\s+(\S+)", params)
        out[label] = secs
        log(f"phase 5: {label} (-mesh 2 -mesh-locality {' '.join(flags)}) "
            f"on two gloo ranks on {dev}: {secs:.1f} s, internal fraction "
            f"{frac.group(1) if frac else '?'}, boundary rows "
            f"{rows.group(1) if rows else '?'}; held to the single card's "
            f"-fuse-s3 run on the same order: {gaps}; both ranks the same "
            f"node order and lambda bit for bit; launches rank 0 "
            f"{_rank_counts(ranks[0])[1]}, rank 1 {_rank_counts(ranks[1])[1]}")
    g = mesh.init_group(0, 1, dev, "nccl")
    try:
        _zero_counts()
        os.chdir(workdir)
        t0 = time.perf_counter()
        assert cli_main(_mesh_argv("ls", "loc1", [*LS_FLAGS,
                                                  "-mesh-locality"],
                                   graphs), g) == 0
        secs = time.perf_counter() - t0
        g.engine = None
        counts, forms = _read_counts()
        _path_launched(counts, "ls", ["-fuse-s3"], True, "loc1")
        for name, v in {**counts, **forms}.items():
            launched[name] = launched.get(name, 0) + v
        ref = _permuted_run(workdir, _mesh_argv(
            "ls", "loc1-rs", [*LS_FLAGS, "-mesh", "1", "-mesh-rowshard",
                              "-fuse-s3"], graphs), 1, dev, g)
        n_files = _same_files(_outdir(workdir, "loc1"), ref, _MODEL_FILES)
        mx = open(os.path.join(ref, "max.txt")).read().split()
        log(f"phase 5: -mesh-locality alone on one NCCL rank: {secs:.1f} s, "
            f"stop {mx[0]}; {n_files} model and report files equal "
            f"-mesh 1 -mesh-rowshard -fuse-s3's on the same order bit for "
            f"bit; launches {forms}")
    finally:
        mesh.shutdown()
    return out


_DIST_RANK = """
import sys
sys.path.insert(0, {repo!r})
from svinet_torch.cli import parse_args
from svinet_torch.parallel import mesh
argv = {argv!r}
sys.exit(mesh.launch(argv, 2, backend="gloo", devices=[{device!r}],
                     report_dir={reports!r},
                     dist=mesh.Dist.of(parse_args(argv))))
"""


def phase5_dist(dev, workdir, graphs, launched):
    """-dist-nprocs 2: two processes, each one gloo rank on cuda:0, meet
    at a TCP rendezvous on 127.0.0.1 and write the one-process two-rank
    run's files bit for bit (phase 4's mesh2-short, made here when phase 4
    did not run), process 1 under proc1/."""
    import socket
    from svinet_torch.parallel import mesh
    flags = [*SHORT_FLAGS, "-mesh", "2"]
    argv = _mesh_argv("ls", "mesh2-short", flags, graphs)
    os.chdir(workdir)
    if not [d for d in os.listdir(workdir) if "-mesh2-short-" in d]:
        assert mesh.launch(argv, 2, backend="gloo", devices=[dev, dev]) == 0
    one = _outdir(workdir, "mesh2-short")
    two = os.path.join(workdir, "dist")
    reports = os.path.join(workdir, "dist-ranks")
    os.makedirs(two)
    os.makedirs(reports)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DIST_RANK.format(
            repo=repo, reports=reports, device=str(dev),
            argv=[*argv, "-dist-coordinator", f"127.0.0.1:{port}",
                  "-dist-nprocs", "2", "-dist-procid", str(i)])],
        cwd=two, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in (0, 1)]
    try:
        for i, p in enumerate(procs):
            o, e = p.communicate(timeout=600)
            assert p.returncode == 0, (i, o[-2000:], e[-4000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    out = _outdir(two, "mesh2-short")
    assert os.path.isdir(os.path.join(out, "proc1")), os.listdir(out)
    n_files = _same_files(out, one)
    ranks = _rank_reports(reports, (0, 1))
    assert ranks[0]["lam_sha256"] == ranks[1]["lam_sha256"]
    for r, rep in enumerate(ranks):
        counts, forms = _rank_counts(rep)
        _path_launched(counts, "ls", flags, r == 0, "dist")
    log(f"phase 5: -dist-nprocs 2 (one gloo rank a process on {dev}, TCP "
        f"rendezvous on 127.0.0.1): {secs:.1f} s for both processes; "
        f"{n_files} files equal the one-process -mesh 2 run's bit for bit, "
        f"process 1's rows under proc1/ "
        f"({len(os.listdir(os.path.join(out, 'proc1')))} files)")


def _precision_rows(out):
    path = os.path.join(out, "precision.txt")
    return [[int(v) for i, v in enumerate(l.split()) if i != 1]
            for l in open(path).read().splitlines() if l.strip()]


def _fa_rows(out):
    rows = _mmsb_rows(out)
    rows["precision"] = _precision_rows(out)
    return rows


def _precision_ties(got, want, scores, label):
    """precision.txt rows on the card (`got`) against the CPU port's:
    equal counts, or where a count differs, the pair at its cutoff in a
    run of scores within PRECISION_TIE of each other across the cutoff,
    long enough on both sides to carry the difference (`scores`: each
    report's (link probabilities, y)). Returns the ties, printed."""
    ties = []
    assert [r[0] for r in got] == [r[0] for r in want], (label, got, want)
    for row_g, row_w, (s, y) in zip(got, want, scores):
        order = np.argsort(-s, kind="stable")
        ss = s[order]
        for cut, a, b in zip((10, 100, 1000), row_g[1:], row_w[1:]):
            if a == b:
                continue
            t = min(cut, len(ss)) - 1
            near = np.abs(ss - ss[t]) <= PRECISION_TIE
            before = int(near[:t + 1].sum())
            after = int(near[t + 1:].sum())
            assert min(before, after) >= abs(a - b), (
                label, row_g[0], cut, a, b, before, after)
            ties.append((row_g[0], cut, a, b, float(ss[t]), before + after))
    for tie in ties:
        log(f"phase 5: {label}: precision at iteration {tie[0]}, top "
            f"{tie[1]}: {tie[2]} hits on the card against {tie[3]} on the "
            f"CPU, a tie of {tie[5]} scores within {PRECISION_TIE:g} of "
            f"{tie[4]:.9g}")
    return ties


def _fa_cli(workdir, net, gt, label, flags, scores=None):
    """FastAMM2 through the CLI in this process; with `scores` a list, each
    report's (link probabilities, y) is appended to it."""
    from svinet_torch.svi import fastamm2
    counts = fastamm2.precision_counts
    if scores is not None:
        def keep(s, y):
            scores.append((np.asarray(s).copy(), np.asarray(y).copy()))
            return counts(s, y)
        fastamm2.precision_counts = keep
    try:
        return _run_engine_cli(workdir, net, gt, PLANTED["n"], PLANTED["k"],
                               label, flags)
    finally:
        fastamm2.precision_counts = counts


def phase5_fastamm2(dev, workdir, graphs, launched):
    """FastAMM2 on planted-20k on the card and on two gloo ranks sharing
    it, each held to the CPU port's rows (heldout at 1e-4, precision
    counts equal up to ties). Returns the launches of kernel 8 in the
    single-card run."""
    from svinet_torch.parallel import mesh
    net, gt, _ = graphs["planted"]
    scores = []
    _zero_counts()
    t0 = time.perf_counter()
    out = _fa_cli(workdir, net, gt, "fa", FA_FLAGS, scores)
    secs = time.perf_counter() - t0
    counts, forms = _read_counts()
    rows = _fa_rows(out)
    want = FA_CPU_ROWS["fa"]
    held = {k: want[k] for k in ("heldout", "validation")}
    _rows_close({k: rows[k] for k in held}, held, "fa")
    scores = scores[1:]      # the Adamic-Adar baseline's first
    assert len(scores) == len(rows["precision"]), len(scores)
    ties = _precision_ties(rows["precision"], want["precision"], scores,
                           "fa")
    steps = int(FA_FLAGS[FA_FLAGS.index("-max-iterations") + 1]) + 1
    assert forms["phi_fixed_point:f32"] == steps, (forms, steps)
    for name in ("dirichlet_expectation", "phi_fixed_point", "heldout_sums",
                 "edge_assignments"):
        assert counts[name], (name, counts)
    for name, v in {**counts, **forms}.items():
        launched[name] = launched.get(name, 0) + v
    aa = open(os.path.join(out, "adamic_adar.txt")).read().split()
    log(f"phase 5: FastAMM2 ({' '.join(FA_FLAGS)}) on planted-20k: "
        f"{secs:.1f} s, {steps} steps, heldout rows "
        f"{_rows_gap(rows, held):.3e} from the CPU port's (limit "
        f"{MMSB_ROW_RTOL:g}), precision rows {rows['precision']} (CPU "
        f"{want['precision']}, {len(ties)} ties), Adamic-Adar {aa}; "
        f"launches {forms}")
    reports = os.path.join(workdir, "fa2-ranks")
    os.makedirs(reports)
    os.chdir(workdir)
    t0 = time.perf_counter()
    assert mesh.launch(["-file", net, "-n", str(PLANTED["n"]), "-k",
                        str(PLANTED["k"]), "-nmi", gt, "-seed", "1",
                        "-lt-min-deg", "1", "-label", "fa2", *FA_FLAGS,
                        "-mesh", "2"], 2, backend="gloo", devices=[dev, dev],
                       report_dir=reports) == 0
    secs2 = time.perf_counter() - t0
    ranks = _rank_reports(reports, (0, 1))
    for key in ("gamma_sha256", "lam_sha256"):
        assert ranks[0][key] == ranks[1][key], key
    for r, rep in enumerate(ranks):
        c, f = _rank_counts(rep)
        _path_launched(c, "mmsb", [], r == 0, "fa2")
        for name, v in {**c, **f}.items():
            launched[name] = launched.get(name, 0) + v
    out2 = _outdir(workdir, "fa2")
    rows2 = _fa_rows(out2)
    _rows_close({k: rows2[k] for k in held}, held, "fa2")
    ties2 = _precision_ties(rows2["precision"], want["precision"], scores,
                            "fa2")
    log(f"phase 5: FastAMM2 -mesh 2 on two gloo ranks on {dev}: "
        f"{secs2:.1f} s, heldout rows {_rows_gap(rows2, held):.3e} from the "
        f"CPU port's, precision rows {rows2['precision']} ({len(ties2)} "
        f"ties), replicas bit for bit equal")
    return forms["phi_fixed_point:f32"]


def phase5_fp512(dev):
    """Kernel 8 at FastAMM2's block (B = 512) and minibatch shapes against
    its plain version in float64 on the kernel's rounds, two launches
    bitwise equal, each block's pairs on one R_b, and R_b against the
    plain version's own. Returns the report of the n=1M, K=500 shape."""
    from svinet_torch.ops.edges import owner_csr
    from svinet_torch.ops.phicomp import (
        pair_block_stats_plain, phi_fixed_point)
    from svinet_torch.svi.fastamm2 import BLOCK as FB
    log_eps = float(np.float32(np.log(1e-30)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    report = None
    for n, k, m, link in FA_FP_SHAPES:
        elogpi, elogbeta = _fp_state(dev, gen, n, k)
        r = n // 3
        other = torch.randperm(n - 1, generator=gen, device=dev)[:m]
        other = other + (other >= r).to(other.dtype)
        pairs = torch.stack([other.clamp(max=r), other.clamp(min=r)],
                            1).to(torch.int32).contiguous()
        y = torch.full((m,), link, dtype=torch.int32, device=dev)
        w = torch.ones(m, dtype=torch.float32, device=dev)
        csr = owner_csr(pairs.reshape(-1), n)

        def run():
            return phi_fixed_point(elogpi, elogbeta, pairs, y, w, log_eps,
                                   50, 1e-5, block=FB, csr=csr)

        def plain():
            return pair_block_stats_plain(elogpi, elogbeta, pairs, y, w,
                                          log_eps, 50, 1e-5, block=FB)

        g_k, l_k, r_k, staged, stop = phi_fixed_point(
            elogpi, elogbeta, pairs, y, w, log_eps, 50, 1e-5, block=FB,
            csr=csr, keep_staged=True)
        g_2, l_2, r_2 = run()
        torch.cuda.synchronize()
        assert (torch.equal(g_k, g_2) and torch.equal(l_k, l_2)
                and torch.equal(r_k, r_2)), (n, k, m)
        del g_2
        blk = torch.arange(m, device=dev) // FB
        assert torch.equal(r_k, r_k[::FB][blk]), (n, k, m)
        split, phi_err = _split_pairs(elogpi, elogbeta, pairs, y, w, r_k,
                                      staged, log_eps)
        del staged
        n_split = int(split.sum())
        assert n_split <= max(FP_SPLIT_SHARE * m, 0), (n, k, m, n_split)
        g_p, l_p, _ = pair_block_stats_plain(
            elogpi.double(), elogbeta.double(), pairs, y, w.double(),
            log_eps, 50, 1e-5, given=r_k, block=FB)
        err = max(_close_to_max(g_k, g_p), _close_to_max(l_k, l_p))
        assert err <= FP_TOL, (n, k, m, err)
        del g_p
        _, _, r_p = plain()
        differ = int((r_k[::FB] != r_p[::FB]).sum())
        # each pair (and the padding slot) its block's R_b rounds
        needed = float(torch.minimum(stop, r_k).double().sum())
        big = n * k >= 10**7
        ms = cuda_ms(run, 5 if big else 20)
        plain_ms = cuda_ms(plain, 2 if big else 5)
        bnd = fp_bound(n, k, m, m, needed)
        floor = fp_floor_ms(n, k, m)
        log(f"phase 5: phi_fixed_point at B={FB}, n={n} K={k}, "
            f"{m} {'links' if link else 'nonlinks'} of node {r}: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms "
            f"({bnd[1]}), floor {floor:.4f} ms; {-(-m // FB)} blocks, R_b "
            f"mean {float(r_k[::FB].double().mean()):.2f}, differs from the "
            f"plain version's on {differ}; err (of the largest entry) "
            f"{err:.3e}, phi within {phi_err:.3e} on all but {n_split} "
            f"pairs; two launches bitwise equal")
        report = dict(_report(err, ms, plain_ms, bnd), floor_ms=floor)
        del g_k, elogpi, csr
        torch.cuda.empty_cache()
    return report


def phase5_order():
    """Host seconds of reorder_locality and locality_edge_layout at every
    d of LOCALITY_D, with the layout's internal fraction, boundary rows and
    collective bytes, on the planted n=100k graph: on stretch one reorder
    takes longer than the phase's budget (`python -m
    svinet_torch.tools.locality_order --graph stretch` times it)."""
    from svinet_torch.tools import locality_order as lo
    n, k = lo.GRAPHS["planted"]
    net = lo.ingest(lo.graph_edges("planted"), n, k)
    for row in lo.time_orders(net, k, LOCALITY_D):
        log("phase 5: locality order of "
            + lo.describe("planted", net.n, len(net.edges), k, row))


def phase5_locality_kernels(dev, adj_n, adj_loc, g0, lam, workdir):
    """Kernels 2, 4 and 5 over the locality row space: on stretch's links
    at d = 1 (adj_loc: n + Xmax rows, every link internal) beside the same
    passes over the engine's n rows, bit for bit on the owned rows, timed;
    and kernel 5 on rank 0's links of planted-20k's d = 2 layout ([owned |
    boundary table] rows, a quarter of the links with one end in the
    table) against its plain version at 1e-4, timed."""
    from svinet_torch.graph import Network
    from svinet_torch.cli import parse_args
    from svinet_torch.ops.digamma import dirichlet_expectation_plain
    from svinet_torch.ops.edges import build_adjacency, choose_edge_block
    from svinet_torch.ops.expectations import dirichlet_expectation
    from svinet_torch.parallel.locality import locality_edge_layout
    from svinet_torch.svi.sweep_math import (
        fused_phi_s3_pass, fused_phi_s3_pass_pull_plain, phi_pass, s3_pass)
    n, k = g0.shape
    rows = adj_loc.n
    elogpi = torch.zeros((rows, k), device=dev)
    elogpi[:n] = dirichlet_expectation(g0)
    mphi = torch.zeros((rows, k), device=dev)
    mphi[:n] = g0 / g0.sum(1, keepdim=True)
    elb0 = dirichlet_expectation(lam)[:, 0].contiguous()
    ga, sa = phi_pass(elogpi, elb0, adj_loc)
    gb, sb = phi_pass(elogpi[:n], elb0, adj_n)
    assert torch.equal(ga[:n], gb) and torch.equal(sa, sb)
    assert torch.equal(s3_pass(mphi, adj_loc), s3_pass(mphi[:n], adj_n))
    del ga, gb
    links = adj_n.nbr.shape[0] // 2
    t = {"phi_pass": (cuda_ms(lambda: phi_pass(elogpi, elb0, adj_loc), 3),
                      cuda_ms(lambda: phi_pass(elogpi[:n], elb0, adj_n), 3),
                      phi_bound(rows, k, links, adj_loc)),
         "s3_pass": (cuda_ms(lambda: s3_pass(mphi, adj_loc), 3),
                     cuda_ms(lambda: s3_pass(mphi[:n], adj_n), 3),
                     s3_bound(rows, k, links, adj_loc))}
    del elogpi, mphi
    torch.cuda.empty_cache()
    for name, (ms_loc, ms_n, bnd) in t.items():
        log(f"phase 5: {name} over stretch's locality rows (n + "
            f"{rows - n}, d=1): {ms_loc:.4f} ms against {ms_n:.4f} ms over "
            f"the n rows, bound {bnd[0]:.4f} ms ({bnd[1]}); the owned "
            f"rows' results bit for bit equal")
    # kernel 5 on planted-20k's d=2 layout, rank 0's links
    os.chdir(workdir)
    net_path = os.path.join(workdir, f"planted-n{PLANTED['n']}-k"
                                     f"{PLANTED['k']}.txt")
    cfg = parse_args(["-file", net_path, "-n", str(PLANTED["n"]), "-k",
                      str(PLANTED["k"]), "-link-sampling"])
    net = Network(cfg)
    net.read(net_path)
    net.drop_singles()
    net.reorder_locality(2)
    n_pad = -(-net.n // 2) * 2
    es, ms, _, info = locality_edge_layout(net.edges, n_pad, 2, 1 << 16)
    per = info["per_shard"]
    mine = es[:per][ms[:per] > 0]
    rows, k = info["rows_per"] + 2 * info["xmax"], PLANTED["k"]
    adj = build_adjacency(mine, rows, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    elogpi = dirichlet_expectation_plain(
        0.01 + 9.99 * torch.rand((rows, k), generator=gen, device=dev))
    mphi = torch.rand((rows, k), generator=gen, device=dev)
    mphi = mphi / mphi.sum(1, keepdim=True)
    elb0 = dirichlet_expectation_plain(
        0.5 + 4.5 * torch.rand((k, 2), generator=gen,
                               device=dev))[:, 0].contiguous()
    block = choose_edge_block(adj.nbr.shape[0], k)
    got = fused_phi_s3_pass(elogpi, mphi, elb0, adj, one_launch=True)
    again = fused_phi_s3_pass(elogpi, mphi, elb0, adj, one_launch=True)
    want = fused_phi_s3_pass_pull_plain(elogpi, mphi, elb0, adj, block)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    err = max(_rel_err(a, b) for a, b in zip(got, want))
    assert err <= PHI_TOL, err
    ms5 = cuda_ms(lambda: fused_phi_s3_pass(elogpi, mphi, elb0, adj,
                                            one_launch=True), 20)
    plain_ms = cuda_ms(lambda: fused_phi_s3_pass_pull_plain(
        elogpi, mphi, elb0, adj, block), 5)
    bnd = fused_bound(rows, k, len(mine), adj)
    remote = int((mine >= info["rows_per"]).any(1).sum())
    log(f"phase 5: fused_phi_s3_pass (kernel 5) over rank 0's locality rows "
        f"of planted-20k at d=2 ({info['rows_per']} owned + "
        f"{2 * info['xmax']} table rows, {len(mine)} links, {remote} with "
        f"an end in the table): kernel {ms5:.4f} ms, plain {plain_ms:.4f} "
        f"ms, bound {bnd[0]:.4f} ms ({bnd[1]}), err {err:.3e}; two launches "
        f"bitwise equal")


def phase5_stretch(dev, eng, workdir):
    """The stretch engine's state on one NCCL rank under -fuse-s3:
    step(3) single card, row-sharded and locality (d = 1: every link
    internal, an 8-row table), their peak memory, kernels 2, 4 and 5 over
    locality row spaces; then a FastAMM2 step of each kind on the
    state."""
    from svinet_torch.evals.likelihood import result_from_sums
    from svinet_torch.ops.edges import build_adjacency
    from svinet_torch.parallel import mesh
    from svinet_torch.parallel.locality import locality_edge_layout
    from svinet_torch.parallel.mesh import LOCAL, LocalityComm, MeshComm
    from svinet_torch.svi.fastamm2 import BLOCK as FB, M_SETS
    from svinet_torch.svi.mmsb import svi_step
    n, k = eng.n, eng.k
    net = eng.network
    n_train = len(net.training_links)
    g0, l0 = eng.gamma.clone(), eng.lam.clone()
    single = (eng._ho, eng.adj)
    g = mesh.init_group(0, 1, dev, "nccl")
    try:
        hidx, pp, yy, ww, nb = mesh.rowshard_heldout_layout(
            net.validation_pairs, net.validation_y.astype(np.int32), n, 1)
        rs_ho = tuple(torch.as_tensor(a, device=dev)
                      for a in (pp, yy, ww)) + (nb,)
        hidx_d = torch.as_tensor(hidx.astype(np.int64), device=dev)
        t0 = time.perf_counter()
        es, ms, exp_idx, info = locality_edge_layout(net.training_links, n,
                                                     1, 1 << 16)
        loc_adj = build_adjacency(es[ms > 0], n + info["xmax"], dev)
        torch.cuda.synchronize()
        t_layout = time.perf_counter() - t0
        loc_comm = LocalityComm(g, hidx_d, torch.as_tensor(
            exp_idx.astype(np.int64), device=dev), 0)
        layouts = {"single card": (None, LOCAL, single[0], single[1]),
                   "row-sharded": (g, MeshComm(g, True, hidx_d), rs_ho,
                                   single[1]),
                   "locality": (g, loc_comm, rs_ho, loc_adj)}
        eng.cfg.fuse_s3 = True
        eng.cfg.bf16_rows = False
        eng._mphi_bf16 = None
        eng.annealing = True
        res = {}
        for name, (grp, comm, ho, adj) in layouts.items():
            eng._group, eng._comm, eng._ho, eng.adj = grp, comm, ho, adj
            mphi = comm.rows_out("mphi", n, k, torch.float32, dev)
            for _ in range(2):          # a warm-up, then the timed steps
                eng.gamma, eng.lam = g0.clone(), l0.clone()
                eng.mphi = (torch.zeros((n, k), device=dev) if mphi is None
                            else mphi.zero_())
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                held = torch.cuda.memory_allocated(dev)
                _zero_counts()
                t0 = time.perf_counter()
                eng.step(3)
                sums = result_from_sums(eng._ho_res)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            counts = {key: v for key, v in _read_counts()[0].items() if v}
            assert counts == {"dirichlet_expectation": 6, "phi_pass": 3,
                              "mean_indicator_update": 3, "s3_pass": 3,
                              "heldout_sums": 1}, (name, counts)
            res[name] = dict(rate=3 * n_train / dt, ms=dt * 1e3,
                             peak=torch.cuda.max_memory_allocated(dev)
                             / 2**30, held=held / 2**30, avg=sums.avg,
                             gamma=eng.gamma, lam=eng.lam)
        ref = res["single card"]
        for name in ("row-sharded", "locality"):
            r = res[name]
            gap = max(float((r["gamma"] - ref["gamma"]).abs().max()
                            / ref["gamma"].abs().max()),
                      float((r["lam"] - ref["lam"]).abs().max()
                            / ref["lam"].abs().max()))
            assert gap <= MESH_RTOL, (name, gap)
            r["gap"] = gap
        assert torch.equal(res["locality"]["gamma"],
                           res["row-sharded"]["gamma"])
        for name, r in res.items():
            log(f"phase 5: stretch step(3) -fuse-s3 {name}: {r['ms']:.1f} ms "
                f"= {r['rate']:.0f} edges/s, peak device memory "
                f"{r['peak']:.2f} GiB ({r['held']:.2f} GiB held as it "
                f"began), heldout avg {r['avg']:.6f}"
                + (f", {r['gap']:.2e} from the single card" if "gap" in r
                   else ""))
        log(f"phase 5: the locality layout at d=1 on stretch's "
            f"{n_train} links and its adjacency over {n + info['xmax']} "
            f"rows: {t_layout:.1f} s; locality's gamma equals row-sharded's "
            f"bit for bit")
        del res, ref
        eng.mphi = None
        torch.cuda.empty_cache()
        phase5_locality_kernels(dev, single[1], loc_adj, g0, l0, workdir)
    finally:
        eng._group, eng._comm, eng._ho, eng.adj = (None, LOCAL, single[0],
                                                   single[1])
        eng.gamma, eng.lam = g0, l0
        eng.mphi = None
        eng.cfg.fuse_s3 = False
        mesh.shutdown()
    torch.cuda.empty_cache()
    # FastAMM2's step on the state: an informative step (one node's links)
    # and a non-informative one (n/10 nonlinks), block 512, gamma's update
    # in kernel 8's node pass
    rng = np.random.default_rng(5)
    r = int(rng.integers(0, n))
    nbr = net.neighbors(r).astype(np.int64)
    other = rng.choice(n - 1, size=n // M_SETS, replace=False)
    other = other + (other >= r)
    eta = torch.tensor([[1.0, 1.0]], device=dev).repeat(k, 1)
    out = {}
    for kind, others, y, scale in (("informative", nbr, 1, float(n)),
                                   ("non-informative", other, 0,
                                    float(n) * M_SETS)):
        lo, hi = np.minimum(r, others), np.maximum(r, others)
        pairs = torch.as_tensor(np.stack([lo, hi], 1).astype(np.int32),
                                device=dev)
        yy = torch.full((len(lo),), y, dtype=torch.int32, device=dev)
        w = torch.ones(len(lo), dtype=torch.float32, device=dev)
        sc, nr, rt = (torch.tensor(v, dtype=torch.float32, device=dev)
                      for v in (scale, 0.5, 0.01))
        args = (g0, l0, pairs, yy, w, float(np.float32(1.0 / k)), eta, sc,
                sc, nr, rt, 1.0, float(np.float32(np.log(1e-30))), 50, 1e-5)
        svi_step(*args, block=FB)
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        gg, _ = svi_step(*args, block=FB)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        assert _read_counts()[0]["phi_fixed_point"] == 1
        assert torch.isfinite(gg).all()
        out[kind] = (len(lo), wall, cuda_ms(lambda: svi_step(*args,
                                                             block=FB), 5))
    log("phase 5: FastAMM2 step on stretch's state (n=1M, K=500, block "
        f"{FB}): " + "; ".join(
            f"{kind} ({m} pairs) {w:.2f} ms wall, {d:.2f} ms on the card"
            for kind, (m, w, d) in out.items()))


def phase5(dev, workdir, stretch_eng):
    """-mesh-locality, -dist-* and FastAMM2. Returns (the launches of the
    phase's paths by kernel and "kernel:form", kernel 8's report at
    FastAMM2's block and its launches in the FastAMM2 run)."""
    t0 = time.perf_counter()
    graphs = _planted_graphs(workdir)
    launched = {}
    fp_report = phase5_fp512(dev)
    phase5_locality(dev, workdir, graphs, launched)
    phase5_dist(dev, workdir, graphs, launched)
    fa_launches = phase5_fastamm2(dev, workdir, graphs, launched)
    phase5_stretch(dev, stretch_eng, workdir)
    phase5_order()
    log(f"phase 5: {time.perf_counter() - t0:.1f} s")
    return launched, fp_report, fa_launches


# ---------------------------------------------------------------------
# Phase 6: FastAMM (-infset), dense and under -fastqueue W.

# FastAMM on planted-20k through the CLI, after -preprocess: the dense
# engine at K=20 and the sparse top-W one at K=100, W=8, each held to the
# CPU port's rows (`python3 chip_smoke.py --record-cpu famm` prints
# FAMM_CPU_ROWS): heldout.txt's columns as MMSB_CPU_ROWS holds them. The
# dense run is also cut after the report of FAMM_CUT and -resume'd: the
# cut run's rows are the uninterrupted run's bit for bit, and the resumed
# rows are held to the CPU port's resumed run (neither package keeps the
# host Generator in a checkpoint, so a resumed run draws its minibatches
# anew; the per-node counters are restored).
FAMM_STEPS = 3000
FAMM_FLAGS = ["-infset", "-max-iterations", str(FAMM_STEPS), "-rfreq",
              "500", "-no-stop"]
FAMM_K_SPARSE = 100
FAMM_W_SPARSE = 8
# -fastqueue past the kernels' narrow form (W <= 64): 1,000 steps at K = 200
FAMM_K_WIDE = 200
FAMM_W_WIDE = 128
FAMM_WIDE_STEPS = 1000
FAMM_WIDE_FLAGS = ["-infset", "-max-iterations", str(FAMM_WIDE_STEPS),
                   "-rfreq", "500", "-no-stop"]
FAMM_CUT = 1500
FAMM_CPU_ROWS = {
    "famm": {
        "heldout": [
            [500, -1.909123404, -0.030885301, -3.787361168, -0.030854725,
             -0.003749486, -0.03460421],
            [1000, -3.196554186, -0.002748702, -6.39036037, -0.002745981,
             -0.006326454, -0.009072434],
            [1500, -2.904057425, -0.004954945, -5.803160449, -0.00495004,
             -0.005745126, -0.010695166],
            [2000, -2.697002476, -0.007230987, -5.386774046, -0.007223829,
             -0.005332904, -0.012556732],
            [2500, -2.539267884, -0.009641396, -5.068894559, -0.009631851,
             -0.005018203, -0.014650054],
            [3000, -2.411420894, -0.012098675, -4.810742879, -0.012086697,
             -0.004762633, -0.01684933],
        ],
    },
    "famm-fq": {
        "heldout": [
            [500, -6.039504051, -1.5202e-05, -12.07899189, -1.5187e-05,
             -0.011958196, -0.011973383],
            [1000, -5.704670429, -5.778e-05, -11.409282684, -5.7723e-05,
             -0.011295184, -0.011352907],
            [1500, -5.457840919, -9.4147e-05, -10.915587425, -9.4053e-05,
             -0.010806426, -0.010900479],
            [2000, -5.227002621, -0.000148205, -10.453856468, -0.000148059,
             -0.010349313, -0.010497371],
            [2500, -5.031366348, -0.000214441, -10.06251812, -0.000214229,
             -0.009961888, -0.010176117],
            [3000, -4.835501671, -0.000299466, -9.670703888, -0.00029917,
             -0.009573992, -0.009873162],
        ],
    },
    "famm-fqw": {
        "heldout": [
            [500, -2.696829319, -0.004595249, -5.389063835, -0.0045907,
             -0.005335171, -0.009925871],
            [1000, -2.684702635, -0.004687551, -5.36471796, -0.004682911,
             -0.005311068, -0.009993979],
        ],
    },
    "famm-cut": {
        "heldout": [
            [500, -1.909123404, -0.030885301, -3.787361168, -0.030854725,
             -0.003749486, -0.03460421],
            [1000, -3.196554186, -0.002748702, -6.39036037, -0.002745981,
             -0.006326454, -0.009072434],
            [1500, -2.904057425, -0.004954945, -5.803160449, -0.00495004,
             -0.005745126, -0.010695166],
            [2000, -2.626859813, -0.008923151, -5.244796275, -0.008914317,
             -0.005192346, -0.014106662],
            [2500, -3.009341773, -0.004190067, -6.014494399, -0.004185919,
             -0.005954346, -0.010140265],
            [3000, -2.875694406, -0.005560121, -5.745828133, -0.005554616,
             -0.005688367, -0.011242983],
        ],
    },
}
# kernel 8's FastAMM form: (n, K, pairs, padded length) of one minibatch:
# a node's links and informative zeros, no pairs at all, a hub's
FAMM_FP_SHAPES = ((20_000, 20, 121, 256), (1_000_000, 500, 141, 256),
                  (1_000_000, 500, 0, 256), (1_000_000, 500, 16_000, 16_384))
# kernel 10: (n, K, W, pairs, padded length); K=30,000 takes 15 column
# tiles of 2,048 in its sums, the last one partial
SPARSE_FP_SHAPES = ((20_000, 20, 8, 121, 256), (1_000_000, 500, 16, 141, 256),
                    (1_000_000, 8_000, 16, 141, 256),
                    (1_000_000, 8_000, 64, 141, 256),
                    (1_000_000, 8_000, 16, 16_000, 16_384),
                    (1_000_000, 8_000, 64, 16_000, 16_384),
                    (1_000_000, 8_000, 16, 0, 256),
                    (1_000_000, 30_000, 16, 141, 256),
                    (1_000_000, 8_000, 96, 141, 256),
                    (1_000_000, 8_000, 128, 141, 256),
                    (1_000_000, 8_000, 128, 16_000, 16_384),
                    (20_000, 3_000, 1_500, 41, 64),
                    (20_000, 4_200, 2_100, 41, 64))
# the widths past which each wide form's region outgrows the card's shared
# memory, so that it takes device scratch (the kernels' own queries,
# asserted): kernel 10 at W = 2,049 (its warp's region, 4W + 2 words of
# rows, a table of 3 x 16,384 entries and 6W words of facts, passes the
# H100's 227 KB), kernel 11 at W = 2,100
WIDE_SCRATCH_W = {"svt_sparse_fastamm_scratch": 2_049,
                  "svt_sparse_scores_scratch": 2_100}
# kernel 10's exit rule in sight: (n, K, W, pairs, padded length, thresh)
# of disjoint nonlink pairs on a state made with numpy (_k10_sight_state),
# where a pair's last rounds move gamma_hat by more than FP_TOL: the plain
# version with each pair exiting on its own first round below thresh, or
# with one round short, parts from the rule's sums there (CPU probes of
# the plain version: by 9.0e-3 and 7.4e-2 at the first shape, 1.6e-2 and
# 1.6e-2 at the second; the largest changes of the rounds around R lie
# 1.6e-3 and 3.2e-5 from thresh, far from a tie). The cluster form, and
# the grid form past its 8,192 threads (301 pairs of 32 lanes, three
# slots a lane; R 3, within its first window of rounds, which each pair
# then runs again up to R). At a wider W every pair's rounds settle at
# once there, so that a pair's own exit moves nothing; the grid form's
# windows and exit are the same code at every W, its rounds past W = 128
# in the record (SPARSE_FP_SHAPES' W = 1,500 and 2,100)
K10_SIGHT = ((20_000, 500, 16, 141, 256, 1e-3),
             (20_000, 500, 40, 300, 512, 2e-4))
K10_SIGHT_SEED = 1
# kernel 10 profiled a call at a time: the cluster form at W = 16 and 128,
# the grid form at a hub's minibatch; a profiler session that recorded
# no device activity is made again, this many sessions at most
K10_PROFILED = ((1_000_000, 8_000, 16, 141, 256),
                (1_000_000, 8_000, 128, 141, 256),
                (1_000_000, 8_000, 16, 16_000, 16_384))
K10_PROFILE_TRIES = 3
# the wide form's (W > 64) shape of the kernels line's row
SPARSE_WIDE = (1_000_000, 8_000, 128)
# kernel 11's scores form: (n, K, W, held-out pairs); its assignments form
# on stretch's links: (n, K, W, links), all of them at SPARSE_STRETCH (the
# kernels line's row), the first 2M or 2^18 at K=8,000 (the main path's
# shape, planted-20k's links at K=100, W=8, is the -fastqueue CLI run's
# own). W = 12 leaves lanes of its pair's group idle, W = 40 takes three
# slot registers a lane; at (20k, 17), W=16, K - W = 1 (random links of
# n = 20k there)
SCORE_SHAPES = ((20_000, 100, 8, 4_000), (1_000_000, 500, 16, 400_000),
                (1_000_000, 8_000, 16, 400_000),
                (1_000_000, 8_000, 12, 1 << 18),
                (1_000_000, 8_000, 40, 1 << 18),
                (1_000_000, 8_000, 64, 100_000),
                (20_000, 17, 16, 1 << 18),
                (1_000_000, 8_000, 96, 20_000),
                (1_000_000, 8_000, 128, 20_000),
                (20_000, 4_000, 2_100, 100))
SPARSE_STRETCH = (1_000_000, 500, 16)
ASSIGN_SHAPES = ((*SPARSE_STRETCH, STRETCH["n_edges"]),
                 (1_000_000, 8_000, 16, 1 << 21),
                 (1_000_000, 8_000, 12, 1 << 18),
                 (1_000_000, 8_000, 40, 1 << 18),
                 (1_000_000, 8_000, 64, 1 << 21),
                 (20_000, 17, 16, 1 << 18),
                 (1_000_000, 8_000, 96, 1 << 18),
                 (1_000_000, 8_000, 128, 1 << 18))
# K11_TIES: (K, W, tied links, self links) of synth.tied_topw_state's
# states, whose two largest phis are equal to the bit: the card names the
# plain version's community on every link (the first slot's), and the
# plain version with a last-slot argmax names the other on every link
K11_TIES = ((96, 8, 8_192, 2_048), (96, 12, 8_192, 2_048),
            (96, 40, 4_096, 1_024), (130, 64, 4_096, 1_024))
K11_TIES_SEED = 20
# K11_NAN: (K, W, links, rows) of synth.nan_topw_state's states, disjoint
# rows of rest 0 whose phis are all NaN: the card names each link's first
# slot, as the plain version does, where no slot's phi equals the largest
# (rows = 2 links: the node pass; more: each pair its own digammas)
K11_NAN = ((96, 8, 512, 1_024), (96, 12, 512, 4_096), (96, 40, 512, 1_024),
           (160, 64, 512, 4_096), (260, 96, 512, 1_024))
# an assignment on the card may name another community than the plain
# version only where the plain phi of its slot is this close to the
# largest (the card's digamma and exp differ from torch's in the last
# bits)
ASSIGN_TIE = 1e-5


def _famm_cli(workdir, net, gt, label, flags):
    return _run_engine_cli(workdir, net, gt, PLANTED["n"], PLANTED["k"],
                           label, flags)


def _famm_runs(workdir, record):
    """-preprocess, then FastAMM's CLI runs on planted-20k: dense, sparse,
    and the dense run cut after FAMM_CUT and resumed. Returns ({label:
    rows}, {label: (out, seconds, launches, forms)})."""
    from svinet_torch.synth import write_planted
    net, gt = write_planted(workdir, PLANTED["n"], PLANTED["k"],
                            PLANTED["avg_deg"], PLANTED["seed"])
    suffix = "-cpu" if record else ""
    t0 = time.perf_counter()
    pre = _famm_cli(workdir, net, gt, "famm-pre" + suffix, ["-preprocess"])
    secs = time.perf_counter() - t0
    nb = os.path.join(pre, "neighbors.bin")
    assert os.path.getsize(nb) > 0
    os.chdir(workdir)
    if os.path.exists("neighbors.bin"):
        os.remove("neighbors.bin")
    os.symlink(nb, "neighbors.bin")
    log(f"phase 6: -preprocess on planted-20k: {secs:.1f} s, "
        f"{os.path.getsize(nb)} bytes of informative zeros")
    # the wide run before the narrow -fastqueue run, whose last edge
    # assignments phase6_link_communities holds
    runs = (("famm", PLANTED["k"], FAMM_FLAGS),
            ("famm-fqw", FAMM_K_WIDE,
             ["-fastqueue", str(FAMM_W_WIDE), *FAMM_WIDE_FLAGS]),
            ("famm-fq", FAMM_K_SPARSE,
             ["-fastqueue", str(FAMM_W_SPARSE), *FAMM_FLAGS]))
    rows, info = {}, {}
    for label, k, flags in runs:
        if not record:
            _zero_counts()
        t0 = time.perf_counter()
        out = _run_engine_cli(workdir, net, gt, PLANTED["n"], k,
                              label + suffix, flags)
        info[label] = (out, time.perf_counter() - t0,
                       *_read_counts())
        rows[label] = _mmsb_rows(out)
    Cut, undo = _crash_after(FAMM_CUT)
    label = "famm-cut" + suffix
    try:
        try:
            _famm_cli(workdir, net, gt, label,
                      FAMM_FLAGS + ["-checkpoint-freq", "1e-9"])
            raise AssertionError("the cut did not happen")
        except Cut:
            pass
    finally:
        undo()
    cut_rows = _mmsb_rows(_outdir(workdir, label))
    out = _famm_cli(workdir, net, gt, label, FAMM_FLAGS + ["-resume"])
    rows["famm-cut"] = _mmsb_rows(out)
    info["famm-cut"] = (out, 0.0, {}, {})
    rows["famm-cut-before"] = cut_rows
    return rows, info


def _keep_assignments():
    """Make FastAMM keep copies of the last edge assignments it asks for:
    the state, the links and kernel 11's answer. Returns (that record,
    undo)."""
    import svinet_torch.svi.fastamm as famm
    orig = famm.sparse_edge_assignments
    last = {}

    def kept(ids, vals, rest, lam, edges, k, workspace=None):
        cid, mx = orig(ids, vals, rest, lam, edges, k, workspace)
        last.update(args=tuple(a.clone() for a in (ids, vals, rest, lam,
                                                   edges)),
                    k=k, got=(cid.clone(), mx.clone()))
        return cid, mx

    famm.sparse_edge_assignments = kept

    def undo():
        famm.sparse_edge_assignments = orig
    return last, undo


def phase6_link_communities(out, last):
    """Kernel 11's assignment form at the main path's shape: the last call
    of the -fastqueue run (planted-20k's training links, K=100, W=8, the
    final state) held to the plain version on the same inputs (1e-4; a
    community apart only within ASSIGN_TIE) and launched again bitwise
    equal; then the run's communities.txt, mcount.txt and aggregate.txt
    held byte for byte, and its last mutual3 to the digit, to what
    link_communities makes of the plain assignments (at a tie the card's
    community, and the card's side of link_thresh where the two phis lie
    within FP_TOL of it)."""
    from svinet_torch.evals.nmi import overlapping_nmi, read_cover_file
    from svinet_torch.ops.sparse_gamma import sparse_edge_assignments
    from svinet_torch.svi.fastamm import link_communities
    args, k = last["args"], last["k"]
    c_k, m_k = last["got"]
    c_2, m_2 = sparse_edge_assignments(*args, k)
    torch.cuda.synchronize()
    assert torch.equal(c_k, c_2) and torch.equal(m_k, m_2)
    ids, vals, rest, lam, edges = (a.cpu() for a in args)
    c_k, m_k = c_k.cpu(), m_k.cpu()
    c_p, m_p = sparse_edge_assignments(ids, vals, rest, lam, edges, k)
    differ = _assign_ties(ids, vals, rest, lam, edges, k, c_k, c_p, m_p)
    same = c_k == c_p
    err = float(((m_k - m_p).abs() / m_p.abs())[same].max())
    assert err <= FP_TOL, err
    params = dict(line.split(": ", 1) for line in
                  open(os.path.join(out, "param.txt")).read().splitlines()
                  if ": " in line)
    thr, min_deg = float(params["link_thresh"]), int(params["lt_min_deg"])
    flip = (m_k > thr) != (m_p > thr)
    assert bool(((m_p[flip] - thr).abs() <= FP_TOL * thr).all())
    seq = np.loadtxt(os.path.join(out, "gamma.txt"), usecols=(0, 1),
                     dtype=np.int64)
    seq2id = np.empty(len(seq), np.int64)
    seq2id[seq[:, 0]] = seq[:, 1]
    with tempfile.TemporaryDirectory() as tmp:
        comms = link_communities(
            lambda name: os.path.join(tmp, name), edges.numpy(),
            torch.where(same, c_p, c_k).numpy(),
            torch.where(flip, m_k, m_p).numpy(), k, thr, min_deg, seq2id)
        for name in ("communities.txt", "mcount.txt", "aggregate.txt"):
            assert (open(os.path.join(tmp, name)).read()
                    == open(os.path.join(out, name)).read()), name
        nmi = overlapping_nmi(
            read_cover_file(os.path.join(out, "ground_truth.txt")),
            read_cover_file(os.path.join(tmp, "communities.txt")))
    m3 = [line.split()[-1] for line in open(os.path.join(out, "mutual.txt"))
          if line.startswith("mutual3")]
    assert m3 and m3[-1] == f"{nmi:g}", (m3[-1:], nmi)
    log(f"phase 6: union_scores (assignments) at the main path's shape, "
        f"the -fastqueue run's last call ({edges.shape[0]} links, K={k}, "
        f"W={ids.shape[1]}): largest phi within {err:.3e} of the plain "
        f"version's, {differ} links on another community within a tie of "
        f"{ASSIGN_TIE:g}, {int(flip.sum())} on the other side of "
        f"link_thresh within {FP_TOL:g}; launched again bitwise equal; "
        f"communities.txt ({len(comms)} communities), mcount.txt and "
        f"aggregate.txt as the plain assignments make them, mutual3 "
        f"{m3[-1]}")


def phase6_cli(workdir):
    """FastAMM through the CLI on the card: every run's rows held to the
    CPU port's, kernel 8's FastAMM form launched once a dense step, kernel
    10 once a sparse step, kernel 11 every report (scores) and once a
    report and at the stop (assignments), the -fastqueue run's last
    assignments and community files held to the plain version's. Returns
    (launches by name and "name:form", {row name: (launches a unit, the
    unit)})."""
    last, undo = _keep_assignments()
    try:
        rows, info = _famm_runs(workdir, record=False)
    finally:
        undo()
    launches, per_unit = {}, {}
    for label in ("famm", "famm-fq", "famm-fqw"):
        out, secs, counted, forms = info[label]
        want = {"heldout": FAMM_CPU_ROWS[label]["heldout"]}
        _rows_close({"heldout": rows[label]["heldout"]}, want, label)
        reports = len(rows[label]["heldout"])
        wide = label == "famm-fqw"
        steps = (FAMM_WIDE_STEPS if wide else FAMM_STEPS) + 1
        assert reports == (steps - 1) // 500, (label, reports)
        if label == "famm":
            assert forms["phi_fixed_point:fastamm"] == steps, forms
            assert counted["heldout_sums"] >= reports, counted
            assert counted["edge_assignments"] == reports + 1, counted
            assert not counted["sparse_fastamm_stats"], counted
            assert not counted["union_scores"], counted
            per_unit["phi_fixed_point:fastamm"] = (
                forms["phi_fixed_point:fastamm"] / steps, "FastAMM step")
        else:
            # the wide run (W = 128) takes only the kernels' wide forms
            sfx = "+wide" if wide else ""
            k10 = "sparse_fastamm_stats:" + ("wide" if wide else "f32")
            assert forms[k10] == steps, forms
            assert forms[f"union_scores:assign{sfx}"] == reports + 1, forms
            assert forms[f"union_scores:scores{sfx}"] >= reports, forms
            assert counted["sparse_fastamm_stats"] == steps, counted
            assert not counted["phi_fixed_point"], counted
            per_unit["sparse_fastamm_stats:wide" if wide
                     else "sparse_fastamm_stats"] = (
                forms[k10] / steps, "FastAMM step")
            for form in ("scores", "assign"):
                per_unit[f"union_scores:{form}{sfx}"] = (
                    forms[f"union_scores:{form}{sfx}"] / reports,
                    "FastAMM report")
        assert counted["dirichlet_expectation"] >= steps, counted
        for name, v in {**counted, **forms}.items():
            launches[name] = launches.get(name, 0) + v
        g = np.loadtxt(os.path.join(out, "gamma.txt"))
        assert np.isfinite(g).all() and g.shape[0] == PLANTED["n"]
        nmi = float(open(os.path.join(out, "mutual.txt")).read().split()[-1])
        flags = FAMM_WIDE_FLAGS if wide else FAMM_FLAGS
        log(f"phase 6: FastAMM {label} ({' '.join(flags[1:])}"
            + (f" -k {FAMM_K_SPARSE} -fastqueue {FAMM_W_SPARSE}"
               if label == "famm-fq" else "")
            + (f" -k {FAMM_K_WIDE} -fastqueue {FAMM_W_WIDE}" if wide
               else "")
            + f") on planted-20k: {secs:.1f} s, {steps} steps = "
            f"{secs / steps * 1e3:.3f} ms a step with the reports, heldout "
            f"rows {_rows_gap(rows[label], want):.3e} "
            f"from the CPU port's (limit {MMSB_ROW_RTOL:g}), NMI {nmi:.6f}; "
            f"launches {forms}")
    # the cut run: its rows are the uninterrupted run's, bit for bit; the
    # resumed rows are held to the CPU port's resumed run
    whole = rows["famm"]["heldout"]
    before = rows["famm-cut-before"]["heldout"]
    assert before == whole[:len(before)] and before[-1][0] == FAMM_CUT, (
        before, whole)
    after = rows["famm-cut"]["heldout"]
    assert after[:len(before)] == before, (after, before)
    _rows_close({"heldout": after[len(before):]},
                {"heldout": FAMM_CPU_ROWS["famm-cut"]["heldout"][
                    len(before):]}, "famm-cut")
    log(f"phase 6: the dense run cut after iteration {FAMM_CUT} and "
        f"-resume'd: rows to the cut the uninterrupted run's bit for bit, "
        f"the resumed rows {len(after) - len(before)} within "
        f"{MMSB_ROW_RTOL:g} of the CPU port's resumed run")
    phase6_link_communities(info["famm-fq"][0], last)
    return launches, per_unit


def _sparse_state(dev, gen, n, k, w):
    """A top-W state: each row W distinct communities (a + j s mod K, s
    prime to K), values descending from about 50 to 0.5, and a rest of
    about 0.01 a tail community."""
    a = torch.randint(0, k, (n, 1), generator=gen, device=dev)
    strides = torch.tensor([s for s in range(1, 4 * w + 64, 2)
                            if np.gcd(s, k) == 1][:64], device=dev)
    s = strides[torch.randint(0, len(strides), (n, 1), generator=gen,
                              device=dev)]
    ids = ((a + torch.arange(w, device=dev) * s) % k).to(torch.int32)
    vals = torch.sort(0.5 + 50.0 * torch.rand((n, w), generator=gen,
                                               device=dev) ** 3,
                      dim=1, descending=True).values
    rest = 0.01 * (k - w) * (0.5 + torch.rand(n, generator=gen, device=dev))
    return ids.contiguous(), vals.contiguous(), rest.contiguous()


def _minibatch(dev, gen, n, m, n_links):
    """Node n // 3 with m distinct others, the first n_links of them
    links: (pairs (m, 2) int32 global ids, y, w, the touched nodes (r
    first))."""
    r = n // 3
    other = torch.randperm(n - 1, generator=gen, device=dev)[:m]
    other = other + (other >= r).to(other.dtype)
    pairs = torch.stack([other.clamp(max=r), other.clamp(min=r)], 1)
    y = (torch.arange(m, device=dev) < n_links).to(torch.int32)
    w = torch.ones(m, dtype=torch.float32, device=dev)
    nodes = torch.cat([torch.tensor([r], device=dev), other])
    return pairs.to(torch.int32).contiguous(), y, w, nodes


def _local(pairs, nodes, lead_zero):
    """The rows of a step (sorted nodes, node 0 first when lead_zero) and
    the pairs as indices into them."""
    rows = torch.unique(nodes)
    local = torch.searchsorted(rows, pairs.long())
    if lead_zero:
        rows = torch.cat([rows.new_zeros(1), rows])
        local = local + 1
    return rows, local.to(torch.int32).contiguous()


def sparse_fp_bound(t, k, w, m, rounds_sum):
    """Kernel 10's bound from this run's rounds: each pair's two rows of W
    ids and values and a rest, its label and weight, Elogbeta, the (t, K)
    gamma_hat written and lambda_hat; about 20 f32 operations a slot a
    round and 4W exponentials a round at the special-function rate."""
    n_bytes = m * (2 * (8.0 * w + 4) + 16.0) + 8.0 * k + 4.0 * t * k + 8.0 * k
    ops = 20.0 * 2 * w * rounds_sum + 4.0 * t * k
    sfu = 4.0 * w * rounds_sum
    t_ = {"bytes": n_bytes / PEAK_BYTES_S * 1e3,
          "operations": max(ops / PEAK_F32_S, sfu / PEAK_SFU_S) * 1e3}
    by = max(t_, key=t_.get)
    return t_[by], by


def phase6_fp(dev):
    """Kernel 8's FastAMM form (block = the padded length, a rho a row)
    against its plain version on the same rows, with the same rounds, two
    launches bitwise equal. Returns the report at n=1M, K=500, one node's
    minibatch."""
    from svinet_torch.ops.digamma import dirichlet_expectation
    from svinet_torch.ops.phicomp import (
        NodeUpdate, node_update_plain, pair_block_stats_plain,
        phi_fixed_point)
    log_eps = float(np.float32(np.log(1e-30)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    report = None
    for n, k, m, pad in FAMM_FP_SHAPES:
        gamma = 0.05 + torch.rand((n, k), generator=gen, device=dev) ** 4 * 10
        lam = 1.0 + 19.0 * torch.rand((k, 2), generator=gen, device=dev)
        pairs_g, y, w, nodes = _minibatch(dev, gen, n, m, min(m, 21))
        rows, pairs = _local(pairs_g, nodes, True)
        g = gamma[rows]
        rho = torch.rand(rows.shape[0], generator=gen, device=dev)
        scale = torch.tensor(n / 2.0, dtype=torch.float32, device=dev)
        elogpi = dirichlet_expectation(g)
        elogbeta = dirichlet_expectation(lam)
        upd = NodeUpdate(g, 0.05, scale, rho)

        def run():
            return phi_fixed_point(elogpi, elogbeta, pairs, y, w, log_eps,
                                   50, 1e-5, block=pad, update=upd)

        def plain():
            gacc, lacc, r = pair_block_stats_plain(
                elogpi, elogbeta, pairs, y, w, log_eps, 50, 1e-5, block=pad)
            return node_update_plain(gacc, upd), lacc, r

        o_k, l_k, r_k = run()
        o_2, l_2, r_2 = run()
        torch.cuda.synchronize()
        assert (torch.equal(o_k, o_2) and torch.equal(l_k, l_2)
                and torch.equal(r_k, r_2)), (n, k, m)
        o_p, l_p, r_p = plain()
        assert torch.equal(r_k, r_p), (n, k, m, r_k[:1], r_p[:1])
        err = max(_close_to_max(o_k, o_p),
                  _close_to_max(l_k, l_p) if m else 0.0)
        assert err <= FP_TOL, (n, k, m, err)
        # a row with no pairs decays toward alpha; node 0's row is read only
        ms = cuda_ms(run, 20)
        plain_ms = cuda_ms(plain, 5)
        rounds = int(r_k[0]) if m else 0
        bnd = fp_bound(rows.shape[0], k, m, m, float(m * rounds),
                       update=True)
        log(f"phase 6: phi_fixed_point FastAMM form at n={n} K={k}, {m} "
            f"pairs padded to {pad}, {rows.shape[0]} rows: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms "
            f"({bnd[1]}); R {rounds} as the plain version's; err (of the "
            f"largest entry) {err:.3e}; two launches bitwise equal")
        if (n, k, m) == (1_000_000, 500, 141):
            report = _report(err, ms, plain_ms, bnd)
        del gamma
        torch.cuda.empty_cache()
    return report


def _wide_scratch_split(dev):
    """Kernel 11 takes device scratch from WIDE_SCRATCH_W on, by its own
    scratch query, and none at the narrow and the shared-memory wide widths
    below it; kernel 10's grid form puts its warps' regions in device
    memory from WIDE_SCRATCH_W on (its query's second answer), in shared
    memory below."""
    from svinet_torch.kernels import build
    for name, w in WIDE_SCRATCH_W.items():
        k10 = name == "svt_sparse_fastamm_scratch"
        for below in (64, 128, w - 400) + ((w - 1,) if k10 else ()):
            if k10:
                assert build.ask(name, dev, below, 2)[1] == 0, (name, below)
            else:
                assert build.scratch(name, below, dev,
                                     torch.float32) is None, (name, below)
        if k10:
            assert build.ask(name, dev, w, 2)[1] == 1, (name, w)
        else:
            assert build.scratch(name, w, dev, torch.float32) is not None, (
                name, w)


def _k10_sight_state(dev, n, k, w, m, pad, thresh):
    """The state where kernel 10's exit rule shows in its sums
    (K10_SIGHT): made with numpy from a seed, so that the card and the CPU
    see the same state. Each row W distinct communities, values from 0.5
    to 5.5, a tail of about 0.01 a community, lambda U(1, 20); m disjoint
    random pairs, all nonlinks, so that each row of gamma_hat holds one
    pair end and a pair's phis show in it undiluted. Returns the args of
    sparse_fastamm_stats at thresh and the CSR."""
    from svinet_torch.ops.digamma import dirichlet_expectation
    from svinet_torch.ops.edges import owner_csr
    from svinet_torch.ops.sparse_gamma import K10_SEG_LEN
    rng = np.random.default_rng(K10_SIGHT_SEED)
    ids = np.argsort(rng.random((n, k)), 1)[:, :w].astype(np.int32)
    vals = -np.sort(-(0.5 + 5.0 * rng.random((n, w)) ** 2), 1)
    rest = 0.01 * (k - w) * (0.5 + rng.random(n))
    lam = rng.uniform(1.0, 20.0, (k, 2))
    nodes = rng.permutation(n)[:2 * m]
    pairs = np.sort(nodes.reshape(m, 2), 1)
    rows = np.unique(nodes)
    local = np.searchsorted(rows, pairs).astype(np.int32)
    t32 = dict(device=dev, dtype=torch.float32)
    ids, vals, rest = (torch.as_tensor(ids, device=dev),
                       torch.as_tensor(vals, **t32),
                       torch.as_tensor(rest, **t32))
    elogbeta = dirichlet_expectation(torch.as_tensor(lam, **t32))
    pairs = torch.as_tensor(pairs.astype(np.int32), device=dev)
    y = torch.zeros(m, dtype=torch.int32, device=dev)
    wt = torch.ones(m, **t32)
    local = torch.as_tensor(local, device=dev)
    lp, lq = local[:, 0].contiguous(), local[:, 1].contiguous()
    csr = owner_csr(local.reshape(-1), len(rows), K10_SEG_LEN)
    log_eps = float(np.float32(np.log(1e-30)))
    return ((ids, vals, rest, elogbeta, pairs, y, wt, lp, lq, len(rows),
             log_eps, 50, thresh, pad), csr)


def _k10_changes(args, upto):
    """The plain version's largest change at rounds 1..upto over the
    padded minibatch (its rounds rerun in f32, as it runs them)."""
    from svinet_torch.ops.sparse_gamma import sparse_phi_fixed_point
    ids, vals, rest, elogbeta, pairs, y = args[:6]
    log_eps, block = args[10], args[13]
    k = elogbeta.shape[0]
    if pairs.shape[0] < block:
        pairs = torch.cat([pairs, pairs.new_zeros((1, 2))])
        y = torch.cat([y, y.new_zeros(1)])
    p, q = pairs[:, 0].long(), pairs[:, 1].long()
    ends = (ids[p], vals[p], rest[p], ids[q], vals[q], rest[q])
    out, prev = [], None
    for r in range(upto + 1):
        _, _, p1, p2, _ = sparse_phi_fixed_point(*ends, elogbeta, y, log_eps,
                                                 k, r, -1.0)
        if prev is not None:
            out.append(float(torch.maximum(
                (p1 - prev[0]).abs().mean(-1),
                (p2 - prev[1]).abs().mean(-1)).max()))
        prev = (p1, p2)
    return out


def _k10_round_tie(args, r_k, r_p):
    """Where the card's R (r_k) and the plain version's (r_p) differ, assert
    a tie: the plain version's largest change at every round from the
    earlier end to the later one's round before within ORIG_ROUND_TIE of
    thresh. Returns whether they differ."""
    if r_k == r_p:
        return False
    first, last = min(r_k, r_p), max(r_k, r_p)
    near = _k10_changes(args, last - 1)[first - 1:]
    thresh = args[12]
    assert all(abs(v - thresh) <= ORIG_ROUND_TIE for v in near), (
        r_k, r_p, near)
    log(f"phase 6: kernel 10 ended at round {r_k}, the plain version at "
        f"{r_p}: a tie, the largest change at rounds {first}-{last - 1} "
        + ", ".join(f"{v:.9e}" for v in near) + f" against {thresh}")
    return True


def _k10_faults(args, want):
    """How far the sums (gamma_hat, lambda_hat: the larger _close_to_max)
    move from want, the plain version's, under each planted fault in the
    plain version: each pair stopping at its own first round below thresh
    (the pairs run one at a time, each a block of one), and R - 1 rounds."""
    from svinet_torch.ops.sparse_gamma import sparse_fastamm_stats_plain
    ids, vals, rest, elogbeta, pairs, y, w, lp, lq = args[:9]
    g, l, r = want
    gs, ls = torch.zeros_like(g), torch.zeros_like(l)
    for i in range(pairs.shape[0]):
        gi, li, _ = sparse_fastamm_stats_plain(
            ids, vals, rest, elogbeta, pairs[i:i + 1], y[i:i + 1],
            w[i:i + 1], lp[i:i + 1], lq[i:i + 1], *args[9:13], 1)
        gs += gi
        ls += li
    g1, l1, _ = sparse_fastamm_stats_plain(
        *args[:11], max(int(r[0]) - 1, 0), *args[12:])
    return {name: max(_close_to_max(a, g), _close_to_max(b, l))
            for name, (a, b) in (("per-pair exit", (gs, ls)),
                                 ("R - 1 rounds", (g1, l1)))}


def k10_profiled(shapes=K10_PROFILED):
    """Three calls of kernel 10 at each shape (the engine's CSR and a
    kept workspace) under torch.profiler: exactly one device kernel a call
    and no copy or memset. Logs the kernel's name. Run in a process of its own
    (k10_profiled_apart): in a process that ran a profiler session before,
    the card's records can go missing."""
    from svinet_torch.ops.digamma import dirichlet_expectation
    from svinet_torch.ops.edges import owner_csr
    from svinet_torch.ops.sparse_gamma import (
        K10_SEG_LEN, SparseWorkspace, sparse_fastamm_stats)
    dev = torch.device("cuda", 0)
    log_eps = float(np.float32(np.log(1e-30)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    for n, k, wt, m, pad in shapes:
        ids, vals, rest = _sparse_state(dev, gen, n, k, wt)
        lam = 1.0 + 19.0 * torch.rand((k, 2), generator=gen, device=dev)
        pairs, y, w, nodes = _minibatch(dev, gen, n, m, min(m, 21))
        rows, local = _local(pairs, nodes, False)
        csr = owner_csr(local.reshape(-1), rows.shape[0], K10_SEG_LEN)
        args = (ids, vals, rest, dirichlet_expectation(lam), pairs, y, w,
                local[:, 0].contiguous(), local[:, 1].contiguous(),
                rows.shape[0], log_eps, 50, 1e-5, pad, csr,
                SparseWorkspace(dev))
        # a session that recorded no device activity at all (the card's
        # records can go missing) is made again, up to K10_PROFILE_TRIES
        for tries in range(1, K10_PROFILE_TRIES + 1):
            sp = _trace_split(lambda: sparse_fastamm_stats(*args), 3)
            if sp["device"]:
                break
        launches = sum(c for name, (_, c) in sp["runtime"].items()
                       if "Launch" in name or "Memset" in name
                       or "Memcpy" in name)
        dev_ops = sp["device"]
        assert launches == 1, (n, k, wt, m, sp["runtime"])
        assert len(dev_ops) == 1 and list(dev_ops.values())[0][1] == 1, (
            n, k, wt, m, dev_ops, tries)
        log(f"phase 6: sparse_fastamm_stats at n={n} K={k} W={wt}, {m} "
            f"pairs padded to {pad}: one launch and one device kernel a "
            f"call ({next(iter(dev_ops))}), by the profiler"
            + (f" (session {tries})" if tries > 1 else ""))
        del ids, vals, rest, args
        torch.cuda.empty_cache()


def k10_profiled_apart():
    """k10_profiled in a new process (this file from this checkout), its
    log passed on; a failure there fails here."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {root!r}); "
         "import chip_smoke; chip_smoke.k10_profiled()"],
        capture_output=True, text=True, timeout=600, cwd=root)
    for line in out.stdout.splitlines():
        if line.startswith("phase 6:"):
            log(line)
    assert out.returncode == 0, out.stderr[-4000:]


def phase6_sparse(dev):
    """Kernel 10 against its plain version at every shape of
    SPARSE_FP_SHAPES and K10_SIGHT (the same R, or a tie; sums at FP_TOL of
    the largest entry; two launches bitwise equal, and a third into the
    first call's workspace, which allocates nothing), one device kernel a
    call by the profiler at a narrow, a wide and a hub shape (K10_PROFILED,
    in a process of its own), and, at K10_SIGHT's state, each planted fault of the plain version parting
    from its sums by more than FP_TOL. Returns the reports at n=1M,
    K=8,000, W=16 and at SPARSE_WIDE (its wide form), one node's
    minibatch, each call given the CSR and a kept workspace as the engine
    gives them."""
    from svinet_torch.ops.digamma import dirichlet_expectation
    from svinet_torch.ops.edges import owner_csr
    from svinet_torch.ops.sparse_gamma import (
        K10_SEG_LEN, SparseWorkspace, sparse_fastamm_stats,
        sparse_fastamm_stats_plain)
    log_eps = float(np.float32(np.log(1e-30)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    report = reports_wide = None
    _wide_scratch_split(dev)
    k10_profiled_apart()
    shapes = [(shape, None) for shape in SPARSE_FP_SHAPES]
    shapes += [(shape[:5], shape[5]) for shape in K10_SIGHT]
    for (n, k, wt, m, pad), sight in shapes:
        if sight:
            args, csr = _k10_sight_state(dev, n, k, wt, m, pad, sight)
            ids = vals = rest = None
        else:
            ids, vals, rest = _sparse_state(dev, gen, n, k, wt)
            lam = 1.0 + 19.0 * torch.rand((k, 2), generator=gen, device=dev)
            elogbeta = dirichlet_expectation(lam)
            pairs, y, w, nodes = _minibatch(dev, gen, n, m, min(m, 21))
            rows, local = _local(pairs, nodes, False)
            lp, lq = local[:, 0].contiguous(), local[:, 1].contiguous()
            args = (ids, vals, rest, elogbeta, pairs, y, w, lp, lq,
                    rows.shape[0], log_eps, 50, 1e-5, pad)
            csr = owner_csr(local.reshape(-1), rows.shape[0],
                            K10_SEG_LEN)
        t = args[9]
        ws = SparseWorkspace(dev)

        def run(into=ws):
            return sparse_fastamm_stats(*args, csr, into)

        g_k, l_k, r_k = (a.clone() for a in run())
        g_2, l_2, r_2 = run(SparseWorkspace(dev))
        torch.cuda.synchronize()
        assert (torch.equal(g_k, g_2) and torch.equal(l_k, l_2)
                and torch.equal(r_k, r_2)), (n, k, wt, m)
        before = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
        g_3, l_3, r_3 = run()
        torch.cuda.synchronize()
        assert torch.cuda.memory_stats(dev)[
            "allocation.all.allocated"] == before, (n, k, wt, m)
        assert (torch.equal(g_k, g_3) and torch.equal(l_k, l_3)
                and torch.equal(r_k, r_3)), (n, k, wt, m)
        g_p, l_p, r_p = sparse_fastamm_stats_plain(*args)
        rounds = int(r_k[0]) if m else 0
        tie = m and _k10_round_tie(args, rounds, int(r_p[0]))
        if tie:
            # the tie excuses the round, not the values: the sums are held
            # to the plain version's after exactly the card's R rounds
            g_p, l_p, _ = sparse_fastamm_stats_plain(*args[:11], rounds,
                                                     -1.0, *args[13:])
        else:
            assert torch.equal(r_k, r_p), (n, k, wt, m, r_k[:1], r_p[:1])
        err = (max(_close_to_max(g_k, g_p), _close_to_max(l_k, l_p))
               if m else float(g_k.abs().max() + l_k.abs().max()))
        assert err <= FP_TOL, (n, k, wt, m, err)
        tag = (f"phase 6: sparse_fastamm_stats at n={n} K={k} W={wt}, {m} "
               f"pairs padded to {pad}, {t} touched rows")
        if sight:
            faults = _k10_faults(args, (g_p, l_p, r_p))
            assert all(v > FP_TOL for v in faults.values()), (n, k, wt, m,
                                                            faults)
            log(f"{tag} (K10_SIGHT's state, thresh {args[12]}): R {rounds}, "
                f"err {err:.3e}; the plain version with each planted fault "
                "parts from the sums by "
                + ", ".join(f"{v:.3e} ({name})" for name, v in
                            faults.items()) + f" (limit {FP_TOL:g})")
            del g_k, g_2, g_p, ws
            torch.cuda.empty_cache()
            continue
        ms = cuda_ms(run, 20)
        plain_ms = cuda_ms(lambda: sparse_fastamm_stats_plain(*args), 3)
        bnd = sparse_fp_bound(t, k, wt, m, float(m * rounds))
        log(f"{tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}); R {rounds} "
            + ("(a tie)" if tie else "as the plain version's")
            + f"; err {err:.3e}; two launches bitwise equal, a third into "
            "the first's workspace equal too and allocating nothing")
        if (n, k, wt, m) == (1_000_000, 8_000, 16, 141):
            report = _report(err, ms, plain_ms, bnd)
        if (n, k, wt, m) == (*SPARSE_WIDE, 141):
            reports_wide = _report(err, ms, plain_ms, bnd)
        del ids, vals, rest, g_k, g_2, g_p, ws
        torch.cuda.empty_cache()
    return report, reports_wide


def score_bound(pairs, w, k, out_bytes):
    """Kernel 11's bound: the rows the pairs name read once (W ids and
    values and a rest each), the K values of its table it needs (beta, or
    Elogbeta's first column), each pair read and its outputs written
    once, at the memory rate."""
    m = pairs.shape[0]
    rows = int(torch.unique(pairs).numel()) if m else 0
    n_bytes = rows * (8.0 * w + 4) + 4.0 * k + m * (8.0 + out_bytes)
    return n_bytes / PEAK_BYTES_S * 1e3, "bytes"


def score_floor_ms(n_pairs, w, out_bytes):
    """Kernel 11's floor: each end's ids, values and rest gathered from
    device memory in whole 32-byte sectors, as random pairs of rows find
    them, the pairs read and the outputs written once."""
    sec = 2 * (-(-4 * w // 32) * 32) + 32
    return n_pairs * (2 * sec + 8.0 + out_bytes) / PEAK_BYTES_S * 1e3


def _plain_phi(ids, vals, rest, lam, edges, k):
    """The plain assignments' union slots and phis of the given links
    (edges (E, 2)): (slots (E, 2W), phi (E, 2W))."""
    from svinet_torch.ops.digamma import dirichlet_expectation_plain
    from svinet_torch.ops.sparse_gamma import DEAD, _dup_mask, _value_at_slots
    e = edges.long()
    p, q = e[:, 0], e[:, 1]
    wt = ids.shape[1]
    slots = torch.cat([ids[p], ids[q]], 1)
    first = _dup_mask(slots)
    gp = _value_at_slots(ids[p], vals[p], rest[p] / max(k - wt, 1), slots)
    gq = _value_at_slots(ids[q], vals[q], rest[q] / max(k - wt, 1), slots)
    tp, tq = vals[p].sum(-1) + rest[p], vals[q].sum(-1) + rest[q]
    eb = dirichlet_expectation_plain(lam)
    d = torch.special.digamma
    x = d(gp) - d(tp)[:, None] + d(gq) - d(tq)[:, None] + eb[slots.long(), 0]
    return slots, torch.softmax(torch.where(first, x, DEAD), -1)


def _assign_ties(ids, vals, rest, lam, edges, k, cid_k, cid_p, mx_p):
    """Links whose community differs between the card and the plain
    version: the plain phi of the card's community must lie within
    ASSIGN_TIE of the plain largest. Returns how many differ."""
    from svinet_torch.ops.sparse_gamma import _dup_mask
    bad = torch.nonzero(cid_k != cid_p).flatten()
    if not bad.numel():
        return 0
    slots, phi = _plain_phi(ids, vals, rest, lam, edges[bad], k)
    at = ((slots == cid_k[bad][:, None]) & _dup_mask(slots)).float().argmax(-1)
    got = phi.gather(1, at[:, None])[:, 0]
    assert bool(((mx_p[bad] - got) <= ASSIGN_TIE).all()), (
        float((mx_p[bad] - got).max()))
    return int(bad.numel())


def _no_alloc(dev, fn, want):
    """fn() into a grown workspace: no allocation, and outputs equal to
    want."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
    got = fn()
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def phase6_ties(dev):
    """Kernel 11's assignments on K11_TIES' states (synth.tied_topw_state):
    every link's community exactly the plain version's, no ASSIGN_TIE
    slack, its phi within FP_TOL; the plain version with a last-slot
    argmax parts from the card on every link, so that this check sees the
    first-slot rule."""
    from svinet_torch.ops.digamma import dirichlet_expectation
    from svinet_torch.ops.sparse_gamma import (
        _union_scores_plain, sparse_edge_assignments)
    from svinet_torch.synth import tied_topw_state
    for k, wt, n_tied, n_self in K11_TIES:
        ids, vals, rest, lam, links = (
            torch.as_tensor(a, device=dev) for a in
            tied_topw_state(K11_TIES_SEED, k, wt, n_tied, n_self))
        c_k, m_k = sparse_edge_assignments(ids, vals, rest, lam, links, k)
        c_p, m_p = _union_scores_plain(ids, vals, rest,
                                       dirichlet_expectation(lam), links, k,
                                       True)
        torch.cuda.synchronize()
        assert torch.equal(c_k, c_p), (k, wt, int((c_k != c_p).sum()))
        err = float(((m_k - m_p).abs() / m_p.abs()).max())
        assert err <= FP_TOL, (k, wt, err)
        slots, phi = _plain_phi(ids, vals, rest, lam, links, k)
        last = 2 * wt - 1 - phi.flip(-1).argmax(-1)
        c_last = slots.gather(1, last[:, None])[:, 0]
        parts = int((c_last != c_k).sum())
        assert parts == links.shape[0], (k, wt, parts)
        log(f"phase 6: union_scores (assignments) on K11_TIES' state at "
            f"K={k} W={wt}, {n_tied} tied links and {n_self} self links: "
            f"every community the plain version's, largest phi within "
            f"{err:.3e}; the plain version with a last-slot argmax parts "
            f"from the card on {parts} of {links.shape[0]} links")


def phase6_nan(dev):
    """Kernel 11's assignments on K11_NAN's states (synth.nan_topw_state),
    into a workspace that a state of finite phis filled first: every
    link's community the plain version's (its first slot's), its phi NaN
    as the plain version's."""
    from svinet_torch.ops.digamma import dirichlet_expectation
    from svinet_torch.ops.sparse_gamma import (
        SparseWorkspace, _union_scores_plain, sparse_edge_assignments)
    from svinet_torch.synth import nan_topw_state
    for k, wt, n_links, n_rows in K11_NAN:
        ids, vals, rest, lam, links = (
            torch.as_tensor(a, device=dev) for a in
            nan_topw_state(K11_TIES_SEED, k, wt, n_links, n_rows))
        ws = SparseWorkspace(dev)
        # the workspace's outputs hold another state's communities first
        sparse_edge_assignments(ids, vals, rest + 1.0, lam, links, k, ws)
        c_k, m_k = sparse_edge_assignments(ids, vals, rest, lam, links, k,
                                           ws)
        c_p, m_p = _union_scores_plain(ids, vals, rest,
                                       dirichlet_expectation(lam), links, k,
                                       True)
        torch.cuda.synchronize()
        assert bool(m_p.isnan().all()), (k, wt)
        assert torch.equal(c_p, ids[links[:, 0].long(), 0]), (k, wt)
        assert torch.equal(c_k, c_p), (k, wt, int((c_k != c_p).sum()))
        assert bool(m_k.isnan().all()), (k, wt, int((~m_k.isnan()).sum()))
        log(f"phase 6: union_scores (assignments) on K11_NAN's state at "
            f"K={k} W={wt}, {n_links} links on {n_rows} rows: every phi "
            f"NaN and every community the first slot's, as the plain "
            f"version's")


def phase6_scores(dev):
    """Kernel 11 in both forms against its plain version: the scores of
    held-out pairs at SCORE_SHAPES, the assignments of stretch's links at
    ASSIGN_SHAPES (1e-4; a community apart only within ASSIGN_TIE), two
    launches bitwise equal, a third into the first's workspace equal too
    and allocating nothing; then the exact ties of K11_TIES and the NaN
    phis of K11_NAN. Returns the reports of the scores at n=1M, K=8,000,
    W=16 and of the assignments."""
    from svinet_torch.ops.sparse_gamma import (
        SparseWorkspace, _union_scores_plain, sparse_edge_assignments,
        sparse_pair_scores, union_scores)
    from svinet_torch.ops.digamma import dirichlet_expectation
    from svinet_torch.synth import random_edges
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    reports = {}
    for n, k, wt, m in SCORE_SHAPES:
        ids, vals, rest = _sparse_state(dev, gen, n, k, wt)
        lam = 1.0 + 19.0 * torch.rand((k, 2), generator=gen, device=dev)
        pairs = torch.randint(0, n, (m, 2), generator=gen,
                              device=dev).to(torch.int32)
        beta = (lam[:, 0] / (lam[:, 0] + lam[:, 1])).contiguous()
        ws = SparseWorkspace(dev)

        def run(into=ws):
            return sparse_pair_scores(ids, vals, rest, lam, pairs, k, into)

        def plain():
            return _union_scores_plain(ids, vals, rest, beta, pairs, k,
                                       False)

        a_k, b_k = (t.clone() for t in run())
        a_2, b_2 = run(SparseWorkspace(dev))
        torch.cuda.synchronize()
        assert torch.equal(a_k, a_2) and torch.equal(b_k, b_2)
        _no_alloc(dev, lambda: union_scores(ids, vals, rest, beta, pairs, k,
                                            False, ws), (a_k, b_k))
        a_p, b_p = plain()
        err = max(_rel_err(a_k, a_p), _rel_err(b_k, b_p),
                  float(((a_k - a_p).abs() / a_p.abs()).max()),
                  float(((b_k - b_p).abs() / b_p.abs()).max()))
        assert err <= FP_TOL, (n, k, wt, m, err)
        ms = cuda_ms(run, 20)
        plain_ms = cuda_ms(plain, 3)
        bnd = score_bound(pairs, wt, k, 8)
        floor = score_floor_ms(m, wt, 8)
        log(f"phase 6: union_scores (scores) at n={n} K={k} W={wt}, {m} "
            f"pairs: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bnd[0]:.4f} ms, floor {floor:.4f} ms; relative err "
            f"{err:.3e}; two launches bitwise equal, a third into the "
            f"first's workspace equal too and allocating nothing")
        if (n, k, wt) == (1_000_000, 8_000, 16):
            reports["scores"] = dict(_report(err, ms, plain_ms, bnd),
                                     floor_ms=floor)
        if (n, k, wt) == SPARSE_WIDE:
            reports["scores+wide"] = dict(_report(err, ms, plain_ms, bnd),
                                          floor_ms=floor)
        if k == 100:
            # no pair at all: both forms return empty outputs
            none = pairs[:0]
            for got in (sparse_pair_scores(ids, vals, rest, lam, none, k),
                        sparse_edge_assignments(ids, vals, rest, lam, none,
                                                k)):
                assert all(t.shape == (0,) for t in got), got
        del ids, vals, rest, ws
        torch.cuda.empty_cache()
    all_edges = torch.as_tensor(random_edges(STRETCH["n"],
                                             STRETCH["n_edges"], 0),
                                device=dev)
    for n, k, wt, n_links in ASSIGN_SHAPES:
        ids, vals, rest = _sparse_state(dev, gen, n, k, wt)
        lam = 1.0 + 19.0 * torch.rand((k, 2), generator=gen, device=dev)
        if n == STRETCH["n"]:
            edges, which = all_edges[:n_links], "of stretch's links"
        else:
            edges = torch.as_tensor(random_edges(n, n_links, 0), device=dev)
            which = "random links"
        e = edges.shape[0]
        # the plain version's chunk: its (links, 2W, W) match tensors
        # within a few GB
        chunk = (1 << 28) // (2 * wt * wt)
        ws = SparseWorkspace(dev)

        def run(into=ws):
            return sparse_edge_assignments(ids, vals, rest, lam, edges, k,
                                           into)

        def plain():
            eb = dirichlet_expectation(lam)
            cs, ms_ = [], []
            for lo in range(0, e, chunk):
                c, v = _union_scores_plain(ids, vals, rest, eb,
                                           edges[lo:lo + chunk], k, True)
                cs.append(c)
                ms_.append(v)
            return torch.cat(cs), torch.cat(ms_)

        c_k, m_k = (t.clone() for t in run())
        c_2, m_2 = run(SparseWorkspace(dev))
        torch.cuda.synchronize()
        assert torch.equal(c_k, c_2) and torch.equal(m_k, m_2)
        elogbeta = dirichlet_expectation(lam)
        _no_alloc(dev, lambda: union_scores(ids, vals, rest, elogbeta, edges,
                                            k, True, ws), (c_k, m_k))
        c_p, m_p = plain()
        differ = _assign_ties(ids, vals, rest, lam, edges, k, c_k, c_p, m_p)
        same = c_k == c_p
        err = float(((m_k - m_p).abs() / m_p.abs())[same].max())
        assert err <= FP_TOL, (n, k, wt, err)
        ms = cuda_ms(run, 5)
        plain_ms = cuda_ms(plain, 1)
        bnd = score_bound(edges, wt, k, 8)
        floor = score_floor_ms(e, wt, 8)
        log(f"phase 6: union_scores (assignments) on {e} {which} at n={n} "
            f"K={k} W={wt}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (in "
            f"chunks of {chunk} links), bound {bnd[0]:.3f} ms, floor "
            f"{floor:.3f} ms ({floor / ms:.0%} of it); largest phi within "
            f"{err:.3e}, {differ} links on another community within a tie "
            f"of {ASSIGN_TIE:g}; two launches bitwise equal, a third into "
            f"the first's workspace equal too and allocating nothing")
        if (n, k, wt) == SPARSE_STRETCH:
            reports["assign"] = dict(_report(err, ms, plain_ms, bnd),
                                     floor_ms=floor)
        if (n, k, wt) == SPARSE_WIDE:
            reports["assign+wide"] = dict(_report(err, ms, plain_ms, bnd),
                                          floor_ms=floor)
        del ids, vals, rest, c_k, c_2, c_p, m_k, m_2, m_p, ws
        torch.cuda.empty_cache()
    phase6_ties(dev)
    phase6_nan(dev)
    return reports


def phase6_steps(dev):
    """Wall and device times of a FastAMM step of each kind on a stretch-
    shaped state: the dense step at n=1M, K=500, and the -fastqueue step
    at n=1M, K=8,000, W=16; an informative step (21 links and 100 zeros of
    one node, padded to 256) and a non-informative one (200 nonlinks)."""
    from svinet_torch.ops.sparse_gamma import (
        K10_SEG_LEN, SparseWorkspace, sparse_fastamm_step)
    from svinet_torch.svi.fastamm import Batch, fastamm_step, to_device
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    ws = SparseWorkspace(dev)
    log_eps = float(np.float32(np.log(1e-30)))
    n = STRETCH["n"]
    for kind, kk in (("dense", STRETCH["k"]), ("fastqueue", 8_000)):
        state = (0.05 + torch.rand((n, kk), generator=gen, device=dev) ** 4
                 * 10 if kind == "dense" else
                 _sparse_state(dev, gen, n, kk, 16))
        lam = 1.0 + 19.0 * torch.rand((kk, 2), generator=gen, device=dev)
        eta = torch.ones((kk, 2), device=dev)
        for step_kind, m, links, scale in (
                ("informative", 121, 21, n / 2.0),
                ("non-informative", 200, 0,
                 float(n) * n / (2.0 * 1e-4 * 200))):
            pairs_g, y, w, nodes = _minibatch(dev, gen, n, m, links)
            dense = kind == "dense"
            rows, local = _local(pairs_g, nodes, dense)
            rho = torch.rand(rows.shape[0], generator=gen, device=dev)
            host = [a.cpu().numpy() for a in (
                rows, local if dense else pairs_g, y, w,
                local.reshape(-1).long(), rho)]
            # a report interval of steps, copied to the card at once as
            # the engine copies them
            reps = 100
            t0 = time.perf_counter()
            batches = [Batch(*host, scale, 0.01)] * reps
            steps = (to_device(batches, dev) if dense
                     else to_device(batches, dev, K10_SEG_LEN))
            torch.cuda.synchronize()
            copy = (time.perf_counter() - t0) * 1e3

            def step(st):
                if dense:
                    return fastamm_step(
                        state, lam, st.rows, st.pairs, st.y, st.w, st.rho,
                        0.002, eta, st.scale, st.rhot, 1.0, log_eps, 50,
                        1e-5, 256, st.csr)
                return sparse_fastamm_step(
                    *state, lam, st.pairs, st.y, st.w, st.lp, st.lq,
                    st.rows, st.rho, 0.002, eta, st.scale, st.rhot, 1.0,
                    log_eps, kk, 50, 1e-5, 256, st.csr, ws)

            step(steps[0])
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for st in steps:
                step(st)
            end.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
            dev_ms = start.elapsed_time(end) / reps
            log(f"phase 6: FastAMM {kind} step, {step_kind} ({m} pairs, "
                f"{rows.shape[0]} rows) at n={n} K={kk}"
                + (" W=16" if not dense else "")
                + f": {wall:.3f} ms wall a step over {reps} steps "
                f"({dev_ms:.3f} ms between events on the card), their copy "
                f"to the card {copy:.1f} ms")
        if kind == "dense":
            assert torch.isfinite(state).all()
        else:
            assert torch.isfinite(state[1]).all()
        del state
        torch.cuda.empty_cache()


DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")


def _trace_split(fn, calls):
    """One call of fn split by torch.profiler's trace, averaged over
    `calls` calls (after one inside the profiler), each followed by a
    synchronize: {"host": the call's ms on the host, "alloc": ms in
    aten::empty*, "ops": ms in other top-level aten ops, "runtime": {CUDA
    runtime call: (ms, count)}, "device": {kernel: (ms, launches)},
    "busy": device ms, "span": ms from the first kernel's start to the
    last one's end, "gaps": span - busy, "lead": ms from the call's start
    to its first kernel}, a call's numbers each divided by `calls`. A
    device event belongs to the call whose CUDA runtime or driver call
    launched it (the trace's correlation ids), whatever the two clocks'
    offset."""
    from torch.profiler import ProfilerActivity, profile, record_function
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(calls + 1):
            with record_function(f"k10call{i}"):
                fn()
            torch.cuda.synchronize()
    with tempfile.NamedTemporaryFile(suffix=".json") as tmp:
        prof.export_chrome_trace(tmp.name)
        events = [e for e in json.load(open(tmp.name))["traceEvents"]
                  if e.get("ph") == "X"]
    marks = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith("k10call")),
                   key=lambda e: e["ts"])[1:]
    out = {"host": 0.0, "alloc": 0.0, "ops": 0.0, "runtime": {},
           "device": {}, "busy": 0.0, "span": 0.0, "gaps": 0.0,
           "lead": 0.0}
    for mk in marks:
        lo, hi = mk["ts"], mk["ts"] + mk["dur"]
        out["host"] += mk["dur"] / 1e3
        ops = sorted((e for e in events if e.get("cat") == "cpu_op"
                      and lo <= e["ts"] <= hi), key=lambda e: e["ts"])
        end = -1.0
        for e in ops:   # top-level ops only: nested ones lie inside
            if e["ts"] >= end:
                key = "alloc" if e["name"].startswith("aten::empty") else "ops"
                out[key] += e["dur"] / 1e3
                end = e["ts"] + e["dur"]
        launched = set()
        for e in events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and (
                    lo <= e["ts"] <= hi):
                ms, c = out["runtime"].get(e["name"], (0.0, 0))
                out["runtime"][e["name"]] = (ms + e["dur"] / 1e3, c + 1)
                launched.add(e.get("args", {}).get("correlation"))
        launched.discard(None)
        dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS
                      and e.get("args", {}).get("correlation") in launched),
                     key=lambda e: e["ts"])
        for e in dev:
            name = re.sub(r"^void |\(anonymous namespace\)::", "",
                          e["name"]).split("(")[0]
            ms, c = out["device"].get(name, (0.0, 0))
            out["device"][name] = (ms + e["dur"] / 1e3, c + 1)
        if dev:
            busy = sum(e["dur"] for e in dev) / 1e3
            span = (dev[-1]["ts"] + dev[-1]["dur"] - dev[0]["ts"]) / 1e3
            out["busy"] += busy
            out["span"] += span
            out["gaps"] += span - busy
            out["lead"] += (dev[0]["ts"] - lo) / 1e3
    n = max(len(marks), 1)
    for key in ("host", "alloc", "ops", "busy", "span", "gaps", "lead"):
        out[key] /= n
    for key in ("runtime", "device"):
        out[key] = {k: (ms / n, c / n) for k, (ms, c) in out[key].items()}
    return out


def phase6(dev, workdir):
    """FastAMM: kernel 8's FastAMM form, kernels 10 and 11 against their
    plain versions, the CLI runs on planted-20k, the step's times on a
    stretch-shaped state. Returns (launches by name and form, {row name:
    (launches a unit, the unit)}, {row name: report})."""
    t0 = time.perf_counter()
    reports = {"phi_fixed_point:fastamm": phase6_fp(dev)}
    (reports["sparse_fastamm_stats"],
     reports["sparse_fastamm_stats:wide"]) = phase6_sparse(dev)
    scores = phase6_scores(dev)
    for form in ("scores", "assign", "scores+wide", "assign+wide"):
        reports[f"union_scores:{form}"] = scores[form]
    launches, per_unit = phase6_cli(workdir)
    phase6_steps(dev)
    log(f"phase 6: {time.perf_counter() - t0:.1f} s")
    return launches, per_unit, reports


# ---------------------------------------------------------------------
# Phase 7: FastInit (-findk) and SBM (-single, batch and -infset).

# The CLI runs on planted-20k, each held to the CPU port's
# (`python3 chip_smoke.py --record-cpu fk sbm` prints FK_CPU and
# SBM_CPU_ROWS): -findk's heldout.txt rows at FK_ROW_RTOL and its files
# (sha256 of each) byte for byte, unless a link's normalized overlap lies
# within FK_THRESH_TIE of link_thresh on the card's final state (a pair
# sharing two ids of equal products sits at 0.5 exactly, and the sums'
# order moves such links across it), where kernel 13 and the plain version
# may select only such links apart; the SBM
# runs' rows at MMSB_ROW_RTOL. The batch run is also cut after the report
# of SBM_CUT and -resume'd: no draw follows the init, so the resumed run
# writes the uninterrupted run's rows bit for bit.
FK_FLAGS = ["-findk"]
SBM_FLAGS = ["-single", "-max-iterations", "60", "-no-stop"]
SBMI_STEPS = 3000
SBMI_FLAGS = ["-single", "-infset", "-max-iterations", str(SBMI_STEPS),
              "-rfreq", "500", "-no-stop"]
SBM_CUT = 30
FK_ROW_RTOL = 1e-5
FK_THRESH_TIE = 1e-5
FK_FILES = ("communities.txt", "communities_size.txt", "groups.txt",
            "mutual.txt")
FK_CPU = {'heldout': [[1, -25.562826157, -5.9815e-05, -51.125591278, -5.9755e-05,
                       -0.05061431, -0.050674065],
                      [2, -6.074268818, -0.000638128, -12.147899628, -0.000637496,
                       -0.012026415, -0.012663911],
                      [3, -3.644290447, -0.002591767, -7.285989761, -0.002589201,
                       -0.007213126, -0.009802327],
                      [4, -2.725623846, -0.011001419, -5.440246105, -0.010990528,
                       -0.005385841, -0.016376369],
                      [5, -2.028622627, -0.050470371, -4.006774902, -0.050420405,
                       -0.003966705, -0.05438711]],
          'validation': [[1, -25.10943, -5e-05, -50.21882],
                         [2, -5.98505, -0.00057, -11.96953],
                         [3, -3.41126, -0.00239, -6.82013]],
          'files': {'communities.txt': '5c81bbc8de484cf596392a85030619fa1b35c2bcf652e966f259a42c01a9ee76',
                    'communities_size.txt': 'fedc24dc4560e730abfff1ec3ffd26da19e86538b0485cc0fd5a0eee5731b0f1',
                    'groups.txt': '4e07b6e021605b4630d958f99f68fc8f270c2d69cb7c19788a7d26bb7bd4a138',
                    'mutual.txt': '45e6b680cb10fe00f8b450a9183a2ad641386e033c89d3e201f614143544a8e3'}}
SBM_CPU_ROWS = {'sbm': {'heldout': [[1, -3.462412959, -0.000984786, -6.923840962,
                                     -0.000983811, -0.006854599, -0.00783841],
                                    [2, -3.461848399, -0.000985663, -6.922711348,
                                     -0.000984688, -0.006853481, -0.007838168],
                                    [3, -3.461846424, -0.000985641, -6.922707399,
                                     -0.000984665, -0.006853477, -0.007838142],
                                    [4, -3.461846424, -0.00098565, -6.922707399,
                                     -0.000984674, -0.006853477, -0.007838151],
                                    [5, -3.461846424, -0.000985659, -6.922707399,
                                     -0.000984683, -0.006853477, -0.00783816],
                                    [6, -3.461846424, -0.000985661, -6.922707399,
                                     -0.000984685, -0.006853477, -0.007838162],
                                    [7, -3.461846424, -0.000985658, -6.922707399,
                                     -0.000984682, -0.006853477, -0.007838159],
                                    [8, -3.461846424, -0.000985661, -6.922707399,
                                     -0.000984685, -0.006853477, -0.007838162],
                                    [9, -3.461846424, -0.000985658, -6.922707399,
                                     -0.000984682, -0.006853477, -0.007838159],
                                    [10, -3.461846424, -0.000985655, -6.922707399,
                                     -0.000984679, -0.006853477, -0.007838156],
                                    [11, -3.461846424, -0.000985661, -6.922707399,
                                     -0.000984685, -0.006853477, -0.007838162],
                                    [12, -3.461846424, -0.000985663, -6.922707399,
                                     -0.000984687, -0.006853477, -0.007838164],
                                    [13, -3.461846424, -0.00098566, -6.922707399,
                                     -0.000984684, -0.006853477, -0.007838161],
                                    [14, -3.461846424, -0.000985664, -6.922707399,
                                     -0.000984689, -0.006853477, -0.007838166],
                                    [15, -3.461846424, -0.000985661, -6.922707399,
                                     -0.000984685, -0.006853477, -0.007838162],
                                    [16, -3.461846424, -0.000985659, -6.922707399,
                                     -0.000984683, -0.006853477, -0.00783816],
                                    [17, -3.461846424, -0.000985658, -6.922707399,
                                     -0.000984683, -0.006853477, -0.007838159],
                                    [18, -3.461846424, -0.000985658, -6.922707399,
                                     -0.000984682, -0.006853477, -0.007838159],
                                    [19, -3.461846424, -0.00098566, -6.922707399,
                                     -0.000984684, -0.006853477, -0.007838161],
                                    [20, -3.461846424, -0.000985662, -6.922707399,
                                     -0.000984686, -0.006853477, -0.007838163],
                                    [21, -3.461846424, -0.000985658, -6.922707399,
                                     -0.000984683, -0.006853477, -0.007838159],
                                    [22, -3.461846424, -0.000985655, -6.922707399,
                                     -0.000984679, -0.006853477, -0.007838156],
                                    [23, -3.461846424, -0.000985664, -6.922707399,
                                     -0.000984688, -0.006853477, -0.007838165],
                                    [24, -3.461846424, -0.000985664, -6.922707399,
                                     -0.000984688, -0.006853477, -0.007838165],
                                    [25, -3.461846424, -0.000985662, -6.922707399,
                                     -0.000984686, -0.006853477, -0.007838163],
                                    [26, -3.461846424, -0.000985666, -6.922707399,
                                     -0.00098469, -0.006853477, -0.007838167],
                                    [27, -3.461846424, -0.000985683, -6.922707399,
                                     -0.000984707, -0.006853477, -0.007838184],
                                    [28, -3.461846424, -0.000985688, -6.922707399,
                                     -0.000984712, -0.006853477, -0.007838189],
                                    [29, -3.461846424, -0.000985645, -6.922707399,
                                     -0.000984669, -0.006853477, -0.007838146],
                                    [30, -3.461846424, -0.000985646, -6.922707399,
                                     -0.00098467, -0.006853477, -0.007838147],
                                    [31, -3.461846424, -0.000985643, -6.922707399,
                                     -0.000984667, -0.006853477, -0.007838144],
                                    [32, -3.461846424, -0.000985647, -6.922707399,
                                     -0.000984671, -0.006853477, -0.007838148],
                                    [33, -3.461846424, -0.000985642, -6.922707399,
                                     -0.000984666, -0.006853477, -0.007838143],
                                    [34, -3.461846424, -0.000985646, -6.922707399,
                                     -0.00098467, -0.006853477, -0.007838147],
                                    [35, -3.461846424, -0.000985654, -6.922707399,
                                     -0.000984678, -0.006853477, -0.007838155],
                                    [36, -3.461846424, -0.000985668, -6.922707399,
                                     -0.000984692, -0.006853477, -0.007838169],
                                    [37, -3.461846424, -0.000985681, -6.922707399,
                                     -0.000984705, -0.006853477, -0.007838182],
                                    [38, -3.461846424, -0.000985679, -6.922707399,
                                     -0.000984704, -0.006853477, -0.007838181],
                                    [39, -3.461846424, -0.000985674, -6.922707399,
                                     -0.000984698, -0.006853477, -0.007838175],
                                    [40, -3.461846424, -0.000985684, -6.922707399,
                                     -0.000984708, -0.006853477, -0.007838185],
                                    [41, -3.461846424, -0.000985681, -6.922707399,
                                     -0.000984705, -0.006853477, -0.007838182],
                                    [42, -3.461846424, -0.00098568, -6.922707399,
                                     -0.000984704, -0.006853477, -0.007838181],
                                    [43, -3.461846424, -0.000985682, -6.922707399,
                                     -0.000984706, -0.006853477, -0.007838183],
                                    [44, -3.461846424, -0.000985694, -6.922707399,
                                     -0.000984718, -0.006853477, -0.007838195],
                                    [45, -3.461846424, -0.000985643, -6.922707399,
                                     -0.000984668, -0.006853477, -0.007838144],
                                    [46, -3.461846424, -0.000985655, -6.922707399,
                                     -0.00098468, -0.006853477, -0.007838156],
                                    [47, -3.461846424, -0.000985655, -6.922707399,
                                     -0.000984679, -0.006853477, -0.007838156],
                                    [48, -3.461846424, -0.000985657, -6.922707399,
                                     -0.000984681, -0.006853477, -0.007838158],
                                    [49, -3.461846424, -0.000985656, -6.922707399,
                                     -0.00098468, -0.006853477, -0.007838157],
                                    [50, -3.461846424, -0.000985654, -6.922707399,
                                     -0.000984678, -0.006853477, -0.007838155],
                                    [51, -3.461846424, -0.000985654, -6.922707399,
                                     -0.000984678, -0.006853477, -0.007838155],
                                    [52, -3.461846424, -0.000985659, -6.922707399,
                                     -0.000984683, -0.006853477, -0.00783816],
                                    [53, -3.461846424, -0.000985657, -6.922707399,
                                     -0.000984681, -0.006853477, -0.007838158],
                                    [54, -3.461846424, -0.000985656, -6.922707399,
                                     -0.00098468, -0.006853477, -0.007838157],
                                    [55, -3.461846424, -0.000985657, -6.922707399,
                                     -0.000984682, -0.006853477, -0.007838158],
                                    [56, -3.461846424, -0.000985655, -6.922707399,
                                     -0.000984679, -0.006853477, -0.007838156],
                                    [57, -3.461846424, -0.000985657, -6.922707399,
                                     -0.000984681, -0.006853477, -0.007838158],
                                    [58, -3.461846424, -0.000985657, -6.922707399,
                                     -0.000984681, -0.006853477, -0.007838158],
                                    [59, -3.461846424, -0.000985659, -6.922707399,
                                     -0.000984683, -0.006853477, -0.00783816],
                                    [60, -3.461846424, -0.000985659, -6.922707399,
                                     -0.000984683, -0.006853477, -0.00783816],
                                    [61, -3.461846424, -0.000985658, -6.922707399,
                                     -0.000984683, -0.006853477, -0.00783816]]},
                'sbmi': {'heldout': [[500, -0.596862316, -0.128023639, -1.065701008,
                                      -0.127896896, -0.001055043, -0.128951939],
                                     [1000, -2.123086214, -0.002914519, -4.243257999,
                                      -0.002911634, -0.004200823, -0.007112457],
                                     [1500, -1.937261701, -0.004191671, -3.870331526,
                                      -0.004187521, -0.003831626, -0.008019147],
                                     [2000, -1.82224071, -0.005622388, -3.638859034,
                                      -0.005616822, -0.003602469, -0.009219291],
                                     [2500, -2.565008402, -0.001433278, -5.128583431,
                                      -0.001431859, -0.005077295, -0.006509154],
                                     [3000, -2.862601757, -0.000857372, -5.724346161,
                                      -0.000856523, -0.0056671, -0.006523623]]}}
# kernel 12 on planted-20k's links, stretch's and a graph with a hub of
# VOTE_HUB links; the labels come from a few values, so counts tie
VOTE_HUB = 50_000
# kernel 13 at these widths on made rows, beside stretch's links at 64
OVERLAP_WIDTHS = (8, 130, 4_097, 8_192)
# above this width a pair's table outgrows shared memory (device scratch):
# made rows over fewer pairs, since the plain version's (B, w, w) blocks
# grow as w^2
OVERLAP_WIDE = 4_096
OVERLAP_WIDE_PAIRS = 1_000
# kernel 14 on chunk 3 and on whole E-steps: (n, K, held-out pairs, the
# whole E-steps' state), on planted-20k's, stretch's and planted
# n=2,000's links. The chunk check is made in the member state
# (_estep_model: 0.8 of each row on its node's block, a random balanced
# assignment, under a lambda whose rows depend on their neighbours' and
# held-out partners' rows), beside the plain version with each planted
# fault (every neighbour read from the round's input, the held-out list
# left out), which must part from it by more than ESTEP_TOL. A random phi
# under a lambda scaled at random (the saturated state) puts every row
# one-hot on one column whatever the kernel gathers. The whole E-steps
# need rounds that contract: the member state's do at n = 2,000, and so do
# the planted state's (the member state on planted-20k's blocks, which
# stops by the threshold after an odd number of rounds, the last round's
# rows copied back into phi); at n = 20,000 and at stretch the member
# state's do not (two plain versions that add tot in other orders part by
# up to 1.0 within one round), so there they run from the saturated
# state and hold the rounds and the driver. K = 1,000 and 1,001 take the
# kernel's tiles, 1,001 and 37 its rows of 4-byte units (K % 4 != 0).
ESTEP_SHAPES = ((20_000, 20, 4_000, "saturated"),
                (1_000_000, 500, 400_000, "saturated"),
                (2_000, 1_000, 400, "member"),
                (2_000, 1_001, 400, "member"),
                (20_000, 37, 4_000, "saturated"),
                (20_000, 20, 4_000, "planted"))
# the member state's lambda: (diagonal row, row K)
ESTEP_MEMBER_LAMBDA = ((3.0, 7.0), (1.0, 9.0))
ESTEP_TOL = 1e-4


def _clean_links(edges):
    """A raw edge list as the network keeps it: (lo, hi), no self loop, no
    repeat."""
    e = np.sort(np.asarray(edges, np.int64), 1)
    e = e[e[:, 0] != e[:, 1]]
    return np.unique(e, axis=0).astype(np.int32)


def _planted_links():
    from svinet_torch.synth import planted_blocks
    edges, _ = planted_blocks(PLANTED["n"], PLANTED["k"], PLANTED["avg_deg"],
                              PLANTED["seed"])
    return _clean_links(edges)


def _batch_planted_links():
    from svinet_torch.synth import planted_blocks
    edges, _ = planted_blocks(BATCH_PLANTED["n"], BATCH_PLANTED["k"],
                              BATCH_PLANTED["avg_deg"], BATCH_PLANTED["seed"])
    return _clean_links(edges)


def _hub_links(gen_np):
    """A random graph of 100,000 nodes and 200,000 links, with node 0
    linked to VOTE_HUB others."""
    n = 100_000
    e = gen_np.integers(0, n, size=(200_000, 2))
    hub = np.stack([np.zeros(VOTE_HUB, np.int64),
                    gen_np.choice(np.arange(1, n), VOTE_HUB, replace=False)],
                   1)
    return n, _clean_links(np.concatenate([e, hub]))


def vote_bound(n, n_entries, width):
    """Kernel 12's bound (labels, rowptr and the neighbour ids read once,
    ids and counts written once) and its floor (each label gathered as a
    32-byte sector)."""
    base = 4 * n + 4 * (n + 1) + 4 * n_entries + 8 * n * width
    return (bound(base, 0.0),
            (base - 4 * n + 32 * n_entries) / PEAK_BYTES_S * 1e3)


def phase7_vote(dev, stretch_links):
    """Kernel 12 bit for bit against its plain version and across two
    launches: planted-20k's links at width 64 and 8, stretch's at 64, a
    hub of VOTE_HUB links at 64. Returns stretch's report."""
    from svinet_torch.ops.edges import build_adjacency
    from svinet_torch.svi.fastinit import vote_plan, vote_topk, vote_topk_plain
    gen_np = np.random.default_rng(17)
    hub_n, hub = _hub_links(gen_np)
    cases = (("planted-20k", PLANTED["n"], _planted_links(), (64, 8), 10),
             ("stretch", STRETCH["n"], stretch_links, (64,), 1000),
             (f"a {VOTE_HUB}-link hub", hub_n, hub, (64,), 300))
    report = None
    for label, n, links, widths, values in cases:
        adj = build_adjacency(links, n, dev)
        plan = vote_plan(adj)
        labels = torch.as_tensor(gen_np.integers(0, values, n),
                                 dtype=torch.int32, device=dev)
        for w in widths:
            def run():
                return vote_topk(labels, adj, n, w, plan)

            def plain():
                return vote_topk_plain(labels, adj, n, w)

            ids_k, cnt_k = run()
            ids_2, cnt_2 = run()
            torch.cuda.synchronize()
            assert torch.equal(ids_k, ids_2) and torch.equal(cnt_k, cnt_2)
            ids_p, cnt_p = plain()
            assert torch.equal(ids_k, ids_p), (label, w)
            assert torch.equal(cnt_k, cnt_p), (label, w)
            ms = cuda_ms(run, 10)
            plain_ms = cuda_ms(plain, 2)
            bnd, floor = vote_bound(n, adj.nbr.shape[0], w)
            log(f"phase 7: vote_topk on {label} (n={n}, {adj.nbr.shape[0]} "
                f"votes, {plan.hub_node.shape[0]} hubs) at width {w}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} "
                f"ms, floor {floor:.4f} ms; bit for bit the plain version's "
                f"and across two launches")
            if label == "stretch":
                report = dict(_report(0.0, ms, plain_ms, bnd), floor_ms=floor)
        del adj, plan
        torch.cuda.empty_cache()
    return report


def _made_rows(gen_np, n, w, universe):
    """(ids, cnt) of n rows of width w: each a random number of real slots
    (a tenth of the rows none), distinct ids a + j s mod universe (s prime
    to it), counts descending; the sentinel n and 0 past them."""
    real = gen_np.integers(0, w + 1, n)
    real[gen_np.random(n) < 0.1] = 0
    a = gen_np.integers(0, universe, (n, 1))
    s = gen_np.choice([x for x in range(1, 64) if np.gcd(x, universe) == 1],
                      (n, 1))
    j = np.arange(w)[None, :]
    ids = ((a + j * s) % universe).astype(np.int32)
    cnt = -np.sort(-gen_np.integers(1, 50, (n, w)), 1).astype(np.float32)
    past = j >= real[:, None]
    ids[past] = n
    cnt[past] = 0.0
    return ids, cnt


def _overlap_ties(ids, pi, pairs, mid_k, mid_p, mx_p):
    """The pairs whose card id differs from the plain version's; each must
    have, at the card's id, a product within 1e-6 of the largest."""
    bad = torch.nonzero(mid_k != mid_p).flatten()
    for i in bad.tolist():
        p, q = (int(v) for v in pairs[i])
        at_p = torch.nonzero(ids[p] == mid_k[i]).flatten()
        at_q = torch.nonzero(ids[q] == mid_k[i]).flatten()
        assert len(at_p) == 1 and len(at_q) == 1, (i, p, q)
        prod = float(pi[p, at_p[0]] * pi[q, at_q[0]])
        assert abs(prod - float(mx_p[i])) <= 1e-6 * float(mx_p[i]), (
            i, prod, float(mx_p[i]))
    return len(bad)


def overlap_bound(rows, w, m):
    """Kernel 13's bound (the ids and pi rows the pairs name, `rows` of
    them, read once, the pairs read and three outputs written) and its
    floor (each pair's two rows gathered)."""
    return (bound(8 * rows * w + 8 * m + 12 * m, 0.0),
            (16 * w + 20) * m / PEAK_BYTES_S * 1e3)


def phase7_overlap(dev, stretch_links):
    """Kernel 13 against its plain version (sums and largest products at
    ESTEP_TOL, ids equal up to ties) and across two launches: stretch's
    links on a width-64 vote of stretch, made rows at OVERLAP_WIDTHS over
    planted-20k's links and random pairs. Returns stretch's report and
    the widest made rows' (tables in device scratch)."""
    from svinet_torch.ops.edges import build_adjacency
    from svinet_torch.svi.fastinit import (
        overlap_stats, overlap_stats_plain, sparse_pi, vote_topk)
    gen_np = np.random.default_rng(18)
    n = STRETCH["n"]
    adj = build_adjacency(stretch_links, n, dev)
    labels = torch.as_tensor(gen_np.integers(0, 1000, n), dtype=torch.int32,
                             device=dev)
    ids, cnt = vote_topk(labels, adj, n, 64)
    del adj
    cases = [("stretch's links", ids, cnt,
              torch.as_tensor(stretch_links, device=dev))]
    planted = _planted_links()
    for w in OVERLAP_WIDTHS:
        m_ids, m_cnt = _made_rows(gen_np, PLANTED["n"], w,
                                  min(4 * w, PLANTED["n"] - 1))
        rand = gen_np.integers(0, PLANTED["n"], (200_000, 2)).astype(np.int32)
        pairs = np.concatenate([planted, rand])
        if w > OVERLAP_WIDE:
            pairs = np.concatenate([planted[:OVERLAP_WIDE_PAIRS // 2],
                                    rand[:OVERLAP_WIDE_PAIRS // 2]])
        cases.append((f"made rows of width {w}",
                      torch.as_tensor(m_ids, device=dev),
                      torch.as_tensor(m_cnt, device=dev),
                      torch.as_tensor(pairs, device=dev)))
    report = None
    for label, ids, cnt, pairs in cases:
        nn, w = ids.shape
        m = pairs.shape[0]
        pi = sparse_pi(ids, cnt, 0.01)

        def run():
            return overlap_stats(ids, pi, pairs)

        def plain():
            # the plain version's blocks at about 1 GB of (B, w, w) floats
            return overlap_stats_plain(ids, pi, pairs,
                                       block=max(1, (1 << 28) // (w * w)))

        scratch_before = overlap_stats.forms.get("scratch", 0)
        s_k, mx_k, mid_k = run()
        s_2, mx_2, mid_2 = run()
        torch.cuda.synchronize()
        assert (torch.equal(s_k, s_2) and torch.equal(mx_k, mx_2)
                and torch.equal(mid_k, mid_2))
        # the kernel's own scratch query put the tables in device scratch
        # past OVERLAP_WIDE, and only there
        took = overlap_stats.forms.get("scratch", 0) - scratch_before
        assert took == (2 if w > OVERLAP_WIDE else 0), (label, took)
        s_p, mx_p, mid_p = plain()
        err = max(_rel_err(s_k, s_p), _rel_err(mx_k, mx_p))
        assert err <= ESTEP_TOL, (label, err)
        ties = _overlap_ties(ids, pi, pairs, mid_k, mid_p, mx_p)
        shared = float((s_p > 0).float().mean())
        ms = cuda_ms(run, 5)
        plain_ms = cuda_ms(plain, 1)
        rows = int(torch.unique(pairs).numel())
        bnd, floor = overlap_bound(rows, w, m)
        form = ("tables in device scratch" if w > OVERLAP_WIDE else
                "a block a pair" if w > 64 else "a group a pair")
        log(f"phase 7: overlap_stats on {label} (n={nn}, width {w}, {m} "
            f"pairs over {rows} rows, {shared:.1%} sharing an id; {form}): "
            f"kernel "
            f"{ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bnd[0]:.4f} ms, floor {floor:.4f} "
            f"ms; sums within {err:.3e}, {ties} ids apart on a tie within "
            f"1e-6; two launches bitwise equal")
        if label == "stretch's links":
            report = dict(_report(err, ms, plain_ms, bnd), floor_ms=floor)
        if w == OVERLAP_WIDTHS[-1]:
            wide = dict(_report(err, ms, plain_ms, bnd), floor_ms=floor)
    del cases
    torch.cuda.empty_cache()
    return report, wide


def _estep_graph(dev, gen, n, links, m_held):
    """The CSRs of the links and of m_held random pairs (no pair of a
    node with itself), and those pairs."""
    from svinet_torch.ops.edges import build_adjacency
    held = torch.randint(0, n, (m_held, 2), generator=gen, device=dev)
    held = held[held[:, 0] != held[:, 1]]
    return (build_adjacency(links, n, dev),
            build_adjacency(held.cpu().numpy(), n, dev),
            held.to(torch.int32))


def _estep_model(dev, gen, n, k, member=None):
    """phi, gamma, lambda and what the E-step takes of them (Elogpi, A -
    A_K, B - B_K). The member state (member: each node's block, below k):
    each row 0.8 on its block and 0.2 a random softmax, lambda's rows
    ESTEP_MEMBER_LAMBDA. The saturated state (no member): a random softmax
    and an assortative lambda, each entry scaled at random."""
    from svinet_torch.ops.digamma import dirichlet_expectation
    phi = torch.softmax(3.0 * torch.rand((n, k), generator=gen, device=dev),
                        -1)
    gamma = 1.0 + 99.0 * torch.rand(k, generator=gen, device=dev)
    if member is None:
        lam = torch.cat([torch.tensor([[9.0, 1.0]], device=dev).repeat(k, 1),
                         torch.tensor([[1.0, 9.0]], device=dev)])
        lam = lam * (0.5 + torch.rand((k + 1, 2), generator=gen, device=dev))
    else:
        phi = 0.2 * phi + 0.8 * torch.nn.functional.one_hot(
            torch.as_tensor(member, device=dev).long(), k).float()
        diag, rest = ESTEP_MEMBER_LAMBDA
        lam = torch.cat([torch.tensor([diag], device=dev).repeat(k, 1),
                         torch.tensor([rest], device=dev)])
    elogpi = dirichlet_expectation(gamma.reshape(1, k))[0].contiguous()
    eb = dirichlet_expectation(lam)
    da = (eb[:k, 0] - eb[k, 0]).contiguous()
    db = (eb[:k, 1] - eb[k, 1]).contiguous()
    return phi, gamma, lam, elogpi, da, db


def _estep_faults(src, seen, elogpi, da, db, tot, la, ha, c, want):
    """How far chunk c's rows move from want (the plain version on phi as
    the chunk sees it, seen) under each planted fault, in the plain
    version: every neighbour read from the round's input src, or the
    held-out list left out."""
    from svinet_torch.ops.edges import build_adjacency
    from svinet_torch.svi.sbm import estep_chunk_plain
    none = build_adjacency(np.zeros((0, 2), np.int32), src.shape[0],
                           src.device)
    faults = {"neighbours from the input": (src, ha),
              "no held-out list": (seen, none)}
    return {name: float((estep_chunk_plain(phi, elogpi, da, db, tot, la, h,
                                           c)[0] - want).abs().max())
            for name, (phi, h) in faults.items()}


def estep_bound(n, k, la, ha):
    """A chunk's bound (phi read once, the chunk's CSR entries read, its
    rows and their changes written once) and floor (each of its rows'
    neighbours and held-out partners gathered, 4K bytes each)."""
    entries = (la.nbr.shape[0] + ha.nbr.shape[0]) / 16
    rows = n / 16
    base = 4 * n * k + 4 * entries + 4 * rows * k + 16 * rows
    return (bound(base, 0.0),
            (4 * k * entries + 4 * entries + 4 * rows * k) / PEAK_BYTES_S
            * 1e3)


def phase7_estep(dev, stretch_links, shapes=ESTEP_SHAPES):
    """Kernel 14 against its plain version at each of shapes
    (ESTEP_SHAPES). In the member state, chunk 3 of a round whose output
    already holds other rows for chunks 0-2: the new rows and their
    changes at ESTEP_TOL against the plain version on phi as the chunk
    sees it, each planted fault's plain version more than ESTEP_TOL from
    it, the round's input and the output's other rows untouched, tot
    renewed, two launches bitwise equal. From the shape's whole-E-step
    state, a one-round E-step (phi the round's output rows bit for bit)
    and a whole E-step on the plain version's rounds, phi at ESTEP_TOL
    (the planted state stops before ESTEP_ROUNDS). Returns stretch's
    report."""
    from svinet_torch.synth import planted_blocks
    from svinet_torch.svi.sbm import (
        ESTEP_ROUNDS, N_CHUNKS, chunk_sums, estep_buffers, estep_chunk,
        estep_chunk_plain, sbm_estep, sbm_estep_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    report = None
    for n, k, m_held, whole in shapes:
        if n == STRETCH["n"]:
            links = stretch_links
        elif n == PLANTED["n"]:
            links = _planted_links()
        else:
            links = _batch_planted_links()
        la, ha, _ = _estep_graph(dev, gen, n, links, m_held)
        member = torch.randperm(n, generator=gen, device=dev) % k
        phi, _, _, elogpi, da, db = _estep_model(dev, gen, n, k, member)
        bufs = estep_buffers(n, k, dev)
        c = 3
        rows = torch.arange(c, n, N_CHUNKS, device=dev)
        chunk_of = torch.arange(n, device=dev) % N_CHUNKS
        before = (chunk_of < c)[:, None]
        # the round's output with other rows of chunks 0-2 in it
        dst0 = torch.where(
            before, torch.softmax(torch.rand((n, k), generator=gen,
                                             device=dev), -1), phi)
        seen = torch.where(before, dst0, phi)  # phi as chunk c sees it

        def one(src):
            dst = dst0.clone()
            chunk_sums(seen, bufs)
            tot = bufs.tot.clone()
            estep_chunk(src, dst, elogpi, da, db, la, ha, c, bufs)
            return dst, tot, bufs.change[rows].clone()

        phi_k = phi.clone()
        dst_k, tot, ch_k = one(phi_k)
        tot_k = bufs.tot.clone()
        dst_2, _, ch_2 = one(phi.clone())
        torch.cuda.synchronize()
        assert torch.equal(dst_k, dst_2) and torch.equal(ch_k, ch_2)
        assert torch.equal(tot_k, bufs.tot)
        new_k = dst_k[rows]
        new_p, ch_p = estep_chunk_plain(seen, elogpi, da, db, tot, la, ha, c)
        err = max(float((new_k - new_p).abs().max()), _rel_err(ch_k, ch_p))
        assert err <= ESTEP_TOL, (n, k, err)
        faults = _estep_faults(phi, seen, elogpi, da, db, tot, la, ha, c,
                               new_p)
        assert min(faults.values()) > ESTEP_TOL, (n, k, faults)
        assert torch.equal(phi_k, phi)
        others = chunk_of != c
        assert torch.equal(dst_k[others], dst0[others])
        err_tot = _rel_err(tot_k, torch.where(chunk_of[:, None] <= c, dst_k,
                                              phi).sum(0))
        assert err_tot <= ESTEP_TOL, err_tot
        del dst_2, seen
        phi_t, dst_t = phi.clone(), dst0.clone()
        ms = cuda_ms(lambda: estep_chunk(phi_t, dst_t, elogpi, da, db, la,
                                         ha, c, bufs), 10)
        plain_ms = cuda_ms(lambda: estep_chunk_plain(
            phi_t, elogpi, da, db, bufs.tot, la, ha, c), 2)
        bnd, floor = estep_bound(n, k, la, ha)
        del phi_t, dst_t, dst0, dst_k
        # the whole E-steps' state
        if whole == "saturated":
            phi, _, _, elogpi, da, db = _estep_model(dev, gen, n, k)
        elif whole == "planted":
            phi, _, _, elogpi, da, db = _estep_model(
                dev, gen, n, k, planted_blocks(
                    PLANTED["n"], PLANTED["k"], PLANTED["avg_deg"],
                    PLANTED["seed"])[1])
        # one round: phi takes the round's output rows, bit for bit those
        # of its chunks launched one by one (a round can part from the
        # plain version's by more than ESTEP_TOL in the saturated state,
        # whose logits run to thousands; ten rounds do not)
        phi_k = phi.clone()
        _, r_1 = sbm_estep(phi_k, elogpi, da, db, la, ha, max_rounds=1,
                           bufs=bufs)
        out = torch.empty_like(phi)
        chunk_sums(phi, bufs)
        for cc in range(N_CHUNKS):
            estep_chunk(phi, out, elogpi, da, db, la, ha, cc, bufs)
        assert r_1 == 1 and torch.equal(phi_k, out), n
        del phi_k, out
        phi_k = phi.clone()
        t0 = time.perf_counter()
        _, r_k = sbm_estep(phi_k, elogpi, da, db, la, ha, bufs=bufs)
        torch.cuda.synchronize()
        secs_k = time.perf_counter() - t0
        phi_p = phi.clone()
        t0 = time.perf_counter()
        _, r_p = sbm_estep_plain(phi_p, elogpi, da, db, la, ha)
        torch.cuda.synchronize()
        secs_p = time.perf_counter() - t0
        assert r_k == r_p, (n, k, r_k, r_p)
        assert whole != "planted" or r_k < ESTEP_ROUNDS, r_k
        err_full = float((phi_k - phi_p).abs().max())
        assert err_full <= ESTEP_TOL, (n, k, err_full)
        log(f"phase 7: estep_chunk at n={n} K={k} "
            f"({la.nbr.shape[0]} link and {ha.nbr.shape[0]} held-out "
            f"entries), chunk {c}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bnd[0]:.4f} ms, floor {floor:.4f} "
            f"ms; rows within {err:.3e} (largest entry "
            f"{float(new_p.max(1).values.mean()):.3f} on average), a fault "
            f"moves them by "
            + ", ".join(f"{v:.3e} ({name})" for name, v in faults.items())
            + f"; tot within {err_tot:.3e}, two launches bitwise equal; from "
            f"the {whole} state one round's phi the round's output bit for "
            f"bit, a whole E-step {r_k} rounds (the plain version's {r_p}) in "
            f"{secs_k * 1e3:.1f} ms (plain {secs_p * 1e3:.1f} ms), phi "
            f"within {err_full:.3e}")
        if n == STRETCH["n"]:
            report = dict(_report(max(err, err_full), ms, plain_ms, bnd),
                          floor_ms=floor)
        del phi, phi_k, phi_p, la, ha, bufs
        torch.cuda.empty_cache()
    return report


# kernel 14 timed through the E-step's own entry, sbm_estep, which takes
# the same arguments in both designs the kernel has had (so estep_times
# also times an older checkout's package): (n, K, held-out pairs) on
# planted-20k's and stretch's links, from the saturated state
ESTEP_TIMED = ((20_000, 20, 4_000), (1_000_000, 500, 400_000))


def _device_split(fn):
    """{kernel: (device ms, launches)} over the second of two calls of fn
    under torch.profiler (it drops the first kernels it sees)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    split = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0 and not ev.key.startswith(("aten::", "cuda")):
            name = re.sub(r"^void |\(anonymous namespace\)::", "",
                          ev.key).split("(")[0]
            ms, count = split.get(name, (0.0, 0))
            split[name] = (ms + us / 1e3, count + ev.count)
    return split


def estep_times(dev, stretch_links):
    """Kernel 14 through sbm_estep at ESTEP_TIMED: a one-round E-step split
    by kernel (device ms and launches), two whole E-steps of ESTEP_ROUNDS
    rounds (threshold 0, so that every design runs them all) on the
    host's clock, and at stretch two SBM batch iterations with the peak
    memory. Logs each."""
    from svinet_torch.svi.sbm import (
        ESTEP_ROUNDS, estep_buffers, sbm_batch_step, sbm_estep)
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    for n, k, m_held in ESTEP_TIMED:
        links = stretch_links if n == STRETCH["n"] else _planted_links()
        la, ha, held = _estep_graph(dev, gen, n, links, m_held)
        phi, gamma, lam, elogpi, da, db = _estep_model(dev, gen, n, k)
        bufs = estep_buffers(n, k, dev)
        phi_t = phi.clone()
        split = _device_split(lambda: sbm_estep(
            phi_t, elogpi, da, db, la, ha, max_rounds=1, thresh=0.0,
            bufs=bufs))
        walls = []
        for _ in range(2):
            phi_t.copy_(phi)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, r = sbm_estep(phi_t, elogpi, da, db, la, ha, thresh=0.0,
                             bufs=bufs)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            assert r == ESTEP_ROUNDS and torch.isfinite(phi_t).all()
        tag = (f"phase 7: E-step timed at n={n} K={k} ({la.nbr.shape[0]} "
               f"link and {ha.nbr.shape[0]} held-out entries)")
        log(f"{tag}: a round by kernel (profiler): " + "; ".join(
            f"{name} {ms:.4f} ms in {count} launches"
            for name, (ms, count) in sorted(split.items(),
                                            key=lambda t: -t[1][0])))
        log(f"{tag}: a whole E-step of {ESTEP_ROUNDS} rounds "
            + ", ".join(f"{w:.1f}" for w in walls) + " ms (host clock)")
        del phi_t
        if n == STRETCH["n"]:
            eta = torch.ones((k + 1, 2), device=dev)
            links_t = torch.as_tensor(links, device=dev)
            torch.cuda.reset_peak_memory_stats(dev)
            for it in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                phi, gamma, lam, rounds = sbm_batch_step(
                    phi, gamma, lam, la, ha, links_t, held, 0.5, eta,
                    float(n) * (n - 1) / 2 - held.shape[0],
                    float(links_t.shape[0]), bufs=bufs)
                torch.cuda.synchronize()
                log(f"phase 7: SBM batch iteration {it + 1} on stretch "
                    f"(n={n}, K={k}, {links_t.shape[0]} links): "
                    f"{(time.perf_counter() - t0) * 1e3:.1f} ms (host "
                    f"clock), {rounds} E-step rounds, peak memory "
                    f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
            assert torch.isfinite(phi).all() and torch.isfinite(lam).all()
            del links_t
        del phi, la, ha, bufs
        torch.cuda.empty_cache()


def _stretch_links():
    """Stretch's training links: STRETCH["n_edges"] random pairs, each
    kept once."""
    from svinet_torch.synth import random_edges
    links = random_edges(STRETCH["n"], STRETCH["n_edges"], 0)
    return links[np.unique(links[:, 0].astype(np.int64) * STRETCH["n"]
                           + links[:, 1], return_index=True)[1]]


def _p7_cli(workdir, net, gt, label, flags):
    return _run_engine_cli(workdir, net, gt, PLANTED["n"], PLANTED["k"],
                           label, flags)


def _sha(path):
    import hashlib
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def _fk_record(out):
    rows = _mmsb_rows(out)
    return {"heldout": rows["heldout"], "validation": rows["validation"],
            "files": {name: _sha(os.path.join(out, name))
                      for name in FK_FILES}}


def _p7_runs(workdir, record):
    """-findk, -single (batch) and -single -infset on planted-20k, and the
    batch run cut after SBM_CUT and resumed. Returns ({label: rows},
    {label: (out, seconds, launches, forms)})."""
    from svinet_torch.synth import write_planted
    # a directory of its own: -single -infset would read a neighbors.bin
    # that an earlier phase left in the working directory
    workdir = os.path.join(workdir, "phase7")
    os.makedirs(workdir, exist_ok=True)
    net, gt = write_planted(workdir, PLANTED["n"], PLANTED["k"],
                            PLANTED["avg_deg"], PLANTED["seed"])
    suffix = "-cpu" if record else ""
    rows, info = {}, {}
    for label, flags in (("fk", FK_FLAGS), ("sbm", SBM_FLAGS),
                         ("sbmi", SBMI_FLAGS)):
        if not record:
            _zero_counts()
        t0 = time.perf_counter()
        out = _p7_cli(workdir, net, gt, label + suffix, flags)
        info[label] = (out, time.perf_counter() - t0, *_read_counts())
        rows[label] = (_fk_record(out) if label == "fk"
                       else {"heldout": _mmsb_rows(out)["heldout"]})
    if record:
        return rows, info
    Cut, undo = _crash_after(SBM_CUT)
    label = "sbm-cut"
    try:
        try:
            _p7_cli(workdir, net, gt, label,
                    SBM_FLAGS + ["-checkpoint-freq", "1e-9"])
            raise AssertionError("the cut did not happen")
        except Cut:
            pass
    finally:
        undo()
    rows["sbm-cut-before"] = _mmsb_rows(_outdir(workdir, label))
    out = _p7_cli(workdir, net, gt, label, SBM_FLAGS + ["-resume"])
    rows["sbm-cut"] = _mmsb_rows(out)
    info["sbm-cut"] = (out, 0.0, {}, {})
    return rows, info


def _keep_fastinit_state():
    """Make FastInit keep copies of the state its last community
    extraction saw. Returns (that record, undo)."""
    from svinet_torch.svi.fastinit import FastInit
    orig = FastInit.log_communities
    last = {}

    def kept(self):
        if self.ids is not None:
            last.update(ids=self.ids.clone(), cnt=self.cnt.clone(),
                        links=self._links.clone(),
                        thresh=self.cfg.link_thresh, alpha=self.cfg.alpha,
                        seq2id=self.network.seq2id.copy())
        return orig(self)

    FastInit.log_communities = kept
    return last, lambda: setattr(FastInit, "log_communities", orig)


def _fk_check(last, out):
    """On the -findk run's final state: the links that kernel 13 and the
    plain version select apart (normalized overlap >= link_thresh) all lie
    within FK_THRESH_TIE of link_thresh, and communities.txt is what
    link_groups makes of the kernel's outputs. Returns (links within the
    tie, links selected apart)."""
    from svinet_torch.io.writers import write_communities
    from svinet_torch.svi.fastinit import (
        link_groups, overlap_stats, overlap_stats_plain, sparse_pi)
    ids, links, t = last["ids"], last["links"], last["thresh"]
    pi = sparse_pi(ids, last["cnt"], last["alpha"])
    w = ids.shape[1]
    got = [a.cpu().numpy() for a in overlap_stats(ids, pi, links)]
    want = [a.cpu().numpy() for a in overlap_stats_plain(
        ids, pi, links, block=max(64, (1 << 28) // (w * w)))]

    def norm(s, mx):
        return np.where(s > 0, mx / np.maximum(s, 1e-30), 0.0)

    n_k, n_p = norm(*got[:2]), norm(*want[:2])
    apart = (n_k >= t) != (n_p >= t)
    near = np.abs(n_p - t) <= FK_THRESH_TIE
    assert not (apart & ~near).any(), int((apart & ~near).sum())
    path = os.path.join(out, "communities-check.txt")
    write_communities(path, link_groups(links.cpu().numpy(), *got,
                                        ids.shape[0], t), last["seq2id"])
    same = open(path, "rb").read() == open(
        os.path.join(out, "communities.txt"), "rb").read()
    os.remove(path)
    assert same, "communities.txt is not the kernel's grouping"
    return int(near.sum()), int(apart.sum())


def phase7_cli(workdir):
    """The three engines' CLI runs on the card: rows held to the CPU
    port's, -findk's files byte for byte, the resumed batch run bit for bit
    the uninterrupted one's; kernel 12 launched every FastInit sweep and
    SBM init sweep, kernel 13 at every FastInit report, kernel 14 sixteen
    times an E-step round and its sums form sixteen times an E-step. Returns (launches by name and form, {name:
    (launches a unit, the unit)})."""
    last, undo = _keep_fastinit_state()
    try:
        rows, info = _p7_runs(workdir, record=False)
    finally:
        undo()
    launches, per_unit = {}, {}
    # -findk: int(log10(20000)) + 1 = 5 sweeps, a report each
    out, secs, counted, forms = info["fk"]
    sweeps = int(np.log10(PLANTED["n"])) + 1
    assert counted["vote_topk"] == sweeps, counted
    # a report: the stopping split, the validation split at a new maximum,
    # the training links; do_on_stop's communities once more
    assert sweeps * 2 + 1 <= counted["overlap_stats"] <= sweeps * 3 + 1, (
        counted)
    assert not counted["estep_chunk"], counted
    got = rows["fk"]
    _rows_close({"heldout": got["heldout"]},
                {"heldout": FK_CPU["heldout"]}, "fk")
    for a, b in zip(got["heldout"], FK_CPU["heldout"]):
        np.testing.assert_allclose(a[1:], b[1:], rtol=FK_ROW_RTOL)
    differ = [name for name in FK_FILES
              if got["files"][name] != FK_CPU["files"][name]]
    ties, apart = _fk_check(last, out)
    assert not differ or ties, f"-findk files differ: {differ}, no tie"
    nmi = float(open(os.path.join(out, "mutual.txt")).read().split()[-1])
    k_est = sum(1 for _ in open(os.path.join(out, "communities.txt")))
    log(f"phase 7: FastInit (-findk) on planted-20k: {secs:.1f} s, {sweeps} "
        f"sweeps, estimated K {k_est}, NMI {nmi:.6f}; heldout rows within "
        f"{_rows_gap({'heldout': got['heldout']}, {'heldout': FK_CPU['heldout']}):.3e} of the CPU "
        f"port's (limit {FK_ROW_RTOL:g}); {', '.join(FK_FILES)} byte for "
        f"byte but {differ} ({ties} links within {FK_THRESH_TIE:g} of "
        f"link_thresh, {apart} of them selected apart by the kernel and the "
        f"plain version on the final state); launches {forms}")
    per_unit["vote_topk"] = (counted["vote_topk"] / sweeps, "FastInit sweep")
    per_unit["overlap_stats"] = (counted["overlap_stats"] / sweeps,
                                 "FastInit report")
    for name, v in {**counted, **forms}.items():
        launches[name] = launches.get(name, 0) + v
    init_sweeps = int(np.log10(PLANTED["n"])) + 2
    for label, steps in (("sbm", 61), ("sbmi", SBMI_STEPS + 1)):
        out, secs, counted, forms = info[label]
        _rows_close(rows[label], SBM_CPU_ROWS[label], label)
        assert counted["vote_topk"] == init_sweeps, counted
        assert not counted["overlap_stats"], counted
        if label == "sbm":
            # the sums form's 16 launches an E-step, then at least one
            # round an iteration, at most ten
            assert forms["estep_chunk:sums"] == 16 * steps, forms
            assert 32 * steps <= counted["estep_chunk"] <= 176 * steps, (
                counted)
            per_unit["estep_chunk"] = (counted["estep_chunk"] / steps,
                                       "SBM batch iteration")
        else:
            assert not counted["estep_chunk"], counted
        # Elogpi and Elogbeta a batch iteration or a step with partners
        assert counted["dirichlet_expectation"] >= (
            2 * steps if label == "sbm" else steps), counted
        for name, v in {**counted, **forms}.items():
            launches[name] = launches.get(name, 0) + v
        g = np.loadtxt(os.path.join(out, "gamma.txt"))
        assert np.isfinite(g).all() and g.shape == (PLANTED["n"],
                                                    PLANTED["k"] + 2)
        lam = np.loadtxt(os.path.join(out, "lambda.txt"))
        assert lam.shape == (PLANTED["k"] + 1, 3) and (lam[:, 1:] > 0).all()
        log(f"phase 7: SBM {label} ({' '.join(SBM_FLAGS if label == 'sbm' else SBMI_FLAGS)}) "
            f"on planted-20k: {secs:.1f} s, {steps} iterations = "
            f"{secs / steps * 1e3:.3f} ms an iteration with the reports, "
            f"heldout rows {_rows_gap(rows[label], SBM_CPU_ROWS[label]):.3e} "
            f"from the CPU port's (limit {MMSB_ROW_RTOL:g}); launches "
            f"{forms}")
    whole = rows["sbm"]["heldout"]
    before = rows["sbm-cut-before"]["heldout"]
    after = rows["sbm-cut"]["heldout"]
    assert before == whole[:len(before)] and before[-1][0] == SBM_CUT, (
        before[-1:], whole[:1])
    assert after == whole, (after[-1:], whole[-1:])
    log(f"phase 7: the SBM batch run cut after iteration {SBM_CUT} and "
        f"-resume'd: its {len(after)} rows the uninterrupted run's bit for "
        f"bit")
    return launches, per_unit


def phase7_times(dev, stretch_links):
    """On stretch: one FastInit sweep with its report's overlap over every
    training link and the host's community grouping; SBM's stochastic step
    on a stretch-shaped state (its batch iteration: estep_times)."""
    from svinet_torch.ops.edges import build_adjacency
    from svinet_torch.svi.fastinit import (
        link_groups, overlap_stats, sparse_pi, vote_plan, vote_topk)
    from svinet_torch.svi.sbm import StochStep, sbm_stoch_step
    n, k = STRETCH["n"], STRETCH["k"]
    gen_np = np.random.default_rng(20)
    adj = build_adjacency(stretch_links, n, dev)
    plan = vote_plan(adj)
    links = torch.as_tensor(stretch_links, device=dev)
    labels = torch.arange(n, dtype=torch.int32, device=dev)
    for sweep in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, cnt = vote_topk(labels, adj, n, 64, plan)
        labels = torch.where(ids[:, 0] < n, ids[:, 0], labels)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s, mx, mid = overlap_stats(ids, sparse_pi(ids, cnt, 0.01), links)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        groups = link_groups(stretch_links, s.cpu().numpy(),
                             mx.cpu().numpy(), mid.cpu().numpy(), n, 0.5)
        t3 = time.perf_counter()
        log(f"phase 7: FastInit sweep {sweep + 1} on stretch (n={n}, "
            f"{stretch_links.shape[0]} links, width 64): the vote "
            f"{(t1 - t0) * 1e3:.1f} ms, the overlap of every link "
            f"{(t2 - t1) * 1e3:.1f} ms, grouping on the host "
            f"{(t3 - t2):.2f} s ({len(groups)} communities)")
    del ids, cnt, s, mx, mid, plan, adj
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    phi, gamma, lam, _, _, _ = _estep_model(dev, gen, n, k)
    eta = torch.ones((k + 1, 2), device=dev)
    # a stochastic step: a node's 40 links and 100 zeros
    reps = 100
    steps = []
    for _ in range(reps):
        r = int(gen_np.integers(0, n))
        others = np.unique(gen_np.integers(0, n, 141))
        others = others[others != r]
        rows = np.unique(np.r_[r, others])
        steps.append(StochStep(
            r, torch.as_tensor(others, device=dev),
            torch.as_tensor((np.arange(len(others)) < 40).astype(np.int32),
                            device=dev),
            torch.as_tensor(rows, device=dev),
            torch.as_tensor(gen_np.uniform(0.01, 0.05, len(rows)).astype(
                np.float32), device=dev),
            int(np.searchsorted(rows, r)),
            torch.as_tensor(np.searchsorted(rows, others), device=dev),
            torch.as_tensor(np.float32([n / 2, 0.5, n / 2, 0.01]),
                            device=dev)))
    sbm_stoch_step(phi, gamma, lam, steps[0], 0.5, eta)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for st in steps:
        gamma, lam = sbm_stoch_step(phi, gamma, lam, st, 0.5, eta)
    torch.cuda.synchronize()
    log(f"phase 7: SBM stochastic step on stretch (n={n}, K={k}, 140 "
        f"partners): {(time.perf_counter() - t0) * 1e3 / reps:.3f} ms wall "
        f"a step over {reps} steps")
    assert torch.isfinite(phi).all() and torch.isfinite(gamma).all()
    del phi
    torch.cuda.empty_cache()


# -findk past the width whose tables kernel 13 keeps in shared memory, on
# planted n=2,000 (BATCH_PLANTED): its overlap tables in device scratch
FK_WIDE_WIDTH = 4_100


def phase7_wide_cli(workdir):
    """-findk -findk-width FK_WIDE_WIDTH through the CLI on the card: every
    FastInit report's overlap pass in kernel 13's scratch form, the files
    written and finite. Returns (launches by name and form, {name:
    (launches a unit, the unit)})."""
    from svinet_torch.cli import main
    from svinet_torch.synth import write_planted
    wd = os.path.join(workdir, "phase7wide")
    os.makedirs(wd, exist_ok=True)
    n, k = BATCH_PLANTED["n"], BATCH_PLANTED["k"]
    net, gt = write_planted(wd, n, k, BATCH_PLANTED["avg_deg"],
                            BATCH_PLANTED["seed"])
    os.chdir(wd)
    _zero_counts()
    t0 = time.perf_counter()
    assert main(["-file", net, "-n", str(n), "-k", str(k), "-nmi", gt,
                 "-seed", "1", "-label", "fkw", "-findk", "-findk-width",
                 str(FK_WIDE_WIDTH)]) == 0
    secs = time.perf_counter() - t0
    counted, forms = _read_counts()
    out = _outdir(wd, "fkw")
    sweeps = int(np.log10(n)) + 1
    assert forms.get("overlap_stats:scratch", 0) == counted[
        "overlap_stats"] >= sweeps, (counted, forms)
    assert counted["vote_topk"] >= sweeps, counted
    rows = _mmsb_rows(out)["heldout"]
    assert rows and np.isfinite(np.asarray(rows, float)).all(), rows
    comms = open(os.path.join(out, "communities.txt")).read().splitlines()
    log(f"phase 7: -findk -findk-width {FK_WIDE_WIDTH} on planted n={n}: "
        f"{secs:.1f} s, {len(rows)} heldout rows, {len(comms)} communities;"
        f" launches {forms}")
    launches = {**counted, **forms}
    return launches, {"overlap_stats:scratch": (
        forms["overlap_stats:scratch"] / sweeps, "FastInit sweep")}


def phase7(dev, workdir):
    """FastInit and SBM: kernels 12, 13 and 14 against their plain
    versions, the CLI runs on planted-20k, the times on stretch. Returns
    (launches by name and form, {name: (launches a unit, the unit)},
    {name: report})."""
    t0 = time.perf_counter()
    stretch_links = _stretch_links()
    reports = {"vote_topk": phase7_vote(dev, stretch_links)}
    (reports["overlap_stats"],
     reports["overlap_stats:scratch"]) = phase7_overlap(dev, stretch_links)
    reports["estep_chunk"] = phase7_estep(dev, stretch_links)
    launches, per_unit = phase7_cli(workdir)
    wl, wu = phase7_wide_cli(workdir)
    for name, v in wl.items():
        launches[name] = launches.get(name, 0) + v
    per_unit.update(wu)
    estep_times(dev, stretch_links)
    phase7_times(dev, stretch_links)
    log(f"phase 7: {time.perf_counter() - t0:.1f} s")
    return launches, per_unit, reports


# ---------------------------------------------------------------------
# Phase 8: the full blockmodel (-orig, kernel 15) and the generator
# family (-gen, -ppc, -gml, -lcstats; kernel 16).

# Kernel 15 over all pairs of a planted graph (BATCH_PLANTED's degree and
# seed at n nodes), or over the first chunk the -orig engine cuts them into
# (chunk True): (n, K, chunk), the first the -orig runs' shape, the one
# with chunk the timed iteration's. A cluster of 8 CTAs keeps a block of
# the rule on chip for all its rounds, a group of G lanes a pair; the
# shapes take every G (ORIG_LANES, from the kernel's own layout query):
# one lane (no shuffle), 2, 4, 8, 16 and a warp, and K = 520 two column
# tiles (its logits through shared memory)
ORIG_SHAPES = ((2_000, 20, False), (2_000, 100, False), (500, 301, False),
               (2_000, 8, False), (10_000, 50, True), (1_000, 200, False),
               (200, 520, False))
ORIG_LANES = {8: (1, 1), 20: (2, 1), 50: (4, 1), 100: (8, 1), 200: (16, 1),
              301: (32, 1), 520: (32, 2)}
# the -orig CLI runs on planted n=2,000, K=20 (BATCH_PLANTED), held to the
# CPU port's rows at MMSB_ROW_RTOL (`python3 chip_smoke.py --record-cpu
# orig` prints ORIG_CPU_ROWS); the run cut after the report of ORIG_CUT
# and -resume'd must write the uninterrupted run's files bit for bit
ORIG_RUNS = {"orig": ["-orig", "-max-iterations", "2", "-rfreq", "1"],
             "origl": ["-orig", "-logl", "-itype", "1", "-max-iterations",
                       "2", "-rfreq", "1"]}
ORIG_WHOLE = ["-orig", "-max-iterations", "4", "-rfreq", "1"]
ORIG_CUT = 2
ORIG_CPU_ROWS = {'orig': {'heldout': [[1, -2.357075691, -0.009105343, -4.7050457,
                       -0.009022393, -0.042863225, -0.051885618],
                      [2, -2.357052326, -0.009105327, -4.704999447,
                       -0.009022377, -0.042862804, -0.05188518],
                      [3, -2.357042074, -0.009105093, -4.70497942,
                       -0.009022145, -0.042862621, -0.051884766]],
          'logl': []},
 'origl': {'heldout': [[1, -2.357945681, -0.009062536, -4.706828594,
                        -0.008979976, -0.042879467, -0.051859443],
                       [2, -2.355924845, -0.009102406, -4.702746868,
                        -0.009019483, -0.042842283, -0.051861765],
                       [3, -2.355921745, -0.009102408, -4.702741146,
                        -0.009019484, -0.042842231, -0.051861715]],
           'logl': [[1, -600716.01716], [2, -393761.09855],
                    [3, -393752.68267]]}}
# kernel 15's R_b is the plain version's on every block but at a tie: a
# block may end rounds apart only where the plain version's largest change
# at each round between the two ends lies within an f32 unit (of a phi of
# 1) of the threshold. The kernel's logits are the plain version's bits,
# its softmax sums in another order, and a change of 1e-5 is a mean of
# differences of phis near 1: at (2,000, 8) one block's change at round 20
# is 9.99126e-6 in f32 and 1.00045e-5 in float64, and the kernel takes the
# round float64 takes (ties seen on the card: within 1.6e-8, up to 3 of
# 977 blocks a shape, two rounds apart at most)
ORIG_ROUND_TIE = float(np.finfo(np.float32).eps)
# one iteration timed on all pairs of a planted graph at (n, K)
ORIG_TIMED = (10_000, 50)
# gamma_hat and the moments against the float64 plain version on the
# kernel's rounds, of their largest entry; the ELBO terms relative (or
# absolute under 1)
ORIG_TOL = 1e-4
# kernel 16: (n, K, rows drawn; None: all), bit for bit its plain version
# on the card, under -gen's beta and under a low beta with eps above zero
# (the shortcuts' cases); the timed shape is -gen's dense limit (the plain
# version on its first rows). The generator CLI's network_gen.dat on the
# card may part from the CPU port's only at Gumbel near-ties (the
# frameworks' logs differ in last bits): GEN_NEAR_TIE
GEN_SHAPES = ((2_000, 20, None), (65_536, 500, 4))
GEN_TIMED = (65_536, 20)
GEN_TIMED_PLAIN_ROWS = 64
GEN_NEAR_TIE = 4e-6
# the generator CLI: -gen and -gen -orig at GEN_CLI_N nodes, K =
# BATCH_PLANTED's; -gml, -lcstats and -ppc (100 draws) on a planted graph
# of GEN_MODEL_N nodes with a random model; every file byte for byte the
# CPU port's, ppc's z-scores within PPC_TOL (relative, or absolute under
# 1). The CPU draws JAX's stream in int64 torch arithmetic, slowly, so
# these shapes stay small
GEN_CLI_N = 1_000
GEN_MODEL_N = 150
PPC_TOL = 1e-5


def _orig_pairs(dev, n):
    """All pairs of a planted graph of n nodes (BATCH_PLANTED's degree,
    blocks and seed) in the engine's order, with their labels."""
    from svinet_torch.svi.orig import all_pairs
    from svinet_torch.synth import planted_blocks
    raw, _ = planted_blocks(n, BATCH_PLANTED["k"], BATCH_PLANTED["avg_deg"],
                            BATCH_PLANTED["seed"])
    lo = np.minimum(raw[:, 0], raw[:, 1]).astype(np.int64)
    hi = np.maximum(raw[:, 0], raw[:, 1]).astype(np.int64)
    keys = np.unique((lo * n + hi)[lo < hi])
    return all_pairs(n, None, keys, dev)


def _orig_state(dev, gen, n, k):
    """Elogpi (kernel 1) of gamma rows spread from near-uniform to near one
    community, and a symmetric beta in [0.01, 0.99]."""
    from svinet_torch.ops.digamma import dirichlet_expectation
    gamma = 0.05 + torch.rand((n, k), generator=gen, device=dev) ** 4 * 10.0
    b = torch.rand((k, k), generator=gen, device=dev)
    beta = ((b + b.t()) / 2).clamp(0.01, 0.99)
    return dirichlet_expectation(gamma), beta


def orig_bound(n, k, m, rounds, elbo):
    """Kernel 15's bound: Elogpi, L, the pairs and labels read, the staged
    phis and gamma_hat (read and written) or the terms written; 4K^2 + 12K
    f32 operations and 2K exponentials a pair and round, over the rounds
    the rule gives these pairs (each its block's R_b)."""
    n_bytes = 4 * n * k + 8 * k * k + 12 * m
    n_bytes += (4 * n * k + 8 * k * k + 4 * m) if elbo else (
        8 * m * k + 8 * n * k)
    t_sfu = rounds * 2 * k / PEAK_SFU_S * 1e3
    ms, by = bound(n_bytes, rounds * (4 * k * k + 12 * k))
    return (t_sfu, "operations") if t_sfu > ms else (ms, by)


def _orig_round_ties(elogpi, lf2, pairs, y, r_k, r_p, thresh):
    """Blocks of the rule whose R_b on the card (r_k) and in the plain
    version (r_p) differ, each asserted a tie: the plain version's largest
    change over the block at every round from the earlier end to the
    later one's round before within ORIG_ROUND_TIE of thresh (the block's
    rounds rerun in f32 as the plain version runs them). Returns how
    many."""
    from svinet_torch.ops.orig_phi import BLOCK, _products, softmax_plain
    m, k = pairs.shape[0], elogpi.shape[1]
    bk, bp = r_k[::BLOCK].long(), r_p[::BLOCK].long()
    bad = torch.nonzero(bk != bp).flatten().tolist()
    for b in bad:
        lo, hi = b * BLOCK, min((b + 1) * BLOCK, m)
        first = int(min(bk[b], bp[b]))
        last = int(max(bk[b], bp[b]))
        p, q = pairs[lo:hi, 0].long(), pairs[lo:hi, 1].long()
        e1, e2, link = elogpi[p], elogpi[q], y[lo:hi] == 1
        if hi == m and m % BLOCK:
            # the padding pair (0, 0), a nonlink, in the last block
            e1 = torch.cat([e1, elogpi[:1]])
            e2 = torch.cat([e2, elogpi[:1]])
            link = torch.cat([link, link.new_zeros(1)])
        a1 = torch.full(e1.shape, 1.0 / k, dtype=e1.dtype, device=e1.device)
        a2 = a1.clone()
        worst = []
        for _ in range(last - 1):
            n1 = softmax_plain(e1 + _products(lf2, link, a2))
            n2 = softmax_plain(e2 + _products(lf2, link, a1))
            worst.append(float(torch.maximum((n1 - a1).abs().mean(-1),
                                             (n2 - a2).abs().mean(-1)).max()))
            a1, a2 = n1, n2
        near = worst[first - 1:]
        assert all(abs(v - thresh) <= ORIG_ROUND_TIE for v in near), (
            b, first, last, near)
        log(f"phase 8: kernel 15's block {b} ended at round {int(bk[b])}, "
            f"the plain version's at {int(bp[b])}: a tie, its largest "
            f"change at rounds {first}-{last - 1} "
            f"{', '.join(f'{v:.9e}' for v in near)} against {thresh}")
    return len(bad)


def phase8_kernel15(dev):
    """Kernel 15 at ORIG_SHAPES (each shape's lanes a group and tiles
    asserted): training and ELBO forms each two launches
    bitwise equal, every pair of a block on its block's rounds, the two
    forms on the same rounds and those the plain version's (f32, under the
    rule itself) block by block, a round apart only at a tie
    (_orig_round_ties); each pair's phis and terms and gamma_hat
    and the moments held to the plain version in float64 on the kernel's
    rounds (a pair that went to another attractor in f32 is counted,
    logged and held under FP_SPLIT_SHARE). Returns the reports of both
    forms at the first shape."""
    from svinet_torch.ops.edges import owner_csr
    from svinet_torch.ops.orig_phi import (
        BLOCK, elbo_logf_pair, logf_pair, moments, orig_chunk,
        orig_chunk_plain, orig_layout)
    from svinet_torch.svi.orig import chunk_pairs
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    reports = {}
    for n, k, first_chunk in ORIG_SHAPES:
        pairs, y = _orig_pairs(dev, n)
        if first_chunk:
            head = chunk_pairs(pairs, y, n, k)[0]
            pairs, y = head.pairs, head.y
        m = pairs.shape[0]
        lay = orig_layout(k)
        assert (lay["lanes"], lay["tiles"]) == ORIG_LANES[k], (k, lay)
        assert lay["kp"] == lay["tiles"] * lay["lanes"] * lay["columns"] >= k
        elogpi, beta = _orig_state(dev, gen, n, k)
        lf2 = logf_pair(beta).contiguous()
        csr = owner_csr(pairs.reshape(-1), n)
        g_k = torch.zeros((n, k), device=dev)
        staged, r_k = orig_chunk(elogpi, lf2, pairs, y, 50, 1e-5, pad=True,
                                 gacc=g_k, csr=csr)
        g_2 = torch.zeros((n, k), device=dev)
        staged_2, r_2 = orig_chunk(elogpi, lf2, pairs, y, 50, 1e-5, pad=True,
                                   gacc=g_2, csr=csr)
        torch.cuda.synchronize()
        assert (torch.equal(g_k, g_2) and torch.equal(staged, staged_2)
                and torch.equal(r_k, r_2)), (n, k, "two launches differ")
        del staged_2, g_2
        blk = torch.arange(m, device=dev) // BLOCK
        assert torch.equal(r_k, r_k[::BLOCK][blk]), (n, k)
        assert int(r_k.min()) >= 1 and int(r_k.max()) <= 50
        # the plain version in float64 on the kernel's rounds
        st64, _ = orig_chunk_plain(elogpi.double(), lf2.double(), pairs, y,
                                   50, 1e-5, BLOCK, True, given=r_k)
        gap = (staged.double() - st64).abs().amax(1).view(m, 2).amax(1)
        split = gap > FP_SPLIT_PHI
        n_split = int(split.sum())
        assert n_split <= FP_SPLIT_SHARE * m, (n, k, n_split)
        phi_err = float(gap[~split].max())
        mixed = torch.where(split.repeat_interleave(2)[:, None],
                            staged.double(), st64)
        g64 = torch.zeros((n, k), dtype=torch.float64, device=dev)
        g64.index_add_(0, pairs.reshape(-1).long(), 2.0 * mixed)
        a_k, y_k = moments(staged, y)
        a64, y64 = moments(mixed, y)
        err = max(_close_to_max(g_k, g64), _close_to_max(a_k, a64),
                  _close_to_max(y_k, y64))
        assert err <= ORIG_TOL, (n, k, err)
        if n_split:
            i = int(torch.nonzero(split)[0])
            log(f"phase 8: kernel 15 at n={n} K={k}: pair {i} "
                f"{pairs[i].tolist()} y={int(y[i])} ended {float(gap[i]):.3e}"
                f" from the float64 phis after {int(r_k[i])} rounds "
                f"(another attractor in f32)")
        del st64, mixed, g64
        # the plain version under the rule itself, f32: R_b block by block
        t0 = time.perf_counter()
        st_p, r_p = orig_chunk_plain(elogpi, lf2, pairs, y, 50, 1e-5, BLOCK,
                                     True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        del st_p
        n_blocks = r_k[::BLOCK].numel()
        n_ties = _orig_round_ties(elogpi, lf2, pairs, y, r_k, r_p, 1e-5)
        # the ELBO form on the same fixed point
        e_new, b_new = _orig_state(dev, gen, n, k)
        lfe2 = elbo_logf_pair(b_new).contiguous()
        t_k, re_k = orig_chunk(elogpi, lf2, pairs, y, 50, 1e-5, pad=True,
                               elbo=(e_new, lfe2))
        t_2, re_2 = orig_chunk(elogpi, lf2, pairs, y, 50, 1e-5, pad=True,
                               elbo=(e_new, lfe2))
        torch.cuda.synchronize()
        assert torch.equal(t_k, t_2) and torch.equal(re_k, re_2)
        assert torch.equal(re_k, r_k)
        t64, _ = orig_chunk_plain(elogpi.double(), lf2.double(), pairs, y,
                                  50, 1e-5, BLOCK, True,
                                  elbo=(e_new.double(), lfe2.double()),
                                  given=r_k)
        err_e = _rel_err(t_k.double()[~split], t64[~split])
        assert err_e <= ORIG_TOL, (n, k, err_e)
        sum_err = abs(float(t_k.double().sum()) - float(t64.sum())) / abs(
            float(t64.sum()))
        del t64
        # each pair (and the padding slot) its block's R_b rounds
        needed = float(r_k.double().sum()) + (int(r_k[-1]) if m % BLOCK
                                              else 0)
        reps = 3 if m * k * k > 10**9 else 10
        g_t = torch.zeros((n, k), device=dev)
        ms = cuda_ms(lambda: orig_chunk(elogpi, lf2, pairs, y, 50, 1e-5,
                                        pad=True, gacc=g_t, csr=csr), reps)
        ms_e = cuda_ms(lambda: orig_chunk(elogpi, lf2, pairs, y, 50, 1e-5,
                                          pad=True, elbo=(e_new, lfe2)),
                       reps)
        t0 = time.perf_counter()
        orig_chunk_plain(elogpi, lf2, pairs, y, 50, 1e-5, BLOCK, True,
                         elbo=(e_new, lfe2))
        torch.cuda.synchronize()
        plain_ms_e = (time.perf_counter() - t0) * 1e3
        bnd = orig_bound(n, k, m, needed, False)
        bnd_e = orig_bound(n, k, m, needed, True)
        what = " (the timed iteration's first chunk)" if first_chunk else ""
        log(f"phase 8: orig_chunk n={n} K={k} pairs={m}{what}: training form "
            f"{ms:.4f} ms, plain {plain_ms:.1f} ms, bound {bnd[0]:.4f} ms "
            f"({bnd[1]}; without fma at most half of it: "
            f"{2 * bnd[0]:.4f} ms); ELBO form {ms_e:.4f} ms, plain "
            f"{plain_ms_e:.1f} ms, bound {bnd_e[0]:.4f} ms; "
            f"{lay['lanes']} lanes a group, {lay['tiles']} tile(s) of "
            f"{lay['columns']} columns a lane; "
            f"{n_blocks} blocks of "
            f"{BLOCK}, R_b mean {float(r_k[::BLOCK].double().mean()):.2f}, "
            f"max {int(r_k.max())}, {needed / m:.2f} rounds a pair; R_b the "
            f"plain version's on {n_blocks - n_ties} of {n_blocks} blocks "
            f"({n_ties} a round apart at a tie), both forms; on the "
            f"kernel's rounds "
            f"phi within {phi_err:.3e} of float64 on all but {n_split} pairs"
            f", gamma_hat and moments {err:.3e} of their largest entry, "
            f"terms {err_e:.3e} (their sum {sum_err:.3e}); two launches of "
            f"each form bitwise equal")
        reports[(n, k)] = (dict(_report(err, ms, plain_ms, bnd)),
                           dict(_report(err_e, ms_e, plain_ms_e, bnd_e)))
        del staged, pairs, y, csr, g_k, g_t
        torch.cuda.empty_cache()
    return reports[ORIG_SHAPES[0][:2]]


def gen_bound(n, k, pairs, drawn_p, drawn_q, n_edges):
    """Kernel 16's bound on this run's draw: the logits and beta read once,
    the edges written; a pair's u (one threefry2x32-20, about 90 integer
    instructions with the float it makes), and K Gumbels for each category
    the shortcuts left to draw (a threefry2x32-20, two logf of about 15
    instructions each, an add and a compare: some 125), each instruction
    an operation at the f32 rate of the table (the card's 32-bit integer
    rate is half that: a ceiling of half the bound)."""
    ops = pairs * 90.0 + (drawn_p + drawn_q) * k * 125.0
    return bound(4 * n * k + 4 * k + 8 * n_edges, ops)


def _gen_state(rng, n, k, low_beta):
    """pi ~ Dir(0.05) rows of n, beta of -gen's Beta(4700.59, 0.77), or a
    low beta in [0.05, 0.3] with eps 0.02: (logits, beta) on the host."""
    from svinet_torch.config import Config
    from svinet_torch.svi.gen import logits_of
    cfg = Config()
    pi = rng.dirichlet(np.full(k, 0.05), size=n)
    if low_beta:
        beta, eps = rng.uniform(0.05, 0.3, size=k), 0.02
    else:
        beta, eps = rng.beta(cfg.eta0_gen, cfg.eta1_gen, size=k), cfg.epsilon
    return (logits_of(pi), beta.astype(np.float32),
            float(np.float32(eps)))


def _gen_near_ties(logits, key, row_block, apart):
    """Each pair (i, j) of `apart` must have two of its z_p's or its z_q's
    Gumbel scores (JAX's stream, computed on the CPU) within GEN_NEAR_TIE:
    where the card's logf and the CPU's log may order them otherwise."""
    from svinet_torch.ops import threefry
    from svinet_torch.svi.gen import _block_keys
    n, k = logits.shape
    lg = torch.as_tensor(logits)
    for i, j in apart:
        start = i // row_block * row_block
        keys = _block_keys(key, start)
        x = (i - start) * n + j
        c = torch.arange(k, dtype=torch.int64)
        gaps = []
        for kk, row in ((keys[0], lg[i]), (keys[1], lg[j])):
            sc = torch.sort(threefry.gumbel_at(kk, x * k + c) + row).values
            gaps.append(float(sc[-1] - sc[-2]))
        assert min(gaps) <= GEN_NEAR_TIE, (i, j, gaps)


def phase8_kernel16(dev):
    """Kernel 16 at GEN_SHAPES bit for bit its plain version on the card,
    two launches bitwise equal; timed at GEN_TIMED with the share of pairs
    each shortcut skipped. Returns its report at GEN_SHAPES[0] (kernel, plain
    version and bound on the same 2M pairs)."""
    from svinet_torch.ops import threefry
    from svinet_torch.svi.gen import (
        default_row_block, gen_pairs, gen_pairs_plain)
    rng = np.random.default_rng(16)
    key = threefry.prng_key(11)
    report = None
    for n, k, rows in GEN_SHAPES:
        for low in (False, True):
            lg_np, b_np, eps = _gen_state(rng, n, k, low)
            lg = torch.as_tensor(lg_np, device=dev)
            beta = torch.as_tensor(b_np, device=dev)
            rb = default_row_block(n, k)
            stats = torch.zeros(2, dtype=torch.int64, device=dev)
            e_k = gen_pairs(lg, beta, eps, key, rb, 0, rows, stats=stats)
            e_2 = gen_pairs(lg, beta, eps, key, rb, 0, rows)
            e_p = gen_pairs_plain(lg, beta, eps, key, rb, 0, rows)
            torch.cuda.synchronize()
            assert torch.equal(e_k, e_2), (n, k, low, "two launches differ")
            assert torch.equal(e_k, e_p), (n, k, low, e_k.shape, e_p.shape)
            r = rows or n
            pairs = r * (2 * n - r - 1) / 2
            dp, dq = (int(v) for v in stats.tolist())
            log(f"phase 8: gen_pairs n={n} K={k} rows [0, {r}) "
                f"({'low beta, eps 0.02' if low else '-gen beta'}): "
                f"{e_k.shape[0]} links, bit for bit the plain version's, "
                f"two launches bitwise equal; z_p drawn for "
                f"{dp / pairs:.4f} of the pairs, z_q for {dq / pairs:.4f}")
            if rows is None and not low:
                ms = cuda_ms(lambda: gen_pairs(lg, beta, eps, key, rb), 5)
                plain_ms = cuda_ms(
                    lambda: gen_pairs_plain(lg, beta, eps, key, rb), 2)
                report = dict(_report(0.0, ms, plain_ms, gen_bound(
                    n, k, pairs, dp, dq, e_k.shape[0])))
            del e_k, e_2, e_p
    n, k = GEN_TIMED
    lg_np, b_np, eps = _gen_state(rng, n, k, False)
    lg = torch.as_tensor(lg_np, device=dev)
    beta = torch.as_tensor(b_np, device=dev)
    rb = default_row_block(n, k)
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    edges = gen_pairs(lg, beta, eps, key, rb, stats=stats)
    ms = cuda_ms(lambda: gen_pairs(lg, beta, eps, key, rb), 2)
    rows = GEN_TIMED_PLAIN_ROWS
    t0 = time.perf_counter()
    plain = gen_pairs_plain(lg, beta, eps, key, rb, 0, rows)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    assert torch.equal(edges[edges[:, 0] < rows], plain)
    pairs = n * (n - 1) / 2
    dp, dq = (int(v) for v in stats.tolist())
    bnd = gen_bound(n, k, pairs, dp, dq, edges.shape[0])
    sub = rows * (2 * n - rows - 1) / 2
    log(f"phase 8: gen_pairs n={n} K={k} (-gen's dense limit, "
        f"{pairs:.0f} pairs): kernel {ms:.3f} ms, {edges.shape[0]} links "
        f"({pairs / ms / 1e6:.2f} G pairs/s), bound {bnd[0]:.4f} ms "
        f"({bnd[1]}), z_p drawn for {dp / pairs:.4f} of the pairs and z_q "
        f"for {dq / pairs:.4f}; plain version on rows [0, {rows}) "
        f"({sub:.0f} pairs) {plain_ms:.1f} ms, those rows bit for bit")
    del edges, plain
    torch.cuda.empty_cache()
    return report


def _orig_cli(workdir, net, label, flags):
    from svinet_torch.cli import main
    os.chdir(workdir)
    n, k = BATCH_PLANTED["n"], BATCH_PLANTED["k"]
    assert main(["-file", net, "-n", str(n), "-k", str(k), "-seed", "1",
                 "-label", label, *flags]) == 0
    return _outdir(workdir, label)


def _orig_runs(workdir, record):
    """The -orig runs of ORIG_RUNS on planted n=2,000. Returns ({label:
    rows}, {label: (out, seconds, launches, forms)})."""
    from svinet_torch.synth import write_planted
    workdir = os.path.join(workdir, "phase8")
    os.makedirs(workdir, exist_ok=True)
    net, _ = write_planted(workdir, BATCH_PLANTED["n"], BATCH_PLANTED["k"],
                           BATCH_PLANTED["avg_deg"], BATCH_PLANTED["seed"])
    rows, info = {}, {}
    for label, flags in ORIG_RUNS.items():
        if not record:
            _zero_counts()
        t0 = time.perf_counter()
        out = _orig_cli(workdir, net, label + ("-cpu" if record else ""),
                        flags)
        secs = time.perf_counter() - t0
        r = _mmsb_rows(out)
        rows[label] = {"heldout": r["heldout"], "logl": r["logl"]}
        info[label] = (out, secs, *(_read_counts() if not record
                                    else ({}, {})))
    return rows, info, workdir, net


def phase8_orig_cli(workdir):
    """-orig and -orig -logl -itype 1 through the CLI on the card, held to
    the CPU port's rows; kernel 15 once an iteration (one chunk) and its
    ELBO form once a -logl report; the run cut after the report of
    ORIG_CUT and resumed bit for bit the uninterrupted one. Returns
    (launches by name and form, launches an iteration)."""
    rows, info, wd, net = _orig_runs(workdir, record=False)
    launches, iterations, reports = {}, 0, 0
    for label, (out, secs, counted, forms) in info.items():
        _rows_close(rows[label], ORIG_CPU_ROWS[label], label)
        # a report every iteration: iterations 1 to max + 1
        steps = len(rows[label]["heldout"])
        iterations += steps
        reports += steps if label == "origl" else 0
        assert forms["orig_chunk:f32"] == steps, (label, forms)
        assert forms.get("orig_chunk:elbo", 0) == (
            steps if label == "origl" else 0), forms
        assert counted["dirichlet_expectation"] >= steps, counted
        # kernel 15's row counts its training form, the ELBO form its own
        counted = {k: v for k, v in counted.items() if k != "orig_chunk"}
        forms = {("orig_chunk" if k == "orig_chunk:f32" else k): v
                 for k, v in forms.items()}
        for name, v in {**counted, **forms}.items():
            launches[name] = launches.get(name, 0) + v
        beta = np.loadtxt(os.path.join(out, "beta.txt"), ndmin=2)
        gamma = np.loadtxt(os.path.join(out, "gamma.txt"), ndmin=2)
        assert beta.shape == (BATCH_PLANTED["k"],) * 2 and np.isfinite(
            beta).all() and np.allclose(beta, beta.T, atol=1e-5)
        assert gamma.shape == (BATCH_PLANTED["n"], BATCH_PLANTED["k"] + 2)
        assert np.isfinite(gamma).all()
        log(f"phase 8: MMSBOrig {label} ({' '.join(ORIG_RUNS[label])}) on "
            f"planted n=2,000, K=20 (1,999,000 pairs less the held-out "
            f"ones): {secs:.1f} s, {steps} iterations, rows "
            f"{_rows_gap(rows[label], ORIG_CPU_ROWS[label]):.3e} from the "
            f"CPU port's (limit {MMSB_ROW_RTOL:g}); launches {forms}")
    # cut after the report of ORIG_CUT and resumed
    whole = _orig_cli(wd, net, "origw", ORIG_WHOLE)
    Cut, undo = _crash_after(ORIG_CUT)
    try:
        try:
            _orig_cli(wd, net, "origc", ORIG_WHOLE + ["-checkpoint-freq",
                                                      "1e-9"])
            raise AssertionError("the cut did not happen")
        except Cut:
            pass
    finally:
        undo()
    cut = _orig_cli(wd, net, "origc", ORIG_WHOLE + ["-resume"])
    for name in ("gamma.txt", "beta.txt", "groups.txt"):
        assert open(os.path.join(whole, name), "rb").read() == open(
            os.path.join(cut, name), "rb").read(), name
    for name in ("heldout.txt", "max.txt"):
        assert _strip(whole, name) == _strip(cut, name), name
    log(f"phase 8: the -orig run cut after iteration {ORIG_CUT} and "
        f"-resume'd: gamma.txt, beta.txt, groups.txt, heldout.txt and "
        f"max.txt the uninterrupted run's bit for bit")
    per_unit = {"orig_chunk": (launches["orig_chunk"] / iterations,
                               "MMSBOrig iteration"),
                "orig_chunk:elbo": (launches["orig_chunk:elbo"] / reports,
                                    "-orig -logl report")}
    return launches, per_unit


def phase8_orig_timed(dev):
    """One -orig iteration on all pairs of a planted graph at ORIG_TIMED:
    the pair set made on the card, then two iterations timed."""
    from svinet_torch.svi.orig import chunk_pairs, orig_batch_step
    n, k = ORIG_TIMED
    t0 = time.perf_counter()
    pairs, y = _orig_pairs(dev, n)
    chunks = chunk_pairs(pairs, y, n, k)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    rng = np.random.default_rng(4)
    gamma = torch.as_tensor(rng.gamma(100.0, 0.01, size=(n, k)).astype(
        np.float32), device=dev)
    beta = torch.as_tensor(np.clip(rng.integers(0, 100, size=(k, k)) / 100.0,
                                   0.01, 0.99).astype(np.float32),
                           device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for it in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gamma, beta = orig_batch_step(gamma, beta, chunks, 1.0 / k)
        torch.cuda.synchronize()
        log(f"phase 8: MMSBOrig iteration {it + 1} at n={n} K={k} "
            f"({pairs.shape[0]} pairs in {len(chunks)} chunks): "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms wall, peak memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB (the "
            f"pair set made in {setup:.2f} s)")
    assert torch.isfinite(gamma).all() and torch.isfinite(beta).all()
    del pairs, y, chunks
    torch.cuda.empty_cache()


def _gen_model(workdir):
    """A planted graph of GEN_MODEL_N nodes and a random gamma.txt and
    lambda.txt for it (K = BATCH_PLANTED's)."""
    from svinet_torch.synth import write_planted
    n, k = GEN_MODEL_N, BATCH_PLANTED["k"]
    net, _ = write_planted(workdir, n, k, 12, 3)
    rng = np.random.default_rng(6)
    gamma = rng.gamma(0.5, 4.0, size=(n, k)) + 0.01
    lam = rng.uniform(0.5, 20.0, size=(k, 2))
    with open(os.path.join(workdir, "gamma.txt"), "w") as f:
        for i in range(n):
            f.write(f"{i}\t{i}\t" + "\t".join(f"{v:.5f}" for v in gamma[i])
                    + "\n")
    with open(os.path.join(workdir, "lambda.txt"), "w") as f:
        for c in range(k):
            f.write(f"{c}\t{lam[c, 0]:.5f}\t{lam[c, 1]:.5f}\n")
    return net


GEN_RUNS = (("gen", ["-gen", "-seed", "3"]),
            ("genorig", ["-gen", "-orig", "-seed", "3"]),
            ("gml", ["-gml"]), ("lcstats", ["-lcstats"]),
            ("ppc", ["-ppc", "-seed", "5"]))


def _gen_files(path):
    """{relative path: bytes} of every file under path."""
    out = {}
    for root, _, files in os.walk(path):
        for f in files:
            p = os.path.join(root, f)
            out[os.path.relpath(p, path)] = open(p, "rb").read()
    return out


def _gen_runs(workdir, device):
    """GEN_RUNS through the CLI on `device` ("cuda" or "cpu"), each in a
    directory of its own under workdir/<device>. Returns ({label: files},
    {label: (seconds, launches, forms)})."""
    from svinet_torch.cli import main
    prev = os.environ.get("SVINET_TORCH_DEVICE")
    os.environ["SVINET_TORCH_DEVICE"] = device
    files, info = {}, {}
    try:
        for label, flags in GEN_RUNS:
            d = os.path.join(workdir, device, label)
            os.makedirs(d)
            if label in ("gen", "genorig"):
                argv = ["-n", str(GEN_CLI_N), "-k", str(BATCH_PLANTED["k"]),
                        *flags]
            else:
                net = _gen_model(d)
                argv = ["-file", net, "-n", str(GEN_MODEL_N), "-k",
                        str(BATCH_PLANTED["k"]), *flags]
            os.chdir(d)
            _zero_counts()
            t0 = time.perf_counter()
            assert main(argv) == 0
            info[label] = (time.perf_counter() - t0, *_read_counts())
            files[label] = _gen_files(d)
    finally:
        if prev is None:
            os.environ.pop("SVINET_TORCH_DEVICE", None)
        else:
            os.environ["SVINET_TORCH_DEVICE"] = prev
    return files, info


def _gen_file_ties(label, got, want):
    """The pairs in one network_gen.dat and not the other, each at a Gumbel
    near-tie of the draw GEN_RUNS[label] made (pi drawn again from its
    seed, as MMSBGen.gen draws it). Returns their count."""
    from svinet_torch.ops import threefry
    from svinet_torch.svi.gen import default_row_block, logits_of
    n, k = GEN_CLI_N, BATCH_PLANTED["k"]
    alpha = 1.0 / k if label == "genorig" else 0.05
    pi = np.random.default_rng(3).dirichlet(np.full(k, alpha), size=n)

    def pairs(data):
        return {tuple(int(v) for v in line.split())
                for line in data.decode().splitlines() if line}

    apart = sorted(pairs(got) ^ pairs(want))
    _gen_near_ties(logits_of(pi), threefry.prng_key(3),
                   default_row_block(n, k), apart)
    return len(apart)


def _ppc_close(got, want):
    """Every number of a ppc file within PPC_TOL (relative, or absolute
    under 1); the labels equal."""
    g = [line.split("\t") for line in got.decode().splitlines()]
    w = [line.split("\t") for line in want.decode().splitlines()]
    assert len(g) == len(w)
    worst = 0.0
    for a, b in zip(g, w):
        assert a[:-1] == b[:-1]
        x, z = float(a[-1]), float(b[-1])
        worst = max(worst, abs(x - z) / max(1.0, abs(z)))
    return worst


def phase8_gen_cli(workdir):
    """GEN_RUNS on the card and on the CPU: every file byte for byte the
    CPU port's (ppc's z-score files within PPC_TOL); kernel 16 once a
    generated network (-gen, -gen -orig) and once a ppc draw. Returns
    (launches by name and form, launches a network)."""
    wd = os.path.join(workdir, "phase8gen")
    card, info = _gen_runs(wd, "cuda")
    cpu, _ = _gen_runs(wd, "cpu")
    launches, worst, networks = {}, 0.0, 0
    for label, _ in GEN_RUNS:
        secs, counted, forms = info[label]
        want = {"gen": 1, "genorig": 1, "ppc": 100}.get(label, 0)
        networks += want
        assert counted["gen_pairs"] == want, (label, counted)
        assert sorted(card[label]) == sorted(cpu[label]), label
        apart = []
        for name, data in card[label].items():
            if data == cpu[label][name]:
                continue
            apart.append(name)
            if name.endswith("network_gen.dat"):
                ties = _gen_file_ties(label, data, cpu[label][name])
                log(f"phase 8: {label}: network_gen.dat {ties} pairs apart "
                    f"from the CPU port's, each at a Gumbel near-tie")
                continue
            assert "zscores" in name, (label, name)
            worst = max(worst, _ppc_close(data, cpu[label][name]))
        assert worst <= PPC_TOL, (label, worst)
        for name, v in {**counted, **forms}.items():
            launches[name] = launches.get(name, 0) + v
        made = sorted(n for n in card[label] if n not in ("gamma.txt",
                                                          "lambda.txt")
                      and not n.startswith("planted"))
        log(f"phase 8: {label} ({' '.join(dict(GEN_RUNS)[label])}) on the "
            f"card: {secs:.1f} s, {len(made)} files byte for byte the CPU "
            f"port's" + (f" but {apart} (within {worst:.3e})" if apart
                         else "") + f"; launches {forms}")
    edges = card["gen"][f"gen-n{GEN_CLI_N}-k{BATCH_PLANTED['k']}-dense/"
                        f"network_gen.dat"].count(b"\n")
    log(f"phase 8: -gen at n={GEN_CLI_N:,}, K={BATCH_PLANTED['k']} drew "
        f"{edges} links")
    return launches, {"gen_pairs": (launches["gen_pairs"] / networks,
                                    "generated network (-gen, a -ppc draw)")}


def phase8(dev, workdir):
    """The full blockmodel and the generator family: kernels 15 and 16
    against their plain versions, the CLI runs, the timed shapes. Returns
    (launches by name and form, {name: (launches a unit, the unit)},
    {name: report})."""
    t0 = time.perf_counter()
    fp, elbo = phase8_kernel15(dev)
    g = phase8_kernel16(dev)
    launches, per_unit = phase8_orig_cli(workdir)
    gl, gu = phase8_gen_cli(workdir)
    for name, v in gl.items():
        launches[name] = launches.get(name, 0) + v
    per_unit.update(gu)
    phase8_orig_timed(dev)
    log(f"phase 8: {time.perf_counter() - t0:.1f} s")
    return launches, per_unit, {"orig_chunk": fp, "orig_chunk:elbo": elbo,
                                "gen_pairs": g}


def main() -> int:
    if sys.argv[1:2] == ["--record-cpu"]:
        return record_cpu(sys.argv[2:] or ("mmsb", "fa", "famm", "fk",
                                           "sbm", "orig"))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cwd = os.getcwd()
    t_start = time.perf_counter()
    card = phase0(dev)
    if sys.argv[1:] == ["--phase5"]:
        # phase 5 alone on a stretch engine of its own, for work on it;
        # prints no result
        from svinet_torch.svi.linksampling import from_edges
        from svinet_torch.synth import random_edges
        with tempfile.TemporaryDirectory() as workdir:
            try:
                eng = from_edges(random_edges(STRETCH["n"],
                                              STRETCH["n_edges"], 0),
                                 STRETCH["n"], STRETCH["k"], dev,
                                 os.path.join(workdir, "stretch"))
                phase5(dev, workdir, eng)
            finally:
                os.chdir(cwd)
        return 4
    if sys.argv[1:] == ["--phase6"]:
        # phase 6 alone, for work on it; prints no result
        with tempfile.TemporaryDirectory() as workdir:
            try:
                phase6(dev, workdir)
            finally:
                os.chdir(cwd)
        return 4
    if sys.argv[1:] == ["--phase7"]:
        # phase 7 alone, for work on it; prints no result
        with tempfile.TemporaryDirectory() as workdir:
            try:
                phase7(dev, workdir)
            finally:
                os.chdir(cwd)
        return 4
    if sys.argv[1:] == ["--phase8"]:
        # phase 8 alone, for work on it; prints no result
        with tempfile.TemporaryDirectory() as workdir:
            try:
                phase8(dev, workdir)
            finally:
                os.chdir(cwd)
        return 4
    d_report = phase1_dirichlet(dev)
    reports = phase1_sweep_passes(dev)
    form_reports = phase1_forms(dev)
    h_report = phase1_heldout(dev)
    sparse_reports = phase1_sparse(dev)
    phase1_compact(dev)
    fp_report, elbo_report = phase1_phi_fixed_point(dev)
    with tempfile.TemporaryDirectory() as workdir:
        try:
            phase1_edge_assign(dev, workdir)
            launches, per_sweep = phase2(workdir)
            mmsb = phase2_mmsb(workdir)
            assign_report, stretch, uniform_report = phase3(dev, workdir)
            mesh_launches = phase4(dev, workdir, stretch)
            p5_launches, fa_fp_report, fa_launches = phase5(dev, workdir,
                                                            stretch)
            del stretch
            torch.cuda.empty_cache()
            p6_launches, p6_per_unit, p6_reports = phase6(dev, workdir)
            p7_launches, p7_per_unit, p7_reports = phase7(dev, workdir)
            p8_launches, p8_per_unit, p8_reports = phase8(dev, workdir)
        finally:
            os.chdir(cwd)
    # kernel 8 from phase 2's MMSBInfer runs: one launch a step, and its
    # ELBO form one a -logl report
    launches["phi_fixed_point"] = mmsb["phi_fixed_point"]
    launches["phi_fixed_point:elbo"] = mmsb["phi_fixed_point:elbo"]
    # what launches_per_sweep counts over: a link-sampling sweep unless
    # named here
    unit = {"phi_fixed_point": "MMSBInfer step",
            "phi_fixed_point:elbo": "MMSBInfer step",
            "phi_fixed_point:b512": "FastAMM2 step"}
    per_sweep["phi_fixed_point"] = 1.0
    per_sweep["phi_fixed_point:elbo"] = 1.0     # -batch -logl: a report a step
    # kernel 8 at FastAMM2's block of 512 pairs: phase 5's single-card run,
    # one launch a step
    launches["phi_fixed_point:b512"] = fa_launches
    per_sweep["phi_fixed_point:b512"] = 1.0
    # FastAMM from phase 6's CLI runs, counted over their steps (kernel 8's
    # FastAMM form, kernel 10) or their reports (kernel 11's held-out sets
    # and its assignments, the stop's among them)
    for name, (per, what) in p6_per_unit.items():
        launches[name] = p6_launches.get(name, 0)
        per_sweep[name] = per
        unit[name] = what
    # FastInit and SBM from phase 7's CLI runs: kernel 12 a FastInit sweep
    # (and SBM's init sweeps), kernel 13 a FastInit report, kernel 14 an
    # SBM batch iteration
    for name, (per, what) in p7_per_unit.items():
        launches[name] = p7_launches.get(name, 0)
        per_sweep[name] = per
        unit[name] = what
    # kernel 17 from phase 3's stretch engine build: one launch a padded
    # edge block of its device init
    launches["uniform_rows"] = uniform_report.pop("launches")
    per_sweep["uniform_rows"] = float(launches["uniform_rows"])
    unit["uniform_rows"] = "stretch engine's device init"
    # MMSBOrig and the generator from phase 8's CLI runs: kernel 15 a chunk
    # an -orig iteration (one chunk at n=2,000), its ELBO form a chunk a
    # -logl report; kernel 16 a generated network
    for name, (per, what) in p8_per_unit.items():
        launches[name] = p8_launches.get(name, 0)
        per_sweep[name] = per
        unit[name] = what
    # launches, and launches_per_sweep (the count over the sweeps that run
    # made): kernels 1 to 4 from the default-flags CLI run of phase 2,
    # kernel 5 from its -fuse-s3 run, kernel 7 and the top-W form from its
    # -sparse-w run. library_ms is null for all seven: no single PyTorch
    # call computes any of these functions (torch.special.digamma is one
    # part of kernel 1, and torch.topk orders ties otherwise than its top-W
    # form, so phase 1 logs topk's time as a yardstick only; gather,
    # softmax and index_add_ are kernel 2's plain version; kernel 3 is a
    # dozen elementwise calls and two sums; kernel 4 as a library route is
    # a sparse product followed by a multiply and a sum; kernel 6 is two
    # gathers, a dozen elementwise calls and nine sums; kernel 7 is gathers,
    # a sort, a softmax and three index_add_)
    sm = "svinet_tpu/svi/sweep_math.py"
    rows = (
        ("dirichlet_expectation", "svinet_torch/csrc/dirichlet_expectation.cu",
         "svinet_tpu/ops/pallas_digamma.py:69", d_report),
        ("dirichlet_expectation:topw",
         "svinet_torch/csrc/dirichlet_expectation.cu",
         "svinet_tpu/ops/pallas_digamma.py:69",
         sparse_reports["dirichlet_expectation:topw"]),
        ("phi_pass", "svinet_torch/csrc/phi_pass.cu",
         "tools/pallas_gather_bench.py:69", reports["phi_pass"]),
        # the three below were parts of the XLA sweep program on the TPU
        ("mean_indicator_update", "svinet_torch/csrc/mean_indicator.cu",
         f"{sm}:90", reports["mean_indicator_update"]),
        ("s3_pass", "svinet_torch/csrc/s3_pass.cu", f"{sm}:117",
         reports["s3_pass"]),
        ("fused_phi_s3_pass", "svinet_torch/csrc/phi_pass.cu", f"{sm}:160",
         reports["fused_phi_s3_pass"]),
        ("heldout_sums", "svinet_torch/csrc/heldout_sums.cu",
         "svinet_tpu/evals/likelihood.py:85", h_report),
        # the -sparse-w union pass was a part of the XLA sweep program
        ("sparse_union_pass", "svinet_torch/csrc/sparse_union.cu",
         f"{sm}:252", sparse_reports["sparse_union_pass"]),
        # MMSBInfer's local step and -logl's pair terms, parts of XLA
        # programs; the report's edge assignments, blocked XLA on the TPU
        ("phi_fixed_point", "svinet_torch/csrc/phi_fixed_point.cu",
         "svinet_tpu/ops/phicomp.py:33", fp_report),
        ("phi_fixed_point:elbo", "svinet_torch/csrc/phi_fixed_point.cu",
         "svinet_tpu/evals/elbo.py:30", elbo_report),
        # FastAMM2's step (svinet_tpu/svi/fastamm2.py:192, svi_multi_step)
        ("phi_fixed_point:b512", "svinet_torch/csrc/phi_fixed_point.cu",
         "svinet_tpu/ops/phicomp.py:33", fa_fp_report),
        ("edge_assignments", "svinet_torch/csrc/edge_assign.cu",
         "svinet_tpu/svi/communities.py:24", assign_report),
        # FastAMM's dense step (the whole minibatch one block, a rho a
        # row) and its sparse top-W state, parts of XLA programs
        ("phi_fixed_point:fastamm", "svinet_torch/csrc/phi_fixed_point.cu",
         "svinet_tpu/svi/fastamm.py:51",
         p6_reports["phi_fixed_point:fastamm"]),
        ("sparse_fastamm_stats", "svinet_torch/csrc/sparse_fastamm.cu",
         "svinet_tpu/ops/sparse_gamma.py:74",
         p6_reports["sparse_fastamm_stats"]),
        # kernel 11's launches count calls: each launches its pair pass,
        # narrow assignments with 2E >= n a node pass before it
        ("union_scores:scores", "svinet_torch/csrc/sparse_scores.cu",
         "svinet_tpu/ops/sparse_gamma.py:213",
         p6_reports["union_scores:scores"]),
        ("union_scores:assign", "svinet_torch/csrc/sparse_scores.cu",
         "svinet_tpu/ops/sparse_gamma.py:247",
         p6_reports["union_scores:assign"]),
        # FastInit's vote and overlap pass, SBM's E-step chunk: XLA
        # programs on the TPU
        ("vote_topk", "svinet_torch/csrc/fastinit_vote.cu",
         "svinet_tpu/svi/fastinit.py:39", p7_reports["vote_topk"]),
        ("overlap_stats", "svinet_torch/csrc/fastinit_overlap.cu",
         "svinet_tpu/svi/fastinit.py:105", p7_reports["overlap_stats"]),
        ("estep_chunk", "svinet_torch/csrc/sbm_estep.cu",
         "svinet_tpu/svi/sbm.py:97", p7_reports["estep_chunk"]),
        # -orig's coupled fixed point (a while loop of K x K products in
        # XLA) and -logl's pair terms; the generator's pair draw (XLA
        # categorical slabs)
        ("orig_chunk", "svinet_torch/csrc/orig_fixed_point.cu",
         "svinet_tpu/svi/orig.py:39", p8_reports["orig_chunk"]),
        ("orig_chunk:elbo", "svinet_torch/csrc/orig_fixed_point.cu",
         "svinet_tpu/svi/orig.py:68", p8_reports["orig_chunk:elbo"]),
        ("gen_pairs", "svinet_torch/csrc/gen_pairs.cu",
         "svinet_tpu/svi/gen.py:45", p8_reports["gen_pairs"]),
        # LinkSampling's device init (a jax.random.uniform block in the
        # XLA scan on the TPU)
        ("uniform_rows", "svinet_torch/csrc/threefry_uniform.cu",
         "svinet_tpu/svi/linksampling.py:403", uniform_report),
        # the wide forms (W > 64, kernel 13's tables past width 4,096)
        ("sparse_fastamm_stats:wide", "svinet_torch/csrc/sparse_fastamm.cu",
         "svinet_tpu/ops/sparse_gamma.py:74",
         p6_reports["sparse_fastamm_stats:wide"]),
        ("union_scores:scores+wide", "svinet_torch/csrc/sparse_scores.cu",
         "svinet_tpu/ops/sparse_gamma.py:213",
         p6_reports["union_scores:scores+wide"]),
        ("union_scores:assign+wide", "svinet_torch/csrc/sparse_scores.cu",
         "svinet_tpu/ops/sparse_gamma.py:247",
         p6_reports["union_scores:assign+wide"]),
        ("overlap_stats:scratch", "svinet_torch/csrc/fastinit_overlap.cu",
         "svinet_tpu/svi/fastinit.py:105",
         p7_reports["overlap_stats:scratch"]),
    )
    # then the forms of -bf16, -freeze and -prune, as "kernel:form": each
    # with its launches in the phase 2 run that takes it, and its error,
    # times and bound at the main shape from phase 1. A form the main path
    # never launched fails the run
    form_source = {"phi_pass:bf16": "svinet_torch/csrc/phi_pass_bf16.cu",
                   "phi_pass:bf16+conv": "svinet_torch/csrc/phi_pass_bf16.cu",
                   "fused_phi_s3_pass:bf16":
                       "svinet_torch/csrc/phi_pass_bf16.cu"}
    rows += tuple(
        (form, form_source.get(form, source), replaces, form_reports[form])
        for name, source, replaces, _ in rows
        for form in sorted(form_reports) if form.split(":")[0] == name)
    missing = [name for name, *_ in rows if not launches.get(name)]
    assert not missing, f"never launched on the main path: {missing}"
    # phase 4: every kernel of the mesh path launched there (the -sparse-w
    # kernels are refused under a mesh)
    missing = [name for name in ("dirichlet_expectation", "phi_pass",
                                 "mean_indicator_update", "s3_pass",
                                 "fused_phi_s3_pass", "heldout_sums",
                                 "phi_fixed_point", "phi_fixed_point:elbo",
                                 "edge_assignments", "phi_pass:bf16")
               if not mesh_launches.get(name)]
    assert not missing, f"never launched on the mesh path: {missing}"
    # phase 5: every kernel of the locality, -dist and FastAMM2 paths
    missing = [name for name in ("dirichlet_expectation",
                                 "mean_indicator_update",
                                 "fused_phi_s3_pass", "heldout_sums",
                                 "phi_fixed_point", "edge_assignments")
               if not p5_launches.get(name)]
    assert not missing, f"never launched in phase 5: {missing}"
    kernels = [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         "launches_per_sweep": per_sweep[name],
         "launches_per": unit.get(name, "link-sampling sweep"),
         "mesh_launches": mesh_launches.get(name, 0),
         "phase5_launches": p5_launches.get(name, 0), **report,
         "library_ms": None}
        for name, source, replaces, report in rows]
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.0f} s")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
