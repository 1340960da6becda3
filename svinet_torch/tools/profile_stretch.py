"""Where one step of the stretch shape goes, by kernel name.

    python -m svinet_torch.tools.profile_stretch [--edges 20000000]
        [--sparse-w 16,64] [--graph stretch|planted] [--k 500]
        [--sparse-only] [--out DIR]

Builds a LinkSampling engine on n=1M, K=500 and uniform random edges (the
stretch shape of chip_smoke.py; with --graph planted, chip_smoke.py's
planted n=20k graph of 20 blocks at --k columns), warms it up, traces one
step(1) (one sweep plus the held-out tail) with torch.profiler, and prints
the device time by kernel or op, the step's wall time and the device's
busy share; then the same again past annealing with and without -bf16
(the sweep over bf16 rows beside the f32 sweep of the same phase), with
-sparse-w at each --sparse-w width past annealing, and with -fuse-s3, all
on the same engine (--sparse-only: the -sparse-w steps alone). Every trace
is a profiler of its own whose first step is a discarded warm-up (a
profiler drops the first kernels launched after it starts), and must hold
the launches of the hand kernels that a step of one sweep makes (kernels 1
to 4 and 6, at least once each; under -sparse-w the top-W form of kernel
1, kernels 1, 7, 3 and 6), or it is taken again and then refused. Each trace is printed by
kernel name and, above that, summed by hand kernel (the step table: the
hand kernels, the sums across blocks, and what is left to plain PyTorch).
After each trace, one untraced step(3) beside it: its wall time, edges/s
and peak device memory, with the memory the engine held as it began.
Prints the card and its power limit first; writes the tables to
DIR/profile_stretch.txt (DIR defaults to build/svinet_torch).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile, schedule

from svinet_torch.kernels import build
from svinet_torch.svi.linksampling import from_edges
from svinet_torch.synth import planted_blocks, random_edges


# what a step of one sweep launches of the hand kernels, by a part of the
# kernel's name (the row and the wide forms alike): kernel 1 twice (gamma
# and lambda), kernels 2, 3, 4 and 6 once
STEP_LAUNCHES = {"dirichlet_": 2, "phi_pull": 1,
                 "mean_indicator_kernel": 1, "s3_pull_kernel": 1,
                 "heldout_sums": 1}
# and a -sparse-w step: the top-W form of kernel 1 on gamma, kernel 1 on
# lambda, kernels 7, 3 and 6
SPARSE_STEP_LAUNCHES = {"dirichlet_topw": 1,
                        "dirichlet_rows_kernel": 1, "sparse_union_kernel": 1,
                        "mean_indicator_kernel": 1, "heldout_sums": 1}
# chip_smoke.py's planted graph: n=20k, 20 blocks, 20 links a node, seed 7
PLANTED = (20_000, 20, 20, 7)
# the rows of the step table: a hand kernel's name, and the parts of kernel
# names that belong to it
STEP_TABLE = (("kernel 2, phi_pass", ("phi_pull",)),
              ("kernel 4, s3_pass", ("s3_pull",)),
              ("kernel 7, sparse_union_pass", ("sparse_union",)),
              ("kernel 3, mean_indicator_update", ("mean_indicator",)),
              ("kernel 1, top-W form", ("dirichlet_topw",)),
              ("kernel 1, dirichlet_expectation", ("dirichlet_",)),
              ("hub segments combined", ("combine_segments",)),
              ("kernel 6, heldout_sums", ("heldout_sums",)),
              ("sums across blocks", ("colsum_partials",)))
TRACE_ATTEMPTS = 3


def _traced_step(eng):
    """Trace one step(1) under a profiler of its own, after a warm-up step
    inside the same profiler that is not recorded. Returns (device time in
    us by kernel name, launches by kernel name, wall ms, the profiler)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                 ) as prof:
        eng.step(1)
        torch.cuda.synchronize()
        prof.step()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng.step(1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    # device time by kernel: the events that ran on the card, less the
    # span the profiler's own step marker lays over all of them
    kernels, launches = {}, {}
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not ev.name.startswith("ProfilerStep")):
            kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.device_time_total
            launches[ev.name] = launches.get(ev.name, 0) + 1
    return kernels, launches, wall_ms, prof


def trace_step(eng, label: str, expect=STEP_LAUNCHES) -> list:
    """Warm up, trace one step(1) that holds every launch `expect` names
    (by a part of the kernel's name), and return the report's lines."""
    eng.step(1)
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        kernels, launches, wall_ms, prof = _traced_step(eng)
        seen = {part: sum(c for name, c in launches.items() if part in name)
                for part in expect}
        # at least: above 512 columns kernel 3 takes the row in tiles, one
        # launch each
        if all(seen[part] >= expect[part] for part in expect):
            break
        print(f"{label}: trace {attempt} holds {seen} of {expect}",
              flush=True)
    else:
        raise RuntimeError(f"{label}: no trace of {TRACE_ATTEMPTS} held "
                           f"every launch of {sorted(expect)}")
    busy_ms = sum(kernels.values()) / 1e3
    peak1 = torch.cuda.max_memory_allocated()
    n_train = len(eng.network.training_links)
    # one untraced step(3), as chip_smoke.py's phase 3 steps
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.step(3)
    torch.cuda.synchronize()
    wall3 = time.perf_counter() - t0
    lines = [f"{label}: n={eng.n} K={eng.k} training links {n_train}: "
             f"step(1) wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
             f"({100 * busy_ms / wall_ms:.1f}%), peak device memory in the "
             f"step {peak1 / 2**30:.2f} GiB; trace {attempt} of at most "
             f"{TRACE_ATTEMPTS}, every hand kernel's launch in it ({seen})",
             f"{label}: step(3) wall {1e3 * wall3:.1f} ms = "
             f"{3 * n_train / wall3:.0f} edges/s, held at its start "
             f"{held / 2**30:.2f} GiB, peak device memory in the step "
             f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"]
    # the step table: device time by hand kernel, the rest plain PyTorch
    left = dict(kernels)
    for title, parts in STEP_TABLE:
        mine = [name for name in left if any(p in name for p in parts)]
        us = sum(left.pop(name) for name in mine)
        lines.append(f"{us / 1e3:9.3f} ms {100 * us / 1e3 / busy_ms:5.1f}%  "
                     f"x{sum(launches[name] for name in mine):<3d} {title}")
    us = sum(left.values())
    lines.append(f"{us / 1e3:9.3f} ms {100 * us / 1e3 / busy_ms:5.1f}%  "
                 f"x{sum(launches[name] for name in left):<3d} plain PyTorch "
                 f"(finish_lambda, beta, copies)")
    lines.append("by kernel name:")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:25]:
        lines.append(f"{us / 1e3:9.3f} ms {100 * us / 1e3 / busy_ms:5.1f}%  "
                     f"x{launches[name]:<3d} {name[:110]}")
    lines.append(prof.key_averages().table(sort_by="cuda_time_total",
                                           row_limit=25,
                                           max_name_column_width=60))
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--k", type=int, default=500)
    ap.add_argument("--edges", type=int, default=20_000_000)
    ap.add_argument("--graph", choices=("stretch", "planted"),
                    default="stretch")
    ap.add_argument("--sparse-w", default="16,64",
                    help="comma-separated -sparse-w widths to trace")
    ap.add_argument("--sparse-only", action="store_true",
                    help="trace the -sparse-w steps alone")
    ap.add_argument("--out", default=str(build.BUILD_DIR),
                    help="directory for the result files")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_stretch: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    lines = [card]
    dev = torch.device("cuda", 0)
    widths = [int(w) for w in args.sparse_w.split(",") if w]
    if args.graph == "planted":
        n, blocks, avg_deg, seed = PLANTED
        edges = planted_blocks(n, blocks, avg_deg, seed)[0]
    else:
        n, edges = args.n, random_edges(args.n, args.edges, 0)
    with tempfile.TemporaryDirectory() as workdir:
        eng = from_edges(edges, n, args.k, dev,
                         os.path.join(workdir, args.graph))
        del edges
        try:
            if not args.sparse_only:
                lines += trace_step(eng, "default flags")
            # past annealing, f32 rows and then -bf16 rows
            eng.annealing = False
            if not args.sparse_only:
                lines += trace_step(eng, "default flags, annealing over")
                eng.cfg.bf16_rows = True
                lines += trace_step(eng, "-bf16, annealing over")
                eng.cfg.bf16_rows = False
            for w in widths:
                eng.cfg.sparse_w = w
                lines += trace_step(eng, f"-sparse-w {w}, annealing over",
                                    SPARSE_STEP_LAUNCHES)
            eng.cfg.sparse_w = 0
            eng._sparse_rows = None
            eng.annealing = True
            if not args.sparse_only:
                # what LinkSampling.__init__ does under -fuse-s3, on the
                # same network and state (set-up is over a minute of host
                # time)
                eng.cfg.fuse_s3 = True
                eng.mphi = torch.zeros_like(eng.gamma)
                lines += trace_step(eng, "-fuse-s3")
        finally:
            eng.close()
    text = "\n".join(lines)
    print(text, flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_stretch.txt"), "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
