"""Where one step of the stretch shape goes, by kernel name.

    python -m svinet_torch.tools.profile_stretch [--edges 20000000]
                                                 [--out DIR]

Builds a LinkSampling engine on n=1M, K=500 and uniform random edges (the
stretch shape of chip_smoke.py), warms it up, traces one step(1) (one
sweep plus the held-out tail) with torch.profiler, and prints the device
time by kernel or op, the step's wall time and the device's busy share.
Prints the card and its power limit first; writes the table to
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
from torch.profiler import ProfilerActivity, profile

from svinet_torch.kernels import build
from svinet_torch.svi.linksampling import from_edges
from svinet_torch.synth import random_edges



def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--k", type=int, default=500)
    ap.add_argument("--edges", type=int, default=20_000_000)
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
    with tempfile.TemporaryDirectory() as workdir:
        eng = from_edges(random_edges(args.n, args.edges, 0), args.n, args.k,
                         dev, os.path.join(workdir, "stretch"))
        try:
            eng.step(1)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                eng.step(1)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            eng.close()
    # device time by kernel: the events that ran on the card
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.device_time_total
    busy_ms = sum(kernels.values()) / 1e3
    lines.append(f"n={args.n} K={args.k} training links "
                 f"{len(eng.network.training_links)}: step(1) wall "
                 f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
                 f"({100 * busy_ms / wall_ms:.1f}%)")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:25]:
        lines.append(f"{us / 1e3:9.3f} ms {100 * us / 1e3 / busy_ms:5.1f}%  "
                     f"{name[:110]}")
    lines.append(prof.key_averages().table(sort_by="cuda_time_total",
                                           row_limit=25,
                                           max_name_column_width=60))
    text = "\n".join(lines)
    print(text, flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_stretch.txt"), "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
