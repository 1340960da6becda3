"""Where a call of kernel 10's grid form spends its time, phase by phase.

    python -m svinet_torch.tools.k10_phases [--out DIR]

Builds a copy of csrc/sparse_fastamm.cu with timestamps (the card's
%globaltimer, read by thread 0 of CTA 0) after each phase of the grid form,
a grid barrier before each stamp: the set-up (matching, records), the
rounds, lambda_hat's chunks, the row units (the hubs' segments, the rows)
and the finish pass. The stamps go into rounds[1..7] of the call, which
this copy leaves to them (it writes R from rounds[16] on). At a hub's
minibatch of 16,000 pairs at (1M, 8000), W = 16, 64 and 128 (the grid
form; chip_smoke.py's states), it logs each phase's ms, the mean of five
calls after one, with thresh 1e-5 (R rounds) and with no round. The
extra barriers add a few microseconds; the copy is never the main path's
kernel. Prints the card and its power limit first; appends the lines to
DIR/k10_phases.txt (DIR defaults to build/svinet_torch).
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from svinet_torch.kernels import build

_SMOKE = Path(__file__).resolve().parents[2] / "chip_smoke.py"

SHAPES = ((1_000_000, 8_000, 16, 16_000, 16_384),
          (1_000_000, 8_000, 64, 16_000, 16_384),
          (1_000_000, 8_000, 128, 16_000, 16_384))
PHASES = ("set-up", "rounds", "records' barrier", "lambda_hat's chunks",
          "row units", "finish")

# (anchor in csrc/sparse_fastamm.cu, what goes in its place)
_STAMP = """__device__ __forceinline__ void stamp(const Args& a, int i) {
  if (blockIdx.x == 0 && threadIdx.x == 0 && a.m > 8) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.rounds[1 + i] = static_cast<int32_t>(t & 0x7fffffff);
  }
}

"""
_EDITS = (
    ("// NaN-propagating max, as jnp.maximum and .max() take it",
     _STAMP + "// NaN-propagating max, as jnp.maximum and .max() take it"),
    ("  float* const tile = tiles + warp * stride;\n",
     "  if (gridDim.x > 16) {\n    cg::this_grid().sync();\n"
     "    stamp(a, 4);\n  }\n  float* const tile = tiles + warp * stride;\n"),
    ("  const int64_t second = int64_t{12} * a.w_top;",
     "  stamp(a, 0);\n  grid.sync();\n  stamp(a, 1);\n"
     "  const int64_t second = int64_t{12} * a.w_top;"),
    ("  for (int64_t i = tid; i < a.m; i += n_t) a.rounds[i] = rounds;\n"
     "  grid.sync();   // every record written\n",
     "  for (int64_t i = tid + 16; i < a.m; i += n_t) a.rounds[i] = rounds;\n"
     "  grid.sync();   // every record written\n  stamp(a, 2);\n"
     "  grid.sync();\n  stamp(a, 3);\n"),
    ("      gridDim.x, warp, warps, lane);\n  grid.sync();\n"
     "  finish_phase(a, tid, n_t);\n}",
     "      gridDim.x, warp, warps, lane);\n  grid.sync();\n  stamp(a, 5);\n"
     "  finish_phase(a, tid, n_t);\n  grid.sync();\n  stamp(a, 6);\n}"),
)


def stamped_library() -> build.Library:
    """Kernel 10 with the phase stamps, built beside the main library."""
    src = (build.CSRC / "sparse_fastamm.cu").read_text()
    for anchor, new in _EDITS:
        if src.count(anchor) < 1:
            raise RuntimeError(f"k10_phases: the kernel has changed; no "
                               f"{anchor.strip()[:60]!r} to stamp")
        src = src.replace(anchor, new, 1)
    work = build.BUILD_DIR / "k10_phases"
    work.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        shutil.copy(header, work / header.name)
    shutil.copy(build.CSRC / "runtime.cu", work / "runtime.cu")
    (work / "sparse_fastamm.cu").write_text(src)
    names = ("svt_sparse_fastamm", "svt_sparse_fastamm_scratch")
    return build.build_library(
        "k10_phases", [work / "sparse_fastamm.cu", work / "runtime.cu"],
        {name: build.SIGNATURES[name] for name in names})


def phases(dev, log) -> None:
    spec = importlib.util.spec_from_file_location("k10_smoke", _SMOKE)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from svinet_torch.ops.digamma import dirichlet_expectation
    from svinet_torch.ops.edges import owner_csr
    from svinet_torch.ops.sparse_gamma import (
        K10_SEG_LEN, SparseWorkspace, sparse_fastamm_stats)
    lib = stamped_library()
    main_library = build.library
    log_eps = float(np.float32(np.log(1e-30)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    for n, k, wt, m, pad in SHAPES:
        ids, vals, rest = cs._sparse_state(dev, gen, n, k, wt)
        lam = 1.0 + 19.0 * torch.rand((k, 2), generator=gen, device=dev)
        elogbeta = dirichlet_expectation(lam)
        pairs, y, w, nodes = cs._minibatch(dev, gen, n, m, min(m, 21))
        rows, local = cs._local(pairs, nodes, False)
        lp, lq = local[:, 0].contiguous(), local[:, 1].contiguous()
        t = rows.shape[0]
        csr = owner_csr(local.reshape(-1), t, K10_SEG_LEN)
        ws = SparseWorkspace(dev)
        # kernel 10's wrapper launches the stamped copy; the rest of the
        # package keeps the main library
        build.library = lambda: lib
        try:
            for iters, thresh in ((50, 1e-5), (0, -1.0)):
                acc = np.zeros(len(PHASES))
                for rep in range(6):
                    r = sparse_fastamm_stats(
                        ids, vals, rest, elogbeta, pairs, y, w, lp, lq, t,
                        log_eps, iters, thresh, pad, csr, ws)[2]
                    ns = r[1:8].cpu().numpy().astype(np.int64)
                    if rep:
                        acc += np.diff(ns) % (1 << 31) / 1e6
                acc /= 5
                log(f"kernel 10's grid form at n={n} K={k} W={wt}, {m} pairs "
                    f"padded to {pad}, max_iters {iters}: "
                    + ", ".join(f"{p} {v:.4f}" for p, v in zip(PHASES, acc))
                    + f" ms; {acc.sum():.4f} ms in all")
        finally:
            build.library = main_library
        del ids, vals, rest, ws
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/svinet_torch")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k10_phases needs a CUDA card")
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    lines = []

    def log(msg):
        lines.append(msg)
        print(msg, flush=True)

    try:
        log(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip())
        phases(torch.device("cuda", 0), log)
    finally:
        with open(os.path.join(out, "k10_phases.txt"), "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
