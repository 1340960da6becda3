"""Kernel 11 (csrc/sparse_scores.cu) timed: held-out scores and link
assignments on the sparse top-W state.

    python -m svinet_torch.tools.k11_times [--out DIR] [--stamps] [--skip-times]
    PYTHONPATH=OLD python3 svinet_torch/tools/k11_times.py [--out DIR]

At SHAPES (chip_smoke.py's SCORE_SHAPES and ASSIGN_SHAPES up to W = 128,
planted-20k's 196,012 links at K=100, W=8, and W = 32 at 2^18 pairs)
it logs kernel 11's ms a call over 5 calls back to back through
sparse_pair_scores or sparse_edge_assignments, and a call split by
torch.profiler (host, CUDA runtime, device time by kernel, gaps). The
states and links are chip_smoke.py's, from this file's checkout.

With --stamps it also builds a copy of this package's sparse_scores.cu
with clock64 stamps in its W <= 16 kernel (each group's cycles a pair
summed by phase: the loads and the slots' match, the logits, the softmax,
the argmax and its write) and logs each phase's cycles a pair and share
at STAMPED. The stamps go in at anchors of the source's text; a missing
anchor raises.

It times the svinet_torch that comes first on the path. With another
checkout's root first on PYTHONPATH (the second form) it times that
checkout's package, whose wrappers take a workspace as this one's do, so
a design and its parent are compared in one call to the card, in turns
(parent, change, change, parent). Prints the card and its power limit
first; appends the log to DIR/k11_times.txt (DIR defaults to
build/svinet_torch).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

import svinet_torch

# chip_smoke.py of this file's checkout, whatever package is on the path
_SMOKE = Path(__file__).resolve().parents[2] / "chip_smoke.py"
_spec = importlib.util.spec_from_file_location("k11_smoke", _SMOKE)
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

# (form, n, K, W, pairs): chip_smoke.py's narrow and wide rows (up to W =
# 128), the main path's CLI shape, W = 32 (two slot registers a lane)
SHAPES = tuple(dict.fromkeys(
    [("scores", *s) for s in cs.SCORE_SHAPES if s[2] <= 128]
    + [("assign", *s) for s in cs.ASSIGN_SHAPES]
    + [("assign", 20_000, 100, 8, 196_012)]
    + [(form, 1_000_000, 8_000, 32, 1 << 18)
       for form in ("scores", "assign")]))
STAMPED = (("assign", *cs.SPARSE_STRETCH, cs.STRETCH["n_edges"]),
           ("scores", 1_000_000, 8_000, 16, 400_000))


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


class _Inputs:
    """The stretch links once, and a state and its pairs a shape."""

    def __init__(self, dev):
        from svinet_torch.synth import random_edges
        self.dev = dev
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(20)
        self.stretch = torch.as_tensor(
            random_edges(cs.STRETCH["n"], cs.STRETCH["n_edges"], 0),
            device=dev)

    def call(self, form, n, k, wt, m, direct=False):
        """(run, what it logs as its pairs) at one shape: run() makes one
        call of the form's wrapper, or with `direct` of union_scores on a
        table made once (kernel 11's launch alone, for a build of it
        alone)."""
        from svinet_torch.ops.digamma import dirichlet_expectation
        from svinet_torch.ops.sparse_gamma import (SparseWorkspace,
                                                   sparse_edge_assignments,
                                                   sparse_pair_scores,
                                                   union_scores)
        from svinet_torch.synth import random_edges
        dev, gen = self.dev, self.gen
        state = cs._sparse_state(dev, gen, n, k, wt)
        lam = 1.0 + 19.0 * torch.rand((k, 2), generator=gen, device=dev)
        if form == "scores":
            pairs = torch.randint(0, n, (m, 2), generator=gen,
                                  device=dev).to(torch.int32)
            fn, what = sparse_pair_scores, f"{m} pairs"
            table = (lam[:, 0] / (lam[:, 0] + lam[:, 1])).contiguous()
        else:
            pairs = (self.stretch[:m] if n == cs.STRETCH["n"] else
                     torch.as_tensor(random_edges(n, m, 0), device=dev))
            fn, what = sparse_edge_assignments, f"{pairs.shape[0]} links"
            table = dirichlet_expectation(lam)
        # a workspace kept across calls, as the engine keeps one
        ws = SparseWorkspace(dev)

        def run():
            if direct:
                return union_scores(*state, table, pairs, k, form == "assign",
                                    ws)
            return fn(*state, lam, pairs, k, ws)
        return run, what


def times(dev, inputs):
    """Kernel 11 at SHAPES: device ms of 5 calls back to back, and a call
    split by torch.profiler. Logs each."""
    for form, n, k, wt, m in SHAPES:
        run, what = inputs.call(form, n, k, wt, m)
        ms = cs.cuda_ms(run, 5)
        tag = f"kernel 11 ({form}) timed at n={n} K={k} W={wt}, {what}"
        cs.log(f"{tag}: {ms:.4f} ms a call over 5 back to back")
        cs.log(f"{tag}: split: {_split_text(cs._trace_split(run, 5))}")
        del run
        torch.cuda.empty_cache()


# The stamps: a global of cycle sums and a query that reads and clears
# it, then (anchor, what goes in its place) in sparse_scores.cu. STAMP(i)
# adds the cycles since the last stamp to phase i. The loads of a pair
# are issued a pair ahead, so phase 0 is the wait for them, the table's
# gather and the match (and a pair's own digammas where the node pass did
# not run); the scores' pair is whole in phase 1.
_CYCLES = """
__device__ unsigned long long k11_cycles[8];

extern "C" int svt_k11_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k11_cycles, sizeof(k11_cycles));
  const unsigned long long zero[8] = {};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(k11_cycles, zero, sizeof(zero));
  return static_cast<int>(err);
}

#define STAMP(i)                        \\
  {                                     \\
    const long long t_ = clock64();     \\
    acc[i] += t_ - last;                \\
    last = t_;                          \\
  }
"""
_FLUSH = """  if (g == 0) {
    for (int i = 0; i < 4; ++i)
      atomicAdd(&k11_cycles[i], static_cast<unsigned long long>(acc[i]));
    atomicAdd(&k11_cycles[7], static_cast<unsigned long long>(done));
  }
"""
PHASES = ("loads and match", "logits", "softmax", "argmax and write")
_EDITS = (
    ('#include "sparse_slots.cuh"\n', '#include "sparse_slots.cuh"\n'
     + _CYCLES),
    ("                                            int64_t item) {\n"
     "  const int w = a.w_top;\n  // the digammas",
     "                                            int64_t item, long long* "
     "acc, long long& last) {\n  const int w = a.w_top;\n  // the digammas"),
    ("      match_slot<G>(s, ln, ln.low ? s.end_q.y : s.end_p.y, &oth);\n",
     "      match_slot<G>(s, ln, ln.low ? s.end_q.y : s.end_p.y, &oth);\n"
     "  STAMP(0)\n"),
    ("  mx = group_max_redux(mx, ln.group);\n",
     "  STAMP(1)\n  mx = group_max_redux(mx, ln.group);\n"),
    ("  sum = svt::group_sum<G>(sum, ln.group);\n",
     "  sum = svt::group_sum<G>(sum, ln.group);\n  STAMP(2)\n"),
    ("    a.cid[item] = s.id;\n  }\n}\n",
     "    a.cid[item] = s.id;\n  }\n  STAMP(3)\n}\n"),
    ("  for (; item < a.n_pairs; item += step) {\n"
     "    const Slot ahead = load_slot<G, NODE>(a, next, ln);\n"
     "    next = load_pair(a, item + 2 * step);\n"
     "    if constexpr (ASSIGN)\n"
     "      assign_pair<G, NODE>(a, cur, ln, item);\n"
     "    else\n      scores_pair<G>(a, cur, ln, item);\n"
     "    cur = ahead;\n  }\n",
     "  long long acc[4] = {0, 0, 0, 0};\n  long long last = clock64();\n"
     "  long long done = 0;\n  const int g = ln.lane % G;\n"
     "  for (; item < a.n_pairs; item += step) {\n"
     "    const Slot ahead = load_slot<G, NODE>(a, next, ln);\n"
     "    next = load_pair(a, item + 2 * step);\n    ++done;\n"
     "    if constexpr (ASSIGN)\n"
     "      assign_pair<G, NODE>(a, cur, ln, item, acc, last);\n"
     "    else {\n      scores_pair<G>(a, cur, ln, item);\n"
     "      STAMP(1)\n    }\n    cur = ahead;\n  }\n" + _FLUSH),
)


def stamped_library(build):
    """This package's kernel 11 with the stamps, built beside the main
    library."""
    src = (build.CSRC / "sparse_scores.cu").read_text()
    for anchor, new in _EDITS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"k11_times: the kernel has changed; no one "
                               f"{anchor.strip()[:60]!r} to stamp")
        src = src.replace(anchor, new, 1)
    work = build.BUILD_DIR / "k11_stamps"
    work.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        shutil.copy(header, work / header.name)
    shutil.copy(build.CSRC / "runtime.cu", work / "runtime.cu")
    (work / "sparse_scores.cu").write_text(src)
    sigs = {name: build.SIGNATURES[name] for name in build.SIGNATURES
            if name.startswith("svt_sparse_scores")}
    sigs["svt_k11_cycles"] = (ctypes.c_void_p,)
    return build.build_library(
        "k11_stamps", [work / "sparse_scores.cu", work / "runtime.cu"], sigs)


def stamps(dev, inputs):
    """Each phase's cycles a pair (one group's clock64, its pairs' sum
    over the call) at STAMPED, the mean of three calls after one. Logs
    each."""
    from svinet_torch.kernels import build
    lib = stamped_library(build)
    main_library = build.library
    for form, n, k, wt, m in STAMPED:
        run, what = inputs.call(form, n, k, wt, m, direct=True)
        out = (ctypes.c_uint64 * 8)()
        build.library = lambda: lib
        try:
            run()
            torch.cuda.synchronize()
            lib.call("svt_k11_cycles", out)
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            lib.call("svt_k11_cycles", out)
            stamped_ms = cs.cuda_ms(run, 3)
        finally:
            build.library = main_library
        ms = cs.cuda_ms(run, 3)
        if not out[7]:
            cs.log(f"kernel 11 ({form}) at n={n} K={k} W={wt}: no stamped "
                   "pair (another kernel takes this W)")
        else:
            cyc = np.array(out[:4], dtype=np.float64) / out[7]
            phases = (PHASES if form == "assign"
                      else PHASES[:1] + ("the rest",))
            cs.log(f"kernel 11 ({form}) stamped at n={n} "
                   f"K={k} W={wt}, {what}: {out[7] // 3} pairs a call, "
                   "cycles a pair "
                   + ", ".join(f"{p} {c:.1f} ({c / cyc.sum():.1%})"
                               for p, c in zip(phases, cyc)
                               if c or form == "assign")
                   + f"; {cyc.sum():.1f} in all; the stamped call "
                   f"{stamped_ms:.4f} ms against {ms:.4f} unstamped")
        del run
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/svinet_torch")
    ap.add_argument("--stamps", action="store_true",
                    help="also the clock64 stamps of each phase")
    ap.add_argument("--skip-times", action="store_true",
                    help="leave out the times at SHAPES")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k11_times needs a CUDA card")
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
        inputs = _Inputs(dev)
        if not args.skip_times:
            times(dev, inputs)
        if args.stamps:
            stamps(dev, inputs)
    finally:
        cs.log = log
        with open(os.path.join(out, "k11_times.txt"), "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
