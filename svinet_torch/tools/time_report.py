"""The seconds of one report's community extraction, log_communities
(kernel 9's edge assignments, the counting, communities.txt, mcount.txt,
aggregate.txt and, with a ground-truth cover, the NMI row).

    python -m svinet_torch.tools.time_report [--graph planted,stretch]
        [--reps 3] [--out DIR]

Builds a LinkSampling engine on chip_smoke.py's planted n=20k graph of 20
blocks (K=20, with its ground-truth cover, as `-nmi` gives it) and on the
stretch shape (n=1M, K=500, 20M uniform random edges), sweeps it (40
sweeps on planted-20k, near its fit; 4 on stretch, as far as chip_smoke.py
takes it), and times engine.log_communities() --reps times, wall clock
around a synchronised call. It uses only what every slice of the port
has (from_edges, step, log_communities), so the same file times an older
checkout when that checkout comes first on PYTHONPATH. Prints the card
and its power limit first, then one line a graph; writes them to
DIR/time_report.txt (DIR defaults to build/svinet_torch).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

import svinet_torch
from svinet_torch.svi.linksampling import from_edges
from svinet_torch.synth import planted_blocks, random_edges

PLANTED = (20_000, 20, 20, 7)
STRETCH = (1_000_000, 500, 20_000_000)
SWEEPS = {"planted": 40, "stretch": 4}


def _engine(graph: str, workdir: str, dev: torch.device):
    if graph == "planted":
        n, k, deg, seed = PLANTED
        raw, member = planted_blocks(n, k, deg, seed)
        gt = os.path.join(workdir, "gt.txt")
        np.savetxt(gt, np.stack([np.arange(n), member], 1), fmt="%d",
                   delimiter="\t")
        eng = from_edges(raw, n, k, dev, os.path.join(workdir, graph),
                         seed=1, lt_min_deg=1, nmi=True,
                         ground_truth_fname=gt)
    else:
        n, k, e = STRETCH
        eng = from_edges(random_edges(n, e, 0), n, k, dev,
                         os.path.join(workdir, graph))
    return eng


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--graph", default="planted,stretch")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_report needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    lines = [card, "svinet_torch from "
             + os.path.dirname(svinet_torch.__file__)]
    print(*lines, sep="\n", flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        for graph in args.graph.split(","):
            t0 = time.perf_counter()
            eng = _engine(graph, workdir, torch.device("cuda", 0))
            eng.step(SWEEPS[graph])
            torch.cuda.synchronize()
            setup = time.perf_counter() - t0
            secs = []
            for _ in range(args.reps):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                eng.log_communities()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t1)
            nmi = ""
            if eng._mutual is not None:
                eng._mutual.flush()
                nmi = open(eng.cfg.file_str("mutual.txt")).read().split()[-1]
            line = (f"{graph}: n={eng.n} K={eng.k} training links "
                    f"{len(eng.network.training_links)}: log_communities "
                    f"{', '.join(f'{s:.3f}' for s in secs)} s "
                    f"({len(eng._communities)} communities"
                    f"{', NMI ' + nmi if nmi else ''}; set-up and sweeps "
                    f"{setup:.1f} s)")
            print(line, flush=True)
            lines.append(line)
            eng.close()
            del eng
            torch.cuda.empty_cache()
    out = args.out or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "build", "svinet_torch")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "time_report.txt"), "a") as f:
        f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
