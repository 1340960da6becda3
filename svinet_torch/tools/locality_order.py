"""The host side of -mesh-locality, timed: Network.reorder_locality and
parallel/locality.py:locality_edge_layout at each number of ranks d, with
what each layout implies for a sweep's collectives.

    python -m svinet_torch.tools.locality_order [--graph stretch]
        [--d 1,2,4,8] [--out DIR]

`--graph stretch` is chip_smoke.py's stretch shape (n=1M, K=500, 20M
uniform random edges); `planted` its planted n=100k graph of 100 blocks
(5% of the links across blocks). The graph is ingested as the CLI does
(singletons dropped) and each d reorders it in turn, the layout taken on
all its links. A line a d: the host seconds of both, the internal
fraction, the boundary rows and Xmax, and the bytes a sweep's collectives
move on each rank at the graph's K: the locality table of Elogpi and mphi
gathered and its gamma_hat reduce-scattered, against row-sharded's whole
(n, K) of each (f32 rows). Prints the card and its power limit first, and
writes the lines to DIR/locality_order.txt (DIR defaults to
build/svinet_torch).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time

import numpy as np

from svinet_torch.config import Config
from svinet_torch.graph import Network
from svinet_torch.parallel.locality import locality_edge_layout
from svinet_torch.synth import planted_blocks, random_edges

GRAPHS = {"stretch": (1_000_000, 500), "planted": (100_000, 100)}


def graph_edges(name: str) -> np.ndarray:
    """The raw edge list of graph `name` (GRAPHS), made from its seed."""
    n, k = GRAPHS[name]
    if name == "stretch":
        return random_edges(n, 20_000_000, 0)
    return planted_blocks(n, k, 20, 7)[0]


def ingest(edges: np.ndarray, n: int, k: int) -> Network:
    """The network the CLI would build from the edge list."""
    cfg = Config(n=n, k=k, link_sampling=True)
    cfg.resolve()
    net = Network(cfg)
    net.from_arrays(edges[:, 0], edges[:, 1])
    net.drop_singles()
    return net


def collective_bytes(n: int, k: int, d: int, info: dict):
    """(locality, row-sharded): the bytes of the rows a sweep gathers
    (Elogpi and mphi) and reduce-scatters (gamma_hat) on each rank, f32."""
    return (3 * d * info["xmax"] * k * 4, 3 * (-(-n // d) * d) * k * 4)


def time_orders(net: Network, k: int, ds, block: int = 1 << 16):
    """Reorder `net` for each d of ds in turn and lay its links out.
    Yields (d, reorder seconds, layout seconds, layout info, locality
    bytes, row-sharded bytes)."""
    n = net.n
    for d in ds:
        t0 = time.perf_counter()
        net.reorder_locality(d)
        t1 = time.perf_counter()
        info = locality_edge_layout(net.edges, -(-n // d) * d, d, block)[3]
        t2 = time.perf_counter()
        yield (d, t1 - t0, t2 - t1, info, *collective_bytes(n, k, d, info))


def describe(name: str, n: int, n_links: int, k: int, row) -> str:
    d, t_order, t_layout, info, loc, rs = row
    return (f"{name} (n={n}, {n_links} links) at d={d}: reorder_locality "
            f"{t_order:.1f} s, locality_edge_layout {t_layout:.1f} s of host "
            f"time; internal fraction {info['internal_frac']:.4f}, boundary "
            f"rows {info['boundary_rows']} (Xmax {info['xmax']} of "
            f"{info['rows_per']} rows a rank); a sweep's collectives at "
            f"K={k} {loc / 1e9:.3f} GB a rank against row-sharded's "
            f"{rs / 1e9:.3f} GB")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="stretch", choices=sorted(GRAPHS))
    ap.add_argument("--d", default="1,2,4,8")
    ap.add_argument("--out", default=os.path.join("build", "svinet_torch"))
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines = [smi.stdout.strip() or "no nvidia-smi"]
    print(lines[0], flush=True)
    n, k = GRAPHS[args.graph]
    t0 = time.perf_counter()
    net = ingest(graph_edges(args.graph), n, k)
    lines.append(f"{args.graph}: ingest {time.perf_counter() - t0:.1f} s")
    print(lines[-1], flush=True)
    for row in time_orders(net, k, [int(d) for d in args.d.split(",")]):
        lines.append(describe(args.graph, net.n, len(net.edges), k, row))
        print(lines[-1], flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "locality_order.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
