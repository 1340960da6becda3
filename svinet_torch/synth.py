"""Synthetic graphs made from a seed, for tests and the chip smoke run.

planted_blocks: a planted disjoint-community graph with its ground-truth
cover, the kind of graph whose communities the engine should recover.
random_edges: uniform random edges, the edge set of the n=1M/K=500
stretch shape (bench.py:synth_main).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

NOISE = 0.05   # share of planted-graph links that cross blocks


def planted_blocks(n: int, k: int, avg_deg: float, seed: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Nodes 0..n-1 split into k equal contiguous blocks; each node draws
    about avg_deg/2 partners, a fraction NOISE of them anywhere in the
    graph and the rest in its own block. Returns (edges (E,2) int64 with
    duplicates and self loops possible, as in a raw edge list;
    membership (n,) block ids)."""
    rng = np.random.default_rng(seed)
    size = n // k
    member = np.minimum(np.arange(n) // size, k - 1)
    m = int(n * avg_deg / 2)
    src = rng.integers(0, n, size=m)
    block = member[src]
    lo = block * size
    hi = np.where(block == k - 1, n, lo + size)
    dst = lo + (rng.random(m) * (hi - lo)).astype(np.int64)
    anywhere = rng.random(m) < NOISE
    dst[anywhere] = rng.integers(0, n, size=int(anywhere.sum()))
    return np.stack([src, dst], 1), member


def write_planted(dirname: str, n: int, k: int, avg_deg: float, seed: int
                  ) -> Tuple[str, str]:
    """Write a planted graph as an edge list plus its ground-truth cover
    ("node<TAB>community" rows); returns (network path, cover path)."""
    edges, member = planted_blocks(n, k, avg_deg, seed)
    net = os.path.join(dirname, f"planted-n{n}-k{k}.txt")
    gt = os.path.join(dirname, f"planted-n{n}-k{k}-gt.txt")
    np.savetxt(net, edges, fmt="%d", delimiter="\t")
    np.savetxt(gt, np.stack([np.arange(n), member], 1), fmt="%d",
               delimiter="\t")
    return net, gt


def random_edges(n: int, n_edges: int, seed: int = 0) -> np.ndarray:
    """Uniform random (p < q) pairs of distinct nodes. bench.py:38-41
    maps q <= p to p + 1, which repeats the n - 1 pairs (p, p + 1) for
    about half the draws, so ingest would keep only ~55% of them; here
    every draw is a uniform pair and ingest keeps nearly all."""
    rng = np.random.default_rng(seed)
    p = rng.integers(0, n, size=n_edges)
    q = rng.integers(0, n - 1, size=n_edges)
    q = q + (q >= p)
    return np.stack([np.minimum(p, q), np.maximum(p, q)], 1).astype(np.int32)
