"""Synthetic graphs made from a seed, for tests and the chip smoke run.

planted_blocks: a planted disjoint-community graph with its ground-truth
cover, the kind of graph whose communities the engine should recover.
random_edges: uniform random edges, the edge set of the n=1M/K=500
stretch shape (bench.py:synth_main).
tied_topw_state: a sparse top-W state whose links tie exactly between two
communities, for the first-slot rule of the edge assignments.
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


# the tied communities' values (TIE_VALUES in p's row, swapped in q's;
# TIE_SELF twice in a row paired with itself), every other top value, and
# each row's rest: all dyadic, so that every row's total is exact in any
# order of summation
TIE_VALUES = (7.0, 9.0)
TIE_SELF = 8.0
TIE_OTHER = 0.25
TIE_REST = 0.5


def tied_topw_state(seed: int, k: int, w: int, n_tied: int, n_self: int):
    """A top-W state (svinet_tpu/ops/sparse_gamma.py) and links whose two
    largest closed-form phis are equal to the bit, on any digamma:
    communities 2j and 2j + 1 share a row of lambda (so Elogbeta too);
    n_tied links (p, q) hold one such pair of communities at random
    places, p at TIE_VALUES and q at the same values swapped, and n_self
    rows hold one at TIE_SELF twice, each linked to itself. The rows'
    totals are equal and exact, and psi(7), psi(9) lie within a factor 2
    of psi(total) up to W = 64, so psi(g) - psi(total) is exact and both
    tied logits are one rounding of the same sum. Only the first-slot
    rule of the argmax (the JAX argmax's) names the community: the one
    at the lower place in p's row. Returns numpy (ids (n, W) int32, vals
    (n, W) f32, rest (n,) f32, lam (K, 2) f32, links (n_tied + n_self, 2)
    int32), n = 2 n_tied + n_self; each tied link's ends in random
    order."""
    if w < 2 or k < w + 2 or k % 2:
        raise ValueError("tied_topw_state takes 2 <= W <= K - 2, K even")
    rng = np.random.default_rng(seed)
    lam = np.repeat(rng.uniform(1.0, 20.0, (k // 2, 2)), 2,
                    axis=0).astype(np.float32)
    n = 2 * n_tied + n_self
    ids = np.empty((n, w), np.int32)
    vals = np.full((n, w), TIE_OTHER, np.float32)
    rest = np.full(n, TIE_REST, np.float32)
    everyone = np.arange(k)

    def row(r, pair, values):
        others = rng.choice(np.setdiff1d(everyone, pair), w - 2,
                            replace=False)
        at = rng.permutation(w)
        ids[r, at] = np.r_[pair, others]
        vals[r, at[:2]] = values

    for i in range(n_tied):
        pair = 2 * rng.integers(k // 2) + np.arange(2)
        row(2 * i, pair, TIE_VALUES)
        row(2 * i + 1, pair, TIE_VALUES[::-1])
    for r in range(2 * n_tied, n):
        row(r, 2 * rng.integers(k // 2) + np.arange(2), (TIE_SELF, TIE_SELF))
    links = np.concatenate([np.arange(2 * n_tied).reshape(-1, 2),
                            np.repeat(np.arange(2 * n_tied, n), 2
                                      ).reshape(-1, 2)])
    flip = rng.random(n_tied) < 0.5
    links[:n_tied][flip] = links[:n_tied][flip, ::-1]
    return ids, vals, rest, lam, links.astype(np.int32)


def nan_topw_state(seed: int, k: int, w: int, n_links: int, n_rows: int):
    """A top-W state whose links' closed-form phis are all NaN: link i
    joins rows 2i and 2i + 1, whose communities are disjoint and whose
    rests are 0, so every logit takes psi(0) = -inf at the other row's
    tail and the softmax of the row is NaN; the argmax (torch's and jnp's)
    then names the link's first slot, p's first community. Rows past 2
    n_links hold random communities and no link. Returns numpy (ids
    (n_rows, W) int32, vals (n_rows, W) f32, rest (n_rows,) f32, lam (K, 2)
    f32, links (n_links, 2) int32)."""
    if k < 2 * w or n_rows < 2 * n_links:
        raise ValueError("nan_topw_state takes K >= 2W, n_rows >= 2 links")
    rng = np.random.default_rng(seed)
    lam = rng.uniform(1.0, 20.0, (k, 2)).astype(np.float32)
    ids = np.argsort(rng.random((n_rows, k)), 1)[:, :w].astype(np.int32)
    pairs = np.argsort(rng.random((n_links, k)), 1)[:, :2 * w]
    ids[:2 * n_links] = pairs.reshape(2 * n_links, w)
    vals = rng.uniform(0.5, 5.0, (n_rows, w)).astype(np.float32)
    rest = np.zeros(n_rows, np.float32)
    links = np.arange(2 * n_links, dtype=np.int32).reshape(-1, 2)
    return ids, vals, rest, lam, links
