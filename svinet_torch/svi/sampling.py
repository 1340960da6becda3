"""Vectorized non-informative ("ring") nonlink samplers.

The reference's non-informative steps walk a shuffled-node ring one node
at a time, testing each candidate against the graph until `want`
survivors are collected (FastAMM::opt_process_noninf,
reference: src/fastamm.cc:1051-1126; FastAMM2 at src/fastamm2.cc:1101;
SBM's stochastic step draws random nodes instead, src/sbm.cc:545-588).
One-at-a-time `y()` probes are fine at n=75 but are 100k Python
round-trips per iteration at the n=1M design scale of these engines.

Here the scan is batched: grab a chunk of consecutive ring entries,
filter it with the vectorized `Network.y()` / `edge_ok_mask`, keep the
first `want` survivors IN RING ORDER — exactly the set the scalar walk
picks (the scalar loop stops at `want`; the batch loop truncates to the
same first-`want` prefix), at numpy speed.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def ring_nonlink_scan(shuffled: np.ndarray, n: int, start: int,
                      want: int, accept: Callable[[np.ndarray], np.ndarray],
                      max_scan: Optional[int] = None,
                      batch: int = 8192) -> np.ndarray:
    """First `want` ring entries (scanning `shuffled` from `start`,
    wrapping) for which accept(candidates) is True. accept receives a
    candidate node array and returns a boolean mask. Scans at most
    `max_scan` entries (default 4n, the reference's bound,
    src/fastamm.cc:1062)."""
    if max_scan is None:
        max_scan = 4 * n
    picked = []
    got = 0
    q = start
    scanned = 0
    while got < want and scanned < max_scan:
        m = min(max(batch, 2 * (want - got)), max_scan - scanned)
        cand = shuffled[np.arange(q, q + m) % n]
        q += m
        scanned += m
        good = cand[accept(cand)]
        if len(good):
            picked.append(good)
            got += len(good)
    if not picked:
        return np.empty(0, np.int64)
    return np.concatenate(picked)[:want].astype(np.int64)


def nonlink_accept(network, r: int, reject_sorted: Optional[np.ndarray],
                   require_edge_ok: bool) -> Callable[[np.ndarray], np.ndarray]:
    """accept() for the ring scan: candidate != r, not in reject_sorted
    (a SORTED id array, e.g. r's informative-zero set), y(r, c) == 0,
    and optionally not in a heldout split."""
    def accept(cand: np.ndarray) -> np.ndarray:
        ok = cand != r
        if reject_sorted is not None and len(reject_sorted):
            idx = np.clip(np.searchsorted(reject_sorted, cand), 0,
                          len(reject_sorted) - 1)
            ok &= reject_sorted[idx] != cand
        lo = np.minimum(r, cand)
        hi = np.maximum(r, cand)
        ok &= network.y(lo, hi) == 0
        if require_edge_ok:
            ok &= network.edge_ok_mask(lo, hi)
        return ok
    return accept


def random_nonlink_draws(rng: np.random.Generator, network, n: int, r: int,
                         want: int, reject_sorted: Optional[np.ndarray],
                         max_tries: int, batch: int = 4096,
                         require_edge_ok: bool = True) -> np.ndarray:
    """SBM's stochastic variant: uniform random candidate draws instead
    of a ring walk (reference: src/sbm.cc:700-760), batched the same
    way. Survivor criteria: != r, not in reject_sorted, y == 0, and (by
    default) edge_ok — the reference tests edge_ok DURING the draw
    (src/sbm.cc:757 `if (y == 0 && edge_ok(e))`) and keeps drawing until
    `want` valid pairs; filtering after truncation instead yields
    systematically undersized samples on small graphs."""
    accept = nonlink_accept(network, r, reject_sorted,
                            require_edge_ok=require_edge_ok)
    picked = []
    got = 0
    tries = 0
    while got < want and tries < max_tries:
        m = min(max(batch, 2 * (want - got)), max_tries - tries)
        cand = rng.integers(0, n, size=m)
        tries += m
        good = cand[accept(cand)]
        if len(good):
            picked.append(good)
            got += len(good)
    if not picked:
        return np.empty(0, np.int64)
    return np.concatenate(picked)[:want].astype(np.int64)
