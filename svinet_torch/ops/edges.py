"""Edge-array utilities: padding and blocking for the blocked edge passes
(svinet_tpu/ops/edges.py)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

# bytes one (B, K) f32 intermediate of a blocked plain pass may take
BLOCK_BUDGET_BYTES = 1 << 30


def pad_edges(edges: np.ndarray, block: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad an (E,2) edge array to a multiple of `block`.

    Pad rows point at node 0 and are masked out; every pass multiplies by
    (or skips on) the mask, so pad rows contribute exactly zero.
    Returns (padded_edges (Ep,2) int32, mask (Ep,) float32).
    """
    e = np.asarray(edges, np.int32)
    n_edges = e.shape[0]
    padded_len = max(block, ((n_edges + block - 1) // block) * block)
    out = np.zeros((padded_len, 2), np.int32)
    out[:n_edges] = e
    mask = np.zeros(padded_len, np.float32)
    mask[:n_edges] = 1.0
    return out, mask


def choose_edge_block(n_edges: int, k: int) -> int:
    """Edge-block size B for the blocked plain passes (phi, s3, the
    heldout sums' sibling passes, community assignment).

    Each block of a plain pass holds about six live (B, K) f32
    intermediates at its peak (two gathered rows, their sum with
    Elogbeta0, the softmax's exp and quotient, the masked phi handed to
    index_add_). With B*K*4 <= 1 GiB that is about 6 GiB of temporaries.
    On an 80 GB H100 the largest state this engine holds is the n=1M,
    K=500 shape: gamma, Elogpi, gacc, gnext and mphi at 2 GB each, 10 GB
    in all, so a 1 GiB intermediate leaves over 60 GB free. Larger blocks
    would not help: a block of 2^19 edges at K=500 is already far beyond
    what it takes to fill the card, so the per-block launch cost is
    amortised. The CUDA phi kernel does not block at all; it walks every
    edge in one launch and honours the mask. Small edge sets run as one
    power-of-two block (at least 64 edges), as in the JAX package.
    """
    limit = max(8192, BLOCK_BUDGET_BYTES // max(k * 4, 4))
    if n_edges <= limit:
        block = 1 << max(int(np.ceil(np.log2(max(n_edges, 1)))), 6)
        return min(block, 1 << int(np.floor(np.log2(limit))))
    return 1 << int(np.floor(np.log2(limit)))
