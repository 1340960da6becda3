"""Edge-array utilities: padding and blocking for the blocked edge passes
(svinet_tpu/ops/edges.py), and the adjacency the phi and s3 kernels
walk."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

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
    amortised. The CUDA phi kernel does not block at all; it walks the
    whole adjacency in one launch. Small edge sets run as one
    power-of-two block (at least 64 edges), as in the JAX package.
    """
    limit = max(8192, BLOCK_BUDGET_BYTES // max(k * 4, 4))
    if n_edges <= limit:
        block = 1 << max(int(np.ceil(np.log2(max(n_edges, 1)))), 6)
        return min(block, 1 << int(np.floor(np.log2(limit))))
    return 1 << int(np.floor(np.log2(limit)))


# Longest adjacency list one warp of the phi and s3 kernels walks. A node with
# more neighbours (a hub) is cut into segments of this length, so its work
# spreads over many warps instead of serialising on one.
SEG_LEN = 256


class Adjacency(NamedTuple):
    """Symmetric CSR of the real training links, the input of the phi
    pass, the s3 pass and the fused pass.

    Every link (p, q) appears twice: q in p's list and p in q's. Padding
    rows of the padded edge arrays are absent, so no mask is needed, and a
    node without links has an empty list. Nodes with more than `seg_len`
    neighbours are hubs: their lists are cut into segments of at most
    `seg_len` entries, each summed into its own row of a scratch buffer
    and combined in segment order. All index tensors are int32.
    """
    rowptr: torch.Tensor      # (n+1,) node p lists nbr[rowptr[p]:rowptr[p+1]]
    nbr: torch.Tensor         # (2E,) neighbours, ascending within a list
    hub_node: torch.Tensor    # (H,) nodes with more than seg_len neighbours
    hub_segptr: torch.Tensor  # (H+1,) hub h owns segments [h]:[h+1] of it
    seg_node: torch.Tensor    # (S,) the hub node of each segment
    seg_begin: torch.Tensor   # (S,) segment s is nbr[seg_begin[s]:seg_end[s]]
    seg_end: torch.Tensor     # (S,)
    seg_len: int

    @property
    def n(self) -> int:
        return self.rowptr.shape[0] - 1

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        return self[:7]


def build_adjacency(links, n: int, device="cpu",
                    seg_len: int = SEG_LEN) -> Adjacency:
    """Adjacency of the (E,2) real links over n nodes, built on `device`
    (one sort of the 2E directed entries; runs on the CPU too)."""
    if seg_len < 1:
        raise ValueError(f"seg_len must be positive, got {seg_len}")
    e = torch.as_tensor(np.asarray(links, np.int64), device=device)
    e = e.reshape(-1, 2)
    if 2 * e.shape[0] >= 2**31:
        raise ValueError(f"{e.shape[0]} links: the adjacency indexes its "
                         f"2E entries with int32")
    if e.numel() and (int(e.min()) < 0 or int(e.max()) >= n):
        raise ValueError(f"link endpoints must lie in [0, {n})")
    # owner-major, neighbour-minor order through one sort of owner*n + nbr
    key = torch.cat([e[:, 0] * n + e[:, 1], e[:, 1] * n + e[:, 0]])
    key = torch.sort(key).values
    owner = key // n
    return segmented_csr(owner, (key - owner * n).to(torch.int32), n,
                         seg_len)


def owner_csr(owner, n: int, seg_len: int = SEG_LEN) -> Adjacency:
    """The Adjacency of entries 0..m-1, entry j owned by node owner[j]:
    node p lists its entries in ascending order (one stable sort on
    owner's device). Kernel 8 walks the pairs' endpoints this way (owner
    pairs.reshape(-1): slot 2i is pair i's phi1, 2i + 1 its phi2), kernel 9
    the links by their first end (owner edges[:, 0])."""
    owner = owner.long()
    order = torch.sort(owner, stable=True).indices
    return segmented_csr(owner[order], order.to(torch.int32), n, seg_len)


def segmented_csr(owner, nbr, n: int, seg_len: int = SEG_LEN) -> Adjacency:
    """The Adjacency of entries already sorted by owner: entry j, owned by
    owner[j] (int64, ascending), lists nbr[j] (int32). Owners with more
    than seg_len entries are cut into segments."""
    if seg_len < 1:
        raise ValueError(f"seg_len must be positive, got {seg_len}")
    device = owner.device
    i32 = dict(dtype=torch.int32, device=device)
    deg = torch.bincount(owner, minlength=n)
    rowptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(deg, 0, out=rowptr[1:])

    hub_node = torch.nonzero(deg > seg_len).flatten()
    nseg = (deg[hub_node] + seg_len - 1) // seg_len
    hub_segptr = torch.zeros(len(hub_node) + 1, dtype=torch.int64,
                             device=device)
    torch.cumsum(nseg, 0, out=hub_segptr[1:])
    seg_hub = torch.repeat_interleave(
        torch.arange(len(hub_node), device=device), nseg)
    seg_node = hub_node[seg_hub]
    within = torch.arange(len(seg_hub), device=device) - hub_segptr[seg_hub]
    seg_begin = rowptr[seg_node] + within * seg_len
    seg_end = torch.minimum(seg_begin + seg_len, rowptr[seg_node + 1])
    return Adjacency(rowptr.to(**i32), nbr, hub_node.to(**i32),
                     hub_segptr.to(**i32), seg_node.to(**i32),
                     seg_begin.to(**i32), seg_end.to(**i32), seg_len)
