"""Link-community extraction (svinet_tpu/svi/communities.py).

Each training link goes to its argmax-phi community when the max exceeds
link_thresh; a node joins community c when its count there exceeds
lt_min_deg (reference: src/linksampling.cc:668-681, write_communities).
The per-edge (argmax, max) pass runs on the device, blocked; the counting
is host numpy.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from svinet_torch.ops.expectations import dirichlet_expectation


def edge_assignments(gamma, lam, edges, mask):
    """Per-edge argmax_k phi and max phi for the closed-form phi
    (phi_k proportional to exp(Elogpi_p + Elogpi_q + Elogbeta_k0)),
    blocked so the (B,K) phi intermediate stays near 2^26 floats. The mask
    is applied by extract_communities; padding rows are harmless here."""
    elogpi = dirichlet_expectation(gamma)
    elb0 = dirichlet_expectation(lam)[:, 0]
    e = edges.shape[0]
    k = int(gamma.shape[1])
    block = max(1, min(e, (1 << 26) // max(k, 1)))
    am, mx = [], []
    for lo in range(0, e, block):
        blk = edges[lo:lo + block]
        phi = torch.softmax(elogpi[blk[:, 0]] + elogpi[blk[:, 1]] + elb0,
                            dim=-1)
        val, idx = phi.max(dim=-1)
        am.append(idx.to(torch.int32))
        mx.append(val)
    return torch.cat(am), torch.cat(mx)


def extract_communities(argmax: np.ndarray, maxval: np.ndarray,
                        edges: np.ndarray, mask: np.ndarray, n: int, k: int,
                        link_thresh: float, lt_min_deg: int
                        ) -> Dict[int, List[int]]:
    """Host-side counting: node joins community c when its fmap count
    exceeds lt_min_deg (a copy of svinet_tpu/svi/communities.py:61-78,
    whose package init imports JAX)."""
    sel = (maxval > link_thresh) & (mask > 0)
    arg = argmax[sel]
    p = edges[sel, 0]
    q = edges[sel, 1]
    fmap = np.zeros((n, k), np.int32)
    np.add.at(fmap, (p, arg), 1)
    np.add.at(fmap, (q, arg), 1)
    comms: Dict[int, List[int]] = {}
    nodes, cs = np.nonzero(fmap > lt_min_deg)
    for node, c in zip(nodes, cs):
        comms.setdefault(int(c), []).append(int(node))
    return comms
