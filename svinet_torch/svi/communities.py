"""Link-community extraction (svinet_tpu/svi/communities.py).

Each training link goes to its argmax-phi community when the max exceeds
link_thresh; a node joins community c when its count there exceeds
lt_min_deg (reference: src/linksampling.cc:668-681, write_communities).
The per-link (argmax, max) is kernel 9 (csrc/edge_assign.cu) on the card
and the plain version below on the CPU; the counting runs where the
assignments are, as one sort of (node, community) keys, and only the
memberships cross to the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from svinet_torch.kernels import build
from svinet_torch.ops.edges import Adjacency, owner_csr
from svinet_torch.ops.expectations import dirichlet_expectation


def edge_assignments_plain(elogpi, elb0, edges) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """Per-link argmax_k phi (first among equal values) and max phi for
    phi = softmax(Elogpi[p] + Elogpi[q] + Elogbeta[:, 0]), blocked so the
    (B,K) phi intermediate stays near 2^26 floats."""
    e = edges.shape[0]
    k = int(elogpi.shape[1])
    block = max(1, min(e, (1 << 26) // max(k, 1)))
    am, mx = [], []
    for lo in range(0, e, block):
        blk = edges[lo:lo + block].long()
        phi = torch.softmax(elogpi[blk[:, 0]] + elogpi[blk[:, 1]] + elb0,
                            dim=-1)
        val, idx = phi.max(dim=-1)
        am.append(idx.to(torch.int32))
        mx.append(val)
    if not am:
        return (torch.zeros(0, dtype=torch.int32, device=edges.device),
                torch.zeros(0, dtype=torch.float32, device=edges.device))
    return torch.cat(am), torch.cat(mx)


def edge_assignments(gamma, lam, edges, mask=None,
                     csr: Optional[Adjacency] = None):
    """Kernel 9 on a CUDA tensor, edge_assignments_plain on a CPU tensor:
    (argmax (E,) int32, max phi (E,) f32) for every row of `edges`
    (padding rows included; extract_communities applies the mask). `csr`
    is owner_csr(edges[:, 0], n), the links by their first end, made here
    when not given; an engine builds it once for its fixed links. Elogpi
    and Elogbeta come from kernel 1 on the card."""
    elogpi = dirichlet_expectation(gamma)
    elb0 = dirichlet_expectation(lam)[:, 0].contiguous()
    if gamma.device.type == "cpu":
        return edge_assignments_plain(elogpi, elb0, edges)
    build.require_cuda(gamma, "edge_assignments")
    dev = gamma.device
    n, k = elogpi.shape
    edges = edges.to(torch.int32).contiguous()
    e = edges.shape[0]
    build.check_cuda(edges, "edges", torch.int32, (e, 2), dev)
    if csr is None:
        csr = owner_csr(edges[:, 0], n)
    if csr.nbr.shape[0] != e or csr.n != n:
        raise ValueError("csr is not the assignment CSR of these edges")
    argmax = torch.empty(e, dtype=torch.int32, device=dev)
    maxval = torch.empty(e, dtype=torch.float32, device=dev)
    build.launch("svt_edge_assign", dev, elogpi.data_ptr(), elb0.data_ptr(),
                 edges.data_ptr(), csr.rowptr.data_ptr(),
                 csr.nbr.data_ptr(), csr.seg_node.data_ptr(),
                 csr.seg_begin.data_ptr(), csr.seg_end.data_ptr(),
                 argmax.data_ptr(), maxval.data_ptr(), n,
                 csr.seg_node.shape[0], k, csr.seg_len)
    build.count_launch(edge_assignments, "f32")
    return argmax, maxval


edge_assignments.launches = 0
edge_assignments.forms = {}


def extract_communities(argmax, maxval, edges, mask, n: int, k: int,
                        link_thresh: float, lt_min_deg: int
                        ) -> Dict[int, np.ndarray]:
    """{community: its nodes, ascending, as an int64 array}, in ascending
    community order: a node joins c when more than lt_min_deg of its links
    above link_thresh have argmax c (the counting of
    svinet_tpu/svi/communities.py:61-78, which gives lists). Counted where
    the tensors are (torch tensors or numpy arrays), by one unique over
    node * k + c keys: no (n, K) count matrix is made, and only the
    memberships cross to the host."""
    argmax, maxval, edges, mask = (torch.as_tensor(a) for a in
                                   (argmax, maxval, edges, mask))
    sel = (maxval > link_thresh) & (mask > 0)
    arg = argmax[sel].long()
    keys = torch.cat([edges[sel, 0].long() * k + arg,
                      edges[sel, 1].long() * k + arg])
    uniq, counts = torch.unique(keys, return_counts=True)
    kept = uniq[counts > lt_min_deg].cpu().numpy()
    nodes, cols = kept // k, kept % k
    order = np.argsort(cols, kind="stable")
    cs, starts = np.unique(cols[order], return_index=True)
    return dict(zip(cs.tolist(), np.split(nodes[order], starts[1:])))
