"""Pieces of the link-sampling sweep (svinet_tpu/svi/sweep_math.py:22-27,
46-157, without the -freeze `conv` branches).

The split mirrors the reference's phases: the per-link phi pass
(src/linksampling.cc:605-725) — kernel 2 on the card, over the symmetric
adjacency of the training links (ops/edges.py) —, the global
nonlink/mean-indicator update (src/linksampling.cc:526-545), and the s3
cross-moment pass (src/linksampling.cc:731-749). Functions of tensors;
no host state.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from svinet_torch.kernels import build
from svinet_torch.ops.edges import Adjacency, choose_edge_block


class LSConsts(NamedTuple):
    """Per-run constants, rounded to f32 as the JAX engine holds them."""
    alpha: float
    eta0: float
    eta1: float
    ones: float        # number of links in the network
    n_nodes: float     # n

    @classmethod
    def make(cls, alpha, eta0, eta1, ones, n_nodes) -> "LSConsts":
        return cls(*(float(np.float32(v))
                     for v in (alpha, eta0, eta1, ones, n_nodes)))


def edge_blocks(edges, mask, num_blocks: int):
    """(edges, mask) of each of num_blocks equal blocks of a padded edge
    set (pad_edges makes its length a multiple of the block)."""
    return zip(edges.chunk(num_blocks), mask.chunk(num_blocks))


def phi_pass_plain(elogpi, elb0, edges, mask, num_blocks: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked gather, softmax and index_add_ over (Ep,) padded edges.
    Returns (gacc (n,K): phi scattered to both endpoints,
             sumk (K,): 2 * sum of phi)."""
    n, k = elogpi.shape
    gacc = torch.zeros((n, k), dtype=torch.float32, device=elogpi.device)
    sumk = torch.zeros(k, dtype=torch.float32, device=elogpi.device)
    for blk, msk in edge_blocks(edges, mask, num_blocks):
        p, q = blk[:, 0], blk[:, 1]
        logits = elogpi[p] + elogpi[q] + elb0
        phi = torch.softmax(logits, dim=-1) * msk[:, None]
        gacc.index_add_(0, p, phi)
        gacc.index_add_(0, q, phi)
        sumk += 2.0 * phi.sum(dim=0)
    return gacc, sumk


def phi_pass_pull_plain(elogpi, elb0, adj: Adjacency, block: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The phi pass in the kernel's pull form, in plain PyTorch: walk the
    2E directed entries (owner p, neighbour q) of the adjacency in blocks
    of `block`, phi = softmax(Elogpi[p] + Elogpi[q] + Elogbeta0), and add
    phi to the owner's row only. Every link is met from both ends, so the
    column sums of all phi are already 2 * sum over links. Returns
    (gacc, sumk) as phi_pass_plain does."""
    n, k = elogpi.shape
    dev = elogpi.device
    gacc = torch.zeros((n, k), dtype=torch.float32, device=dev)
    sumk = torch.zeros(k, dtype=torch.float32, device=dev)
    rowptr = adj.rowptr.long()
    total = adj.nbr.shape[0]
    for lo in range(0, total, block):
        pos = torch.arange(lo, min(lo + block, total), device=dev)
        p = torch.searchsorted(rowptr, pos, right=True) - 1
        q = adj.nbr[pos].long()
        phi = torch.softmax(elogpi[p] + elogpi[q] + elb0, dim=-1)
        gacc.index_add_(0, p, phi)
        sumk += phi.sum(dim=0)
    return gacc, sumk


def phi_pass(elogpi, elb0, adj: Adjacency
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 2 (csrc/phi_pass.cu) on a CUDA tensor, phi_pass_pull_plain
    on a CPU tensor. Returns (gacc, sumk) as phi_pass_plain does.

    On the card one launch walks the whole adjacency: the warp (or, for
    small K, the part of a warp) that owns node p sums phi over p's
    neighbours and writes gacc[p] once, so nothing is zero-filled, no
    atomic is used and two launches give the same bits. The kernel is
    chosen by K alone:
      K <= 512: rows held in registers; 16-byte loads when K % 4 == 0,
                4-byte loads otherwise;
      K  > 512: the wide kernel, which keeps its running row in gacc
                itself and reads each neighbour row twice.
    Hub segments (adj.seg_*) are summed into a scratch buffer and
    combined in a fixed order by two further small launches, made only
    when the graph has hubs. sumk is gacc.sum(0), which equals
    2 * sum(phi) up to summation order."""
    if elogpi.device.type == "cpu":
        block = choose_edge_block(adj.nbr.shape[0], elogpi.shape[1])
        return phi_pass_pull_plain(elogpi, elb0, adj, block)
    build.require_cuda(elogpi, "phi_pass")
    dev = elogpi.device
    n, k = elogpi.shape
    n_hubs, n_segs = adj.hub_node.shape[0], adj.seg_node.shape[0]
    build.check_cuda(elogpi, "elogpi", torch.float32, (n, k), dev)
    build.check_cuda(elb0, "elb0", torch.float32, (k,), dev)
    build.check_cuda(adj.rowptr, "rowptr", torch.int32, (n + 1,), dev)
    build.check_cuda(adj.nbr, "nbr", torch.int32, adj.nbr.shape, dev)
    build.check_cuda(adj.hub_node, "hub_node", torch.int32, (n_hubs,), dev)
    build.check_cuda(adj.hub_segptr, "hub_segptr", torch.int32,
                     (n_hubs + 1,), dev)
    for name in ("seg_node", "seg_begin", "seg_end"):
        build.check_cuda(getattr(adj, name), name, torch.int32, (n_segs,),
                         dev)
    gacc = torch.empty((n, k), dtype=torch.float32, device=dev)
    partial = torch.empty((n_segs, k), dtype=torch.float32, device=dev)
    build.launch("svt_phi_pass", dev, elogpi.data_ptr(), elb0.data_ptr(),
                 *(t.data_ptr() for t in adj.tensors()), partial.data_ptr(),
                 gacc.data_ptr(), n, n_hubs, n_segs, k, adj.seg_len)
    phi_pass.launches += 1
    return gacc, gacc.sum(dim=0)


phi_pass.launches = 0


def mean_indicator_update(gacc, sumk, deg, consts: LSConsts, annealing: bool
                          ) -> Tuple[torch.Tensor, ...]:
    """Nonlink expectation correction (compute_mean_indicators).

    The reference counts each undirected link under BOTH endpoints
    (src/linksampling.cc:500-514), so the mean indicator is
    gamma_hat / (2 deg) and the nonlink factor is (n - 2 deg - 1). This
    is deliberate and load-bearing (see svinet_tpu/svi/sweep_math.py).

    gnext is built in place over gacc, which the caller must not reuse:
    at the n=1M, K=500 shape that saves one 2 GB (n,K) buffer.
    Returns (gnext, mphi, s1, s2, lam0)."""
    lam0 = consts.eta0 + sumk
    degc = 2.0 * deg[:, None]
    has_links = degc > 0
    mphi = torch.where(has_links, gacc / degc.clamp_min(1.0), 0.0)
    s1 = mphi.sum(dim=0)
    s2 = (mphi * mphi).sum(dim=0)
    gnext = gacc.add_(consts.alpha)
    gnext = torch.where(has_links,
                        gnext + (consts.n_nodes - degc - 1.0) * mphi, gnext)
    if annealing:
        scale = consts.ones / sumk.clamp_min(1e-30)
        gnext = torch.where(has_links, gnext * scale, gnext)
    return gnext, mphi, s1, s2, lam0


def s3_pass(mphi, edges, mask, num_blocks: int) -> torch.Tensor:
    """Cross-moment sum over the links: s3_k = sum_e mphi_p,k mphi_q,k,
    blocked over edges."""
    s3 = torch.zeros(mphi.shape[1], dtype=torch.float32, device=mphi.device)
    for blk, msk in edge_blocks(edges, mask, num_blocks):
        s3 += (mphi[blk[:, 0]] * mphi[blk[:, 1]] * msk[:, None]).sum(dim=0)
    return s3


def finish_lambda(s1, s2, s3, lam0, consts: LSConsts) -> torch.Tensor:
    """lambda1 = eta1 + s1^2 - s2 - s3 (src/linksampling.cc:748)."""
    lam1 = consts.eta1 + s1 * s1 - s2 - s3
    return torch.stack([lam0, lam1], dim=1)
