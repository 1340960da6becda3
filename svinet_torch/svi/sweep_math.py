"""Pieces of the link-sampling sweep (svinet_tpu/svi/sweep_math.py:22-27,
46-206, without the -freeze `conv` branches).

The split mirrors the reference's phases: the per-link phi pass
(src/linksampling.cc:605-725), the global nonlink/mean-indicator update
(src/linksampling.cc:526-545), and the s3 cross-moment pass
(src/linksampling.cc:731-749), which -fuse-s3 folds into the phi pass
with a lag of one sweep. On the card each is a hand-written kernel
(csrc/phi_pass.cu, mean_indicator.cu, s3_pass.cu); the passes over links
walk the symmetric adjacency of the training links (ops/edges.py). Each
wrapper takes its plain version for a CPU tensor and launches its kernel,
or raises, for a CUDA tensor. Functions of tensors; no host state.
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
    for p, q in _pull_entries(adj, block):
        phi = torch.softmax(elogpi[p] + elogpi[q] + elb0, dim=-1)
        gacc.index_add_(0, p, phi)
        sumk += phi.sum(dim=0)
    return gacc, sumk


def _pull_entries(adj: Adjacency, block: int):
    """(owner p, neighbour q) of the adjacency's 2E directed entries, in
    blocks of `block`, as int64 index tensors."""
    rowptr = adj.rowptr.long()
    total = adj.nbr.shape[0]
    for lo in range(0, total, block):
        pos = torch.arange(lo, min(lo + block, total), device=rowptr.device)
        yield (torch.searchsorted(rowptr, pos, right=True) - 1,
               adj.nbr[pos].long())


def _check_adjacency(adj: Adjacency, n: int, dev) -> Tuple[int, int]:
    """Refuse an adjacency the kernels do not take; returns (n_hubs,
    n_segs)."""
    n_hubs, n_segs = adj.hub_node.shape[0], adj.seg_node.shape[0]
    build.check_cuda(adj.rowptr, "rowptr", torch.int32, (n + 1,), dev)
    build.check_cuda(adj.nbr, "nbr", torch.int32, adj.nbr.shape, dev)
    build.check_cuda(adj.hub_node, "hub_node", torch.int32, (n_hubs,), dev)
    build.check_cuda(adj.hub_segptr, "hub_segptr", torch.int32,
                     (n_hubs + 1,), dev)
    for name in ("seg_node", "seg_begin", "seg_end"):
        build.check_cuda(getattr(adj, name), name, torch.int32, (n_segs,),
                         dev)
    return n_hubs, n_segs


def _reduce_scratch(k: int, dev) -> torch.Tensor:
    """The (rows, K) scratch of a kernel that sums columns across rows:
    per-block partial sums, added in a fixed order by a second launch."""
    return torch.empty((build.REDUCE_SCRATCH_ROWS, k), dtype=torch.float32,
                       device=dev)


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
    build.check_cuda(elogpi, "elogpi", torch.float32, (n, k), dev)
    build.check_cuda(elb0, "elb0", torch.float32, (k,), dev)
    n_hubs, n_segs = _check_adjacency(adj, n, dev)
    gacc = torch.empty((n, k), dtype=torch.float32, device=dev)
    partial = torch.empty((n_segs, k), dtype=torch.float32, device=dev)
    build.launch("svt_phi_pass", dev, elogpi.data_ptr(), elb0.data_ptr(),
                 *(t.data_ptr() for t in adj.tensors()), partial.data_ptr(),
                 gacc.data_ptr(), n, n_hubs, n_segs, k, adj.seg_len)
    phi_pass.launches += 1
    return gacc, gacc.sum(dim=0)


phi_pass.launches = 0


def mean_indicator_update_plain(gacc, sumk, deg, consts: LSConsts,
                                annealing: bool) -> Tuple[torch.Tensor, ...]:
    """Nonlink expectation correction (compute_mean_indicators).

    The reference counts each undirected link under BOTH endpoints
    (src/linksampling.cc:500-514), so the mean indicator is
    gamma_hat / (2 deg) and the nonlink factor is (n - 2 deg - 1). This
    is deliberate and load-bearing (see svinet_tpu/svi/sweep_math.py).
    The annealing scale ones / sumk applies only while annealing and only
    to rows with links.

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


def mean_indicator_update(gacc, sumk, deg, consts: LSConsts, annealing: bool,
                          mphi_out=None) -> Tuple[torch.Tensor, ...]:
    """Kernel 3 (csrc/mean_indicator.cu) on a CUDA tensor,
    mean_indicator_update_plain on a CPU tensor. Returns
    (gnext, mphi, s1, s2, lam0); gnext takes gacc's storage, which the
    caller must not reuse.

    On the card one launch reads gacc once and writes gnext over it and
    mphi beside it, and the column sums s1 and s2 come out of the same
    pass (per-block partial rows, added in a fixed order by two small
    launches: no atomics, the same bits every time). `mphi_out`, an (n,K)
    f32 buffer the caller no longer needs, receives mphi and is returned
    in its place, on either device (-fuse-s3 hands over the mphi of the
    sweep before)."""
    if gacc.device.type == "cpu":
        out = mean_indicator_update_plain(gacc, sumk, deg, consts, annealing)
        if mphi_out is None:
            return out
        return (out[0], mphi_out.copy_(out[1]), *out[2:])
    build.require_cuda(gacc, "mean_indicator_update")
    dev = gacc.device
    if gacc.dim() != 2:
        raise ValueError(f"gacc must be (n, k), got {tuple(gacc.shape)}")
    n, k = gacc.shape
    build.check_cuda(gacc, "gacc", torch.float32, (n, k), dev)
    build.check_cuda(sumk, "sumk", torch.float32, (k,), dev)
    build.check_cuda(deg, "deg", torch.float32, (n,), dev)
    mphi = torch.empty_like(gacc) if mphi_out is None else mphi_out
    build.check_cuda(mphi, "mphi_out", torch.float32, (n, k), dev)
    if mphi.data_ptr() == gacc.data_ptr():
        raise ValueError("mphi_out must not be gacc")
    s12 = torch.empty((2, k), dtype=torch.float32, device=dev)
    partial = _reduce_scratch(k, dev)
    build.launch("svt_mean_indicator", dev, gacc.data_ptr(), deg.data_ptr(),
                 sumk.data_ptr(), mphi.data_ptr(), partial.data_ptr(),
                 s12.data_ptr(), n, k, consts.alpha, consts.n_nodes,
                 consts.ones, int(bool(annealing)))
    mean_indicator_update.launches += 1
    return gacc, mphi, s12[0], s12[1], consts.eta0 + sumk


mean_indicator_update.launches = 0


def s3_pass_plain(mphi, edges, mask, num_blocks: int) -> torch.Tensor:
    """Cross-moment sum over the links: s3_k = sum_e mphi_p,k mphi_q,k,
    blocked over the padded edge list (the form held against the JAX
    package's s3_pass)."""
    s3 = torch.zeros(mphi.shape[1], dtype=torch.float32, device=mphi.device)
    for blk, msk in edge_blocks(edges, mask, num_blocks):
        s3 += (mphi[blk[:, 0]] * mphi[blk[:, 1]] * msk[:, None]).sum(dim=0)
    return s3


def s3_pass_pull_plain(mphi, adj: Adjacency, block: int) -> torch.Tensor:
    """s3 in the kernel's pull form, in plain PyTorch: of the adjacency's
    2E directed entries (owner p, neighbour q) keep those with q > p,
    which is every link once, and sum mphi[p] * mphi[q] over them."""
    s3 = torch.zeros(mphi.shape[1], dtype=torch.float32, device=mphi.device)
    for p, q in _pull_entries(adj, block):
        keep = q > p
        s3 += (mphi[p[keep]] * mphi[q[keep]]).sum(dim=0)
    return s3


def s3_pass(mphi, adj: Adjacency) -> torch.Tensor:
    """Kernel 4 (csrc/s3_pass.cu) on a CUDA tensor, s3_pass_pull_plain on
    a CPU tensor. Returns s3 (K,).

    On the card the owner of node p holds mphi[p] in registers and adds
    mphi[p] * mphi[q] for its neighbours q > p to running column sums, so
    every link costs one gathered row; hub segments take a second launch
    and the sums across blocks a third, without atomics. K above 512 runs
    as column tiles of 512."""
    if mphi.device.type == "cpu":
        block = choose_edge_block(adj.nbr.shape[0], mphi.shape[1])
        return s3_pass_pull_plain(mphi, adj, block)
    build.require_cuda(mphi, "s3_pass")
    dev = mphi.device
    n, k = mphi.shape
    build.check_cuda(mphi, "mphi", torch.float32, (n, k), dev)
    _, n_segs = _check_adjacency(adj, n, dev)
    s3 = torch.empty(k, dtype=torch.float32, device=dev)
    partial = _reduce_scratch(k, dev)
    build.launch("svt_s3_pass", dev, mphi.data_ptr(), adj.rowptr.data_ptr(),
                 adj.nbr.data_ptr(), adj.seg_node.data_ptr(),
                 adj.seg_begin.data_ptr(), adj.seg_end.data_ptr(),
                 partial.data_ptr(), s3.data_ptr(), n, n_segs, k,
                 adj.seg_len)
    s3_pass.launches += 1
    return s3


s3_pass.launches = 0


def fused_phi_s3_pass_plain(packed, elb0, edges, mask, num_blocks: int
                            ) -> Tuple[torch.Tensor, ...]:
    """phi_pass_plain and s3_pass_plain in one walk of the padded edge
    list over packed (n, 2K) rows [Elogpi | mphi_prev], with the JAX
    package's signature (svinet_tpu/svi/sweep_math.py:160-206).
    Returns (gacc (n,K), sumk (K,), s3 (K,))."""
    n, k2 = packed.shape
    k = k2 // 2
    gacc = torch.zeros((n, k), dtype=torch.float32, device=packed.device)
    sumk = torch.zeros(k, dtype=torch.float32, device=packed.device)
    s3 = torch.zeros(k, dtype=torch.float32, device=packed.device)
    for blk, msk in edge_blocks(edges, mask, num_blocks):
        p, q = blk[:, 0], blk[:, 1]
        rp, rq = packed[p], packed[q]
        phi = torch.softmax(rp[:, :k] + rq[:, :k] + elb0, dim=-1) * msk[:, None]
        gacc.index_add_(0, p, phi)
        gacc.index_add_(0, q, phi)
        sumk += 2.0 * phi.sum(dim=0)
        s3 += (rp[:, k:] * rq[:, k:] * msk[:, None]).sum(dim=0)
    return gacc, sumk, s3


def fused_phi_s3_pass_pull_plain(elogpi, mphi_prev, elb0, adj: Adjacency,
                                 block: int) -> Tuple[torch.Tensor, ...]:
    """The fused pass in the kernel's pull form, in plain PyTorch: one walk
    of the adjacency's 2E directed entries gives phi to the owner's row
    (phi_pass_pull_plain) and, from the entries with q > p, the
    cross-moment of mphi_prev (s3_pass_pull_plain). Elogpi and mphi_prev
    stay two arrays. Returns (gacc, sumk, s3)."""
    n, k = elogpi.shape
    dev = elogpi.device
    gacc = torch.zeros((n, k), dtype=torch.float32, device=dev)
    sumk = torch.zeros(k, dtype=torch.float32, device=dev)
    s3 = torch.zeros(k, dtype=torch.float32, device=dev)
    for p, q in _pull_entries(adj, block):
        phi = torch.softmax(elogpi[p] + elogpi[q] + elb0, dim=-1)
        gacc.index_add_(0, p, phi)
        sumk += phi.sum(dim=0)
        keep = q > p
        s3 += (mphi_prev[p[keep]] * mphi_prev[q[keep]]).sum(dim=0)
    return gacc, sumk, s3


# Most gathered floats (directed adjacency entries times K) at which
# -fuse-s3 takes the one fused launch. Kernel 5 reads the same rows as
# kernel 2 followed by kernel 4, so all it can win is the second walk of
# the adjacency and its launches, about 14 us a sweep; it pays for that
# with three more rows in registers and fewer warps per SM. On an H100
# 80GB HBM3 at 700 W (tools/bench_kernels.py) it wins where the pass is
# launch-sized, 0.078 against 0.102 ms at n=20k, K=20, 200k links (8.0e6
# floats), wins or draws level at n=50k, K=20, 500k links (2.0e7 floats:
# 0.103 against 0.105 ms in one call, 0.105 against 0.140 in another), and
# from there on loses: 0.175 against 0.171 ms at
# n=100k, K=20, 1M links (4.0e7), 0.504 against 0.440 at n=300k, K=20, 3M
# links (1.2e8), 0.644 against 0.416 at n=20k, K=500, 200k links (2.0e8),
# 1.90 against 1.64 at n=1M, K=20, 10M links (4.0e8), and 55.0 against
# 46.0 ms at K=500 with 20M links. The limit is the largest measured size
# at which the one launch was not the slower.
FUSED_MAX_WORK = 20_000_000
# widest row csrc/phi_pass.cu's register kernel holds (common.cuh kRegMaxK)
FUSED_MAX_K = 512


def fused_takes_one_launch(k: int, n_entries: int) -> bool:
    """Whether the fused pass over an adjacency of n_entries directed
    entries at width k is kernel 5 (True) or kernel 2 then kernel 4."""
    return k <= FUSED_MAX_K and n_entries * k <= FUSED_MAX_WORK


def fused_phi_s3_pass(elogpi, mphi_prev, elb0, adj: Adjacency,
                      one_launch=None) -> Tuple[torch.Tensor, ...]:
    """The phi pass and the cross-moment of the mean indicators of the
    sweep before (-fuse-s3). Returns (gacc, sumk, s3) as
    fused_phi_s3_pass_plain does; fused_phi_s3_pass_pull_plain on a CPU
    tensor.

    The JAX package packs [Elogpi | mphi_prev] into (n, 2K) rows; here the
    two stay apart, which saves the concatenation and lets the kernel read
    mphi_prev[q] only for q > p. On the card this is either kernel 5, one
    launch of csrc/phi_pass.cu's register kernel with its fused flag (hub
    segments and the sums across blocks take further small launches), or
    kernel 2 followed by kernel 4 on mphi_prev: both hand kernels, the
    same result. Which one runs is decided by what was measured (see
    FUSED_MAX_WORK): kernel 5 when the pass is small enough to be bound by
    its launches and K <= 512, the two kernels otherwise. `one_launch`
    overrides the choice, for timing the two beside each other."""
    if elogpi.device.type == "cpu":
        block = choose_edge_block(adj.nbr.shape[0], elogpi.shape[1])
        return fused_phi_s3_pass_pull_plain(elogpi, mphi_prev, elb0, adj,
                                            block)
    build.require_cuda(elogpi, "fused_phi_s3_pass")
    dev = elogpi.device
    n, k = elogpi.shape
    if one_launch is None:
        one_launch = fused_takes_one_launch(k, adj.nbr.shape[0])
    elif one_launch and k > FUSED_MAX_K:
        raise ValueError(f"kernel 5 holds rows of at most {FUSED_MAX_K} "
                         f"columns, got K={k}")
    if not one_launch:
        gacc, sumk = phi_pass(elogpi, elb0, adj)
        return gacc, sumk, s3_pass(mphi_prev, adj)
    build.check_cuda(elogpi, "elogpi", torch.float32, (n, k), dev)
    build.check_cuda(mphi_prev, "mphi_prev", torch.float32, (n, k), dev)
    build.check_cuda(elb0, "elb0", torch.float32, (k,), dev)
    n_hubs, n_segs = _check_adjacency(adj, n, dev)
    gacc = torch.empty((n, k), dtype=torch.float32, device=dev)
    partial = torch.empty((n_segs, k), dtype=torch.float32, device=dev)
    s3 = torch.empty(k, dtype=torch.float32, device=dev)
    s3_partial = _reduce_scratch(k, dev)
    build.launch("svt_phi_s3_pass", dev, elogpi.data_ptr(),
                 mphi_prev.data_ptr(), elb0.data_ptr(),
                 *(t.data_ptr() for t in adj.tensors()), partial.data_ptr(),
                 gacc.data_ptr(), s3_partial.data_ptr(), s3.data_ptr(), n,
                 n_hubs, n_segs, k, adj.seg_len)
    fused_phi_s3_pass.launches += 1
    return gacc, gacc.sum(dim=0), s3


fused_phi_s3_pass.launches = 0


def finish_lambda(s1, s2, s3, lam0, consts: LSConsts) -> torch.Tensor:
    """lambda1 = eta1 + s1^2 - s2 - s3 (src/linksampling.cc:748)."""
    lam1 = consts.eta1 + s1 * s1 - s2 - s3
    return torch.stack([lam0, lam1], dim=1)
