"""Pieces of the link-sampling sweep (svinet_tpu/svi/sweep_math.py:22-206,
with the -freeze `conv` branches and the -bf16 rows).

The split mirrors the reference's phases: the per-link phi pass
(src/linksampling.cc:605-725), the global nonlink/mean-indicator update
(src/linksampling.cc:526-545), and the s3 cross-moment pass
(src/linksampling.cc:731-749), which -fuse-s3 folds into the phi pass
with a lag of one sweep. On the card each is a hand-written kernel
(csrc/phi_pass.cu, mean_indicator.cu, s3_pass.cu); the passes over links
walk the symmetric adjacency of the training links (ops/edges.py). Each
wrapper takes its plain version for a CPU tensor and launches its kernel,
or raises, for a CUDA tensor. Functions of tensors; no host state.

Two things change what the passes over links read. -bf16: Elogpi and mphi
may be stored as bfloat16 rows; every pass widens what it gathered to f32
and sums in f32, so a pass given bf16 rows equals the same pass given
those values as f32. -freeze: `conv` (n,) int32 holds 0 for a free node
and, for a node frozen to column c, c + 1; a link with exactly one frozen
end gives the one-hot of that column in place of its phi, and to s3 only
the free end's mphi at that column.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from svinet_torch.kernels import build
from svinet_torch.ops.digamma import (
    dirichlet_expectation, dirichlet_expectation_topw)
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


def converged_of(gamma, alpha: float, prev=None) -> torch.Tensor:
    """Per-node convergence flag (svinet_tpu/svi/sweep_math.py:30-43): a
    node with exactly one community where gamma - alpha >= 1 is frozen to
    it. Returns int32 (n,): 0 = not converged, else community index + 1.
    The flags are sticky: with `prev`, a node whose count is not 1 keeps
    the flag it had. Plain PyTorch; on the card the sweep gets the same
    flags from kernel 3 (mean_indicator_update with `conv`)."""
    active = gamma - alpha >= 1.0
    count = active.sum(dim=-1)
    first = active.to(torch.int8).argmax(dim=-1).to(torch.int32)
    fresh = torch.where(count == 1, first + 1, 0).to(torch.int32)
    return fresh if prev is None else torch.where(count == 1, fresh, prev)


def _one_sided(conv, p, q, k: int):
    """For the pairs (p, q): whether exactly one end is frozen, the one-hot
    (B, K) of the frozen column max(cp, cq) - 1, and whether p is frozen."""
    cp, cq = conv[p], conv[q]
    column = (torch.maximum(cp, cq) - 1).clamp_min(0).long()
    return ((cp > 0) ^ (cq > 0))[:, None], F.one_hot(column, k).float(), cp > 0


def _phi_of(elogpi, elb0, p, q, conv) -> torch.Tensor:
    """phi (B, K) of the pairs (p, q): the softmax of the two gathered rows
    (f32 or bf16, widened after the gather) plus Elogbeta0; the frozen
    column's one-hot where `conv` marks exactly one end frozen."""
    phi = torch.softmax(elogpi[p].float() + elogpi[q].float() + elb0, dim=-1)
    if conv is not None:
        one_sided, hard, _ = _one_sided(conv, p, q, phi.shape[1])
        phi = torch.where(one_sided, hard, phi)
    return phi


def _s3_of(mphi, p, q, conv) -> torch.Tensor:
    """The pairs' contributions (B, K) to s3: mphi[p] * mphi[q]; where
    `conv` marks exactly one end frozen, the free end's mphi at the frozen
    column and 0 elsewhere (the column itself, not the one after it:
    svinet_tpu/svi/sweep_math.py:117-129)."""
    mp, mq = mphi[p].float(), mphi[q].float()
    contrib = mp * mq
    if conv is not None:
        one_sided, hard, p_frozen = _one_sided(conv, p, q, mp.shape[1])
        free_end = torch.where(p_frozen[:, None], mq, mp)
        contrib = torch.where(one_sided, hard * free_end, contrib)
    return contrib


def phi_pass_plain(elogpi, elb0, edges, mask, num_blocks: int, conv=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked gather, softmax and index_add_ over (Ep,) padded edges.
    Returns (gacc (n,K): phi scattered to both endpoints,
             sumk (K,): 2 * sum of phi)."""
    n, k = elogpi.shape
    gacc = torch.zeros((n, k), dtype=torch.float32, device=elogpi.device)
    sumk = torch.zeros(k, dtype=torch.float32, device=elogpi.device)
    for blk, msk in edge_blocks(edges, mask, num_blocks):
        p, q = blk[:, 0], blk[:, 1]
        phi = _phi_of(elogpi, elb0, p, q, conv) * msk[:, None]
        gacc.index_add_(0, p, phi)
        gacc.index_add_(0, q, phi)
        sumk += 2.0 * phi.sum(dim=0)
    return gacc, sumk


def phi_pass_pull_plain(elogpi, elb0, adj: Adjacency, block: int, conv=None
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
        phi = _phi_of(elogpi, elb0, p, q, conv)
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


ROW_DTYPES = (torch.float32, torch.bfloat16)
# widest row the kernels hold in registers (csrc/common.cuh kRegMaxK); wider
# rows take a wide kernel (kernel 2) or column tiles (kernels 3 and 4)
REG_MAX_K = 512


def _check_rows(t, name: str, shape, dev) -> bool:
    """Refuse gathered rows that are neither f32 nor bf16; returns whether
    they are bf16."""
    if t.dtype not in ROW_DTYPES:
        raise TypeError(f"{name} has dtype {t.dtype}, expected float32 or "
                        f"bfloat16")
    build.check_cuda(t, name, t.dtype, shape, dev)
    return t.dtype == torch.bfloat16


def _form(bf16: bool, conv) -> str:
    """The name a launch is counted under: the row type, and whether the
    -freeze form ran."""
    return ("bf16" if bf16 else "f32") + ("" if conv is None else "+conv")


def _conv_ptr(conv, n: int, dev) -> Optional[int]:
    """The pointer a kernel takes for `conv`: null without -freeze."""
    if conv is None:
        return None
    build.check_cuda(conv, "conv", torch.int32, (n,), dev)
    return conv.data_ptr()


def phi_pass(elogpi, elb0, adj: Adjacency, conv=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 2 (csrc/phi_pass.cu) on a CUDA tensor, phi_pass_pull_plain
    on a CPU tensor. Returns (gacc, sumk) as phi_pass_plain does. elogpi
    is f32 or bf16 (both the owner's and the neighbour's row are gathered
    from it); conv is None or the (n,) int32 converged flags.

    On the card one launch walks the whole adjacency: the warp (or, for
    small K, the part of a warp) that owns node p sums phi over p's
    neighbours and writes gacc[p] once, so nothing is zero-filled, no
    atomic is used and two launches give the same bits. The kernel is
    chosen by K alone:
      K <= 512: rows held in registers; one load per four values when
                K % 4 == 0 (16 bytes of f32, 8 of bf16), one per value
                otherwise;
      K  > 512: the wide kernel, which keeps its running row in gacc
                itself and reads each neighbour row twice.
    With conv, a link with exactly one frozen end fetches no row. Hub
    segments (adj.seg_*) are summed into a scratch buffer and combined in
    a fixed order by two further small launches, made only when the graph
    has hubs. sumk, the column sums of the rows written (2 * sum(phi) up
    to summation order), comes from the same launches: per-block partial
    rows, added in a fixed order by one more small launch."""
    if elogpi.device.type == "cpu":
        block = choose_edge_block(adj.nbr.shape[0], elogpi.shape[1])
        return phi_pass_pull_plain(elogpi, elb0, adj, block, conv)
    build.require_cuda(elogpi, "phi_pass")
    dev = elogpi.device
    n, k = elogpi.shape
    bf16 = _check_rows(elogpi, "elogpi", (n, k), dev)
    build.check_cuda(elb0, "elb0", torch.float32, (k,), dev)
    n_hubs, n_segs = _check_adjacency(adj, n, dev)
    gacc = torch.empty((n, k), dtype=torch.float32, device=dev)
    sumk = torch.empty(k, dtype=torch.float32, device=dev)
    partial = torch.empty((n_segs, k), dtype=torch.float32, device=dev)
    sumk_partial = _reduce_scratch(k, dev)
    build.launch("svt_phi_pass_bf16" if bf16 else "svt_phi_pass", dev,
                 elogpi.data_ptr(), elb0.data_ptr(), _conv_ptr(conv, n, dev),
                 *(t.data_ptr() for t in adj.tensors()), partial.data_ptr(),
                 gacc.data_ptr(), sumk_partial.data_ptr(), sumk.data_ptr(), n,
                 n_hubs, n_segs, k, adj.seg_len)
    build.count_launch(phi_pass, _form(bf16, conv))
    return gacc, sumk


phi_pass.launches = 0
phi_pass.forms = {}


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


class MeanUpdate(NamedTuple):
    """What mean_indicator_update returns; the first five fields are
    mean_indicator_update_plain's."""
    gnext: torch.Tensor
    mphi: Optional[torch.Tensor]       # f32, None when not asked for
    s1: torch.Tensor
    s2: torch.Tensor
    lam0: torch.Tensor
    mphi_bf16: Optional[torch.Tensor] = None   # mphi rounded to bf16
    conv: Optional[torch.Tensor] = None        # converged flags of gnext


def mean_indicator_update(gacc, sumk, deg, consts: LSConsts, annealing: bool,
                          mphi_out=None, *, mphi_f32: bool = True,
                          mphi_bf16: bool = False, conv=None) -> MeanUpdate:
    """Kernel 3 (csrc/mean_indicator.cu) on a CUDA tensor,
    mean_indicator_update_plain on a CPU tensor. gnext takes gacc's
    storage, which the caller must not reuse.

    On the card one launch reads gacc once and writes gnext over it and
    mphi beside it, and the column sums s1 and s2 come out of the same
    pass (per-block partial rows, added in a fixed order by two small
    launches: no atomics, the same bits every time). `mphi_out`, an (n,K)
    f32 buffer the caller no longer needs, receives mphi and is returned
    in its place, on either device (-fuse-s3 hands over the mphi of the
    sweep before). It may also be -sparse-w's (n, K, 2) rows, whose even
    half (Elogpi) is dead by then: mphi goes into the odd half and 0 into
    the even one, whole pairs (a store of half a pair makes the L2 merge
    the sector: 8.44 against 2.45 ms at n=1M, K=500 on an H100 80GB HBM3
    at 700 W, chip_smoke.py), and MeanUpdate.mphi is the odd half.

    `mphi_bf16` also returns mphi rounded to bfloat16, the rows a -bf16
    sweep's s3 pass gathers, written by the same launch; `mphi_f32=False`
    then leaves the f32 mphi unwritten (the default sweep uses it for s3
    only). `conv`, the (n,) int32 converged flags before this sweep, asks
    for the sticky flags after it, converged_of(gnext, alpha, conv), which
    the launch takes from the gnext rows it holds; conv is not modified."""
    if not (mphi_f32 or mphi_bf16):
        raise ValueError("mean_indicator_update: no mphi asked for")
    pairs = mphi_out is not None and mphi_out.dim() == 3
    if pairs and (mphi_bf16 or conv is not None or not mphi_f32):
        raise ValueError("mphi into (n, K, 2) pairs takes neither bf16 rows "
                         "nor converged flags")
    if gacc.device.type == "cpu":
        out = mean_indicator_update_plain(gacc, sumk, deg, consts, annealing)
        mphi = out[1]
        if pairs:
            mphi_out[..., 0] = 0.0
            mphi_out = mphi_out[..., 1]
        return MeanUpdate(
            out[0],
            None if not mphi_f32 else
            mphi if mphi_out is None else mphi_out.copy_(mphi),
            *out[2:],
            mphi.to(torch.bfloat16) if mphi_bf16 else None,
            None if conv is None else converged_of(out[0], consts.alpha,
                                                   conv))
    build.require_cuda(gacc, "mean_indicator_update")
    dev = gacc.device
    if gacc.dim() != 2:
        raise ValueError(f"gacc must be (n, k), got {tuple(gacc.shape)}")
    n, k = gacc.shape
    build.check_cuda(gacc, "gacc", torch.float32, (n, k), dev)
    build.check_cuda(sumk, "sumk", torch.float32, (k,), dev)
    build.check_cuda(deg, "deg", torch.float32, (n,), dev)
    mphi = None
    if mphi_f32:
        mphi = torch.empty_like(gacc) if mphi_out is None else mphi_out
        build.check_cuda(mphi, "mphi_out", torch.float32,
                         (n, k, 2) if pairs else (n, k), dev)
        if mphi.data_ptr() == gacc.data_ptr():
            raise ValueError("mphi_out must not be gacc")
    mphi_b = (torch.empty_like(gacc, dtype=torch.bfloat16) if mphi_bf16
              else None)
    conv_out = count_first = None
    if conv is not None:
        conv_out = torch.empty_like(conv)
        if k > REG_MAX_K:     # column tiles hand the count on
            count_first = torch.empty((n, 2), dtype=torch.int32, device=dev)
    s12 = torch.empty((2, k), dtype=torch.float32, device=dev)
    partial = _reduce_scratch(k, dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    build.launch("svt_mean_indicator", dev, gacc.data_ptr(), deg.data_ptr(),
                 sumk.data_ptr(), ptr(mphi), int(pairs), ptr(mphi_b),
                 partial.data_ptr(),
                 s12.data_ptr(), _conv_ptr(conv, n, dev), ptr(conv_out),
                 ptr(count_first), n, k, consts.alpha, consts.n_nodes,
                 consts.ones, int(bool(annealing)))
    build.count_launch(
        mean_indicator_update,
        "+".join(name for name, on in (("f32", mphi_f32), ("bf16", mphi_bf16),
                                       ("conv", conv is not None)) if on))
    return MeanUpdate(gacc, mphi[..., 1] if pairs else mphi, s12[0], s12[1],
                      consts.eta0 + sumk, mphi_b, conv_out)


mean_indicator_update.launches = 0
mean_indicator_update.forms = {}


def s3_pass_plain(mphi, edges, mask, num_blocks: int, conv=None
                  ) -> torch.Tensor:
    """Cross-moment sum over the links: s3_k = sum_e mphi_p,k mphi_q,k,
    blocked over the padded edge list (the form held against the JAX
    package's s3_pass)."""
    s3 = torch.zeros(mphi.shape[1], dtype=torch.float32, device=mphi.device)
    for blk, msk in edge_blocks(edges, mask, num_blocks):
        s3 += (_s3_of(mphi, blk[:, 0], blk[:, 1], conv)
               * msk[:, None]).sum(dim=0)
    return s3


def s3_pass_pull_plain(mphi, adj: Adjacency, block: int, conv=None
                       ) -> torch.Tensor:
    """s3 in the kernel's pull form, in plain PyTorch: of the adjacency's
    2E directed entries (owner p, neighbour q) keep those with q > p,
    which is every link once, and sum mphi[p] * mphi[q] over them."""
    s3 = torch.zeros(mphi.shape[1], dtype=torch.float32, device=mphi.device)
    for p, q in _pull_entries(adj, block):
        keep = q > p
        s3 += _s3_of(mphi, p[keep], q[keep], conv).sum(dim=0)
    return s3


def s3_pass(mphi, adj: Adjacency, conv=None) -> torch.Tensor:
    """Kernel 4 (csrc/s3_pass.cu) on a CUDA tensor, s3_pass_pull_plain on
    a CPU tensor. Returns s3 (K,) f32. mphi is f32 or bf16; conv is None
    or the (n,) int32 converged flags.

    On the card the owner of node p holds mphi[p] in registers and adds
    mphi[p] * mphi[q] for its neighbours q > p to running column sums, so
    every link costs one gathered row (none where conv marks exactly one
    end frozen: that link gives one value); hub segments take a second
    launch and the sums across blocks a third, without atomics. K above
    512 runs as column tiles of 512."""
    if mphi.device.type == "cpu":
        block = choose_edge_block(adj.nbr.shape[0], mphi.shape[1])
        return s3_pass_pull_plain(mphi, adj, block, conv)
    build.require_cuda(mphi, "s3_pass")
    dev = mphi.device
    n, k = mphi.shape
    bf16 = _check_rows(mphi, "mphi", (n, k), dev)
    _, n_segs = _check_adjacency(adj, n, dev)
    s3 = torch.empty(k, dtype=torch.float32, device=dev)
    partial = _reduce_scratch(k, dev)
    build.launch("svt_s3_pass", dev, mphi.data_ptr(), int(bf16),
                 _conv_ptr(conv, n, dev), adj.rowptr.data_ptr(),
                 adj.nbr.data_ptr(), adj.seg_node.data_ptr(),
                 adj.seg_begin.data_ptr(), adj.seg_end.data_ptr(),
                 partial.data_ptr(), s3.data_ptr(), n, n_segs, k,
                 adj.seg_len)
    build.count_launch(s3_pass, _form(bf16, conv))
    return s3


s3_pass.launches = 0
s3_pass.forms = {}


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
        # packed rows may be bf16: widened after the gather
        rp, rq = packed[p].float(), packed[q].float()
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
        phi = _phi_of(elogpi, elb0, p, q, None)
        gacc.index_add_(0, p, phi)
        sumk += phi.sum(dim=0)
        keep = q > p
        s3 += _s3_of(mphi_prev, p[keep], q[keep], None).sum(dim=0)
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
# at which the one launch was not the slower. Over bf16 rows (-bf16) the
# same limit is kept: the crossover is set by launches, not by bytes, and
# measured in the same place, 0.060 against 0.069 ms at 8.0e6 values,
# 0.096 against 0.095 at 2.0e7, 0.160 against 0.154 at 4.0e7 and 28.95
# against 27.29 ms at K=500 with 20M links. Measured again after kernel 4's
# design pass (which left these shapes the pull form, csrc/s3_pass.cu):
# 0.098 against 0.141 ms at 8.0e6, 0.103 against 0.134 at 2.0e7,
# 0.176 against 0.170 at 4.0e7, 0.497 against 0.441 at 1.2e8, 53.7 against
# 44.0 ms at K=500 with 20M links (bf16 rows 29.1 against 27.3). The limit
# stands, and no layout would move it: kernel 5 gathers the same 3E rows as
# the two kernels, with more of them live in registers.
FUSED_MAX_WORK = 20_000_000
# widest row csrc/phi_pass.cu's register kernel holds
FUSED_MAX_K = REG_MAX_K


def fused_takes_one_launch(k: int, n_entries: int) -> bool:
    """Whether the fused pass over an adjacency of n_entries directed
    entries at width k is kernel 5 (True) or kernel 2 then kernel 4."""
    return k <= FUSED_MAX_K and n_entries * k <= FUSED_MAX_WORK


def fused_phi_s3_pass(elogpi, mphi_prev, elb0, adj: Adjacency,
                      one_launch=None) -> Tuple[torch.Tensor, ...]:
    """The phi pass and the cross-moment of the mean indicators of the
    sweep before (-fuse-s3). Returns (gacc, sumk, s3) as
    fused_phi_s3_pass_plain does; fused_phi_s3_pass_pull_plain on a CPU
    tensor. elogpi and mphi_prev are f32, or both bf16 under -bf16.

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
    bf16 = _check_rows(elogpi, "elogpi", (n, k), dev)
    if mphi_prev.dtype != elogpi.dtype:
        raise TypeError(f"kernel 5 gathers elogpi and mphi_prev as one row "
                        f"type, got {elogpi.dtype} and {mphi_prev.dtype}")
    build.check_cuda(mphi_prev, "mphi_prev", elogpi.dtype, (n, k), dev)
    build.check_cuda(elb0, "elb0", torch.float32, (k,), dev)
    n_hubs, n_segs = _check_adjacency(adj, n, dev)
    gacc = torch.empty((n, k), dtype=torch.float32, device=dev)
    sumk = torch.empty(k, dtype=torch.float32, device=dev)
    partial = torch.empty((n_segs, k), dtype=torch.float32, device=dev)
    s3 = torch.empty(k, dtype=torch.float32, device=dev)
    # two scratch buffers, each held until the launch is enqueued
    sumk_partial, s3_partial = _reduce_scratch(k, dev), _reduce_scratch(k, dev)
    build.launch("svt_phi_s3_pass_bf16" if bf16 else "svt_phi_s3_pass", dev,
                 elogpi.data_ptr(), mphi_prev.data_ptr(), elb0.data_ptr(),
                 *(t.data_ptr() for t in adj.tensors()), partial.data_ptr(),
                 gacc.data_ptr(), sumk_partial.data_ptr(), sumk.data_ptr(),
                 s3_partial.data_ptr(), s3.data_ptr(), n, n_hubs, n_segs, k,
                 adj.seg_len)
    build.count_launch(fused_phi_s3_pass, _form(bf16, None))
    return gacc, sumk, s3


fused_phi_s3_pass.launches = 0
fused_phi_s3_pass.forms = {}


# ---------------------------------------------------------------------
# -sparse-w: the top-W union pass (svinet_tpu/svi/sweep_math.py:209-286).
# Per node the W columns of the largest gamma, their Elogpi values
# (topvals) and the mean indicators of the sweep before at them (topm); per
# link a softmax over the union of the two lists, with exact logits
# gathered at (node, column). Elogpi and the mean indicators of the sweep
# before are held side by side as (n, K, 2) f32 `rows`, so that a value of
# each at one (node, column) is one 8-byte load on the card
# (csrc/sparse_union.cu). The rows belong to the sparse sweep alone.

def union_rows(elogpi, mphi) -> torch.Tensor:
    """(n, K, 2) f32 rows [Elogpi, mphi] from two (n, K) arrays, for
    callers that hold them apart (the engine's sweep writes the rows in
    place: sparse_union_sweep)."""
    return torch.stack([elogpi.float(), mphi.float()], dim=-1)


def _union_halves(rows):
    """(flat Elogpi, flat mphi) of the (n, K, 2) rows, each (n*K,)."""
    return rows[..., 0].reshape(-1), rows[..., 1].reshape(-1)


def sparse_union_pass_plain(rows, ids, topvals, topm, elb0, edges, mask,
                            num_blocks: int) -> Tuple[torch.Tensor, ...]:
    """The JAX block function (svinet_tpu/svi/sweep_math.py:252-277) over
    the padded edge list: per link the 2W candidate columns, their logits,
    a stable sort of the ids to mark duplicates (the first copy is kept),
    the softmax over the kept slots, phi added at (p, id) and (q, id), sumk
    at 2 phi, s3 at mphi[p,id] * mphi[q,id] on kept slots, each end's mphi
    at its own columns taken from topm. rows (n,K,2) f32 [Elogpi, mphi of
    the sweep before]; ids (n,W) int32, topvals and topm (n,W) f32.
    Returns (gacc (n,K), sumk (K,), s3 (K,))."""
    n, k = rows.shape[:2]
    dev = rows.device
    gacc = torch.zeros(n * k, dtype=torch.float32, device=dev)
    sumk = torch.zeros(k, dtype=torch.float32, device=dev)
    s3 = torch.zeros(k, dtype=torch.float32, device=dev)
    flat_e, flat_m = _union_halves(rows)
    idl = ids.long()
    for blk, msk in edge_blocks(edges, mask, num_blocks):
        p, q = blk[:, 0].long(), blk[:, 1].long()
        idp, idq = idl[p], idl[q]
        cand = torch.cat([idp, idq], dim=1)
        lq_at_p = flat_e[q[:, None] * k + idp]
        lp_at_q = flat_e[p[:, None] * k + idq]
        logits = torch.cat([topvals[p] + lq_at_p, lp_at_q + topvals[q]],
                           dim=1) + elb0[cand]
        # mphi of each end at the 2W slots: its own list's from topm
        m_p = torch.cat([topm[p], flat_m[p[:, None] * k + idq]], dim=1)
        m_q = torch.cat([flat_m[q[:, None] * k + idp], topm[q]], dim=1)
        sort_ids, order = torch.sort(cand, dim=1, stable=True)
        sort_logits = logits.gather(1, order)
        dup = torch.cat([torch.zeros_like(sort_ids[:, :1], dtype=torch.bool),
                         sort_ids[:, 1:] == sort_ids[:, :-1]], dim=1)
        phi = torch.softmax(sort_logits.masked_fill(dup, -torch.inf), dim=-1)
        phi = phi.masked_fill(dup, 0.0) * msk[:, None]
        slot_p = (p[:, None] * k + sort_ids).flatten()
        slot_q = (q[:, None] * k + sort_ids).flatten()
        gacc.index_add_(0, slot_p, phi.flatten())
        gacc.index_add_(0, slot_q, phi.flatten())
        sumk.index_add_(0, sort_ids.flatten(), 2.0 * phi.flatten())
        contrib = m_p.gather(1, order) * m_q.gather(1, order)
        contrib = contrib.masked_fill(dup, 0.0) * msk[:, None]
        s3.index_add_(0, sort_ids.flatten(), contrib.flatten())
    return gacc.view(n, k), sumk, s3


def _union_entries(flat_e, ids, topvals, elb0, p, q, k: int):
    """The 2W slots of the entries (owner p, neighbour q) as kernel 7 forms
    them: (columns (B,2W): p's list then q's, logits (B,2W) with a
    duplicate of q's list at -inf, kept (B,2W) bool)."""
    idp, idq = ids[p].long(), ids[q].long()
    lp = (topvals[p] + flat_e[q[:, None] * k + idp]) + elb0[idp]
    lq = (flat_e[p[:, None] * k + idq] + topvals[q]) + elb0[idq]
    in_p = torch.zeros((p.shape[0], k), dtype=torch.bool, device=p.device)
    in_p.scatter_(1, idp, True)
    kept_q = ~in_p.gather(1, idq)
    cols = torch.cat([idp, idq], dim=1)
    kept = torch.cat([torch.ones_like(kept_q), kept_q], dim=1)
    logits = torch.cat([lp, lq], dim=1).masked_fill(~kept, -torch.inf)
    return cols, logits, kept


def sparse_union_pass_pull_plain(rows, ids, topvals, topm, elb0,
                                 adj: Adjacency, block: int
                                 ) -> Tuple[torch.Tensor, ...]:
    """Kernel 7's arithmetic in plain PyTorch: walk the 2E directed entries
    (owner p, neighbour q) of the adjacency in blocks of `block`; p's list
    first, a column of q's list dropped when it is in p's (a K-bit mask of
    p's list, no sort); phi over the kept slots added to the owner's row
    only, and to sumk (every link is met from both ends); s3 from the
    entries with q > p, every link once: mphi[p, c] * mphi[q, c], each
    end's mphi at its own columns from topm, at the other's from the odd
    half of rows. Takes sparse_union_pass_plain's arguments but the
    adjacency; returns what it returns. sumk and s3 are summed in float64:
    a column that every node's list holds (columns tied at alpha) takes a
    term from every link, and an f32 running sum of millions of terms
    stops growing once its unit in the last place passes the terms."""
    n, k = rows.shape[:2]
    dev = rows.device
    gacc = torch.zeros(n * k, dtype=torch.float32, device=dev)
    sumk = torch.zeros(k, dtype=torch.float64, device=dev)
    s3 = torch.zeros(k, dtype=torch.float64, device=dev)
    flat_e, flat_m = _union_halves(rows)
    w = ids.shape[1]
    for p, q in _pull_entries(adj, block):
        cols, logits, kept = _union_entries(flat_e, ids, topvals, elb0, p, q,
                                            k)
        phi = torch.softmax(logits, dim=-1).masked_fill(~kept, 0.0)
        gacc.index_add_(0, (p[:, None] * k + cols).flatten(), phi.flatten())
        sumk.index_add_(0, cols.flatten(), phi.flatten().double())
        low = q > p
        lc, lp, lq = cols[low], p[low], q[low]
        m_p = torch.cat([topm[lp], flat_m[lp[:, None] * k + lc[:, w:]]], 1)
        m_q = torch.cat([flat_m[lq[:, None] * k + lc[:, :w]], topm[lq]], 1)
        contrib = (m_p * m_q).masked_fill(~kept[low], 0.0)
        s3.index_add_(0, lc.flatten(), contrib.flatten().double())
    return gacc.view(n, k), sumk.float(), s3.float()


def sparse_union_pass(rows, ids, topvals, topm, elb0, adj: Adjacency,
                      gacc_out=None) -> Tuple[torch.Tensor, ...]:
    """Kernel 7 (csrc/sparse_union.cu) on a CUDA tensor,
    sparse_union_pass_pull_plain on a CPU tensor. rows (n,K,2) f32:
    Elogpi and the mean indicators of the sweep before side by side
    (union_rows); ids (n,W) int32 with 1 <= W <= K, topvals and topm (n,W)
    f32, from ops/digamma.py:dirichlet_expectation_topw. Returns (gacc,
    sumk, s3): gacc (n,K) the phi of every link added at both ends over the
    union of the two lists, sumk (K,) its column sums, s3 (K,) the
    cross-moment of the mean indicators over the kept slots of every link.
    `gacc_out`, an (n, K) f32 buffer the caller no longer needs, receives
    gacc and is returned in its place.

    On the card one launch walks the adjacency, nodes and hub segments
    alike: the warp that owns node p holds its row of phi sums in shared
    memory and writes gacc[p] once; sumk and s3 leave as per-block rows
    that two small launches add in a fixed order, and a hub's segments
    are combined in segment order: no atomics into device memory, the same
    bits every time."""
    n, k = rows.shape[:2]
    w = ids.shape[1]
    if not 1 <= w <= k:
        raise ValueError(f"the lists must hold 1 to {k} columns, got {w}")
    if rows.device.type == "cpu":
        # a block holds (B, K) of p's mask beside its (B, 2W) slots
        block = choose_edge_block(adj.nbr.shape[0], max(k, 2 * w))
        gacc, sumk, s3 = sparse_union_pass_pull_plain(
            rows, ids, topvals, topm, elb0, adj, block)
        if gacc_out is not None:
            gacc = gacc_out.copy_(gacc)
        return gacc, sumk, s3
    build.require_cuda(rows, "sparse_union_pass")
    dev = rows.device
    build.check_cuda(rows, "rows", torch.float32, (n, k, 2), dev)
    build.check_cuda(ids, "ids", torch.int32, (n, w), dev)
    build.check_cuda(topvals, "topvals", torch.float32, (n, w), dev)
    build.check_cuda(topm, "topm", torch.float32, (n, w), dev)
    build.check_cuda(elb0, "elb0", torch.float32, (k,), dev)
    n_hubs, n_segs = _check_adjacency(adj, n, dev)
    if gacc_out is None:
        gacc = torch.empty((n, k), dtype=torch.float32, device=dev)
    else:
        gacc = gacc_out
        build.check_cuda(gacc, "gacc_out", torch.float32, (n, k), dev)
    sumk = torch.empty(k, dtype=torch.float32, device=dev)
    s3 = torch.empty(k, dtype=torch.float32, device=dev)
    seg_rows = torch.empty((n_segs, k), dtype=torch.float32, device=dev)
    partial = _reduce_scratch(k, dev)
    build.launch("svt_sparse_union", dev, rows.data_ptr(), ids.data_ptr(),
                 topvals.data_ptr(), topm.data_ptr(), elb0.data_ptr(),
                 *(t.data_ptr() for t in adj.tensors()), seg_rows.data_ptr(),
                 partial.data_ptr(), gacc.data_ptr(), sumk.data_ptr(),
                 s3.data_ptr(), n, n_hubs, n_segs, k, w, adj.seg_len)
    build.count_launch(sparse_union_pass, "f32")
    return gacc, sumk, s3


sparse_union_pass.launches = 0
sparse_union_pass.forms = {}


def sparse_union_occupancy(k: int, w: int) -> dict:
    """What kernel 7's launch for (K, W) gets of an SM on the current
    card: registers a thread, bytes of shared memory a warp, warps an
    SM."""
    info = (ctypes.c_int * 3)()
    build.library().call("svt_sparse_union_info", k, w, info)
    return dict(registers=info[0], smem_per_warp=info[1],
                warps_per_sm=info[2])


def sparse_union_sweep(gamma, lam, rows, adj: Adjacency, deg,
                       consts: LSConsts, annealing: bool, w: int,
                       donate_gamma: bool = False):
    """One -sparse-w sweep (svinet_tpu/svi/sweep_math.py:209-286). `rows`
    is the (n, K, 2) f32 buffer the sparse sweeps carry, whose odd half
    holds the mean indicators of the sweep before: the top-W form of kernel
    1 writes Elogpi into its even half and reads topm from the odd one,
    kernel 1 takes lambda, kernel 7 the rows, and kernel 3 writes this
    sweep's mean indicators into the odd half (after kernel 7 has read the
    old ones; 0 into the even half), then finish_lambda. Returns (gamma,
    lam, rows): lam is not modified; `rows` is overwritten and returned.
    gamma is not modified either, unless `donate_gamma`: then kernel 7
    writes gacc into gamma's storage once the top-W form has read it
    (nothing reads gamma after that), and the new gamma is returned in it;
    the caller must not use the gamma it passed."""
    _, ids, topvals, topm = dirichlet_expectation_topw(gamma, w, pair=rows)
    elb0 = dirichlet_expectation(lam)[:, 0].contiguous()
    gacc, sumk, s3 = sparse_union_pass(rows, ids, topvals, topm, elb0, adj,
                                       gamma if donate_gamma else None)
    del gamma, ids, topvals, topm
    out = mean_indicator_update(gacc, sumk, deg, consts, annealing,
                                mphi_out=rows)
    return (out.gnext, finish_lambda(out.s1, out.s2, s3, out.lam0, consts),
            rows)


def finish_lambda(s1, s2, s3, lam0, consts: LSConsts) -> torch.Tensor:
    """lambda1 = eta1 + s1^2 - s2 - s3 (src/linksampling.cc:748)."""
    lam1 = consts.eta1 + s1 * s1 - s2 - s3
    return torch.stack([lam0, lam1], dim=1)
