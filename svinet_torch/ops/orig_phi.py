"""Kernel 15: the full blockmodel's coupled per-pair fixed point, with the
node sums it feeds (svinet_tpu/svi/orig.py:39 _phi2_fixed_point inside
:125 orig_batch_step) and its ELBO form (:68 orig_approx_elbo's pair
terms).

For a pair (p, q) with label y, from phi1 = phi2 = 1/K, Jacobi rounds

  phi1' = softmax(Elogpi[p] + L_y phi2)
  phi2' = softmax(Elogpi[q] + L_y phi1),   (L phi)_g = sum_h L[g, h] phi_h

L_1 = log max(beta, 1e-30) for a link, L_0 = log max(1 - beta, 1e-30)
for a nonlink (K x K), under the JAX package's block rule: blocks of B =
min(edge_block, 2048) pairs at [bB, (b+1)B); block b takes R_b rounds,
the first whose largest change over its slots is below `thresh`, else
`max_iters`; the JAX engine's padding pairs (0, 0), y = 0, count in the
last block's R_b (here one virtual slot, as kernel 8 takes them).

The plain version forms each logit as the kernel does: the product summed
over h = 0, 1, ..., K - 1 in order, every product and sum rounded alone,
then Elogpi added; the softmax as the JAX one, exp(x - max) over its sum.

A CPU tensor takes the plain version; a CUDA tensor launches
csrc/orig_fixed_point.cu or raises: a cluster of CTAs a block of the rule,
all its rounds on chip, each lane's columns of a pair's products in
registers, tile by tile.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from svinet_torch.kernels import build

BLOCK = 2048
# pairs the plain version solves at once: (span, K) f32 temporaries of
# ~64 MB
_PLAIN_FLOATS = 1 << 24


def logf_pair(beta: torch.Tensor) -> torch.Tensor:
    """(2, K, K): L_1 = log max(beta, 1e-30) (links), L_0 = log max(1 -
    beta, 1e-30) (nonlinks) (svinet_tpu/svi/orig.py:130-131)."""
    return torch.stack([torch.log(beta.clamp_min(1e-30)),
                        torch.log((1.0 - beta).clamp_min(1e-30))])


def elbo_logf_pair(beta_new: torch.Tensor) -> torch.Tensor:
    """(2, K, K): the ELBO's lf_1 = log(beta + 1e-10), lf_0 = log(1 - beta
    + 1e-10) of the updated beta (svinet_tpu/svi/orig.py:91-92)."""
    return torch.stack([torch.log(beta_new + 1e-10),
                        torch.log(1.0 - beta_new + 1e-10)])


def product_plain(lf: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """(B, K): x[b, g] = sum_h lf[g, h] phi[b, h], h in order, each
    product and sum rounded alone (the kernel's order)."""
    acc = torch.zeros_like(phi)
    for h in range(phi.shape[1]):
        acc = acc + lf[:, h][None, :] * phi[:, h:h + 1]
    return acc


def _products(lf2, link, phi):
    """L_y phi for rows of mixed y: the links' rows through lf2[0], the
    others through lf2[1]."""
    out = torch.empty_like(phi)
    for sel, lf in ((link, lf2[0]), (~link, lf2[1])):
        if bool(sel.any()):
            out[sel] = product_plain(lf, phi[sel])
    return out


def softmax_plain(x: torch.Tensor) -> torch.Tensor:
    """exp(x - max) over its sum, as jax.nn.softmax forms it."""
    e = torch.exp(x - x.max(-1, keepdim=True).values)
    return e / e.sum(-1, keepdim=True)


def orig_fixed_point_plain(ep, eq, lf2, y, max_iters: int = 50,
                           thresh: float = 1e-5, block: int = BLOCK,
                           pad_row=None, given=None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The coupled fixed point of B pairs from their gathered rows (B, K)
    under the block rule: rows [bB', (b+1)B') form block b (B' = block).
    `pad_row` (K,), when set, is Elogpi[0]: where the last block is
    partial, the padding pair (0, 0), a nonlink, counts in its rounds.
    `given` (B,) int, when set, replaces the rule: row i takes given[i]
    rounds. Rows leave at their bit-stable round. Returns (phi1, phi2,
    rounds (B,) int32)."""
    b, k = ep.shape
    dev = ep.device
    nb = -(-b // block)
    seg = torch.arange(b, device=dev) // block
    yy = y
    if given is None and pad_row is not None and b % block:
        ep = torch.cat([ep, pad_row[None].to(ep.dtype)])
        eq = torch.cat([eq, pad_row[None].to(eq.dtype)])
        yy = torch.cat([yy, yy.new_zeros(1)])
        seg = torch.cat([seg, seg.new_full((1,), nb - 1)])
    link = yy == 1
    lf2 = lf2.to(ep.dtype)
    phi1 = torch.full(ep.shape, 1.0 / k, dtype=ep.dtype, device=dev)
    phi2 = phi1.clone()
    idx = torch.arange(ep.shape[0], device=dev)
    if given is not None:
        lim = given.to(torch.int64)
        idx = idx[lim > 0]
        lim = lim[idx]
    r_block = torch.full((nb,), max_iters, dtype=torch.int32, device=dev)
    done = torch.zeros(nb, dtype=torch.bool, device=dev)
    a_ep, a_eq, a_l, a_seg = ep[idx], eq[idx], link[idx], seg[idx]
    a1, a2 = phi1[idx], phi2[idx]
    for r in range(1, max_iters + 1):
        if idx.numel() == 0:
            break
        n1 = softmax_plain(a_ep + _products(lf2, a_l, a2))
        n2 = softmax_plain(a_eq + _products(lf2, a_l, a1))
        leave = (n1 == a1).all(-1) & (n2 == a2).all(-1)
        if given is None:
            change = torch.maximum((n1 - a1).abs().mean(-1),
                                   (n2 - a2).abs().mean(-1))
            worst = torch.zeros(nb, dtype=change.dtype, device=dev)
            worst.scatter_reduce_(0, a_seg, change, "amax")
            stop = ~done & ~(worst >= thresh)
            r_block[stop] = r
            done |= stop
            leave |= done[a_seg]
        else:
            leave |= lim <= r
        if bool(leave.any()):
            phi1[idx[leave]] = n1[leave]
            phi2[idx[leave]] = n2[leave]
            keep = ~leave
            idx = idx[keep]
            a_ep, a_eq, a_l, a_seg = (a_ep[keep], a_eq[keep], a_l[keep],
                                      a_seg[keep])
            a1, a2 = n1[keep], n2[keep]
            if given is not None:
                lim = lim[keep]
        else:
            a1, a2 = n1, n2
    phi1[idx] = a1
    phi2[idx] = a2
    if given is not None:
        rounds = given.clamp(0, max_iters).to(torch.int32)
    else:
        rounds = r_block[seg[:b]]
    return phi1[:b], phi2[:b], rounds


def pair_terms_plain(phi1, phi2, ep_new, eq_new, lfe2, y) -> torch.Tensor:
    """(B,): each pair's ELBO term, unweighted (svinet_tpu/svi/orig.py:
    103-109)."""
    link = y == 1
    t = torch.empty(phi1.shape[0], dtype=phi1.dtype, device=phi1.device)
    lfe2 = lfe2.to(phi1.dtype)
    for sel, lf in ((link, lfe2[0]), (~link, lfe2[1])):
        if bool(sel.any()):
            t[sel] = (phi1[sel] * (phi2[sel] @ lf.t())).sum(-1)
    t = t + (phi1 * ep_new).sum(-1) + (phi2 * eq_new).sum(-1)
    return (t - (phi1 * torch.log(phi1.clamp_min(1e-30))).sum(-1)
            - (phi2 * torch.log(phi2.clamp_min(1e-30))).sum(-1))


def _spans(m: int, k: int, block: int):
    span = max(1, _PLAIN_FLOATS // max(k * block, 1)) * block
    for lo in range(0, m, span):
        yield lo, min(lo + span, m)


def orig_chunk_plain(elogpi, lf2, pairs, y, max_iters: int, thresh: float,
                     block: int = BLOCK, pad: bool = False, gacc=None,
                     elbo=None, given=None):
    """The chunk in plain PyTorch, over spans of whole blocks. Training
    form: (staged (2m, K), phi1 of pair i in row 2i and phi2 in 2i + 1;
    rounds), gacc (n, K), when given, += 2 phi over the slots in slot
    order (index_add_). ELBO form (elbo = (Elogpi', lf'2)): (terms (m,),
    rounds). `pad`: the chunk ends the pair set, the padding pair counts
    in its last block."""
    m = pairs.shape[0]
    k = elogpi.shape[1]
    dev = elogpi.device
    rounds = torch.zeros(m, dtype=torch.int32, device=dev)
    out = (torch.empty((2 * m, k), dtype=elogpi.dtype, device=dev)
           if elbo is None else
           torch.empty(m, dtype=elogpi.dtype, device=dev))
    for lo, hi in _spans(m, k, block):
        p = pairs[lo:hi, 0].long()
        q = pairs[lo:hi, 1].long()
        ep, eq = elogpi[p], elogpi[q]
        phi1, phi2, rounds[lo:hi] = orig_fixed_point_plain(
            ep, eq, lf2, y[lo:hi], max_iters, thresh, block,
            elogpi[0] if pad and hi == m else None,
            None if given is None else given[lo:hi])
        if elbo is None:
            out[2 * lo:2 * hi].view(hi - lo, 2, k)[:, 0] = phi1
            out[2 * lo:2 * hi].view(hi - lo, 2, k)[:, 1] = phi2
        else:
            out[lo:hi] = pair_terms_plain(phi1, phi2, elbo[0][p], elbo[0][q],
                                          elbo[1], y[lo:hi])
    if elbo is None and gacc is not None:
        gacc.index_add_(0, pairs.reshape(-1).long(), 2.0 * out)
    return out, rounds


def orig_chunk(elogpi, lf2, pairs, y, max_iters: int, thresh: float, *,
               block: int = BLOCK, pad: bool = False, gacc=None, csr=None,
               elbo=None):
    """Kernel 15 on a CUDA tensor, orig_chunk_plain on a CPU tensor: the
    fixed point of a chunk of pairs (whole blocks of the rule, but for the
    last chunk's last block, which `pad` completes). elogpi (n, K) and
    lf2 (2, K, K) f32; pairs (m, 2) and y (m,) int32.

    Training form: returns (staged (2m, K), phi1 of pair i in row 2i and
    phi2 in 2i + 1; rounds (m,) int32, each pair's R_b) and adds 2 phi of
    every slot into gacc (n, K) in slot order, over `csr`
    (ops/edges.py:owner_csr of pairs.reshape(-1)). ELBO form (elbo =
    (Elogpi' (n, K), lf'2 (2, K, K))): returns (terms (m,), rounds). On
    the card a cluster of CTAs keeps each block of the rule on chip for
    all its rounds and decides its exit there, one launch a chunk (the
    ELBO's terms in the same launch)."""
    if elogpi.device.type == "cpu":
        return orig_chunk_plain(elogpi, lf2, pairs, y, max_iters, thresh,
                                block, pad, gacc, elbo)
    build.require_cuda(elogpi, "orig_chunk")
    dev = elogpi.device
    n, k = elogpi.shape
    m = pairs.shape[0]
    build.check_cuda(elogpi, "elogpi", torch.float32, (n, k), dev)
    build.check_cuda(lf2, "lf2", torch.float32, (2, k, k), dev)
    build.check_cuda(pairs, "pairs", torch.int32, (m, 2), dev)
    build.check_cuda(y, "y", torch.int32, (m,), dev)
    if max_iters < 1:
        raise ValueError(f"max_iters must be at least 1, got {max_iters}")
    # L kept transposed (row h holds column h of L), each row padded with
    # zeros to the kernel's kp columns
    kp = orig_layout(k)["kp"]
    lt = _padded_lt(lf2, kp)
    slots = m + (1 if pad and m % block else 0)
    blocks = max(1, -(-m // block))
    phi = torch.empty((slots, 2, k), dtype=torch.float32, device=dev)
    block_rounds = torch.zeros(blocks, dtype=torch.int32, device=dev)
    ep_e = lte = terms = rowptr = nbr = None
    if elbo is None:
        build.check_cuda(gacc, "gacc", torch.float32, (n, k), dev)
        if csr.nbr.shape[0] != 2 * m or csr.n != n:
            raise ValueError("csr is not the endpoint CSR of these pairs")
        rowptr, nbr = csr.rowptr, csr.nbr
    else:
        ep_e, lfe2 = elbo
        build.check_cuda(ep_e, "elogpi_e", torch.float32, (n, k), dev)
        build.check_cuda(lfe2, "lfe2", torch.float32, (2, k, k), dev)
        lte = _padded_lt(lfe2, kp)
        terms = torch.empty(m, dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    build.launch("svt_orig_fixed_point", dev, elogpi.data_ptr(),
                 lt.data_ptr(), pairs.data_ptr(), y.data_ptr(), ptr(ep_e),
                 ptr(lte), phi.data_ptr(), block_rounds.data_ptr(),
                 ptr(terms), ptr(rowptr), ptr(nbr), ptr(gacc), n, m, k, kp,
                 int(max_iters), float(thresh), int(block), int(pad),
                 int(elbo is not None))
    build.count_launch(orig_chunk, "f32" if elbo is None else "elbo")
    rounds = block_rounds.repeat_interleave(block)[:m]
    if elbo is None:
        return phi[:m].view(2 * m, k), rounds
    return terms, rounds


orig_chunk.launches = 0
orig_chunk.forms = {}


def orig_layout(k: int) -> dict:
    """Kernel 15's columns at K (csrc/orig_fixed_point.cu:svt_orig_layout):
    lanes a group, columns a lane a tile, tiles, and kp, the row L's
    transposes are padded to."""
    info = (ctypes.c_int * 4)()
    build.library().call("svt_orig_layout", int(k), info)
    return dict(lanes=info[0], columns=info[1], tiles=info[2], kp=info[3])


def _padded_lt(lf2: torch.Tensor, kp: int) -> torch.Tensor:
    """(2, K, kp): each L transposed, its rows padded with zeros."""
    k = lf2.shape[1]
    lt = torch.zeros((2, k, kp), dtype=lf2.dtype, device=lf2.device)
    lt[:, :, :k] = lf2.transpose(1, 2)
    return lt


def moments(staged: torch.Tensor, y: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A, Y) of a chunk's staged phis, K x K: A = sum phi1 phi2^T, Y =
    sum y phi1 phi2^T (svinet_tpu/svi/orig.py:146-151, w = 1 on every
    real pair)."""
    k = staged.shape[1]
    pp = staged.view(-1, 2, k)
    phi1, phi2 = pp[:, 0], pp[:, 1]
    a = phi1.t() @ phi2
    yv = phi1 * (y == 1).to(staged.dtype)[:, None]
    return a, yv.t() @ phi2
