"""Kernel 8: the per-pair phi fixed point of the MMSB local step, with the
sufficient statistics it feeds (svinet_tpu/ops/phicomp.py:33
phi_fixed_point inside svinet_tpu/svi/mmsb.py:49 pair_block_stats, and the
per-pair terms of svinet_tpu/evals/elbo.py:30 approx_elbo).

For a pair (p, q) with label y the reference's PhiComp iterates, from
phi1 = phi2 = 1/K (reference: update_phis_until_conv,
src/mmsbinfer.hh:105-199),

  phi1'_k = softmax_k( Elogpi[p,k] + Elogf_k phi2_k + [y=1](1-phi2_k) log eps )
  phi2'_k = softmax_k( Elogpi[q,k] + Elogf_k phi1_k + [y=1](1-phi1_k) log eps )
  Elogf_k = Elogbeta[k,0] for a link, Elogbeta[k,1] for a nonlink

Jacobi rounds: both updates read the partner's phi of the round before.

Exit: the JAX package's block rule (svinet_tpu/ops/phicomp.py:33-67,
called per block by svinet_tpu/svi/mmsb.py:49-78). The pairs are cut into
blocks of B = min(edge_block, 2048) (svinet_tpu/svi/mmsb.py:307) at
positions [bB, (b+1)B). Block b takes R_b rounds: the first round r >= 1
at which the largest change over all B slots of the block is below
`thresh`, else max_iters; change is the larger of the two mean absolute
changes of a pair's round. Every slot of the block takes exactly R_b
rounds, and every slot counts: pairs of weight 0 (nonlinks that -inf
masks) iterate too and add nothing, since the weights enter only the sums
(svinet_tpu/svi/mmsb.py:65-72, svinet_tpu/evals/elbo.py:56-66). The JAX
engine pads a minibatch to whole blocks with pairs (0, 0), y = 0, w = 0
(svinet_tpu/svi/mmsb.py:430-438, :467-470; -logl's pairs through
svinet_tpu/ops/edges.py:10-24, mmsb.py:590-598); here that padding is
virtual: every pad slot is the same nonlink (0, 0), so one such pair stands
for all of them in the last block's R_b, and no padded array is made.

A round is a pure function of (phi1, phi2): once a round leaves both
unchanged bit for bit, every later round does too, with change 0. So a
pair stops computing at that round, its bit-stable round, and ends where
the block's R_b rounds would have taken it, exactly.

Training form: gacc[p] += w phi1, gacc[q] += w phi2, and
lacc[:, 0] += w phi1 phi2 over links, lacc[:, 1] over nonlinks
(svinet_tpu/svi/mmsb.py:65-72); with a NodeUpdate the rows written are
the step's next gamma from gacc (svinet_tpu/svi/mmsb.py:159-160, 240). ELBO form: the sum over pairs of
w (sum_k phi1 phi2 Elogf + [y=1](1 - sum_k phi1 phi2) log eps
+ sum_k phi1 Elogpi_p + phi2 Elogpi_q - sum_k phi log phi)
(svinet_tpu/evals/elbo.py:56-66).

A CPU tensor takes the plain version; a CUDA tensor launches
csrc/phi_fixed_point.cu or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from svinet_torch.kernels import build
from svinet_torch.ops.edges import SEG_LEN, Adjacency, owner_csr

# pairs of a block of the exit rule (svinet_tpu/svi/mmsb.py:307): an
# engine passes min(edge_block, 2048)
BLOCK = 2048
# pairs the plain version solves at once: (span, K) f32 temporaries of
# ~64 MB
_PLAIN_BLOCK_FLOATS = 1 << 24
# where the pair pass keeps a group's rows (csrc/phi_fixed_point.cu), by
# the index its plan reports: shared memory where an SM holds four groups,
# else device memory
LAYOUTS = {1: "shared rows", 2: "device rows"}


def phi_fixed_point_plain(elogpi_p, elogpi_q, elogbeta, y, log_eps: float,
                          max_iters: int = 50, thresh: float = 1e-5,
                          block: int = BLOCK, pad_row=None, given=None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fixed point of B pairs from their gathered rows (B, K), under
    the block rule: rows [bB', (b+1)B') form block b (B' = `block`), each
    of its rows runs the block's rounds. `pad_row` (K,), when set, is
    Elogpi[0]: where the last block is partial, the padding pair (0, 0), a
    nonlink, fills it (and counts in its rounds); without it a partial
    block is as long as it is (the JAX phi_fixed_point on those rows).
    `given` (B,) int, when set, replaces the rule: row i takes given[i]
    rounds (so that the arithmetic of another implementation can be held
    to this one on the rounds it took). Rows leave the computation at
    their bit-stable round. Returns (phi1, phi2, rounds (B,) int32)."""
    b, k = elogpi_p.shape
    dev = elogpi_p.device
    nb = -(-b // block)
    seg = torch.arange(b, device=dev) // block
    ep, eq, yy = elogpi_p, elogpi_q, y
    if given is None and pad_row is not None and b % block:
        ep = torch.cat([ep, pad_row[None].to(ep.dtype)])
        eq = torch.cat([eq, pad_row[None].to(eq.dtype)])
        yy = torch.cat([yy, yy.new_zeros(1)])
        seg = torch.cat([seg, seg.new_full((1,), nb - 1)])
    yf = (yy == 1)[:, None]
    elogf = torch.where(yf, elogbeta[:, 0], elogbeta[:, 1])
    phi1 = torch.full(ep.shape, 1.0 / k, dtype=ep.dtype, device=dev)
    phi2 = phi1.clone()
    idx = torch.arange(ep.shape[0], device=dev)
    if given is not None:
        lim = given.to(torch.int64)
        idx = idx[lim > 0]
        lim = lim[idx]
    r_block = torch.full((nb,), max_iters, dtype=torch.int32, device=dev)
    done = torch.zeros(nb, dtype=torch.bool, device=dev)
    # the rows still computing, compacted: their inputs and phis
    a_ep, a_eq, a_f, a_y, a_seg = ep[idx], eq[idx], elogf[idx], yf[idx], \
        seg[idx]
    a1, a2 = phi1[idx], phi2[idx]
    for r in range(1, max_iters + 1):
        if idx.numel() == 0:
            break
        u1 = torch.where(a_y, (1.0 - a2) * log_eps, 0.0)
        n1 = torch.softmax(a_ep + a_f * a2 + u1, dim=-1)
        u2 = torch.where(a_y, (1.0 - a1) * log_eps, 0.0)
        n2 = torch.softmax(a_eq + a_f * a1 + u2, dim=-1)
        leave = (n1 == a1).all(-1) & (n2 == a2).all(-1)
        if given is None:
            change = torch.maximum((n1 - a1).abs().mean(-1),
                                   (n2 - a2).abs().mean(-1))
            # each block's largest change this round; its rows that left
            # are bit-stable, change 0
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
            a_ep, a_eq, a_f, a_y, a_seg = (a_ep[keep], a_eq[keep],
                                           a_f[keep], a_y[keep], a_seg[keep])
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


def _plain_blocks(m: int, k: int, block: int = BLOCK):
    """Spans of whole blocks of `block` pairs (the last may be partial),
    with (span, K) temporaries near _PLAIN_BLOCK_FLOATS."""
    span = max(1, _PLAIN_BLOCK_FLOATS // max(k * block, 1)) * block
    for lo in range(0, m, span):
        yield lo, min(lo + span, m)


def pair_block_stats_plain(elogpi, elogbeta, pairs, y, w, log_eps: float,
                           max_iters: int, thresh: float, given=None,
                           block: int = BLOCK):
    """(gacc (n,K), lacc (K,2), rounds (B,)) in plain PyTorch, over spans
    of whole blocks; the scatter is index_add_, in elogpi's dtype.
    `given`: phi_fixed_point_plain's."""
    n, k = elogpi.shape
    dev = elogpi.device
    gacc = torch.zeros((n, k), dtype=elogpi.dtype, device=dev)
    lacc = torch.zeros((k, 2), dtype=elogpi.dtype, device=dev)
    rounds = torch.zeros(pairs.shape[0], dtype=torch.int32, device=dev)
    for lo, hi in _plain_blocks(pairs.shape[0], k, block):
        p = pairs[lo:hi, 0].long()
        q = pairs[lo:hi, 1].long()
        yy, ww = y[lo:hi], w[lo:hi]
        phi1, phi2, rounds[lo:hi] = phi_fixed_point_plain(
            elogpi[p], elogpi[q], elogbeta, yy, log_eps, max_iters, thresh,
            block, elogpi[0], None if given is None else given[lo:hi])
        wc = ww[:, None]
        gacc.index_add_(0, p, wc * phi1)
        gacc.index_add_(0, q, wc * phi2)
        pp = phi1 * phi2 * wc
        ones = (yy == 1)[:, None]
        lacc += torch.stack([torch.where(ones, pp, 0.0).sum(0),
                             torch.where(ones, 0.0, pp).sum(0)], dim=1)
    return gacc, lacc, rounds


def pair_elbo_terms(phi1, phi2, ep, eq, elogbeta, y, log_eps: float):
    """The per-pair local ELBO terms (B,) of converged phis
    (svinet_tpu/evals/elbo.py:56-66)."""
    ones = y == 1
    elogf = torch.where(ones[:, None], elogbeta[:, 0], elogbeta[:, 1])
    pp = phi1 * phi2
    t = (pp * elogf).sum(-1)
    t = t + torch.where(ones, (1.0 - pp.sum(-1)) * log_eps, 0.0)
    t = t + (phi1 * ep).sum(-1) + (phi2 * eq).sum(-1)
    ent = (-(phi1 * torch.log(phi1.clamp_min(1e-30))).sum(-1)
           - (phi2 * torch.log(phi2.clamp_min(1e-30))).sum(-1))
    return t + ent


def pair_elbo_plain(elogpi, elogbeta, pairs, y, w, log_eps: float,
                    max_iters: int, thresh: float, given=None,
                    block: int = BLOCK):
    """(the weighted sum of the per-pair ELBO terms (), rounds (B,));
    `given`: phi_fixed_point_plain's."""
    k = elogpi.shape[1]
    dev = elogpi.device
    total = torch.zeros((), dtype=elogpi.dtype, device=dev)
    rounds = torch.zeros(pairs.shape[0], dtype=torch.int32, device=dev)
    for lo, hi in _plain_blocks(pairs.shape[0], k, block):
        p = pairs[lo:hi, 0].long()
        q = pairs[lo:hi, 1].long()
        yy, ww = y[lo:hi], w[lo:hi]
        ep, eq = elogpi[p], elogpi[q]
        phi1, phi2, rounds[lo:hi] = phi_fixed_point_plain(
            ep, eq, elogbeta, yy, log_eps, max_iters, thresh, block,
            elogpi[0], None if given is None else given[lo:hi])
        terms = pair_elbo_terms(phi1, phi2, ep, eq, elogbeta, yy, log_eps)
        total = total + torch.where(ww != 0, terms * ww, 0.0).sum()
    return total, rounds


class NodeUpdate(NamedTuple):
    """How the node pass writes a node's row from its gamma_hat row g:
    with `gamma` set, the SVI step's (1 - rho) gamma + rho (alpha + gscale
    g) (svinet_tpu/svi/mmsb.py:159-160); without, -batch's alpha + g
    (svinet_tpu/svi/mmsb.py:240). gscale is a () f32 tensor, rho a () f32
    tensor or, for FastAMM's step, an (n,) one, a rho a node
    (svinet_tpu/svi/fastamm.py:62-66)."""
    gamma: Optional[torch.Tensor]
    alpha: float
    gscale: Optional[torch.Tensor] = None
    rho: Optional[torch.Tensor] = None


def node_update_plain(gacc, upd: NodeUpdate) -> torch.Tensor:
    """The node pass's update in plain PyTorch, the JAX step's expressions
    in its order."""
    if upd.gamma is None:
        return upd.alpha + gacc
    rho = upd.rho[:, None] if upd.rho.dim() == 1 else upd.rho
    gammat = upd.alpha + upd.gscale * gacc
    return (1.0 - rho) * upd.gamma + rho * gammat


def _pair_checks(elogpi, elogbeta, pairs, y, w):
    dev = elogpi.device
    n, k = elogpi.shape
    m = pairs.shape[0]
    build.check_cuda(elogpi, "elogpi", torch.float32, (n, k), dev)
    build.check_cuda(elogbeta, "elogbeta", torch.float32, (k, 2), dev)
    build.check_cuda(pairs, "pairs", torch.int32, (m, 2), dev)
    build.check_cuda(y, "y", torch.int32, (m,), dev)
    build.check_cuda(w, "w", torch.float32, (m,), dev)
    return dev, n, k, m


def fixed_point_plan(k: int, elbo: bool, m: int, device) -> dict:
    """The pair pass's launch on `device` for K = k and m pairs: blocks,
    groups (one pair each) a block, where the rows live (LAYOUTS), blocks
    an SM holds, shared memory bytes a block, registers a thread, lanes a
    group."""
    info = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        build.library().call("svt_phi_fixed_point_plan", int(k), int(elbo),
                             int(m), info)
    return dict(blocks=info[0], groups_per_block=info[1],
                layout=LAYOUTS[info[2]], blocks_per_sm=info[3],
                smem_bytes=info[4], registers=info[5], lanes=info[6])


def _scalar(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(dev).reshape(())


def phi_fixed_point(elogpi, elogbeta, pairs, y, w, log_eps: float,
                    max_iters: int, thresh: float, *, block: int = BLOCK,
                    elbo: bool = False,
                    csr: Optional[Adjacency] = None,
                    update: Optional[NodeUpdate] = None,
                    keep_staged: bool = False):
    """Kernel 8 (csrc/phi_fixed_point.cu) on a CUDA tensor, the plain
    version on a CPU tensor. elogpi (n,K) and elogbeta (K,2) f32; pairs
    (B,2) and y (B,) int32; w (B,) f32; any K; `block` the exit rule's.

    Training form: returns (rows (n,K), lacc (K,2), rounds (B,) int32,
    each pair's R_b), rows gamma_hat, or with `update` each node's row as
    NodeUpdate says (the next gamma of an SVI, FastAMM or -batch step;
    gamma is read, not written). On the card pass 1 runs every pair, a
    group of 8 to 32 lanes to a pair with its rows in shared memory, to its
    bit-stable round, recording a mask of its rounds below the threshold,
    and writes phi1 and phi2 into a staging buffer (2B, K); a warp a block
    ANDs the masks into R_b; pass 2 runs again the pairs whose phis came
    after more than R_b rounds, for R_b, and adds lacc from per-group
    running rows in group order; the node pass walks `csr`
    (owner_csr of pairs.reshape(-1): each node's slots, 2i for the first
    end of pair i and 2i + 1 for its second; made here when not given, an
    engine with a fixed pair set makes it once) and writes each node's row
    once, summing w phi over its slots in slot order, hub segments
    combined in segment order. No atomics: two launches give the same
    bits.

    ELBO form (elbo=True): returns (the weighted sum of the per-pair ELBO
    terms, a () f32 tensor, rounds), added per group, per block in group
    order and over blocks in block order.

    keep_staged (on the card): the training form returns the staging
    buffer fourth, phi1 of pair i in row 2i and phi2 in row 2i + 1, the
    ELBO form each pair's unweighted term (B,) third (neither written for
    pairs of weight 0); then the rounds that made pass 1's phis (a pair
    with more than its R_b ran again in pass 2), so that a check can hold
    each pair to the plain version."""
    if elogpi.device.type == "cpu":
        if elbo:
            return pair_elbo_plain(elogpi, elogbeta, pairs, y, w, log_eps,
                                   max_iters, thresh, block=block)
        gacc, lacc, rounds = pair_block_stats_plain(
            elogpi, elogbeta, pairs, y, w, log_eps, max_iters, thresh,
            block=block)
        if update is not None:
            gacc = node_update_plain(gacc, update)
        return gacc, lacc, rounds
    build.require_cuda(elogpi, "phi_fixed_point")
    pairs = pairs.to(torch.int32).contiguous()
    y = y.to(torch.int32).contiguous()
    dev, n, k, m = _pair_checks(elogpi, elogbeta, pairs, y, w)
    kp = (k + 3) // 4 * 4
    # row 0 the links' Elogf, row 1 the nonlinks', padded to kp
    fr = torch.zeros((2, kp), dtype=torch.float32, device=dev)
    fr[:, :k] = elogbeta.t()
    plan = fixed_point_plan(k, elbo, m, dev)
    groups = plan["blocks"] * plan["groups_per_block"]
    rounds = torch.empty(m, dtype=torch.int32, device=dev)
    rows = (None if plan["layout"] != "device rows" else
            torch.empty((groups, 4, kp), dtype=torch.float32, device=dev))
    # the rule's scratch: a mask of words of 64 rounds and a stop round for
    # every slot (the virtual pad slot of a last partial block too), R_b
    slots = m + (1 if m % block else 0)
    words = max(1, -(-max_iters // 64))
    masks = torch.empty((slots, words), dtype=torch.int64, device=dev)
    stop = torch.empty(slots, dtype=torch.int32, device=dev)
    block_rounds = torch.empty(max(1, -(-m // block)), dtype=torch.int32,
                               device=dev)
    if elbo:
        sums = torch.empty(1, dtype=torch.float32, device=dev)
        partial = torch.empty(plan["blocks"], dtype=torch.float32,
                              device=dev)
        terms = torch.empty(m, dtype=torch.float32, device=dev)
        staged = lam = seg_partial = out = gamma = gs = rho = None
        ptrs = (None,) * 7
        n_hubs = n_segs = mode = 0
        seg_len, alpha = SEG_LEN, 0.0
    else:
        if csr is None:
            csr = owner_csr(pairs.reshape(-1), n)
        if csr.nbr.shape[0] != 2 * m or csr.n != n:
            raise ValueError("csr is not the endpoint CSR of these pairs")
        n_hubs, n_segs = csr.hub_node.shape[0], csr.seg_node.shape[0]
        sums = torch.empty(2 * kp, dtype=torch.float32, device=dev)
        partial = terms = None
        staged = torch.empty((2 * m, k), dtype=torch.float32, device=dev)
        lam = torch.empty((groups, 2, kp), dtype=torch.float32, device=dev)
        seg_partial = torch.empty((n_segs, k), dtype=torch.float32,
                                  device=dev)
        out = torch.empty((n, k), dtype=torch.float32, device=dev)
        ptrs = tuple(t.data_ptr() for t in csr.tensors())
        seg_len = csr.seg_len
        gamma = gs = rho = None
        mode, alpha = 0, 0.0
        if update is not None:
            alpha = float(update.alpha)
            mode = 2
            if update.gamma is not None:
                gamma = update.gamma
                build.check_cuda(gamma, "gamma", torch.float32, (n, k), dev)
                gs = _scalar(update.gscale, dev)
                if torch.as_tensor(update.rho).dim() == 1:
                    rho = update.rho
                    build.check_cuda(rho, "rho", torch.float32, (n,), dev)
                    mode = 3
                else:
                    rho = _scalar(update.rho, dev)
                    mode = 1

    def ptr(t):
        return None if t is None else t.data_ptr()

    build.launch("svt_phi_fixed_point", dev, elogpi.data_ptr(),
                 fr.data_ptr(), pairs.data_ptr(), y.data_ptr(),
                 w.data_ptr(), ptr(staged), rounds.data_ptr(), ptr(lam),
                 ptr(rows), ptr(partial), sums.data_ptr(), masks.data_ptr(),
                 stop.data_ptr(), block_rounds.data_ptr(), ptr(terms), *ptrs,
                 ptr(seg_partial), ptr(gamma), ptr(gs), ptr(rho), ptr(out),
                 n, m, n_hubs, n_segs, k, seg_len, int(max_iters),
                 float(log_eps), float(thresh), alpha, mode, int(elbo),
                 plan["blocks"], int(block))
    build.count_launch(phi_fixed_point, "elbo" if elbo else (
        "fastamm" if mode == 3 else "f32"))
    if elbo:
        return (sums[0], rounds, terms, stop[:m]) if keep_staged else (
            sums[0], rounds)
    lacc = torch.stack([sums[:k], sums[kp:kp + k]], dim=1)
    if keep_staged:
        return out, lacc, rounds, staged, stop[:m]
    return out, lacc, rounds


phi_fixed_point.launches = 0
phi_fixed_point.forms = {}
