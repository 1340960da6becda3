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
A pair stops after the first round whose change, the larger of the two
mean absolute changes, is below `thresh`, or after `max_iters` rounds.
That is the reference's per-pair exit; the JAX package runs whole blocks
of 2048 pairs until every pair of the block is below `thresh`, which
moves a converged pair by less than `thresh` a round more
(tests/test_torch_mmsb.py holds the two to 1e-4). A pair of weight 0
(padding, or a nonlink that -inf masks) takes no round and adds nothing.

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

# pairs a plain block solves at once: (B, K) f32 temporaries of ~64 MB
_PLAIN_BLOCK_FLOATS = 1 << 24
# where the pair pass keeps a group's rows (csrc/phi_fixed_point.cu), by
# the index its plan reports: shared memory where an SM holds four groups,
# else device memory
LAYOUTS = {1: "shared rows", 2: "device rows"}


def phi_fixed_point_plain(elogpi_p, elogpi_q, elogbeta, y, log_eps: float,
                          max_iters: int = 50, thresh: float = 1e-5,
                          active=None, given=None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fixed point of B pairs from their gathered rows (B, K), with
    the per-pair exit. `active` (B,) bool marks the pairs that iterate;
    the others keep 1/K and take no round. `given` (B,) int, when set,
    replaces the exit rule: pair i takes given[i] rounds (so that the
    arithmetic of another implementation can be checked on the rounds it
    took, whatever side of the threshold rounding put a change on).
    Returns (phi1, phi2, rounds (B,) int32)."""
    b, k = elogpi_p.shape
    yf = (y == 1)[:, None]
    elogf = torch.where(yf, elogbeta[:, 0], elogbeta[:, 1])
    phi1 = torch.full((b, k), 1.0 / k, dtype=elogpi_p.dtype,
                      device=elogpi_p.device)
    phi2 = phi1.clone()
    done = (torch.zeros(b, dtype=torch.bool, device=elogpi_p.device)
            if active is None else ~active)
    rounds = torch.zeros(b, dtype=torch.int32, device=elogpi_p.device)
    if given is not None:
        done = done | (given <= 0)
    for r in range(max_iters):
        if bool(done.all()):
            break
        u1 = torch.where(yf, (1.0 - phi2) * log_eps, 0.0)
        n1 = torch.softmax(elogpi_p + elogf * phi2 + u1, dim=-1)
        u2 = torch.where(yf, (1.0 - phi1) * log_eps, 0.0)
        n2 = torch.softmax(elogpi_q + elogf * phi1 + u2, dim=-1)
        change = torch.maximum((n1 - phi1).abs().mean(-1),
                               (n2 - phi2).abs().mean(-1))
        run = ~done
        phi1 = torch.where(run[:, None], n1, phi1)
        phi2 = torch.where(run[:, None], n2, phi2)
        rounds += run.to(torch.int32)
        done = done | (~(change >= thresh) if given is None
                       else given <= r + 1)
    return phi1, phi2, rounds


def _plain_blocks(m: int, k: int):
    block = max(1, _PLAIN_BLOCK_FLOATS // max(k, 1))
    for lo in range(0, m, block):
        yield lo, min(lo + block, m)


def pair_block_stats_plain(elogpi, elogbeta, pairs, y, w, log_eps: float,
                           max_iters: int, thresh: float, given=None):
    """(gacc (n,K), lacc (K,2), rounds (B,)) in plain PyTorch, blocked
    over pairs; the scatter is index_add_, in elogpi's dtype. `given`:
    phi_fixed_point_plain's."""
    n, k = elogpi.shape
    dev = elogpi.device
    gacc = torch.zeros((n, k), dtype=elogpi.dtype, device=dev)
    lacc = torch.zeros((k, 2), dtype=elogpi.dtype, device=dev)
    rounds = torch.zeros(pairs.shape[0], dtype=torch.int32, device=dev)
    for lo, hi in _plain_blocks(pairs.shape[0], k):
        p = pairs[lo:hi, 0].long()
        q = pairs[lo:hi, 1].long()
        yy, ww = y[lo:hi], w[lo:hi]
        phi1, phi2, rounds[lo:hi] = phi_fixed_point_plain(
            elogpi[p], elogpi[q], elogbeta, yy, log_eps, max_iters, thresh,
            active=ww != 0, given=None if given is None else given[lo:hi])
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
                    max_iters: int, thresh: float, given=None):
    """(the weighted sum of the per-pair ELBO terms (), rounds (B,));
    `given`: phi_fixed_point_plain's."""
    k = elogpi.shape[1]
    dev = elogpi.device
    total = torch.zeros((), dtype=elogpi.dtype, device=dev)
    rounds = torch.zeros(pairs.shape[0], dtype=torch.int32, device=dev)
    for lo, hi in _plain_blocks(pairs.shape[0], k):
        p = pairs[lo:hi, 0].long()
        q = pairs[lo:hi, 1].long()
        yy, ww = y[lo:hi], w[lo:hi]
        ep, eq = elogpi[p], elogpi[q]
        phi1, phi2, rounds[lo:hi] = phi_fixed_point_plain(
            ep, eq, elogbeta, yy, log_eps, max_iters, thresh, active=ww != 0,
            given=None if given is None else given[lo:hi])
        terms = pair_elbo_terms(phi1, phi2, ep, eq, elogbeta, yy, log_eps)
        total = total + torch.where(ww != 0, terms * ww, 0.0).sum()
    return total, rounds


class NodeUpdate(NamedTuple):
    """How the node pass writes a node's row from its gamma_hat row g:
    with `gamma` set, the SVI step's (1 - rho) gamma + rho (alpha + gscale
    g) (svinet_tpu/svi/mmsb.py:159-160); without, -batch's alpha + g
    (svinet_tpu/svi/mmsb.py:240). gscale and rho are () f32 tensors."""
    gamma: Optional[torch.Tensor]
    alpha: float
    gscale: Optional[torch.Tensor] = None
    rho: Optional[torch.Tensor] = None


def node_update_plain(gacc, upd: NodeUpdate) -> torch.Tensor:
    """The node pass's update in plain PyTorch, the JAX step's expressions
    in its order."""
    if upd.gamma is None:
        return upd.alpha + gacc
    gammat = upd.alpha + upd.gscale * gacc
    return (1.0 - upd.rho) * upd.gamma + upd.rho * gammat


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
                    max_iters: int, thresh: float, *, elbo: bool = False,
                    csr: Optional[Adjacency] = None,
                    update: Optional[NodeUpdate] = None,
                    keep_staged: bool = False):
    """Kernel 8 (csrc/phi_fixed_point.cu) on a CUDA tensor, the plain
    version on a CPU tensor. elogpi (n,K) and elogbeta (K,2) f32; pairs
    (B,2) and y (B,) int32; w (B,) f32; any K.

    Training form: returns (rows (n,K), lacc (K,2), rounds (B,) int32),
    rows gamma_hat, or with `update` each node's row as NodeUpdate says
    (the next gamma of an SVI or -batch step; gamma is read, not written).
    On the card one launch solves every pair, a group of 8 to 32 lanes to
    a pair with its rows in shared memory, and writes w phi1 and w phi2
    into a staging buffer (2B, K); a second walks `csr` (owner_csr of
    pairs.reshape(-1): each node's slots, 2i for the first end of pair i
    and 2i + 1 for its second; made here when not given, an engine with a
    fixed pair set makes it once) and writes each node's row once, summing
    its slots in slot order, hub segments combined in segment order. lacc
    comes from per-group running rows added in group order. No atomics:
    two launches give the same bits.

    ELBO form (elbo=True): returns (the weighted sum of the per-pair ELBO
    terms, a () f32 tensor, rounds), added per group, per block in group
    order and over blocks in block order.

    keep_staged (training form, on the card): the staging buffer comes
    back fourth, w phi1 of pair i in row 2i and w phi2 in row 2i + 1, so
    that a check can hold each pair's phi to the plain version's."""
    if elogpi.device.type == "cpu":
        if elbo:
            return pair_elbo_plain(elogpi, elogbeta, pairs, y, w, log_eps,
                                   max_iters, thresh)
        gacc, lacc, rounds = pair_block_stats_plain(
            elogpi, elogbeta, pairs, y, w, log_eps, max_iters, thresh)
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
    if elbo:
        sums = torch.empty(1, dtype=torch.float32, device=dev)
        partial = torch.empty(plan["blocks"], dtype=torch.float32,
                              device=dev)
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
        partial = None
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
                rho = _scalar(update.rho, dev)
                mode = 1

    def ptr(t):
        return None if t is None else t.data_ptr()

    build.launch("svt_phi_fixed_point", dev, elogpi.data_ptr(),
                 fr.data_ptr(), pairs.data_ptr(), y.data_ptr(),
                 w.data_ptr(), ptr(staged), rounds.data_ptr(), ptr(lam),
                 ptr(rows), ptr(partial), sums.data_ptr(), *ptrs,
                 ptr(seg_partial), ptr(gamma), ptr(gs), ptr(rho), ptr(out),
                 n, m, n_hubs, n_segs, k, seg_len, int(max_iters),
                 float(log_eps), float(thresh), alpha, mode, int(elbo),
                 plan["blocks"])
    build.count_launch(phi_fixed_point, "elbo" if elbo else "f32")
    if elbo:
        return sums[0], rounds
    lacc = torch.stack([sums[:k], sums[kp:kp + k]], dim=1)
    return (out, lacc, rounds, staged) if keep_staged else (out, lacc,
                                                            rounds)


phi_fixed_point.launches = 0
phi_fixed_point.forms = {}
