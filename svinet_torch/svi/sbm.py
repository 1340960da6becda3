"""SBM, the -single engine: a single-membership stochastic blockmodel
(svinet_tpu/svi/sbm.py; reference: src/sbm.cc).

A global gamma (K,) over the group proportions (alpha 0.5), per-node soft
assignments phi (n, K) and lambda (K + 1, 2), whose row K is the
cross-community link rate. batch_infer: up to 10 E-step rounds, each
updating every node's phi chunk by chunk (node id % 16, a chunk seeing
the chunks before it and its own rows as they stood before it: blocked
Gauss-Seidel),

  phi_p ~ softmax(Elogpi + s1_p (A - A_K) + s0_p (B - B_K)),

s1_p the sum of phi over p's training neighbours, s0_p that over its
nonlink partners (all the other nodes, less the neighbours and the
held-out partners), A and B the columns of Elogbeta, until the summed
change is below 0.01; then the closed-form M-step. infer (-single
-infset): stochastic steps around a random node, each touched node
blending its phi toward a one-shot estimate at its own Robbins-Monro
rate.

Kernel 14 (csrc/sbm_estep.cu) runs the E-step's chunks, pulling each
row's sums over the CSRs of the training links and of the held-out pairs
and writing a round's rows apart from its input; kernel 1 takes Elogpi of
the (1, K) gamma and Elogbeta of the (K + 1, 2) lambda, and kernel 12 the
label-propagation sweeps of phi's initialisation. The M-step, the
stochastic step and the likelihood are plain PyTorch, in chunks of pairs.
A CPU tensor takes the plain versions; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from svinet_torch.config import Config
from svinet_torch.evals.likelihood import HeldoutResult, result_from_sums
from svinet_torch.graph import Network
from svinet_torch.io.writers import write_communities
from svinet_torch.kernels import build
from svinet_torch.ops.edges import (
    BLOCK_BUDGET_BYTES, Adjacency, build_adjacency)
from svinet_torch.ops.expectations import dirichlet_expectation
from svinet_torch.svi.base import EngineBase
from svinet_torch.svi.fastamm import node_rates, touched_rows
from svinet_torch.svi.fastinit import label_propagation

N_CHUNKS = 16         # Gauss-Seidel chunks (node id % N_CHUNKS)
ESTEP_ROUNDS = 10
ESTEP_THRESH = 0.01
INF_EPS = 0.001       # reference: src/sbm.cc:9
SBM_ALPHA = 0.5       # reference: src/env.hh:345


def chunk_incident_pairs(pairs: np.ndarray, n_chunks: int = N_CHUNKS):
    """Per-chunk incident pair lists for the blocked Gauss-Seidel E-step:
    chunk c's list holds every pair with an endpoint in chunk c
    (node id % n_chunks == c), padded to a common length. A chunk's
    phi_update then scatters only its own incident pairs instead of the
    whole graph — the full-edge scatter repeated per chunk was ~n_chunks
    times the necessary E-step work. Returns (pairs (C,Emax,2) int32,
    mask (C,Emax) f32)."""
    pairs = pairs.reshape(-1, 2).astype(np.int32)
    cid_p = pairs[:, 0] % n_chunks
    cid_q = pairs[:, 1] % n_chunks
    lists = [pairs[(cid_p == c) | (cid_q == c)] for c in range(n_chunks)]
    emax = max(1, max(len(l) for l in lists))
    emax = ((emax + 63) // 64) * 64
    out = np.zeros((n_chunks, emax, 2), np.int32)
    msk = np.zeros((n_chunks, emax), np.float32)
    for c, l in enumerate(lists):
        out[c, :len(l)] = l
        msk[c, :len(l)] = 1.0
    return out, msk


def held_pairs_of(network: Network) -> np.ndarray:
    """Every split's pairs, deduplicated by key in first-occurrence order:
    each is left out of the nonlink totals exactly once
    (svinet_tpu/svi/sbm.py:301-315)."""
    held = np.concatenate(
        [network.validation_pairs.reshape(-1, 2),
         network.heldout_pairs.reshape(-1, 2),
         network.test_pairs.reshape(-1, 2),
         network.precision_pairs.reshape(-1, 2)], axis=0).astype(np.int32)
    if len(held):
        keys = held[:, 0].astype(np.int64) * network.n + held[:, 1]
        held = held[np.sort(np.unique(keys, return_index=True)[1])]
    return held


def _pair_chunk(k: int) -> int:
    """Pairs a chunk of a plain pair pass: its (B, K) f32 intermediates
    within BLOCK_BUDGET_BYTES."""
    return max(1024, BLOCK_BUDGET_BYTES // max(4 * k, 4))


# ---------------------------------------------------------------------
# Kernel 14: the E-step's chunks.

def _pull_rows(phi: torch.Tensor, adj: Adjacency, rows: torch.Tensor
               ) -> torch.Tensor:
    """(len(rows), K): each row's sum of phi over its adjacency list."""
    k = phi.shape[1]
    rp = adj.rowptr.long()
    out = torch.zeros((rows.shape[0], k), dtype=phi.dtype, device=phi.device)
    nbr = adj.nbr.long()
    step = max(64, BLOCK_BUDGET_BYTES // max(
        4 * k * max(1, nbr.shape[0] // max(1, adj.n)), 1))
    for lo in range(0, rows.shape[0], step):
        r = rows[lo:lo + step]
        b = rp[r]
        d = rp[r + 1] - b
        seg = torch.repeat_interleave(torch.arange(r.shape[0],
                                                   device=phi.device), d)
        start = torch.cumsum(d, 0) - d
        idx = (torch.repeat_interleave(b - start, d)
               + torch.arange(seg.shape[0], device=phi.device))
        out[lo:lo + step].index_add_(0, seg, phi[nbr[idx]])
    return out


def estep_chunk_plain(phi, elogpi, da, db, tot, links: Adjacency,
                      held: Adjacency, c: int, n_chunks: int = N_CHUNKS):
    """Chunk c's new rows from phi as it stands (svinet_tpu/svi/sbm.py:
    97-116): (new phi (n_c, K) of rows c, c + n_chunks, ..., each row's
    summed change (n_c,)). tot is phi's column sums; da = A - A_K, db =
    B - B_K."""
    rows = torch.arange(c, phi.shape[0], n_chunks, device=phi.device)
    old = phi[rows]
    s1 = _pull_rows(phi, links, rows)
    h = _pull_rows(phi, held, rows)
    s0 = ((tot[None, :] - old) - s1) - h
    logits = elogpi[None, :] + s1 * da + s0 * db
    new = torch.softmax(logits, dim=-1)
    return new, (new - old).abs().sum(1)


def sbm_estep_plain(phi, elogpi, da, db, links: Adjacency, held: Adjacency,
                    max_rounds: int = ESTEP_ROUNDS,
                    thresh: float = ESTEP_THRESH) -> Tuple[torch.Tensor, int]:
    """The E-step in plain PyTorch, phi in place: rounds while the summed
    change |phi' - phi| of the round is >= thresh (compared in f32), at
    most max_rounds; each round the chunks in order, tot recomputed
    before each (svinet_tpu/svi/sbm.py:123-142). Returns (phi, rounds)."""
    n = phi.shape[0]
    r = 0
    change = torch.tensor(float("inf"), dtype=phi.dtype)
    while r < max_rounds and bool(change >= thresh):
        before = phi.clone()
        for c in range(min(N_CHUNKS, n)):
            new, _ = estep_chunk_plain(phi, elogpi, da, db, phi.sum(0),
                                       links, held, c)
            phi[c::N_CHUNKS] = new
        change = (phi - before).abs().sum()
        r += 1
    return phi, r


class EStepBuffers(NamedTuple):
    """Kernel 14's buffers: the round's output rows (the E-step swaps them
    with its input after every round), every row's change, the chunks'
    column sums and their total (phi's column sums, added in chunk order),
    and on the card the kernel's scratch (its warps' and blocks' column
    sums) and the ticket of its last block."""
    out: torch.Tensor           # (n, K)
    change: torch.Tensor        # (n,)
    partial: torch.Tensor       # (16, K)
    tot: torch.Tensor           # (K,)
    scratch: torch.Tensor       # svt_sbm_estep_scratch's floats; (0,) on cpu
    ticket: torch.Tensor        # (1,) int32, 0 between launches


def estep_buffers(n: int, k: int, device) -> EStepBuffers:
    device = torch.device(device)
    f32 = dict(dtype=torch.float32, device=device)
    if device.type == "cuda":
        scratch = build.scratch("svt_sbm_estep_scratch", k, device,
                                torch.float32)
    else:
        scratch = torch.empty(0, **f32)
    return EStepBuffers(torch.empty((n, k), **f32), torch.zeros(n, **f32),
                        torch.zeros((N_CHUNKS, k), **f32),
                        torch.zeros(k, **f32), scratch,
                        torch.zeros(1, dtype=torch.int32, device=device))


def _check_estep(phi, links, held, bufs):
    dev = phi.device
    n, k = phi.shape
    build.check_cuda(phi, "phi", torch.float32, (n, k), dev)
    for name, adj in (("links", links), ("held", held)):
        build.check_cuda(adj.rowptr, f"{name}.rowptr", torch.int32, (n + 1,),
                         dev)
        build.check_cuda(adj.nbr, f"{name}.nbr", torch.int32,
                         tuple(adj.nbr.shape), dev)
    for name, t, shape in (("out", bufs.out, (n, k)),
                           ("change", bufs.change, (n,)),
                           ("partial", bufs.partial, (N_CHUNKS, k)),
                           ("tot", bufs.tot, (k,)),
                           ("scratch", bufs.scratch,
                            tuple(bufs.scratch.shape))):
        build.check_cuda(t, name, torch.float32, shape, dev)
    build.check_cuda(bufs.ticket, "ticket", torch.int32, (1,), dev)


def _renew_tot(bufs: EStepBuffers) -> None:
    """bufs.tot = the chunks' column sums added in chunk order."""
    t = bufs.partial[0].clone()
    for c in range(1, N_CHUNKS):
        t += bufs.partial[c]
    bufs.tot.copy_(t)


def chunk_sums(phi: torch.Tensor, bufs: EStepBuffers) -> None:
    """The column sums of every chunk's rows of phi into bufs.partial and
    their total into bufs.tot: kernel 14's sums form on a CUDA tensor, in
    plain PyTorch on a CPU tensor."""
    n, k = phi.shape
    if phi.device.type == "cpu":
        for c in range(N_CHUNKS):
            bufs.partial[c] = phi[c::N_CHUNKS].sum(0)
        _renew_tot(bufs)
        return
    build.require_cuda(phi, "chunk_sums")
    build.launch("svt_sbm_chunk_sums", phi.device, phi.data_ptr(),
                 bufs.scratch.data_ptr(), bufs.ticket.data_ptr(),
                 bufs.partial.data_ptr(), bufs.tot.data_ptr(), n, k,
                 N_CHUNKS)
    for _ in range(N_CHUNKS):  # a launch a chunk
        build.count_launch(estep_chunk, "sums")


def estep_chunk(src, dst, elogpi, da, db, links: Adjacency,
                held: Adjacency, c: int, bufs: EStepBuffers) -> None:
    """Chunk c of a round whose input is src and whose output is dst: the
    chunk's rows computed from phi as it stood before the chunk (the rows
    of chunks before c from dst, all others from src; bufs.tot its column
    sums) into dst, their changes into bufs.change[p], bufs.partial[c] and
    bufs.tot renewed. Kernel 14 on CUDA tensors; on CPU tensors
    estep_chunk_plain over that phi."""
    n, k = src.shape
    if src.device.type == "cpu":
        before = (torch.arange(n) % N_CHUNKS < c)[:, None]
        new, ch = estep_chunk_plain(torch.where(before, dst, src), elogpi,
                                    da, db, bufs.tot, links, held, c)
        dst[c::N_CHUNKS] = new
        bufs.change[c::N_CHUNKS] = ch
        bufs.partial[c] = new.sum(0)
        _renew_tot(bufs)
        return
    build.require_cuda(src, "estep_chunk")
    dev = src.device
    build.check_cuda(dst, "dst", torch.float32, (n, k), dev)
    for name, t in (("elogpi", elogpi), ("da", da), ("db", db)):
        build.check_cuda(t, name, torch.float32, (k,), dev)
    build.launch("svt_sbm_estep_chunk", dev, src.data_ptr(), dst.data_ptr(),
                 elogpi.data_ptr(), da.data_ptr(), db.data_ptr(),
                 links.rowptr.data_ptr(), links.nbr.data_ptr(),
                 held.rowptr.data_ptr(), held.nbr.data_ptr(),
                 bufs.change.data_ptr(), bufs.scratch.data_ptr(),
                 bufs.ticket.data_ptr(), bufs.partial.data_ptr(),
                 bufs.tot.data_ptr(), n, k, c, N_CHUNKS)
    build.count_launch(estep_chunk, "f32")


estep_chunk.launches = 0
estep_chunk.forms = {}


def _estep_rounds(phi, elogpi, da, db, links: Adjacency, held: Adjacency,
                  max_rounds: int, thresh: float, bufs: EStepBuffers
                  ) -> Tuple[torch.Tensor, int]:
    """sbm_estep's rounds through estep_chunk, phi in place: while the
    round's summed change is >= thresh (the f32 sum of the rows' changes,
    read on the host once a round), at most max_rounds, each round the
    chunks in order from phi into bufs.out, then the two swapped; phi
    takes the last round's rows. Returns (phi, rounds)."""
    n = phi.shape[0]
    chunk_sums(phi, bufs)
    src, dst = phi, bufs.out
    r = 0
    change = torch.tensor(float("inf"), dtype=phi.dtype)
    while r < max_rounds and bool(change >= thresh):
        for c in range(min(N_CHUNKS, n)):
            estep_chunk(src, dst, elogpi, da, db, links, held, c, bufs)
        change = bufs.change.sum().cpu()
        src, dst = dst, src
        r += 1
    if src is not phi:
        phi.copy_(src)
    return phi, r


def sbm_estep(phi, elogpi, da, db, links: Adjacency, held: Adjacency,
              max_rounds: int = ESTEP_ROUNDS, thresh: float = ESTEP_THRESH,
              bufs: "EStepBuffers | None" = None
              ) -> Tuple[torch.Tensor, int]:
    """The E-step, phi in place: kernel 14 chunk by chunk on CUDA tensors
    (_estep_rounds), sbm_estep_plain on CPU tensors. Returns (phi,
    rounds)."""
    if phi.device.type == "cpu":
        return sbm_estep_plain(phi, elogpi, da, db, links, held, max_rounds,
                               thresh)
    build.require_cuda(phi, "sbm_estep")
    n, k = phi.shape
    if bufs is None:
        bufs = estep_buffers(n, k, phi.device)
    _check_estep(phi, links, held, bufs)
    return _estep_rounds(phi, elogpi, da, db, links, held, max_rounds,
                         thresh, bufs)


# ---------------------------------------------------------------------
# The M-step, the likelihood, the stochastic step: plain PyTorch.

def _pair_products(phi, pairs) -> torch.Tensor:
    """(K,): sum over the pairs of phi_p * phi_q, in chunks."""
    k = phi.shape[1]
    acc = torch.zeros(k, dtype=phi.dtype, device=phi.device)
    step = _pair_chunk(k)
    for lo in range(0, pairs.shape[0], step):
        pp = pairs[lo:lo + step].long()
        acc += (phi[pp[:, 0]] * phi[pp[:, 1]]).sum(0)
    return acc


def sbm_mstep(phi, links, held, alpha: float, eta, n_valid_pairs: float,
              n_links: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """gamma = alpha + sum_i phi_i; lambda_k from the link and nonlink
    pair products (the nonlink ones in closed form, the held-out pairs
    left out), lambda_K the cross row (svinet_tpu/svi/sbm.py:144-160).
    links and held are (., 2) int pair tensors; the counts are f32."""
    k = phi.shape[1]
    f32 = np.float32
    t = phi.sum(0)
    gamma = float(f32(alpha)) + t
    link_pp = _pair_products(phi, links)
    held_pp = _pair_products(phi, held)
    all_pp = 0.5 * (t * t - (phi * phi).sum(0))
    zero_pp = (all_pp - link_pp - held_pp).clamp_min(0.0)
    nl = torch.tensor(f32(n_links), device=phi.device)
    nz = (torch.tensor(f32(n_valid_pairs), device=phi.device)
          - nl).clamp_min(0.0)
    lam_k = torch.stack([link_pp, zero_pp], 1)
    cross = torch.stack([k * nl - link_pp.sum(),
                         k * nz - zero_pp.sum()]).reshape(1, 2)
    return gamma, eta + torch.cat([lam_k, cross], 0)


def sbm_edge_loglik(phi, lam, pairs, y) -> torch.Tensor:
    """log of each pair's mixture probability (svinet_tpu/svi/sbm.py:
    257-267; reference: SBM::edge_likelihood2), in chunks of pairs."""
    k = phi.shape[1]
    rate = lam[:, 0] / (lam[:, 0] + lam[:, 1])
    out = []
    step = _pair_chunk(k)
    for lo in range(0, pairs.shape[0], step):
        pq = pairs[lo:lo + step].long()
        yy = y[lo:lo + step]
        pp = phi[pq[:, 0]] * phi[pq[:, 1]]
        inner = pp.sum(-1)
        r = torch.where(yy[:, None] == 1, rate[None, :k], 1.0 - rate[None, :k])
        rc = torch.where(yy == 1, rate[k], 1.0 - rate[k])
        s = (pp * r).sum(-1) + (1.0 - inner) * rc
        out.append(torch.log(s.clamp_min(1e-30)))
    if not out:
        return torch.zeros(0, dtype=phi.dtype, device=phi.device)
    return torch.cat(out)


def loglik_sums(phi, lam, pairs, y) -> torch.Tensor:
    """(6,): the held-out sums of sbm_edge_loglik (svinet_tpu/svi/sbm.py:
    247-253)."""
    ll = sbm_edge_loglik(phi, lam, pairs, y)
    ones = y == 1
    onesf = ones.to(ll.dtype)
    return torch.stack([
        ll.sum(), torch.tensor(float(ll.shape[0]), device=ll.device),
        torch.where(ones, 0.0, ll).sum(), (1.0 - onesf).sum(),
        torch.where(ones, ll, 0.0).sum(), onesf.sum()])


def _expectations(gamma, lam):
    """Elogpi (K,) through kernel 1 on the (1, K) gamma, and (A - A_K,
    B - B_K) from Elogbeta of the (K + 1, 2) lambda."""
    k = gamma.shape[0]
    elogpi = dirichlet_expectation(gamma.reshape(1, k))[0]
    elogbeta = dirichlet_expectation(lam)
    return elogpi, elogbeta


def sbm_batch_step(phi, gamma, lam, links: Adjacency, held: Adjacency,
                   link_pairs, held_pairs, alpha: float, eta,
                   n_valid_pairs: float, n_links: float,
                   estep_rounds: int = ESTEP_ROUNDS,
                   bufs: "EStepBuffers | None" = None):
    """One batch iteration, phi in place: the E-step (kernel 14 on the
    card), then the M-step (svinet_tpu/svi/sbm.py:76-160). Returns (phi,
    gamma, lambda, the E-step's rounds)."""
    k = phi.shape[1]
    elogpi, elogbeta = _expectations(gamma, lam)
    da = (elogbeta[:k, 0] - elogbeta[k, 0]).contiguous()
    db = (elogbeta[:k, 1] - elogbeta[k, 1]).contiguous()
    phi, rounds = sbm_estep(phi, elogpi.contiguous(), da, db, links, held,
                            estep_rounds, bufs=bufs)
    gamma, lam = sbm_mstep(phi, link_pairs, held_pairs, alpha, eta,
                           n_valid_pairs, n_links)
    return phi, gamma, lam, rounds


class StochStep(NamedTuple):
    """One stochastic step's minibatch on the device: the start node r,
    its partners dst (m,) and their y; the touched rows (distinct, r and
    every partner, those past the pad too) with their rates; where r and
    each partner sit among them; the four scalars (phi_scale,
    gamma_scale, lambda_scale, rho_t) as () f32 tensors."""
    r: int
    dst: torch.Tensor
    y: torch.Tensor
    rows: torch.Tensor
    rho: torch.Tensor
    at_r: int
    at_dst: torch.Tensor
    scalars: torch.Tensor


def sbm_stoch_step(phi, gamma, lam, st: StochStep, alpha: float, eta):
    """One stochastic iteration around st.r, phi in place
    (svinet_tpu/svi/sbm.py:163-223): only the touched rows change, each
    blended toward its one-shot estimate at its own rate and
    renormalised (a row past the pad toward 0); then gamma and lambda
    take a rho_t step toward the minibatch's scaled statistics. Returns
    (gamma, lambda)."""
    k = phi.shape[1]
    phi_scale, gamma_scale, lambda_scale, rhot = st.scalars.unbind()
    elogpi, elogbeta = _expectations(gamma, lam)
    a_k, b_k = elogbeta[:k, 0], elogbeta[:k, 1]
    a_x, b_x = elogbeta[k, 0], elogbeta[k, 1]
    yf = (st.y == 1)[:, None]
    elf_k = torch.where(yf, a_k, b_k)
    elf_x = torch.where(yf, a_x, b_x)
    phi_r = phi[st.r]
    phi_d = phi[st.dst]
    # the start node's estimate over all its pairs; each partner's over its
    # one pair with r
    t_r = ((1.0 - phi_d) * elf_x + phi_d * elf_k).sum(0)
    phit_r = torch.softmax(elogpi + phi_scale * t_r, dim=-1)
    t_d = (1.0 - phi_r[None, :]) * elf_x + phi_r[None, :] * elf_k
    phit_d = torch.softmax(elogpi[None, :] + phi_scale * t_d, dim=-1)
    target = torch.zeros((st.rows.shape[0], k), dtype=phi.dtype,
                         device=phi.device)
    target[st.at_dst] = phit_d
    target[st.at_r] = phit_r
    rho = st.rho[:, None]
    blended = (1.0 - rho) * phi[st.rows] + rho * target
    phi[st.rows] = blended / blended.sum(1, keepdim=True).clamp_min(1e-30)
    # the statistics from the new phi
    pr = phi[st.r][None, :]
    pd = phi[st.dst]
    pp = pr * pd
    gsum = (pr + pd).sum(0)
    sum_a = torch.where(yf, pp, 0.0).sum(0)
    sum_b = torch.where(yf, 0.0, pp).sum(0)
    ones = (st.y == 1).to(phi.dtype)
    n1, n0 = ones.sum(), (1.0 - ones).sum()
    s1 = torch.where(yf, pp, 0.0).sum()
    s0 = torch.where(yf, 0.0, pp).sum()
    gammat = float(np.float32(alpha)) + gamma_scale * gsum
    lamt_k = eta[:k] + lambda_scale * torch.stack([sum_a, sum_b], 1)
    lamt_x = eta[k] + lambda_scale * torch.stack([n1 - s1, n0 - s0])
    lambdat = torch.cat([lamt_k, lamt_x[None, :]], 0)
    gamma = (1.0 - rhot) * gamma + rhot * gammat
    lam = (1.0 - rhot) * lam + rhot * lambdat
    return gamma, lam


class SBM(EngineBase):
    """The -single engine on the host."""

    stop_min_iter = 5000         # guard iter > 5000 (src/sbm.cc:895)
    stop_decline_reports = 3     # nh > 3 (src/sbm.cc:907)

    def __init__(self, cfg: Config, network: Network, device: torch.device):
        super().__init__(cfg, network, device)
        n, k = self.n, self.k
        f32 = dict(dtype=torch.float32, device=device)
        g0 = self.rng.gamma(100.0 * (100.0 / k), 0.01, size=k)
        self.links = build_adjacency(network.training_links, n, device)
        # phi from label propagation (the structured init of the JAX
        # engine), lambda started assortative
        phi0 = self._label_prop_phi_init()
        l0 = np.concatenate([np.tile([9.0, 1.0], (k, 1)), [[1.0, 9.0]]])
        self.gamma_k = torch.as_tensor(np.float32(g0), device=device)
        self.phi = torch.as_tensor(phi0, **f32)
        self.lam = torch.as_tensor(np.float32(l0), device=device)
        self.eta = torch.as_tensor(
            np.float32(np.tile([cfg.eta0, cfg.eta1], (k + 1, 1))),
            device=device)

        held = held_pairs_of(network)
        self.held = build_adjacency(held, n, device)
        self._link_pairs = self._device_pairs(
            network.training_links.astype(np.int32))
        self._held_pairs = self._device_pairs(held)
        self.n_links = float(len(network.training_links))
        self.n_valid_pairs = float(np.float32(network.total_pairs
                                              - len(held)))
        self._bufs = (estep_buffers(n, k, device) if device.type == "cuda"
                      else None)
        self._sbm_sums = None
        self._resume_if_requested()

    def _state_dict(self) -> dict:
        d = self._host_state()
        d.update(phi=self.phi, gamma_k=self.gamma_k, lam=self.lam)
        # the per-node Robbins-Monro counters are schedule state
        if hasattr(self, "_nodec"):
            d["nodec"] = torch.from_numpy(self._nodec)
        return d

    def _restore_state(self, state) -> None:
        self.phi = state["phi"].to(self.device, torch.float32)
        self.gamma_k = state["gamma_k"].to(self.device, torch.float32)
        self.lam = state["lam"].to(self.device, torch.float32)
        nc = state.get("nodec")
        if nc is not None:
            self._nodec = np.asarray(nc, np.int64).copy()
        self._restore_host_state(state)

    def _label_prop_phi_init(self) -> np.ndarray:
        """phi from log10(n) + 2 label-propagation sweeps at width min(8,
        n) (kernel 12): the propagated labels, largest first, map
        round-robin onto the K groups; a node takes 0.8 on its group and
        0.2 spread (svinet_tpu/svi/sbm.py:347-367)."""
        n, k = self.n, self.k
        lab = label_propagation(self.links, n, min(8, n),
                                int(math.log10(max(n, 10))) + 2)
        lab = lab.cpu().numpy()
        uniq, counts = np.unique(lab, return_counts=True)
        order = uniq[np.argsort(-counts)]
        group = np.empty(n if len(lab) == 0 else int(lab.max()) + 1,
                         np.int64)
        group[order] = np.arange(len(order)) % k
        phi0 = np.full((n, k), 0.2 / k, np.float32)
        phi0[np.arange(n), group[lab]] += 0.8
        return phi0

    # ------------------------------------------------------------------
    def report(self) -> bool:
        """validation.txt and heldout.txt rows of phi's mixture likelihood
        (from the batch interval's tail when it rode there), the stop rule
        (svinet_tpu/svi/sbm.py:371-399)."""
        cfg = self.cfg
        if self._sbm_sums is not None:
            res = result_from_sums(self._sbm_sums)
        else:
            ll = sbm_edge_loglik(self.phi, self.lam, self.val_pairs,
                                 self.val_y).cpu().numpy()
            y = self.val_y.cpu().numpy()
            ones = y == 1
            res = HeldoutResult(
                avg=float(ll.mean()), count=len(ll),
                avg0=float(ll[~ones].mean()) if (~ones).any() else 0.0,
                count0=int((~ones).sum()),
                avg1=float(ll[ones].mean()) if ones.any() else 0.0,
                count1=int(ones.sum()))
        nshol = self._vf.write(self.iteration, self.duration(), res,
                               cfg.zeros_prob, cfg.ones_prob)
        self._hf.write(self.iteration, self.duration(), res,
                       cfg.zeros_prob, cfg.ones_prob)
        stop = self._stop_and_write_max(nshol, None)
        self._end_of_report()
        return stop and cfg.use_validation_stop

    def batch_infer(self) -> None:
        """Every iteration up to the next report boundary, then the
        validation sums on the final state: one host round trip an
        interval (svinet_tpu/svi/sbm.py:401-429)."""
        cfg = self.cfg
        r = max(cfg.reportfreq, 1)
        while True:
            if cfg.max_iterations and self.iteration > cfg.max_iterations:
                self.do_on_stop()
                return
            todo = r - (self.iteration % r)
            if cfg.max_iterations:
                todo = min(todo, cfg.max_iterations - self.iteration + 1)
            self._sbm_sums = None
            for _ in range(todo):
                self.phi, self.gamma_k, self.lam, _ = sbm_batch_step(
                    self.phi, self.gamma_k, self.lam, self.links, self.held,
                    self._link_pairs, self._held_pairs, SBM_ALPHA, self.eta,
                    self.n_valid_pairs, self.n_links, bufs=self._bufs)
            self._sbm_sums = loglik_sums(self.phi, self.lam, self.val_pairs,
                                         self.val_y).cpu()
            self.iteration += todo
            if self.iteration % r == 0 and self.report():
                self.do_on_stop()
                return

    # ------------------------------------------------------------------
    def _minibatch(self):
        """One iteration's draws, in the JAX engine's order
        (svinet_tpu/svi/sbm.py:461-484): r, the coin, then the non-
        informative partners. Returns (r, partners, their y, the
        scales)."""
        net, n, k = self.network, self.n, self.k
        r = int(self.rng.integers(0, n))
        if self.rng.uniform() >= INF_EPS:
            others = np.concatenate([net.neighbors(r),
                                     net.sparse_zeros(r)]).astype(np.int64)
            scales = (n / 2.0, 0.5, n / 2.0)
        else:
            from svinet_torch.svi.sampling import random_nonlink_draws
            inf_sorted = np.sort(net.sparse_zeros(r).astype(np.int64))
            others = random_nonlink_draws(self.rng, net, n, r, k, inf_sorted,
                                          max_tries=50 * k)
            phi_scale = (n * n) / (2 * INF_EPS * k)
            scales = (phi_scale, n / (2 * INF_EPS * k), phi_scale)
        lo, hi = np.minimum(r, others), np.maximum(r, others)
        others = others[net.edge_ok_mask(lo, hi) & (others != r)]
        ys = net.y(np.full(len(others), r), others).astype(np.int32)
        return r, others, ys, scales

    def _stoch_step(self, r, others, ys, scales, pad: int) -> StochStep:
        """The step's device minibatch: the first `pad` partners step, and
        every partner and r take a rate and a counter tick (a node twice
        in the list, its last place's rate)."""
        cfg = self.cfg
        touched = np.r_[r, others].astype(np.int64)
        rho = node_rates(touched, self._nodec, cfg.nodetau0, cfg.nodekappa)
        rows, rho = touched_rows(touched, rho, self.n)
        m = min(len(others), pad)
        dst = others[:m]
        rhot = (cfg.tau0 + (self.iteration + 1)) ** (-cfg.kappa)
        dev = self.device
        return StochStep(
            r, torch.as_tensor(dst, device=dev),
            torch.as_tensor(ys[:m], device=dev),
            torch.as_tensor(rows, device=dev),
            torch.as_tensor(rho, device=dev),
            int(np.searchsorted(rows, r)),
            torch.as_tensor(np.searchsorted(rows, dst), device=dev),
            torch.as_tensor(np.float32([*scales, rhot]), device=dev))

    def infer(self) -> None:
        """Stochastic SVI (-single -infset; svinet_tpu/svi/sbm.py:432-521):
        each iteration a Bernoulli(0.001) coin picks an informative step
        (the start node's links and informative zeros, phi_scale n/2) or a
        non-informative one (K random nonlink partners)."""
        cfg = self.cfg
        net = self.network
        if net.sparse_zeros_ptr is None:
            nb = cfg.file_str("neighbors.bin")
            if os.path.exists(nb):
                net.load_neighborhood_sets(nb)
            elif os.path.exists("neighbors.bin"):
                net.load_neighborhood_sets("neighbors.bin")
            else:
                net.set_neighborhood_sets(cfg)
        if not hasattr(self, "_nodec"):   # restored by -resume
            self._nodec = np.zeros(self.n, np.int64)
        max_deg = int(net.training_deg.max()) if self.n else 1
        pad = 1 << int(np.ceil(np.log2(max(max_deg + 101, self.k, 64))))
        while True:
            if cfg.max_iterations and self.iteration > cfg.max_iterations:
                self.do_on_stop()
                return
            r, others, ys, scales = self._minibatch()
            if len(others):
                st = self._stoch_step(r, others, ys, scales, pad)
                self.gamma_k, self.lam = sbm_stoch_step(
                    self.phi, self.gamma_k, self.lam, st, SBM_ALPHA,
                    self.eta)
            # with no partner nothing steps, but the report boundary stands
            self.iteration += 1
            if self.iteration % cfg.reportfreq == 0 and self.report():
                self.do_on_stop()
                return

    def do_on_stop(self, next_iteration=None) -> None:
        """gamma.txt as phi's rows, the (K + 1) x 2 lambda.txt, groups.txt
        and communities.txt (svinet_tpu/svi/sbm.py:523-549)."""
        cfg = self.cfg
        phi = self.phi.cpu().numpy()
        lam = self.lam.cpu().numpy()
        seq2id = self.network.seq2id
        with open(cfg.file_str("gamma.txt"), "w") as f:
            f.writelines(
                f"{i}\t{int(seq2id[i])}\t"
                + "\t".join(f"{v:.5f}" for v in phi[i]) + "\n"
                for i in range(self.n))
        with open(cfg.file_str("lambda.txt"), "w") as f:
            for kk in range(lam.shape[0]):
                f.write(f"{kk}\t{lam[kk, 0]:.5f}\t{lam[kk, 1]:.5f}\n")
        groups = phi.argmax(1)
        with open(cfg.file_str("groups.txt"), "w") as f:
            f.writelines(
                f"{i}\t{int(seq2id[i])}\t"
                + "\t".join(f"{v:.3f}" for v in phi[i])
                + f"\t{int(groups[i])}\n" for i in range(self.n))
        comms: dict = {}
        for i, g in enumerate(groups):
            comms.setdefault(int(g), []).append(i)
        write_communities(cfg.file_str("communities.txt"), comms, seq2id)
        if cfg.checkpoint_freq:
            self.save_checkpoint(next_iteration)
