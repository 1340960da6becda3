"""MMSBOrig, the -orig engine: the full blockmodel of Airoldi et al., batch
variational inference (svinet_tpu/svi/orig.py; reference:
src/mmsbinferorig.cc:211-294).

A K x K beta, point-estimated each iteration as beta_gh = sum y phi1_g
phi2_h / sum phi1_g phi2_h (symmetrised), and per pair the coupled fixed
point over log f (kernel 15, ops/orig_phi.py). Every unordered pair i < j
that no held-out split holds is solved once an iteration and adds 2 phi1
to gamma_hat[i], 2 phi2 to gamma_hat[j] and its moments phi1 phi2^T.

The pairs are those of np.triu_indices(n, 1), in that order, filtered by
the held-out splits, made on the engine's device row block by row block
and cut into chunks of whole blocks of the exit rule, so that no host
array of n^2/2 pairs and no (n^2/2, K) phi is ever made: a chunk's phis
are staged on the device, added into gamma_hat by the kernel's node pass
and into the K x K moments by a product, chunk by chunk in a fixed
order. The held-out log-likelihood and the per-node terms of the ELBO
are plain PyTorch.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from svinet_torch.config import Config
from svinet_torch.evals.likelihood import HeldoutResult
from svinet_torch.graph import Network
from svinet_torch.io.writers import write_groups
from svinet_torch.ops.edges import Adjacency, owner_csr
from svinet_torch.ops.expectations import dirichlet_expectation, dirichlet_mean
from svinet_torch.ops.orig_phi import (
    BLOCK, elbo_logf_pair, logf_pair, moments, orig_chunk)
from svinet_torch.svi.base import EngineBase

# bytes a chunk's staged phis (2 pairs x K f32) may take
STAGE_BYTES = 1 << 30
# pairs of the triangle made at once while the pair set is built
_ROW_PAIRS = 1 << 24


class PairChunk(NamedTuple):
    """A chunk of the pair set: whole blocks of the rule but the last
    chunk's last block, which `pad` completes with the padding pair."""
    pairs: torch.Tensor          # (c, 2) int32
    y: torch.Tensor              # (c,) int32
    csr: Optional[Adjacency]     # owner_csr of the chunk's ends (card)
    pad: bool


def _sorted_keys(keys, device) -> torch.Tensor:
    keys = np.asarray(keys if keys is not None else [], np.int64)
    return torch.as_tensor(np.sort(keys) if len(keys) else
                           np.array([-1], np.int64), device=device)


def _member(keys: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    idx = torch.searchsorted(table, keys).clamp_max(table.shape[0] - 1)
    return table[idx] == keys


def all_pairs(n: int, held_keys, edge_keys, device):
    """Every pair i < j of n nodes in np.triu_indices order whose key i n +
    j is not among held_keys, and its label (1 where the key is among
    edge_keys), made on `device` a block of rows at a time
    (svinet_tpu/svi/orig.py:208-213). Returns (pairs (m, 2) int32, y (m,)
    int32)."""
    held = _sorted_keys(held_keys, device)
    links = _sorted_keys(edge_keys, device)
    out_p, out_y = [], []
    i0 = 0
    while i0 < n - 1:
        # rows [i0, i1) with about _ROW_PAIRS pairs
        i1, count = i0, 0
        while i1 < n - 1 and (count == 0 or count + (n - 1 - i1)
                              <= _ROW_PAIRS):
            count += n - 1 - i1
            i1 += 1
        rows = torch.arange(i0, i1, device=device, dtype=torch.int64)
        per = n - 1 - rows
        i = torch.repeat_interleave(rows, per)
        start = torch.cumsum(per, 0) - per
        j = (torch.arange(i.shape[0], device=device)
             - torch.repeat_interleave(start, per) + i + 1)
        keys = i * n + j
        ok = ~_member(keys, held)
        out_p.append(torch.stack([i[ok], j[ok]], 1).to(torch.int32))
        out_y.append(_member(keys[ok], links).to(torch.int32))
        i0 = i1
    if not out_p:
        return (torch.zeros((0, 2), dtype=torch.int32, device=device),
                torch.zeros(0, dtype=torch.int32, device=device))
    return torch.cat(out_p), torch.cat(out_y)


def chunk_pairs(pairs, y, n: int, k: int, block: int = BLOCK,
                stage_bytes: int = 0) -> List[PairChunk]:
    """The pair set in chunks of whole blocks whose staged phis take at
    most stage_bytes (STAGE_BYTES when 0); on the card each with its
    endpoint CSR, made once."""
    stage_bytes = stage_bytes or STAGE_BYTES
    per = max(block, stage_bytes // (8 * k) // block * block)
    m = pairs.shape[0]
    chunks = []
    for lo in range(0, max(m, 1), per):
        p, yy = pairs[lo:lo + per], y[lo:lo + per]
        csr = (owner_csr(p.reshape(-1), n) if p.device.type == "cuda"
               else None)
        chunks.append(PairChunk(p, yy, csr, lo + per >= m))
    return chunks


def orig_batch_step(gamma, beta, chunks: List[PairChunk], alpha: float,
                    max_iters: int = 50, thresh: float = 1e-5,
                    block: int = BLOCK):
    """One batch iteration (svinet_tpu/svi/orig.py:125-162; reference:
    src/mmsbinferorig.cc:211-270): Elogpi of gamma (kernel 1), every
    chunk's fixed point (kernel 15, gamma_hat in its node pass), the
    moments; gamma' = alpha + gamma_hat, beta' = clip((Y + Y^T) / max(A +
    A^T, 1e-30), 1e-5, 1 - 1e-5). Returns (gamma', beta')."""
    n, k = gamma.shape
    dev = gamma.device
    elogpi = dirichlet_expectation(gamma)
    lf2 = logf_pair(beta).contiguous()
    gacc = torch.zeros((n, k), dtype=gamma.dtype, device=dev)
    a = torch.zeros((k, k), dtype=gamma.dtype, device=dev)
    ym = torch.zeros((k, k), dtype=gamma.dtype, device=dev)
    for c in chunks:
        if c.pairs.shape[0] == 0:
            continue
        staged, _ = orig_chunk(elogpi, lf2, c.pairs, c.y, max_iters, thresh,
                               block=block, pad=c.pad, gacc=gacc, csr=c.csr)
        ac, yc = moments(staged, c.y)
        a += ac
        ym += yc
        del staged
    gamma_new = float(np.float32(alpha)) + gacc
    bden = a + a.t()
    bnum = ym + ym.t()
    beta_new = (bnum / bden.clamp_min(1e-30)).clamp(1e-5, 1.0 - 1e-5)
    return gamma_new, beta_new


def orig_approx_elbo(gamma_new, gamma_old, beta_old, beta_new,
                     chunks: List[PairChunk], alpha: float,
                     max_iters: int = 50, thresh: float = 1e-5,
                     block: int = BLOCK) -> float:
    """The approximate ELBO of -logl (svinet_tpu/svi/orig.py:68-120;
    reference: MMSBInferOrig::approx_log_likelihood): the phis re-derived
    from gamma_old and beta_old by the same fixed point (kernel 15's ELBO
    form), the pair terms under beta_new and gamma_new, each pair twice,
    then the per-node Dirichlet terms."""
    n, k = gamma_new.shape
    elogpi_old = dirichlet_expectation(gamma_old)
    elogpi_new = dirichlet_expectation(gamma_new)
    lf2 = logf_pair(beta_old).contiguous()
    lfe2 = elbo_logf_pair(beta_new).contiguous()
    s = torch.zeros((), dtype=torch.float64, device=gamma_new.device)
    for c in chunks:
        if c.pairs.shape[0] == 0:
            continue
        terms, _ = orig_chunk(elogpi_old, lf2, c.pairs, c.y, max_iters,
                              thresh, block=block, pad=c.pad,
                              elbo=(elogpi_new, lfe2))
        s = s + (2.0 * terms).sum().double()
    a = torch.tensor(float(np.float32(alpha)), dtype=torch.float64)
    g = gamma_new.double()
    e = elogpi_new.double()
    s = s.cpu() + n * (torch.lgamma(k * a) - k * torch.lgamma(a))
    s = s + ((a - 1.0) * e).sum().cpu()
    s = s - (torch.lgamma(g.sum(1)).sum() - torch.lgamma(g).sum()).cpu()
    s = s - ((g - 1.0) * e).sum().cpu()
    return float(s)


def orig_edge_loglik(gamma, beta, pairs, y) -> torch.Tensor:
    """log max(s, 1e-30), s = sum_gh pi_p,g pi_q,h beta_gh^y
    (1 - beta_gh)^(1 - y) (svinet_tpu/svi/orig.py:166-174; reference:
    MMSBInferOrig::edge_likelihood)."""
    pi = dirichlet_mean(gamma)
    pp = pi[pairs[:, 0].long()]
    qq = pi[pairs[:, 1].long()]
    link = (y == 1)[:, None]
    s = torch.where(link, pp @ beta, pp @ (1.0 - beta))
    return torch.log((s * qq).sum(-1).clamp_min(1e-30))


class MMSBOrig(EngineBase):
    """The -orig engine on the host (svinet_tpu/svi/orig.py:177-305).
    The stock reference build has no stopping rule here; this engine
    keeps the classic held-out controller (guard iter > min(n, 5000)), as
    the JAX engine does."""

    def __init__(self, cfg: Config, network: Network, device: torch.device):
        super().__init__(cfg, network, device)
        n, k = self.n, self.k
        g0 = self.rng.gamma(100.0, 0.01, size=(n, k))
        if cfg.itype == 0:
            # init_beta1 (reference: src/mmsbinferorig.cc:167-186)
            b0 = np.clip(self.rng.integers(0, 100, size=(k, k)) / 100.0,
                         0.01, 0.99)
        else:
            # init_beta2: assortative diagonal, epsilon off it (reference:
            # src/mmsbinferorig.cc:189-209)
            eta0 = cfg.total_pairs * cfg.ones_prob / k
            eta1 = cfg.total_pairs / (k * k) - eta0
            if eta1 < 0:
                eta1 = 1.0
            b0 = np.full((k, k), cfg.epsilon)
            np.fill_diagonal(b0, eta0 / (eta0 + eta1))
        self.gamma = torch.as_tensor(np.asarray(g0, np.float32),
                                     device=device)
        self.beta = torch.as_tensor(np.asarray(b0, np.float32),
                                    device=device)
        self._block = min(cfg.edge_block, BLOCK)
        pairs, y = all_pairs(n, getattr(network, "_held_keys_sorted", None),
                             network._edge_keys, device)
        self.chunks = chunk_pairs(pairs, y, n, k, self._block)
        self._logl = None
        self._resume_if_requested()

    def _state_dict(self) -> dict:
        d = self._host_state()
        d.update(gamma=self.gamma, beta=self.beta)
        return d

    def _restore_state(self, state) -> None:
        self.gamma = state["gamma"].to(self.device, torch.float32)
        self.beta = state["beta"].to(self.device, torch.float32)
        self._restore_host_state(state)

    def step(self, want_old: bool = False):
        """One batch iteration on the engine's state; with want_old, the
        state it started from is returned (gamma, beta)."""
        cfg = self.cfg
        old = (self.gamma, self.beta) if want_old else None
        self.gamma, self.beta = orig_batch_step(
            self.gamma, self.beta, self.chunks, cfg.alpha,
            cfg.online_iterations, cfg.meanchangethresh, self._block)
        return old

    def elbo(self, gamma_old, beta_old) -> float:
        cfg = self.cfg
        return orig_approx_elbo(self.gamma, gamma_old, beta_old, self.beta,
                                self.chunks, cfg.alpha,
                                cfg.online_iterations, cfg.meanchangethresh,
                                self._block)

    def report(self) -> bool:
        """validation.txt and heldout.txt rows of the held-out
        log-likelihood, max.txt, the stop rule (svinet_tpu/svi/orig.py:
        233-251)."""
        cfg = self.cfg
        ll = orig_edge_loglik(self.gamma, self.beta, self.val_pairs,
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
        """Iterations until the stop or -max-iterations; under -logl the
        ELBO row at each report boundary, from the state the boundary's
        iteration started from (svinet_tpu/svi/orig.py:253-290)."""
        cfg = self.cfg
        if cfg.logl and self._logl is None:
            self._logl = open(cfg.file_str("logl.txt"),
                              "a" if cfg.resume else "w")
        lf = self._logl
        while True:
            if cfg.max_iterations and self.iteration > cfg.max_iterations:
                self.do_on_stop()
                return
            want = (lf is not None
                    and (self.iteration + 1) % cfg.reportfreq == 0)
            old = self.step(want_old=want)
            self.iteration += 1
            if lf is not None and self.iteration % cfg.reportfreq == 0:
                s = self.elbo(*old)
                lf.write(f"{self.iteration}\t{self.duration()}\t{s:.5f}\n")
                lf.flush()
            if self.iteration % cfg.reportfreq == 0 and self.report():
                self.do_on_stop()
                return

    def close(self) -> None:
        if self._logl is not None:
            self._logl.close()
            self._logl = None
        super().close()

    def do_on_stop(self, next_iteration=None) -> None:
        """gamma.txt, the K x K beta.txt, groups.txt and, with
        -checkpoint-freq, the checkpoint (svinet_tpu/svi/orig.py:292-305)."""
        cfg = self.cfg
        gamma = self.gamma.cpu().numpy()
        beta = self.beta.cpu().numpy()
        seq2id = self.network.seq2id
        with open(cfg.file_str("gamma.txt"), "w") as f:
            f.writelines(
                f"{i}\t{int(seq2id[i])}\t"
                + "\t".join(f"{v:.5f}" for v in gamma[i]) + "\n"
                for i in range(self.n))
        with open(cfg.file_str("beta.txt"), "w") as f:
            for g in range(self.k):
                f.write("\t".join(f"{v:.5f}" for v in beta[g]) + "\n")
        write_groups(cfg.file_str("groups.txt"), gamma, seq2id)
        if cfg.checkpoint_freq:
            self.save_checkpoint(next_iteration)
