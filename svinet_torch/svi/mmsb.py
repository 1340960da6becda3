"""MMSBInfer, the CLI's default engine: classic SVI with the per-pair phi
fixed point as its local step (svinet_tpu/svi/mmsb.py; reference:
src/mmsbinfer.cc:459-930).

Per iteration: a minibatch of node pairs (random pairs, a random node's
n-1 pairs, or stratified link/nonlink families) is drawn on the host with
the engine's numpy Generator, in the same calls and order as the JAX
engine, so both draw the same pairs; kernel 8 (ops/phicomp.py) solves
each pair's phi fixed point, sums the statistics gamma_hat (n,K) and
lambda_hat (K,2) and takes the natural-gradient Robbins-Monro step of
gamma in its node pass (on the CPU, the plain expressions):

  rho_node = (nodetau0 + iter/100)^(-nodekappa)
  gamma <- (1-rho_node) gamma + rho_node (alpha + scale/|batch| gamma_hat)

and lambda's, once delaylearn lets it (iter * s > total pairs), in plain
PyTorch on (K,2):

  rho_t = (tau0 + iter - lambda_start_iter + 1)^(-kappa)
  lambda <- (1-rho_t) lambda + rho_t (eta + scale/|batch| lambda_hat)

batch_infer sweeps all non-heldout pairs each iteration with gamma =
alpha + gamma_hat (reference: src/mmsbinfer.cc:833-930).

Under -mesh N (parallel/mesh.py; svinet_tpu/svi/mmsb.py:309-330 and
make_sharded_svi_multi_step, make_sharded_batch_step,
svinet_tpu/parallel/mesh.py:602-758) every rank draws the same
minibatches, pads each to N equal whole-block shards as the JAX engine
does and runs kernel 8 on its shard without the node update; gamma_hat
and lambda_hat are all-reduced and every rank takes gamma's step in plain
PyTorch, in the JAX step's expression order, on replicated gamma and
lambda (the reference's pthread map-reduce, src/mmsbinfer.cc:2400-2550).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from svinet_torch.config import Config
from svinet_torch.graph import Network
from svinet_torch.io.writers import load_model
from svinet_torch.ops.expectations import dirichlet_expectation
from svinet_torch.ops.edges import owner_csr
from svinet_torch.ops.phicomp import (
    BLOCK, NodeUpdate, node_update_plain, phi_fixed_point)
from svinet_torch.parallel import mesh
from svinet_torch.svi.base import EngineBase


def _f32(x) -> torch.Tensor:
    """A host scalar as the f32 scalar the JAX step takes it as."""
    return torch.tensor(np.float32(x))


def nonuniform_weights(gamma, pairs, y, mask, infthresh: float):
    """-nonuniform pair weights from the current gamma
    (svinet_tpu/svi/mmsb.py:81-117; reference:
    MMSBInfer::opt_nonuniform_process, src/mmsbinfer.cc:1525-1700). With
    p_i = E[pi_p] . E[pi_q]: every link, weight #links; the first nonlink
    with p_i < infthresh, weight #such nonlinks; the first 0.1% of the
    nonlinks with p_i >= infthresh, weight #those. Returns (weights,
    the number of pairs processed)."""
    gp = gamma[pairs[:, 0].long()]
    gq = gamma[pairs[:, 1].long()]
    pip = gp / gp.sum(-1, keepdim=True)
    piq = gq / gq.sum(-1, keepdim=True)
    p_i = (pip * piq).sum(-1).clamp(0.0, 1.0)
    valid = mask > 0
    is_link = (y == 1) & valid
    noninf = (y == 0) & valid & (p_i < infthresh)
    inf = (y == 0) & valid & (p_i >= infthresh)
    nones = is_link.sum().to(torch.int32)
    nz_inf = inf.sum().to(torch.int32)
    nz_noninf = noninf.sum().to(torch.int32)
    n3_max = (0.001 * nz_inf.to(torch.float32)).to(torch.int32)
    sel_noninf = noninf & (torch.cumsum(noninf.to(torch.int32), 0) <= 1)
    sel_inf = inf & (torch.cumsum(inf.to(torch.int32), 0) <= n3_max)
    f = gamma.dtype
    w = (is_link.to(f) * nones.to(f)
         + sel_noninf.to(f) * nz_noninf.to(f)
         + sel_inf.to(f) * nz_inf.to(f))
    n_processed = nones + sel_noninf.sum() + sel_inf.sum()
    return w, n_processed


def _shard_stats(elogpi, elogbeta, pairs, y, w, log_eps: float,
                 max_iters: int, thresh: float, csr, block: int, group):
    """gamma_hat (n,K) and lambda_hat (K,2) over all ranks' shards: kernel
    8 on this rank's pairs without the node update, then both summed over
    the ranks (svinet_tpu/parallel/mesh.py:654-659). A shard that holds
    no pair adds zeros."""
    n, k = elogpi.shape
    if pairs.shape[0]:
        gacc, lacc, _ = phi_fixed_point(elogpi, elogbeta, pairs, y, w,
                                        log_eps, max_iters, thresh,
                                        block=block, csr=csr)
    else:
        gacc = elogpi.new_zeros((n, k))
        lacc = elogpi.new_zeros((k, 2))
    return mesh.all_reduce(gacc), mesh.all_reduce(lacc)


def svi_step(gamma, lam, pairs, y, w, alpha: float, eta, gscale, lscale,
             noderhot, rhot, do_lambda, log_eps: float, max_iters: int,
             thresh: float = 1e-5, infthresh: float = 0.0,
             nonuniform: bool = False, csr=None, block: int = BLOCK,
             group=None):
    """One natural-gradient SVI step (svinet_tpu/svi/mmsb.py:123-164).
    infthresh > 0 gives weight 0 to the nonlinks whose max_k pi_p pi_q is
    below it (reference: MMSBInfer::opt_process,
    src/mmsbinfer.cc:1192-1298); with `nonuniform` the weights are
    nonuniform_weights' and the scales carry the -rnode flag in their
    sign: > 0 takes the scale 3n / (2 n_processed), <= 0 keeps |scale|
    (src/mmsbinfer.cc:571-572). The scalars are f32 tensors or floats;
    `block` is the exit rule's (ops/phicomp.py), the engine's B. With a
    mesh `group`, pairs, y and w are this rank's shard of the minibatch
    (make_sharded_svi_multi_step, svinet_tpu/parallel/mesh.py:633-663):
    the -nonuniform weights take the global counts
    (mesh.sharded_nonuniform_weights) and gamma's step runs after the
    all-reduce. Returns the new (gamma, lam)."""
    elogpi = dirichlet_expectation(gamma)
    elogbeta = dirichlet_expectation(lam)
    dev = gamma.device
    gs = torch.as_tensor(gscale, dtype=torch.float32).to(dev)
    ls = torch.as_tensor(lscale, dtype=torch.float32).to(dev)
    if nonuniform and infthresh > 0.0:
        if group is None:
            w, n_proc = nonuniform_weights(gamma, pairs, y, w, infthresh)
        else:
            w, n_proc = mesh.sharded_nonuniform_weights(gamma, pairs, y, w,
                                                        infthresh, group)
        n = torch.tensor(float(gamma.shape[0]), dtype=gamma.dtype,
                         device=dev)
        dev_scale = 3.0 * n / (2.0 * n_proc.clamp_min(1).to(gamma.dtype))
        gs = torch.where(gs > 0, dev_scale, -gs)
        ls = torch.where(ls > 0, dev_scale, -ls)
    elif infthresh > 0.0:
        gp = gamma[pairs[:, 0].long()]
        gq = gamma[pairs[:, 1].long()]
        pip = gp / gp.sum(-1, keepdim=True)
        piq = gq / gq.sum(-1, keepdim=True)
        inf = (pip * piq).max(-1).values >= infthresh
        w = torch.where((y == 1) | inf, w, 0.0)
    nr = torch.as_tensor(noderhot, dtype=torch.float32).to(dev)
    rt = torch.as_tensor(rhot, dtype=torch.float32).to(dev)
    upd = NodeUpdate(gamma, alpha, gs, nr)
    if group is None:
        # kernel 8's node pass writes the next gamma
        # (ops/phicomp.py:NodeUpdate)
        gamma, lacc, _ = phi_fixed_point(elogpi, elogbeta, pairs, y, w,
                                         log_eps, max_iters, thresh,
                                         block=block, csr=csr, update=upd)
    else:
        gacc, lacc = _shard_stats(elogpi, elogbeta, pairs, y, w, log_eps,
                                  max_iters, thresh, csr, block, group)
        gamma = node_update_plain(gacc, upd)
    if float(do_lambda) > 0:
        lambdat = eta + ls * lacc
        lam = (1.0 - rt) * lam + rt * lambdat
    return gamma, lam


def batch_step(gamma, lam, pairs, y, w, alpha: float, eta, do_lambda,
               log_eps: float, max_iters: int, thresh: float = 1e-5,
               csr=None, block: int = BLOCK, group=None):
    """One coordinate-ascent pass over all non-heldout pairs
    (svinet_tpu/svi/mmsb.py:233-243; reference: MMSBInfer::batch_infer,
    src/mmsbinfer.cc:833-895): gamma = alpha + gamma_hat, and lambda =
    eta + lambda_hat unless -nolambda. With a mesh `group`, pairs are this
    rank's shard and gamma_hat, lambda_hat are summed over the ranks first
    (make_sharded_batch_step, svinet_tpu/parallel/mesh.py:706-758)."""
    elogpi = dirichlet_expectation(gamma)
    elogbeta = dirichlet_expectation(lam)
    if group is None:
        gamma, lacc, _ = phi_fixed_point(elogpi, elogbeta, pairs, y, w,
                                         log_eps, max_iters, thresh,
                                         block=block, csr=csr,
                                         update=NodeUpdate(None, alpha))
    else:
        gacc, lacc = _shard_stats(elogpi, elogbeta, pairs, y, w, log_eps,
                                  max_iters, thresh, csr, block, group)
        gamma = node_update_plain(gacc, NodeUpdate(None, alpha))
    if float(do_lambda) > 0:
        lam = eta + lacc
    return gamma, lam


def init_gamma_random(rng: np.random.Generator, n: int, k: int,
                      deterministic: bool = False) -> np.ndarray:
    """gamma_ij ~ Gamma(100, 0.01): mean 1 with ~10% noise (reference:
    MMSBInfer::init_gamma, src/mmsbinfer.cc:373-386); deterministic mode
    takes the reference's closed-form grid (src/mmsbinfer.cc:376-383)."""
    if deterministic:
        i = np.arange(n)[:, None].astype(np.float64)
        j = np.arange(k)[None, :].astype(np.float64)
        g = 0.09 + 0.01 * ((i + 1.0) / (i + j + 1.0))
        return np.minimum(g, 0.9)
    return rng.gamma(100.0, 1.0 / 100.0, size=(n, k))


class MMSBInfer(EngineBase):
    """The engine on the host: batch, rpair, rnode and stratified modes."""

    dual_heldout_splits = True   # src/mmsbinfer.cc:206-328

    def __init__(self, cfg: Config, network: Network, device: torch.device,
                 group: "mesh.Group | None" = None):
        super().__init__(cfg, network, device, group)
        n, k = self.n, self.k
        if cfg.model_load and cfg.gamma_location:
            g0, l0 = load_model(cfg.gamma_location, n, k, cfg.t)
        else:
            g0 = init_gamma_random(self.rng, n, k, cfg.deterministic)
            l0 = np.tile([cfg.eta0, cfg.eta1], (k, 1))
        self.gamma = torch.as_tensor(g0, dtype=torch.float32, device=device)
        self.lam = torch.as_tensor(l0, dtype=torch.float32, device=device)
        self.alpha = float(np.float32(cfg.alpha))
        self.eta = torch.as_tensor(np.tile([cfg.eta0, cfg.eta1], (k, 1)),
                                   dtype=torch.float32, device=device)
        self.log_eps = float(np.float32(np.log(cfg.epsilon)))

        self._family = 0
        # -nonuniform needs -inf (reference: src/mmsbinfer.cc:543-548)
        self._nonuniform = bool(cfg.nonuniform and cfg.infthresh > 0)
        self._lambda_start_iter = 0
        self._delaylearn_reported = False
        # the exit rule's block (svinet_tpu/svi/mmsb.py:307)
        self._block = min(cfg.edge_block, BLOCK)
        # the report files keep their rows of before a resume
        mode = "a" if cfg.resume else "w"
        self._lf = open(cfg.file_str("logl.txt"), mode) if cfg.logl else None
        self._mf = open(cfg.file_str("modularity.txt"), mode)
        self._elbo_cache = None
        if self._group is not None:
            cfg.plog("mesh devices", self._group.size)
        self._resume_if_requested()
        if self._group is not None:
            # rank 0's state on every rank, at start and after -resume
            self.gamma = mesh.broadcast(self.gamma.contiguous())
            self.lam = mesh.broadcast(self.lam.contiguous())

    def close(self) -> None:
        super().close()
        for f in (self._lf, self._mf):
            if f is not None:
                f.close()

    def _state_dict(self) -> dict:
        d = super()._state_dict()
        # the lambda Robbins-Monro clock and the stratified family phase
        # are schedule state: without them a resume restarts rhot at
        # (tau0 + 1)^-kappa and the link/nonlink alternation at 0
        d["lambda_clock"] = [int(self._lambda_start_iter),
                             int(self._delaylearn_reported),
                             int(self._family)]
        return d

    def _restore_state(self, state) -> None:
        super()._restore_state(state)
        lc = state.get("lambda_clock")
        if lc is not None:
            self._lambda_start_iter = int(lc[0])
            self._delaylearn_reported = bool(lc[1])
            self._family = int(lc[2])

    # ------------------------------------------------------------------
    def _y_of(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        return self.network.y(lo, hi).astype(np.int32)

    def _edge_ok(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        return self.network.edge_ok_mask(lo, hi)

    def _sample_rpair(self, s: int, family: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """s uniform random valid pairs, with replacement
        (reference: get_random_edge, src/mmsbinfer.hh:719-748)."""
        out = np.zeros((0, 2), np.int64)
        ys = np.zeros(0, np.int32)
        while len(out) < s:
            m = max(64, 2 * (s - len(out)))
            if family == 1:
                tl = self.network.training_links
                sel = self.rng.integers(0, len(tl), size=m)
                lo = tl[sel, 0].astype(np.int64)
                hi = tl[sel, 1].astype(np.int64)
                ok = np.ones(m, bool)
            else:
                a = self.rng.integers(0, self.n, size=m)
                b = self.rng.integers(0, self.n, size=m)
                lo, hi = np.minimum(a, b), np.maximum(a, b)
                ok = lo != hi
                ok &= self._edge_ok(lo, hi)
            lo, hi = lo[ok], hi[ok]
            y = self._y_of(lo, hi)
            if family is not None:
                keep = y == family
                lo, hi, y = lo[keep], hi[keep], y[keep]
            take = min(s - len(out), len(lo))
            out = np.concatenate([out, np.stack([lo[:take], hi[:take]], 1)])
            ys = np.concatenate([ys, y[:take]])
        return out.astype(np.int32), ys

    def _sample_rnode(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """A random node's n-1 valid pairs
        (reference: get_randomnode_edges, src/mmsbinfer.cc:1866-1876)."""
        r = int(self.rng.integers(0, self.n))
        other = np.concatenate([np.arange(r), np.arange(r + 1, self.n)])
        lo = np.minimum(r, other).astype(np.int64)
        hi = np.maximum(r, other).astype(np.int64)
        ok = self._edge_ok(lo, hi)
        lo, hi = lo[ok], hi[ok]
        y = self._y_of(lo, hi)
        w = np.ones(len(lo), np.float32)
        ss = self.cfg.subsample_scale
        if ss > 1:
            zeros = np.nonzero(y == 0)[0]
            drop = zeros[np.arange(len(zeros)) % ss != 0]
            w[drop] = 0.0
            w[zeros[np.arange(len(zeros)) % ss == 0]] = float(ss)
        return np.stack([lo, hi], 1).astype(np.int32), y, w

    def _pad_to(self, m: int) -> int:
        """Pairs a minibatch of m is padded to in the JAX engine: whole
        blocks, and under -mesh nd equal whole-block shards
        (svinet_tpu/svi/mmsb.py:430-438). Only the mesh path reads it:
        the shards' spans (mesh.shard_span)."""
        b = self._block
        pt = max(b, ((m + b - 1) // b) * b)
        if self._group is not None:
            nd = self._group.size
            pt = max(b, ((pt + nd - 1) // nd + b - 1) // b * b) * nd
        return pt

    def _shard(self, pairs, y, w, pad_to: int):
        """This rank's pairs of a minibatch padded to pad_to, on the
        device: (pairs, y, w)."""
        lo, hi = mesh.shard_span(len(pairs), pad_to, self._group)
        return tuple(torch.as_tensor(a[lo:hi], device=self.device)
                     for a in (pairs, y, w))

    def _prepare_minibatch(self, it: int):
        """One minibatch and its schedule scalars (pairs, y, w, gscale,
        lscale, noderhot, rhot, do_lambda); advances the host sampling
        state (the family alternation, delaylearn's bookkeeping). The
        JAX engine pads the minibatch to whole blocks; here the padding is
        the exit rule's virtual pad pair (ops/phicomp.py)."""
        cfg = self.cfg
        if cfg.randomnode:
            pairs, y, w = self._sample_rnode()
            gscale = lscale = self.n / 2.0
        else:
            fam = self._family if cfg.stratified else None
            pairs, y = self._sample_rpair(cfg.s, fam)
            w = np.ones(len(pairs), np.float32)
            scale = float(self.network.total_pairs)
            if cfg.stratified:
                scale *= (cfg.ones_prob if self._family == 1
                          else cfg.zeros_prob)
            gscale = lscale = scale / len(pairs)
        if self._nonuniform:
            # the step computes the rnode scale 3n/(2 n_processed); the
            # sign flags the mode (see svi_step)
            gscale = lscale = (1.0 if cfg.randomnode else -gscale)

        noderhot = (cfg.nodetau0 + it / 100.0) ** (-cfg.nodekappa)
        do_lambda = 0.0
        rhot = 0.0
        if not cfg.nolambda and (
                not cfg.delaylearn or it * cfg.s > self.network.total_pairs):
            if not self._delaylearn_reported:
                self._lambda_start_iter = it
                cfg.plog("learning lambda since (iter)", it)
                self._delaylearn_reported = True
            rhot = (cfg.tau0 + (it - self._lambda_start_iter + 1)) ** (
                -cfg.kappa)
            do_lambda = 1.0
        if cfg.stratified:
            self._family = 0 if self._family else 1
        return (pairs, y, w, gscale, lscale, noderhot, rhot, do_lambda)

    def _step_minibatches(self, count: int) -> None:
        """`count` SVI steps, their minibatches all drawn first as the JAX
        engine draws them, then the eval tail on the final state."""
        cfg = self.cfg
        batches = [self._prepare_minibatch(self.iteration + b)
                   for b in range(count)]
        for pairs, y, w, gs, ls, nr, rt, dl in batches:
            if self._group is None:
                pairs, y, w = (torch.as_tensor(a, device=self.device)
                               for a in (pairs, y, w))
            else:
                # the JAX engine pads a -rnode minibatch as n pairs, the
                # others as s
                pairs, y, w = self._shard(pairs, y, w, self._pad_to(
                    self.n if cfg.randomnode else cfg.s))
            self.gamma, self.lam = svi_step(
                self.gamma, self.lam, pairs, y, w, self.alpha, self.eta,
                _f32(gs), _f32(ls), _f32(nr), _f32(rt), dl, self.log_eps,
                cfg.online_iterations, cfg.meanchangethresh,
                float(cfg.infthresh), self._nonuniform, block=self._block,
                group=self._group)
        self._eval_tail()

    def report(self) -> bool:
        """EngineBase's report, then a modularity.txt row and, with -logl,
        a logl.txt row (svinet_tpu/svi/mmsb.py:567-588)."""
        stop = super().report()
        if not self.primary:
            return stop
        from svinet_torch.evals.modularity import modularity
        edges, mask, _ = self._community_edges()
        if not hasattr(self, "_deg"):
            self._deg = torch.as_tensor(
                self.network.training_deg.astype(np.float32),
                device=self.device)
        q, assor = modularity(self.gamma, edges, mask, self._deg)
        self._mf.write(f"{self.iteration}\t{self.duration()}\t"
                       f"{float(q):.5f}\t{float(assor):.5f}\n")
        self._mf.flush()
        if self._lf is not None:
            from svinet_torch.evals.elbo import approx_elbo
            pairs, y, w, csr = self._elbo_pairs()
            s = approx_elbo(self.gamma, self.lam, pairs, y, w, self.alpha,
                            self.eta, self.log_eps,
                            max_iters=self.cfg.online_iterations,
                            thresh=self.cfg.meanchangethresh,
                            block=self._block)
            self._lf.write(f"{self.iteration}\t{self.duration()}\t"
                           f"{float(s):.5f}\n")
            self._lf.flush()
        return stop

    def _elbo_pairs(self):
        """All non-heldout pairs on the device, with weight 1 and their
        endpoint CSR: -logl's pair set, and -batch's."""
        if self._elbo_cache is None:
            pairs, y = self._all_training_pairs()
            pd = torch.as_tensor(pairs, device=self.device)
            self._elbo_cache = (
                pd, torch.as_tensor(y, device=self.device),
                torch.ones(len(pairs), dtype=torch.float32,
                           device=self.device),
                owner_csr(pd.reshape(-1), self.n))
        return self._elbo_cache

    def infer(self) -> None:
        cfg = self.cfg
        r = max(cfg.reportfreq, 1)
        while True:
            if cfg.max_iterations and self.iteration > cfg.max_iterations:
                self.do_on_stop()
                return
            # every step up to the next report boundary, then the report
            todo = r - (self.iteration % r)
            if cfg.max_iterations:
                todo = min(todo, cfg.max_iterations - self.iteration + 1)
            self._step_minibatches(todo)
            self.iteration += todo
            if self.iteration % r == 0 and self.report():
                self.do_on_stop()
                return

    # ------------------------------------------------------------------
    def _all_training_pairs(self) -> Tuple[np.ndarray, np.ndarray]:
        """All p<q pairs minus heldout (reference: src/mmsbinfer.cc:852-864);
        for graphs of batch-mode size."""
        iu = np.triu_indices(self.n, k=1)
        lo = iu[0].astype(np.int64)
        hi = iu[1].astype(np.int64)
        ok = self._edge_ok(lo, hi)
        lo, hi = lo[ok], hi[ok]
        return np.stack([lo, hi], 1).astype(np.int32), self._y_of(lo, hi)

    def batch_infer(self) -> None:
        cfg = self.cfg
        if self._group is None:
            pairs, y, w, csr = self._elbo_pairs()
        else:
            # this rank's shard of all the pairs, with its endpoint CSR
            p_all, y_all = self._all_training_pairs()
            pairs, y, w = self._shard(p_all, y_all,
                                      np.ones(len(p_all), np.float32),
                                      self._pad_to(len(p_all)))
            csr = (owner_csr(pairs.reshape(-1), self.n)
                   if pairs.shape[0] else None)
        do_lambda = 0.0 if cfg.nolambda else 1.0
        while True:
            if cfg.max_iterations and self.iteration > cfg.max_iterations:
                self.do_on_stop()
                return
            self._tail_res = None
            self.gamma, self.lam = batch_step(
                self.gamma, self.lam, pairs, y, w, self.alpha, self.eta,
                do_lambda, self.log_eps, cfg.online_iterations,
                cfg.meanchangethresh, csr=csr, block=self._block,
                group=self._group)
            # the eval tail rides the report-boundary pass only
            if (self.iteration + 1) % cfg.reportfreq == 0:
                self._eval_tail()
            self.iteration += 1
            if self.iteration % cfg.reportfreq == 0 and self.report():
                self.do_on_stop()
                return
