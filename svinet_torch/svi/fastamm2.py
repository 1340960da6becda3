"""FastAMM2, the -stratified -rnode engine: stratified node SVI
(svinet_tpu/svi/fastamm2.py; reference: src/fastamm2.cc:534-702).

Each iteration flips a fair coin (inf_epsilon = 0.5):
(a) informative step: a random start node's training links,
    scale = n / (2 (1 - eps));
(b) non-informative step: n/m (m = 10) nonlink partners of the start node
    from a shuffled ring of the nodes (svi/sampling.py),
    scale = n m / (2 eps).
Every node updates every iteration, the ones outside the minibatch toward
alpha, so the step is MMSBInfer's svi_step (svi/mmsb.py): kernel 8 solves
each pair's phi fixed point under the block rule at B = 512 pairs, and
writes the next gamma in its node pass. The pairs are drawn on the host
with the engine's numpy Generator in the JAX engine's calls and order.
Reports add precision@10/100/1000 over the precision split, with a
hitcurve file each, and the run starts with the Adamic-Adar baseline
(src/fastamm2.cc:1394-1588).

Under -mesh N every rank draws the same minibatch, pads it as the JAX
engine does to N equal whole-block shards and takes its own shard
(mesh.shard_span); gamma_hat and lambda_hat are all-reduced and every
rank takes the step on replicated gamma and lambda.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from svinet_torch.config import Config
from svinet_torch.evals.likelihood import link_probs
from svinet_torch.evals.precision import (
    adamic_adar_scores, auc, precision_counts, write_hitcurve)
from svinet_torch.graph import Network
from svinet_torch.io.writers import write_edgelist
from svinet_torch.parallel import mesh
from svinet_torch.svi.base import EngineBase
from svinet_torch.svi.mmsb import _f32, svi_step
from svinet_torch.svi.sampling import nonlink_accept, ring_nonlink_scan

INF_EPSILON = 0.5   # reference: src/fastamm2.cc:15
M_SETS = 10         # reference: src/fastamm2.cc:11
BLOCK = 512         # the exit rule's block (svinet_tpu/svi/fastamm2.py:67)


def shared_neighbor_mask(network: Network, pairs: np.ndarray,
                         chunk: int = 1 << 18) -> np.ndarray:
    """(m,) bool: whether the two ends of each pair have a neighbour in
    common. Every other pair's Adamic-Adar score is 0.0 exactly, so
    adamic_adar_scores needs to visit only these; its per-pair Python
    loop over the n/10-scale precision split would take minutes."""
    from scipy.sparse import csr_matrix
    n = network.n
    rp = network.row_ptr[:n + 1].astype(np.int64)
    adj = csr_matrix((np.ones(int(rp[-1]), np.int8),
                      network.col_idx[:rp[-1]], rp), shape=(n, network.n))
    out = np.zeros(len(pairs), bool)
    for lo in range(0, len(pairs), chunk):
        p = pairs[lo:lo + chunk]
        both = adj[p[:, 0]].multiply(adj[p[:, 1]])
        out[lo:lo + chunk] = both.getnnz(axis=1) > 0
    return out


class FastAMM2(EngineBase):
    """The engine on the host: sampling, schedule, precision reports."""

    dual_heldout_splits = True   # src/fastamm2.cc (init_heldout)
    # the precision report (hitcurve_<i>.txt) comes after EngineBase's, and
    # a checkpoint of the report stores the counter past it
    defer_report_hooks = True

    def __init__(self, cfg: Config, network: Network, device: torch.device,
                 group: "mesh.Group | None" = None):
        cfg.create_test_precision_sets = True
        super().__init__(cfg, network, device, group)
        n, k = self.n, self.k

        v = 1.0 if k < 100 else 100.0 / k
        g0 = self.rng.gamma(100.0 * v, 0.01, size=(n, k))
        l0 = np.tile([cfg.eta0, cfg.eta1], (k, 1)) + \
            self.rng.gamma(100.0 * (1.0 if k <= 100 else 100.0 / k), 0.01,
                           size=(k, 2))
        self.gamma = torch.as_tensor(g0, dtype=torch.float32, device=device)
        self.lam = torch.as_tensor(l0, dtype=torch.float32, device=device)
        self.eta = torch.as_tensor(np.tile([cfg.eta0, cfg.eta1], (k, 1)),
                                   dtype=torch.float32, device=device)
        self.alpha = float(np.float32(cfg.alpha))
        self.log_eps = float(np.float32(np.log(cfg.epsilon)))

        self._shuffled = self.rng.permutation(n)
        self._lambda_start_iter = 0
        self._hitcurve_id = 0
        self._pf = open(cfg.file_str("precision.txt"),
                        "a" if cfg.resume else "w")
        # the pairs a minibatch is padded to; those past it are dropped
        # (svinet_tpu/svi/fastamm2.py:68-71), and under -mesh N to N equal
        # whole-block shards (:87-90)
        max_deg = int(network.training_deg.max()) if n else 1
        pad = max(max_deg, max(1, n // M_SETS), BLOCK)
        self._pad = -(-pad // BLOCK) * BLOCK
        if self._group is not None:
            nd = self._group.size
            per = max(BLOCK, ((self._pad + nd - 1) // nd + BLOCK - 1)
                      // BLOCK * BLOCK)
            self._pad = per * nd
            cfg.plog("mesh devices", nd)
        self.precision_pairs = network.precision_pairs
        self.precision_y = network.precision_y

        # FastAMM2 names its split dumps *-pairs.txt rather than
        # *-edges.txt (reference: src/fastamm2.cc:94-117)
        write_edgelist(cfg.file_str("heldout-pairs.txt"),
                       network.heldout_pairs if self._dual
                       else network.validation_pairs,
                       network.heldout_y if self._dual
                       else network.validation_y,
                       network.seq2id)
        write_edgelist(cfg.file_str("validation-pairs.txt"),
                       network.validation_pairs, network.validation_y,
                       network.seq2id)
        if len(network.precision_pairs):
            write_edgelist(cfg.file_str("precision-pairs.txt"),
                           network.precision_pairs, network.precision_y,
                           network.seq2id)
        self._resume_if_requested()
        if self._group is not None:
            # rank 0's state on every rank, at start and after -resume
            self.gamma = mesh.broadcast(self.gamma.contiguous())
            self.lam = mesh.broadcast(self.lam.contiguous())

    def close(self) -> None:
        super().close()
        self._pf.close()

    def _state_dict(self) -> dict:
        d = super()._state_dict()
        # without it a resumed run writes hitcurve_0.txt onward again over
        # the hit curves of the reports before the resume
        d["hitcurve_id"] = int(self._hitcurve_id)
        return d

    def _restore_state(self, state) -> None:
        super()._restore_state(state)
        self._hitcurve_id = int(state.get("hitcurve_id", 0))

    # ------------------------------------------------------------------
    def _sample(self) -> Tuple[np.ndarray, np.ndarray, float]:
        """One minibatch: (pairs (m,2) int32, y (m,) int32, scale)."""
        n = self.n
        r = int(self.rng.integers(0, n))
        if self.rng.uniform() >= INF_EPSILON:   # informative step
            others = self.network.neighbors(r).astype(np.int64)
            ys = np.ones(len(others), np.int32)
            scale = n / (2.0 * (1.0 - INF_EPSILON))
        else:                                   # non-informative step
            # the batched ring walk keeps the reference scalar scan's
            # survivors (src/fastamm2.cc:1101); the heldout splits are
            # excluded after it, below
            setsize = max(1, n // M_SETS)
            start = int(self.rng.integers(0, n))
            others = ring_nonlink_scan(
                self._shuffled, n, start, setsize,
                nonlink_accept(self.network, r, None,
                               require_edge_ok=False))
            ys = np.zeros(len(others), np.int32)
            scale = (float(n) * M_SETS) / (2.0 * INF_EPSILON)
        lo = np.minimum(r, others)
        hi = np.maximum(r, others)
        ok = self.network.edge_ok_mask(lo, hi) & (others != r)
        pairs = np.stack([lo[ok], hi[ok]], 1).astype(np.int32)
        return pairs, ys[ok], scale

    def _prepare(self, it: int):
        """Minibatch `it` and its schedule: (pairs, y, w, scale, noderhot,
        rhot, do_lambda), the pairs cut to the pad."""
        cfg = self.cfg
        pairs, ys, scale = self._sample()
        m = min(len(pairs), self._pad)
        noderhot = (cfg.nodetau0 + it) ** (-cfg.nodekappa)
        rhot = (cfg.tau0 + (it - self._lambda_start_iter + 1)) ** (-cfg.kappa)
        return (pairs[:m], ys[:m], np.ones(m, np.float32), scale, noderhot,
                rhot, 0.0 if cfg.nolambda else 1.0)

    def _step_many(self, count: int) -> None:
        """`count` steps, their minibatches all drawn first as the JAX
        engine draws them, then the report sums on the final state (the
        tail of svi_multi_step_ho, svinet_tpu/svi/fastamm2.py:223-236)."""
        cfg = self.cfg
        batches = [self._prepare(self.iteration + b) for b in range(count)]
        for pairs, y, w, scale, nr, rt, dl in batches:
            if self._group is None:
                pairs, y, w = (torch.as_tensor(a, device=self.device)
                               for a in (pairs, y, w))
            else:
                lo, hi = mesh.shard_span(len(pairs), self._pad, self._group)
                pairs, y, w = (torch.as_tensor(a[lo:hi], device=self.device)
                               for a in (pairs, y, w))
            self.gamma, self.lam = svi_step(
                self.gamma, self.lam, pairs, y, w, self.alpha, self.eta,
                _f32(scale), _f32(scale), _f32(nr), _f32(rt), dl,
                self.log_eps, cfg.online_iterations, cfg.meanchangethresh,
                block=BLOCK, group=self._group)
        self._eval_tail()

    # ------------------------------------------------------------------
    def compute_precision(self) -> Tuple[int, int, int]:
        """precision.txt's row and hitcurve_<i>.txt of this report
        (reference: src/fastamm2.cc:1394-1460)."""
        if not len(self.precision_pairs):
            return 0, 0, 0
        scores = link_probs(self.gamma, self.lam,
                            self._device_pairs(self.precision_pairs))
        c10, c100, c1000, cum = precision_counts(scores.cpu().numpy(),
                                                 self.precision_y)
        write_hitcurve(
            self.cfg.file_str(f"hitcurve_{self._hitcurve_id}.txt"), cum)
        self._hitcurve_id += 1
        self._pf.write(f"{self.iteration}\t{self.duration()}\t"
                       f"{c10}\t{c100}\t{c1000}\n")
        self._pf.flush()
        return c10, c100, c1000

    def log_adamic_adar_baseline(self) -> None:
        """adamic_adar.txt (the counts at 10/100/1000), ad_hitcurve.txt and
        adamic-adar-auc.txt (reference: src/fastamm2.cc:1503-1588)."""
        if not len(self.precision_pairs):
            return
        pairs = self.precision_pairs
        scores = np.zeros(len(pairs))
        near = shared_neighbor_mask(self.network, pairs)
        scores[near] = adamic_adar_scores(self.network, pairs[near])
        c10, c100, c1000, cum = precision_counts(scores, self.precision_y)
        with open(self.cfg.file_str("adamic_adar.txt"), "w") as f:
            f.write(f"{c10}\t{c100}\t{c1000}\n")
        write_hitcurve(self.cfg.file_str("ad_hitcurve.txt"), cum)
        with open(self.cfg.file_str("adamic-adar-auc.txt"), "w") as f:
            f.write(f"{auc(scores, self.precision_y):.5f}\n")

    def report(self) -> bool:
        stop = super().report()
        self.compute_precision()
        self._end_of_report()
        return stop

    def infer(self) -> None:
        """The Adamic-Adar baseline, then steps to the stop (-adamic-adar:
        the baseline only, as src/fastamm2.cc:131-134)."""
        cfg = self.cfg
        self.log_adamic_adar_baseline()
        if cfg.adamic_adar:
            return
        r = max(cfg.reportfreq, 1)
        while True:
            if cfg.max_iterations and self.iteration > cfg.max_iterations:
                self.do_on_stop()
                return
            todo = r - (self.iteration % r)
            if cfg.max_iterations:
                todo = min(todo, cfg.max_iterations - self.iteration + 1)
            self._step_many(todo)
            self.iteration += todo
            if self.iteration % r == 0 and self.report():
                self.do_on_stop()
                return
