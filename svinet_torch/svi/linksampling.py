"""LinkSampling engine, single device, default flags
(svinet_tpu/svi/linksampling.py).

One iteration is one full sweep over the training links with the
closed-form phi per link,

  phi_k  ~  exp( Elogpi[p,k] + Elogpi[q,k] + Elogbeta[k,0] )   (softmax),

scattered into gamma_hat[p] and gamma_hat[q], followed by the mean-
indicator nonlink correction and the lambda cross-moment (reference:
src/linksampling.cc:526-545, 605-749). The sweeps between two report
boundaries run back to back on the device and end with the validation
heldout sums, so a report costs one host synchronisation.
"""

from __future__ import annotations

import time
import numpy as np
import torch

from svinet_torch.config import Config
from svinet_torch.graph import Network
from svinet_torch.io.writers import load_model
from svinet_torch.evals.likelihood import (
    heldout_sums_blocked, link_probs, result_from_sums)
from svinet_torch.evals.precision import auc as auc_fn
from svinet_torch.ops.edges import (
    Adjacency, build_adjacency, choose_edge_block, pad_edges)
from svinet_torch.ops.expectations import dirichlet_expectation
from svinet_torch.svi.base import EngineBase
from svinet_torch.svi.sweep_math import (
    LSConsts, edge_blocks, finish_lambda, mean_indicator_update, phi_pass,
    s3_pass)

# E*K above which the init phis are drawn on the device, blocked: the host
# (E,K) float64 phi matrix of the n=1M, K=500 shape would need 80 GB
DEVICE_INIT_MIN = 1 << 28


def sweep(gamma, lam, edges, mask, adj: Adjacency, deg, consts: LSConsts,
          annealing: bool, num_blocks: int):
    """One full sweep over the training links: the phi pass walks their
    adjacency `adj`, the s3 pass their padded (edges, mask) list. Returns
    the new (gamma, lam); the inputs are not modified."""
    elogpi = dirichlet_expectation(gamma)
    elb0 = dirichlet_expectation(lam)[:, 0].contiguous()
    gacc, sumk = phi_pass(elogpi, elb0, adj)
    del elogpi
    gnext, mphi, s1, s2, lam0 = mean_indicator_update(
        gacc, sumk, deg, consts, annealing)
    s3 = s3_pass(mphi, edges, mask, num_blocks)
    return gnext, finish_lambda(s1, s2, s3, lam0, consts)


def multi_sweep_ho(gamma, lam, edges, mask, adj: Adjacency, deg,
                   consts: LSConsts, annealing: bool, ho_pairs, ho_y, ho_w,
                   epsilon: float,
                   num_blocks: int, n_sweeps: int, ho_blocks: int):
    """n_sweeps sweeps, then the six validation heldout sums on the final
    state (svinet_tpu/svi/linksampling.py:240-260). Returns
    (gamma, lam, sums)."""
    for _ in range(n_sweeps):
        gamma, lam = sweep(gamma, lam, edges, mask, adj, deg, consts,
                           annealing, num_blocks)
    sums = heldout_sums_blocked(gamma, lam, ho_pairs, ho_y, ho_w, epsilon,
                                ho_blocks)
    return gamma, lam, sums


def init_gamma_from_links(rng: np.random.Generator, edges: np.ndarray,
                          n: int, k: int, alpha: float) -> np.ndarray:
    """Random per-link phi added to both endpoints (reference:
    LinkSampling::init_gamma2, src/linksampling.cc:374-401); rows without
    a link fall back to alpha. Host float64, the same draws as the JAX
    engine from the same Generator state."""
    phi = rng.uniform(size=(len(edges), k))
    phi /= phi.sum(axis=1, keepdims=True)
    gamma = np.zeros((n, k), np.float64)
    np.add.at(gamma, edges[:, 0], phi)
    np.add.at(gamma, edges[:, 1], phi)
    empty = gamma.sum(axis=1) == 0
    gamma[empty] = alpha
    return gamma


def init_gamma_from_links_device(gen: torch.Generator, edges, mask, n: int,
                                 k: int, alpha: float, num_blocks: int):
    """init_gamma_from_links drawn on the device block by block, for edge
    sets whose host (E,K) phi matrix would not fit. `gen` lives on the
    edges' device; its numbers differ from numpy's and from jax.random's,
    so this init matches the host one in distribution only."""
    gamma = torch.zeros((n, k), dtype=torch.float32, device=edges.device)
    for blk, msk in edge_blocks(edges, mask, num_blocks):
        phi = torch.rand((blk.shape[0], k), generator=gen,
                         dtype=torch.float32, device=edges.device)
        phi = phi / phi.sum(dim=1, keepdim=True) * msk[:, None]
        gamma.index_add_(0, blk[:, 0], phi)
        gamma.index_add_(0, blk[:, 1], phi)
    empty = gamma.sum(dim=1, keepdim=True) == 0
    return torch.where(empty, alpha, gamma)


class LinkSampling(EngineBase):
    """Host side of the engine: owns the annealing phase and the device
    state; file output, stopping, and community logging live in
    EngineBase."""

    def __init__(self, cfg: Config, network: Network, device: torch.device):
        super().__init__(cfg, network, device)
        n, k = self.n, self.k
        block = choose_edge_block(len(network.training_links), k)
        edges_p, mask = pad_edges(network.training_links, block)
        self.num_blocks = edges_p.shape[0] // block
        self.edges = torch.as_tensor(edges_p, device=device)
        self.mask = torch.as_tensor(mask, device=device)
        # the same links as a symmetric CSR, built once: what the phi
        # pass walks (padding rows are absent from it)
        self.adj = build_adjacency(network.training_links, n, device)
        self.deg = torch.as_tensor(network.training_deg.astype(np.float32),
                                   device=device)

        if cfg.model_load and cfg.gamma_location:
            g0, l0 = load_model(cfg.gamma_location, n, k, cfg.t)
        elif len(network.edges) * k > DEVICE_INIT_MIN:
            ie, im = pad_edges(network.edges, block)
            gen = torch.Generator(device=device)
            gen.manual_seed(cfg.seed)
            g0 = init_gamma_from_links_device(
                gen, torch.as_tensor(ie, device=device),
                torch.as_tensor(im, device=device), n, k, cfg.alpha,
                ie.shape[0] // block)
            l0 = np.tile([cfg.eta0, cfg.eta1], (k, 1))
        else:
            g0 = init_gamma_from_links(self.rng, network.edges, n, k,
                                       cfg.alpha)
            l0 = np.tile([cfg.eta0, cfg.eta1], (k, 1))
        self.gamma = torch.as_tensor(g0, dtype=torch.float32, device=device)
        self.lam = torch.as_tensor(l0, dtype=torch.float32, device=device)
        self.consts = LSConsts.make(cfg.alpha, cfg.eta0, cfg.eta1,
                                    network.ones, n)
        self.annealing = True

        # the validation pairs, padded once to whole blocks, ride the tail
        # of every step; _ho_res holds the sums of the last step
        self._ho = None
        self._ho_res = None
        m = len(network.validation_pairs)
        if m:
            blk = min(1 << 17, max(64, 1 << int(np.ceil(np.log2(m)))))
            pp, ww = pad_edges(network.validation_pairs, blk)
            yy = np.zeros(len(pp), np.int32)
            yy[:m] = network.validation_y
            self._ho = (self._device_pairs(pp), self._device_pairs(yy),
                        self._device_pairs(ww), len(pp) // blk)

    # ------------------------------------------------------------------
    def step(self, n_sweeps: int = 1) -> None:
        """n_sweeps sweeps over all training links; the validation heldout
        sums are computed on the final state as the step's tail."""
        self._ho_res = None
        if self._ho is None:
            for _ in range(n_sweeps):
                self.gamma, self.lam = sweep(
                    self.gamma, self.lam, self.edges, self.mask, self.adj,
                    self.deg, self.consts, self.annealing, self.num_blocks)
            return
        hp, hy, hw, nb = self._ho
        self.gamma, self.lam, self._ho_res = multi_sweep_ho(
            self.gamma, self.lam, self.edges, self.mask, self.adj, self.deg,
            self.consts, self.annealing, hp, hy, hw, self.cfg.epsilon,
            self.num_blocks, n_sweeps, nb)

    def _heldout(self, pairs, y):
        """The validation split is served from the step's tail sums."""
        if pairs is self.val_pairs and self._ho_res is not None:
            return result_from_sums(self._ho_res)
        return super()._heldout(pairs, y)

    def report(self) -> bool:
        """EngineBase reporting + the annealing phase switch: the first
        validation plateau ends annealing instead of the run (reference:
        src/linksampling.cc:1036-1043). The three exits and their
        thresholds are those of svinet_tpu/svi/linksampling.py:1045-1105:
        a genuine plateau (1e-6 per iteration over two reports), a deep
        (> -anneal-drawdown) drawdown below the best, or a sustained
        monotone decline of -anneal-decline-sweeps sweeps; iteration 1000
        is a backstop."""
        stop = super().report()
        self._log_convergence()
        if self.annealing:
            h = getattr(self, "_anneal_hist", [])
            h.append(self.stopper.prev_h)     # prev_h = this report's nshol
            self._anneal_hist = h[-3:]
            genuine_plateau = (self._last_stop_raw
                               and self.stopper.why == 100
                               and self._anneal_plateau())
            mx = self.stopper.max_h
            drawdown = (mx - self.stopper.prev_h) / abs(mx) if mx else 0.0
            regressing = (self.stopper.since_max >= 2
                          and drawdown > self.cfg.anneal_drawdown)
            prev2 = getattr(self, "_anneal_prev_h", None)
            h_now = self.stopper.prev_h
            if prev2 is not None and h_now < prev2:
                self._anneal_decl = getattr(self, "_anneal_decl", 0) + 1
            else:
                self._anneal_decl = 0
            self._anneal_prev_h = h_now
            need = max(3, -(-self.cfg.anneal_decline_sweeps
                            // max(self.cfg.reportfreq, 1)))
            sustained = self._anneal_decl >= need
            if (genuine_plateau or regressing or sustained
                    or self.iteration >= 1000):   # runaway backstop
                self.annealing = False
                self.stopper.reset_after_annealing()
                why = ("plateau" if genuine_plateau else
                       "sustained-decline" if sustained else "no-improve")
                self.log(f"annealing ended at iteration {self.iteration}"
                         f" ({why})")
            else:
                self.stopper.nh = 0
            stop = False
        self._end_of_report()
        return stop

    def _anneal_plateau(self) -> bool:
        """A 1e-6 per-iteration relative change sustained over the last
        two reports (the threshold scales with -rfreq)."""
        h = getattr(self, "_anneal_hist", [])
        if len(h) < 3:
            return False
        a, b, c = h
        if a == 0 or b == 0:
            return False
        thresh = self.cfg.anneal_plateau_rate * max(1, self.cfg.reportfreq)
        return abs((c - b) / b) < thresh and abs((b - a) / a) < thresh

    def _log_convergence(self) -> None:
        """convergence.txt / convergence_hosts.txt: a node is converged
        when exactly one community holds gamma - alpha >= 1 (reference:
        LinkSampling::check_and_set_converged, src/linksampling.cc:456-475;
        MMSBInfer::hosts_conv, src/mmsbinfer.cc:754-790). Only the (n,)
        counts leave the device."""
        if not hasattr(self, "_convf"):
            self._convf = open(self.cfg.file_str("convergence.txt"), "w")
            self._first_conv = np.zeros(self.n, np.int64)
        active = ((self.gamma - self.cfg.alpha >= 1.0).sum(dim=1)
                  .cpu().numpy())
        is_conv = active == 1
        newly = is_conv & (self._first_conv == 0)
        self._first_conv[newly] = max(self.duration(), 1)
        conv = int(is_conv.sum())
        self._convf.write(f"{self.iteration}\t{self.duration()}\t{conv}\t"
                          f"{conv / max(self.n, 1):.5f}\n")
        self._convf.flush()
        with open(self.cfg.file_str("convergence_hosts.txt"), "w") as f:
            for i in np.nonzero(self._first_conv)[0]:
                f.write(f"{i}\t{int(self.network.seq2id[i])}\t"
                        f"{int(self._first_conv[i])}\n")

    def write_auc(self) -> None:
        """auc.txt: 'y score' rows over the heldout pairs + the AUC in
        auc-all.txt (reference: LinkSampling::auc,
        src/linksampling.cc:854-879)."""
        net = self.network
        if len(net.precision_pairs):
            pairs, ys = net.precision_pairs, net.precision_y
        else:
            pairs, ys = net.validation_pairs, net.validation_y
        scores = link_probs(self.gamma, self.lam,
                            self._device_pairs(pairs)).cpu().numpy()
        with open(self.cfg.file_str("auc.txt"), "w") as f:
            for y, s in zip(ys, scores):
                f.write(f"{int(y)} {s:.3f}\n")
        with open(self.cfg.file_str("auc-all.txt"), "a") as f:
            f.write(f"{auc_fn(scores, np.asarray(ys)):.5f}\n")

    def do_on_stop(self) -> None:
        super().do_on_stop()
        self.write_auc()

    # ------------------------------------------------------------------
    def infer(self) -> None:
        """Sweep until the stopping rule or -max-iterations;
        reports fire at iterations 0, r, 2r, ... (r = -rfreq), and every
        sweep up to the next boundary runs in one step."""
        cfg = self.cfg
        timef = open(cfg.file_str("time.txt"), "w")
        try:
            last_t = time.time()
            r = max(cfg.reportfreq, 1)
            if self.iteration == 0:
                self.report()
                self.iteration = 1
            while True:
                if cfg.max_iterations and self.iteration > cfg.max_iterations:
                    self.do_on_stop()
                    return
                j = ((self.iteration + r - 1) // r) * r
                if cfg.max_iterations:
                    j = min(j, cfg.max_iterations)
                todo = j - self.iteration + 1
                self.step(todo)
                now = time.time()
                timef.write(f"{j}\t{(now - last_t) / todo:.6f}\t"
                            f"{self.duration()}\n")
                timef.flush()
                last_t = now
                self.iteration = j
                if j % r == 0 and self.report():
                    self.do_on_stop()
                    return
                self.iteration = j + 1
        finally:
            timef.close()


def from_edges(edges: np.ndarray, n: int, k: int, device: torch.device,
               outdir: str, **flags) -> LinkSampling:
    """A LinkSampling engine on an in-memory (E,2) edge list, with the
    CLI's network set-up (ingest, singleton nodes dropped); `flags` are
    Config fields beside the defaults."""
    cfg = Config(n=n, k=k, link_sampling=True, outdir=outdir, **flags)
    cfg.resolve()
    net = Network(cfg)
    net.from_arrays(edges[:, 0], edges[:, 1])
    net.drop_singles()
    return LinkSampling(cfg, net, device)
