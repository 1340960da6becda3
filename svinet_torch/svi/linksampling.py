"""LinkSampling engine, single device, with -fuse-s3 and -report-batch
(svinet_tpu/svi/linksampling.py).

One iteration is one full sweep over the training links with the
closed-form phi per link,

  phi_k  ~  exp( Elogpi[p,k] + Elogpi[q,k] + Elogbeta[k,0] )   (softmax),

scattered into gamma_hat[p] and gamma_hat[q], followed by the mean-
indicator nonlink correction and the lambda cross-moment (reference:
src/linksampling.cc:526-545, 605-749). The sweeps between two report
boundaries run back to back on the device and end with the validation
heldout sums, so a report costs one host synchronisation; -report-batch B
runs B such intervals before the host reads anything.
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
    LSConsts, edge_blocks, finish_lambda, fused_phi_s3_pass,
    mean_indicator_update, phi_pass, s3_pass)

# E*K above which the init phis are drawn on the device, blocked: the host
# (E,K) float64 phi matrix of the n=1M, K=500 shape would need 80 GB
DEVICE_INIT_MIN = 1 << 28


def sweep(gamma, lam, adj: Adjacency, deg, consts: LSConsts,
          annealing: bool):
    """One full sweep over the training links, whose adjacency `adj` the
    phi pass and the s3 pass walk. Returns the new (gamma, lam); the
    inputs are not modified."""
    elogpi = dirichlet_expectation(gamma)
    elb0 = dirichlet_expectation(lam)[:, 0].contiguous()
    gacc, sumk = phi_pass(elogpi, elb0, adj)
    del elogpi
    gnext, mphi, s1, s2, lam0 = mean_indicator_update(
        gacc, sumk, deg, consts, annealing)
    s3 = s3_pass(mphi, adj)
    return gnext, finish_lambda(s1, s2, s3, lam0, consts)


def fused_sweep(gamma, lam, mphi, adj: Adjacency, deg, consts: LSConsts,
                annealing: bool):
    """The -fuse-s3 sweep (svinet_tpu/svi/linksampling.py:132-150): one
    pass over the links gives the phi sums and the s3 cross-moment of
    `mphi`, the mean indicators of the sweep BEFORE, so s3 lags one sweep
    while s1 and s2 are current; with mphi = 0 (the first sweep) s3 is 0.
    Returns (gamma, lam, mphi of this sweep). gamma and lam are not
    modified; `mphi` is overwritten with the new mean indicators and
    returned, on the CPU as on the card, so a caller that still needs the
    old ones passes a clone."""
    elogpi = dirichlet_expectation(gamma)
    elb0 = dirichlet_expectation(lam)[:, 0].contiguous()
    gacc, sumk, s3 = fused_phi_s3_pass(elogpi, mphi, elb0, adj)
    del elogpi
    gnext, mphi_new, s1, s2, lam0 = mean_indicator_update(
        gacc, sumk, deg, consts, annealing, mphi_out=mphi)
    return gnext, finish_lambda(s1, s2, s3, lam0, consts), mphi_new


def multi_sweep(gamma, lam, mphi, adj: Adjacency, deg, consts: LSConsts,
                annealing: bool, n_sweeps: int, fused: bool):
    """n_sweeps sweeps back to back; `fused` takes the -fuse-s3 body,
    which carries mphi, otherwise mphi passes through untouched. Returns
    (gamma, lam, mphi)."""
    for _ in range(n_sweeps):
        if fused:
            gamma, lam, mphi = fused_sweep(gamma, lam, mphi, adj, deg,
                                           consts, annealing)
        else:
            gamma, lam = sweep(gamma, lam, adj, deg, consts, annealing)
    return gamma, lam, mphi


def sweep_ho_trace(gamma, lam, mphi, adj: Adjacency, deg, consts: LSConsts,
                   annealing: bool, ho_pairs, ho_y, ho_w, epsilon: float,
                   r: int, n_batches: int, ho_blocks: int, fused: bool):
    """n_batches report boundaries, r sweeps apart, with the six
    validation heldout sums of the state at EVERY boundary
    (svinet_tpu/svi/linksampling.py:194-234); `fused` as in multi_sweep.
    Nothing in here reads a value back to the host. Returns
    (gamma, lam, mphi, trace (n_batches, 6))."""
    trace = []
    for _ in range(n_batches):
        gamma, lam, mphi = multi_sweep(gamma, lam, mphi, adj, deg, consts,
                                       annealing, r, fused)
        trace.append(heldout_sums_blocked(gamma, lam, ho_pairs, ho_y, ho_w,
                                          epsilon, ho_blocks))
    return gamma, lam, mphi, torch.stack(trace)


def multi_sweep_ho(gamma, lam, adj: Adjacency, deg, consts: LSConsts,
                   annealing: bool, ho_pairs, ho_y, ho_w, epsilon: float,
                   n_sweeps: int, ho_blocks: int):
    """n_sweeps sweeps, then the six validation heldout sums on the final
    state (svinet_tpu/svi/linksampling.py:240-260). Returns
    (gamma, lam, sums)."""
    gamma, lam, _, trace = sweep_ho_trace(
        gamma, lam, None, adj, deg, consts, annealing, ho_pairs, ho_y, ho_w,
        epsilon, n_sweeps, 1, ho_blocks, False)
    return gamma, lam, trace[0]


def fused_multi_sweep_ho(gamma, lam, mphi, adj: Adjacency, deg,
                         consts: LSConsts, annealing: bool, ho_pairs, ho_y,
                         ho_w, epsilon: float, n_sweeps: int, ho_blocks: int):
    """n_sweeps -fuse-s3 sweeps with the heldout-sums tail
    (svinet_tpu/svi/linksampling.py:170-188). Returns
    (gamma, lam, mphi, sums)."""
    gamma, lam, mphi, trace = sweep_ho_trace(
        gamma, lam, mphi, adj, deg, consts, annealing, ho_pairs, ho_y, ho_w,
        epsilon, n_sweeps, 1, ho_blocks, True)
    return gamma, lam, mphi, trace[0]


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
        self.edges = torch.as_tensor(edges_p, device=device)
        self.mask = torch.as_tensor(mask, device=device)
        # the same links as a symmetric CSR, built once: what the phi and
        # s3 passes walk (padding rows are absent from it); the padded
        # list serves the community extraction
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
        # -fuse-s3 carries the mean indicators across sweeps; zeros before
        # the first sweep (and after -load), so its s3 is 0
        self.mphi = None
        if cfg.fuse_s3:
            cfg.plog("fuse s3", True)
            self.mphi = torch.zeros((n, k), dtype=torch.float32,
                                    device=device)

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
            self.gamma, self.lam, self.mphi = multi_sweep(
                self.gamma, self.lam, self.mphi, self.adj, self.deg,
                self.consts, self.annealing, n_sweeps, self.mphi is not None)
            return
        self._ho_res = self._run_trace(n_sweeps, 1)[0]

    def _run_trace(self, r: int, n_batches: int) -> torch.Tensor:
        """Advance the state by n_batches intervals of r sweeps; returns
        the (n_batches, 6) heldout sums, still on the device."""
        hp, hy, hw, nb = self._ho
        self.gamma, self.lam, self.mphi, trace = sweep_ho_trace(
            self.gamma, self.lam, self.mphi, self.adj, self.deg, self.consts,
            self.annealing, hp, hy, hw, self.cfg.epsilon, r, n_batches, nb,
            self.mphi is not None)
        return trace

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
        if not self._light_report:
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
    def _trace_intervals(self, j: int, r: int, batch: int, timef,
                         last_t: float) -> bool:
        """-report-batch: run `batch` report intervals (r sweeps each)
        before the host reads anything, copy the (batch, 6) heldout sums
        over in one transfer, then replay the rows through the normal
        report path in order (svinet_tpu/svi/linksampling.py:1213-1272).
        The rows are the exact per-boundary values; stop and annealing
        decisions land up to batch-1 intervals late (the extra sweeps only
        converge the state further), and the heavy per-report extras
        (community extraction, convergence log, test-set evals,
        training-sample rows) run on the batch's last row only. A stop
        inside a batch leaves the later rows unwritten and the state at
        the batch's end. Returns True when the run stopped."""
        cfg = self.cfg
        b_eff = batch
        if cfg.max_iterations:
            b_eff = min(batch, (cfg.max_iterations - j) // r + 1)
        rows = self._run_trace(r, b_eff).cpu()
        now = time.time()
        timef.write(f"{j + (b_eff - 1) * r}\t"
                    f"{(now - last_t) / (b_eff * r):.6f}\t"
                    f"{self.duration()}\n")
        timef.flush()
        for idx in range(b_eff):
            self.iteration = j + idx * r
            self._ho_res = rows[idx]
            self._light_report = idx < b_eff - 1
            stop = self.report()
            self._light_report = False
            if stop:
                self.do_on_stop()
                return True
        self.iteration = j + (b_eff - 1) * r + 1
        return False

    def infer(self) -> None:
        """Sweep until the stopping rule or -max-iterations;
        reports fire at iterations 0, r, 2r, ... (r = -rfreq), and every
        sweep up to the next boundary runs in one step. With
        -report-batch B > 1 and a validation split, B whole intervals run
        per host round trip (_trace_intervals)."""
        cfg = self.cfg
        timef = open(cfg.file_str("time.txt"), "w")
        try:
            last_t = time.time()
            r = max(cfg.reportfreq, 1)
            if self.iteration == 0:
                self.report()
                self.iteration = 1
            batch = max(1, int(cfg.report_batch))
            # without a validation split there are no sums to trace
            use_trace = batch > 1 and self._ho is not None
            while True:
                if cfg.max_iterations and self.iteration > cfg.max_iterations:
                    self.do_on_stop()
                    return
                j = ((self.iteration + r - 1) // r) * r
                if cfg.max_iterations:
                    j = min(j, cfg.max_iterations)
                todo = j - self.iteration + 1
                if use_trace and todo == r:
                    if self._trace_intervals(j, r, batch, timef, last_t):
                        return
                    last_t = time.time()
                    continue
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
