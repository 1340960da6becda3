"""Host-side engine scaffolding (svinet_tpu/svi/base.py:29-729).

Output files, the heldout split, the stopping controller, mrstats, and
community/NMI logging live here; the engine subclass owns the gamma/lam
tensors and the sweep. The port keeps the single-split (link-sampling)
protocol and leaves out native checkpoints and multi-process handling.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from svinet_torch.config import Config
from svinet_torch.graph import Network
from svinet_torch.io.native import write_edges_tsv
from svinet_torch.io.writers import (
    ReportFile, save_model, write_communities, write_edgelist, write_groups,
    write_max,
)
from svinet_torch.evals.likelihood import HeldoutResult, heldout_stats
from svinet_torch.evals.nmi import overlapping_nmi, read_cover_file
from svinet_torch.evals.stopping import ValidationStop
from svinet_torch.svi.communities import edge_assignments, extract_communities


class EngineBase:
    """Owns output files, heldout splits, the stopping controller, and the
    community/NMI logging. Subclasses own gamma/lam device state and steps.

    The numpy Generator is consumed in the reference's order: the heldout
    split here, then the training sample, then the subclass's gamma init,
    so the initial state matches the JAX engine's bit for bit."""

    # stop guard iter > stop_min_iter; plateau why code; stop after more
    # than stop_decline_reports declines (evals/stopping.py)
    stop_min_iter = 10
    stop_plateau_why = 100
    stop_decline_reports = 2

    def __init__(self, cfg: Config, network: Network, device: torch.device):
        self.cfg = cfg
        self.network = network
        self.device = device
        self.rng = np.random.default_rng(cfg.seed)
        self._start = time.time()
        cfg.make_outdir()

        if cfg.load_heldout and cfg.load_heldout_fname:
            network.validation_pairs, network.validation_y = \
                network.load_pairs_file(cfg.load_heldout_fname)
            network.assign_training_links()
        else:
            network.sample_heldout_sets(self.rng)
        if cfg.load_test and cfg.load_test_fname:
            network.test_pairs, network.test_y = \
                network.load_pairs_file(cfg.load_test_fname)
            network.assign_training_links()

        # single-split engines write the validation set under both names
        for fname in ("validation-edges.txt", "heldout-edges.txt"):
            write_edgelist(cfg.file_str(fname), network.validation_pairs,
                           network.validation_y, network.seq2id)
        if len(network.test_pairs):
            write_edgelist(cfg.file_str("test-edges.txt"),
                           network.test_pairs, network.test_y, network.seq2id)

        # infer.log (reference: Logger, src/log.cc:9-127) + network.dat
        # symlink of the input (reference: src/env.hh:621-625)
        self._log = open(cfg.file_str("infer.log"), "w")
        self.log("engine: %s  n: %d  k: %d", type(self).__name__,
                 network.n, cfg.k)
        link = cfg.file_str("network.dat")
        try:
            if not os.path.exists(link) and os.path.exists(cfg.datfname):
                os.symlink(os.path.abspath(cfg.datfname), link)
        except OSError:
            pass

        # training-sample likelihood trace (training.txt, stats.txt)
        self._train_sample = self._make_training_sample()
        self._trf = ReportFile(cfg.file_str("training.txt"))

        ext = network.seq2id[network.training_links.astype(np.int64)]
        if not write_edges_tsv(cfg.file_str("training-edges.txt"), ext):
            with open(cfg.file_str("training-edges.txt"), "w") as f:
                for p, q in ext:
                    f.write(f"{int(p)}\t{int(q)}\n")

        if network.ground_truth is not None:
            # both names: ours + the reference's
            for fname in ("ground_truth_stats.txt",
                          "ground_truth_community_sizes.txt"):
                with open(cfg.file_str(fname), "w") as f:
                    for ci, comm in enumerate(network.ground_truth):
                        f.write(f"{ci}\t{len(comm)}\n")

        if network.gt_groups:
            with open(cfg.file_str("gt_groups.txt"), "w") as f:
                for seq in sorted(network.gt_groups):
                    f.write(f"{seq}\t{network.gt_groups[seq]}\n")

        if len(network.precision_pairs):
            write_edgelist(cfg.file_str("precision-edges.txt"),
                           network.precision_pairs, network.precision_y,
                           network.seq2id)

        if getattr(network, "str_ids", None):
            with open(cfg.file_str("str2id.txt"), "w") as f:
                for i, s in enumerate(network.str_ids):
                    f.write(f"{s}\t{i}\n")

        self.n, self.k = network.n, cfg.k
        self.val_pairs = self._device_pairs(network.validation_pairs)
        self.val_y = self._device_pairs(network.validation_y.astype(np.int32))
        self.test_pairs = (self._device_pairs(network.test_pairs)
                           if len(network.test_pairs) else None)
        self.test_y = (self._device_pairs(network.test_y.astype(np.int32))
                       if len(network.test_pairs) else None)

        self.iteration = 0
        self.terminate_requested = False   # set by the SIGTERM handler
        self.stopper = ValidationStop(
            stopthresh=cfg.stopthresh, min_iter=self.stop_min_iter,
            plateau_why=self.stop_plateau_why,
            decline_reports=self.stop_decline_reports)
        self._vf = ReportFile(cfg.file_str("validation.txt"))
        self._hf = ReportFile(cfg.file_str("heldout.txt"))
        # every reference engine opens logl.txt; link sampling never
        # writes it, so touch it for an identical file inventory
        open(cfg.file_str("logl.txt"), "w").close()
        self._tf = (ReportFile(cfg.file_str("test.txt"))
                    if self.test_pairs is not None else None)
        self._mutual = None
        if cfg.nmi and network.ground_truth is not None:
            network.write_gt_communities(cfg.file_str("ground_truth.txt"))
            self._mutual = open(cfg.file_str("mutual.txt"), "w")
        self._communities = {}

        cfg.write_param_txt()
        cfg.plog("inference n", self.n)
        cfg.plog("total pairs", network.total_pairs)
        cfg.plog("network ones", network.ones)
        cfg.plog("heldout pairs (1s and 0s)", len(network.validation_pairs))

        # set by the subclass: the state and the padded training links
        self.gamma = self.lam = self.edges = self.mask = None

    def close(self) -> None:
        """Close the report files the engine holds open between reports."""
        for f in (self._log, self._mutual, getattr(self, "_statsf", None),
                  getattr(self, "_mrf", None), getattr(self, "_convf", None),
                  self._vf, self._hf, self._trf, self._tf):
            if f is not None:
                f.close()

    # ------------------------------------------------------------------
    def duration(self) -> int:
        return int(time.time() - self._start)

    def log(self, fmt: str, *args) -> None:
        """Timestamped line into <outdir>/infer.log
        (reference: Logger::xlog, src/log.cc:72-127)."""
        msg = (fmt % args) if args else fmt
        self._log.write(f"[{self.duration()}s] {msg}\n")
        self._log.flush()

    def _device_pairs(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), device=self.device)

    def _make_training_sample(self):
        """Fixed random sample of training links + equal nonlinks for the
        per-report training likelihood trace (training.txt)."""
        net = self.network
        m = min(max(len(net.training_links) // 100, 10),
                5000, len(net.training_links))
        if m == 0:
            return None
        idx = self.rng.choice(len(net.training_links), size=m, replace=False)
        links = net.training_links[idx]
        # dense tiny graphs can have fewer nonlink pairs than requested
        nonlinks = net._sample_nonlinks(self.rng, m)
        pairs = np.concatenate([links, nonlinks.astype(np.int32)], axis=0)
        ys = np.concatenate([np.ones(len(links), np.int32),
                             np.zeros(len(nonlinks), np.int32)])
        return self._device_pairs(pairs), self._device_pairs(ys)

    def _heldout(self, pairs, y) -> HeldoutResult:
        return heldout_stats(self.gamma, self.lam, pairs, y,
                             self.cfg.epsilon)

    # ------------------------------------------------------------------
    def report(self) -> bool:
        """Validation likelihood + stopping logic. Returns True to stop."""
        cfg = self.cfg
        _mr0 = time.time()
        res = self._heldout(self.val_pairs, self.val_y)
        nshol = self._hf.write(self.iteration, self.duration(), res,
                               cfg.zeros_prob, cfg.ones_prob)
        self._vf.write(self.iteration, self.duration(), res,
                       cfg.zeros_prob, cfg.ones_prob)
        if self._tf is not None:
            tres = self._heldout(self.test_pairs, self.test_y)
            self._tf.write(self.iteration, self.duration(), tres,
                           cfg.zeros_prob, cfg.ones_prob)
        if self._train_sample is not None:
            self._report_training_sample()
        self.log("iteration %d: validation nshol %.5f", self.iteration, nshol)

        stop = self.stopper.update(self.iteration, nshol)
        self._last_stop_raw = stop
        write_max(cfg.file_str("max.txt"), self.iteration, self.duration(),
                  nshol, self.stopper.max_t, self.stopper.max_h,
                  self.stopper.why)
        _mr1 = time.time()
        # per-report communities feed the NMI trace; without -nmi huge
        # runs extract them only at stop
        if self._mutual is not None or self.n * self.k <= (1 << 24):
            self.log_communities()
        self._write_mrstats(_mr0, _mr1, time.time())
        return stop and cfg.use_validation_stop

    def _report_training_sample(self) -> None:
        """training.txt + stats.txt rows, and -accuracy's done.txt on the
        first training-likelihood plateau (reference:
        src/mmsbinfer.cc:2366, src/fastamm.cc:1238-1255)."""
        cfg = self.cfg
        tp, ty = self._train_sample
        trres = self._heldout(tp, ty)
        self._trf.write(self.iteration, self.duration(), trres,
                        cfg.zeros_prob, cfg.ones_prob)
        if not hasattr(self, "_statsf"):
            self._statsf = open(cfg.file_str("stats.txt"), "w")
        self._statsf.write(
            f"{self.iteration}\t{self.duration()}\t{trres.avg:.5f}\t"
            f"{trres.avg1:.5f}\t{trres.avg0:.5f}\t{trres.count1}\t"
            f"{trres.count0}\n")
        self._statsf.flush()
        if cfg.accuracy and not getattr(self, "_done_written", False):
            prev = getattr(self, "_prev_train_avg", 0.0)
            a = trres.avg
            if prev != 0.0 and a > prev and abs((a - prev) / prev) < 1e-5:
                self._done_written = True
                with open(cfg.file_str("done.txt"), "w") as f:
                    f.write(f"{self.iteration}\t{self.duration()}\t"
                            f"{a:.5f}\n")
                    if self._mutual is not None:
                        ours = read_cover_file(
                            cfg.file_str("communities.txt"))
                        gt = read_cover_file(cfg.file_str("ground_truth.txt"))
                        f.write(f"mutual3:\t{overlapping_nmi(gt, ours):g}\n")
            self._prev_train_avg = a

    def _write_mrstats(self, t_report0: float, t_evals: float,
                       t_comm: float) -> None:
        """mrstats.txt: iteration, duration_s, t_train (since the previous
        report ended), t_eval (likelihood evals + metric files),
        t_communities (community extraction + NMI)."""
        now = time.time()
        prev = getattr(self, "_mr_prev_end", self._start)
        if not hasattr(self, "_mrf"):
            self._mrf = open(self.cfg.file_str("mrstats.txt"), "w")
        self._mrf.write(
            f"{self.iteration}\t{self.duration()}\t"
            f"{t_report0 - prev:.4f}\t{t_evals - t_report0:.4f}\t"
            f"{t_comm - t_evals:.4f}\n")
        self._mrf.flush()
        self._mr_prev_end = now

    def _end_of_report(self) -> None:
        """SIGTERM handling at the end of a report: save the model files
        and keep running (reference: src/linksampling.cc:763-766)."""
        if self.terminate_requested:
            self.terminate_requested = False
            self.log("SIGTERM: saving model state at iteration %d",
                     self.iteration)
            self.do_on_stop()

    def log_communities(self) -> None:
        cfg = self.cfg
        edges, mask = self.edges, self.mask     # the padded training links
        argmax, maxval = edge_assignments(self.gamma, self.lam, edges, mask)
        self._communities = extract_communities(
            argmax.cpu().numpy(), maxval.cpu().numpy(), edges.cpu().numpy(),
            mask.cpu().numpy(), self.n, self.k, cfg.link_thresh,
            cfg.lt_min_deg)
        write_communities(cfg.file_str("communities.txt"),
                          self._communities, self.network.seq2id)
        # mcount.txt (seq, ext-id, #memberships) + aggregate.txt
        # (reference: src/fastamm.cc:734-735, 826, 858-882)
        mcount = np.zeros(self.n, np.int64)
        for comm in self._communities.values():
            for node in set(comm):
                mcount[node] += 1
        with open(cfg.file_str("mcount.txt"), "w") as f:
            for i in np.nonzero(mcount)[0]:
                f.write(f"{i}\t{int(self.network.seq2id[i])}\t"
                        f"{int(mcount[i])}\n")
        with open(cfg.file_str("aggregate.txt"), "w") as f:
            vals, counts = np.unique(mcount[mcount > 0], return_counts=True)
            for v, c in zip(vals, counts):
                f.write(f"{int(v)}\t{int(c)}\n")
        if self._mutual is not None:
            ours = read_cover_file(cfg.file_str("communities.txt"))
            gt = read_cover_file(cfg.file_str("ground_truth.txt"))
            self._mutual.write(f"mutual3:\t{overlapping_nmi(gt, ours):g}\n")
            self._mutual.flush()

    def do_on_stop(self) -> None:
        self.log_communities()
        gamma, lam = self.gamma.cpu().numpy(), self.lam.cpu().numpy()
        save_model(self.cfg.outdir, gamma, lam, self.network.seq2id)
        write_groups(self.cfg.file_str("groups.txt"), gamma,
                     self.network.seq2id)
        with open(self.cfg.file_str("communities_size.txt"), "w") as f:
            for c in sorted(self._communities):
                f.write(f"{c}\t{len(self._communities[c])}\n")
        counts = np.bincount(gamma.argmax(1), minlength=self.k)
        with open(self.cfg.file_str("summary.txt"), "a") as f:
            f.write("\t".join(str(int(c)) for c in counts) + "\n")
        self.log("stopped at iteration %d (%d s)", self.iteration,
                 self.duration())
