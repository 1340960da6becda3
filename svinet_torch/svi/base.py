"""Host-side engine scaffolding (svinet_tpu/svi/base.py:29-729).

Output files, the heldout splits, the stopping controller, mrstats,
community/NMI logging and native checkpoints live here; the engine
subclass owns the gamma/lam tensors and the steps. Under a mesh
(parallel/mesh.py) every rank runs the same loop: rank 0 alone writes the
model files, the communities and the checkpoints, the other ranks write
their report rows into a private directory, and the decisions come from
values every rank holds (the step's heldout sums, broadcast from rank 0)
or agree on (a SIGTERM).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from svinet_torch.config import Config
from svinet_torch.graph import Network
from svinet_torch.io import checkpoint
from svinet_torch.io.native import write_edges_tsv
from svinet_torch.io.writers import (
    ReportFile, save_model, write_edgelist, write_groups, write_max,
)
from svinet_torch.evals.likelihood import (
    HeldoutResult, heldout_stats, multi_heldout_sums, result_from_sums)
from svinet_torch.evals.nmi import overlapping_nmi, read_cover_file
from svinet_torch.evals.stopping import ValidationStop
from svinet_torch.ops.edges import owner_csr, pad_edges
from svinet_torch.parallel import mesh
from svinet_torch.svi.communities import edge_assignments, extract_communities


class EngineBase:
    """Owns output files, heldout splits, the stopping controller, and the
    community/NMI logging. Subclasses own gamma/lam device state and steps.

    The numpy Generator is consumed in the reference's order: the heldout
    split(s) here, then the training sample, then the subclass's gamma
    init, so the initial state matches the JAX engine's bit for bit."""

    # The classic-SVI engines sample TWO disjoint splits: heldout drives
    # the stopping rule and heldout.txt, validation is evaluated at new
    # maxima (max.txt column 6; reference: src/mmsbinfer.cc:206-328,
    # 2145-2170). LinkSampling keeps the single split.
    dual_heldout_splits = False

    # stop guard iter > stop_min_iter (None: min(n, 5000)); plateau why
    # code; stop after more than stop_decline_reports declines
    # (evals/stopping.py). The default is the classic-SVI controller.
    stop_min_iter: "int | None" = None
    stop_plateau_why = 0
    stop_decline_reports = 2

    # Checkpoints store the NEXT iteration to run. At a report boundary the
    # minibatch engines have already counted the step (+0); LinkSampling's
    # loop sits at the sweep just done and stores +1.
    ckpt_boundary_offset = 0
    # LinkSampling writes its own per-step time.txt rows
    writes_own_timefile = False
    # engines whose report() changes state after EngineBase.report() call
    # _end_of_report themselves, so a checkpoint sees the whole report
    defer_report_hooks = False

    def __init__(self, cfg: Config, network: Network, device: torch.device,
                 group: "mesh.Group | None" = None):
        self.cfg = cfg
        self.network = network
        self.device = device
        # the mesh this engine is a rank of (None: one device); rank 0 is
        # the primary, which writes the output directory
        self._group = group
        self.primary = self._group is None or self._group.primary
        self.rng = np.random.default_rng(cfg.seed)
        self._start = time.time()
        self._dur_offset = 0
        cfg.make_outdir()
        app = bool(cfg.resume)

        if cfg.load_heldout and cfg.load_heldout_fname:
            network.validation_pairs, network.validation_y = \
                network.load_pairs_file(cfg.load_heldout_fname)
            network.assign_training_links()
        else:
            network.sample_heldout_sets(self.rng,
                                        dual=self.dual_heldout_splits)
        if cfg.load_test and cfg.load_test_fname:
            network.test_pairs, network.test_y = \
                network.load_pairs_file(cfg.load_test_fname)
            network.assign_training_links()

        self._dual = bool(len(network.heldout_pairs))
        write_edgelist(cfg.file_str("validation-edges.txt"),
                       network.validation_pairs, network.validation_y,
                       network.seq2id)
        # dual-split engines write each split to its own file; single-split
        # engines write the one set under both names
        write_edgelist(cfg.file_str("heldout-edges.txt"),
                       network.heldout_pairs if self._dual
                       else network.validation_pairs,
                       network.heldout_y if self._dual
                       else network.validation_y, network.seq2id)
        if len(network.test_pairs):
            write_edgelist(cfg.file_str("test-edges.txt"),
                           network.test_pairs, network.test_y, network.seq2id)

        # infer.log (reference: Logger, src/log.cc:9-127) + network.dat
        # symlink of the input (reference: src/env.hh:621-625)
        self._log = open(cfg.file_str("infer.log"), "a" if app else "w")
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
        self._trf = ReportFile(cfg.file_str("training.txt"), append=app)

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
        # the STOPPING split: heldout for dual-split engines, else the
        # validation split object itself (identity matters: _heldout keys
        # off `pairs is self.val_pairs`)
        if self._dual:
            self.stop_pairs = self._device_pairs(network.heldout_pairs)
            self.stop_y = self._device_pairs(
                network.heldout_y.astype(np.int32))
        else:
            self.stop_pairs, self.stop_y = self.val_pairs, self.val_y
        self._max_v = -2147483647.0   # validation avg at the best nshol
        self.test_pairs = (self._device_pairs(network.test_pairs)
                           if len(network.test_pairs) else None)
        self.test_y = (self._device_pairs(network.test_y.astype(np.int32))
                       if len(network.test_pairs) else None)

        self.iteration = 0
        self.terminate_requested = False   # set by the SIGTERM handler
        # True while an engine replays a row of a -report-batch batch that
        # is not the batch's last: the state belongs to the batch's end,
        # so the report writes its likelihood rows and skips the rest
        self._light_report = False
        self.stopper = ValidationStop(
            stopthresh=cfg.stopthresh,
            min_iter=(min(self.n, 5000) if self.stop_min_iter is None
                      else self.stop_min_iter),
            plateau_why=self.stop_plateau_why,
            decline_reports=self.stop_decline_reports)
        # on -resume the metric histories written so far are kept
        self._vf = ReportFile(cfg.file_str("validation.txt"), append=app)
        self._hf = ReportFile(cfg.file_str("heldout.txt"), append=app)
        # every reference engine opens logl.txt; only -logl writes it, so
        # touch it for an identical file inventory
        open(cfg.file_str("logl.txt"), "a" if app else "w").close()
        self._tf = (ReportFile(cfg.file_str("test.txt"), append=app)
                    if self.test_pairs is not None else None)
        self._mutual = None
        self._gt_cover = None
        if cfg.nmi and network.ground_truth is not None:
            network.write_gt_communities(cfg.file_str("ground_truth.txt"))
            self._mutual = open(cfg.file_str("mutual.txt"),
                                "a" if app else "w")
        self._communities = {}

        cfg.write_param_txt()
        cfg.plog("inference n", self.n)
        cfg.plog("total pairs", network.total_pairs)
        cfg.plog("network ones", network.ones)
        cfg.plog("heldout pairs (1s and 0s)", len(network.validation_pairs))

        # set by the subclass
        self.gamma = self.lam = None
        self._last_ckpt = time.time()
        self._tail_res = None     # the step's eval-tail sums, by set

    def close(self) -> None:
        """Close the report files the engine holds open between reports."""
        for f in (self._log, self._mutual, getattr(self, "_statsf", None),
                  getattr(self, "_mrf", None), getattr(self, "_convf", None),
                  getattr(self, "_timef", None),
                  self._vf, self._hf, self._trf, self._tf):
            if f is not None:
                f.close()

    # ------------------------------------------------------------------
    def duration(self) -> int:
        """Seconds of training, cumulative across resumes: a checkpoint
        stores the seconds so far, so the duration columns stay on one
        clock across a resume."""
        return int(time.time() - self._start) + self._dur_offset

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
        # host copy kept for the step's eval tail
        self._train_sample_np = (pairs, ys)
        return self._device_pairs(pairs), self._device_pairs(ys)

    # -- native checkpoints (svinet_tpu/svi/base.py:271-421) ------------
    def _host_state(self) -> dict:
        """Host scalars every engine checkpoints. The stopping controller's
        history is state: without it a resumed run restarts the plateau
        tracking and stops elsewhere than the uninterrupted run."""
        s = self.stopper
        return {"iteration": self.iteration,
                "dur_offset": self.duration(),
                "max_v": self._max_v,
                "stopper": [s.prev_h, s.max_h, s.max_t, float(s.nh),
                            float(s.why), float(s.since_max)]}

    def _restore_host_state(self, state) -> None:
        self.iteration = int(state["iteration"])
        self._dur_offset = int(state.get("dur_offset", 0))
        self._max_v = float(state.get("max_v", self._max_v))
        self._start = time.time()
        st = state.get("stopper")
        if st is not None:
            s = self.stopper
            s.prev_h, s.max_h, s.max_t = (float(st[0]), float(st[1]),
                                          float(st[2]))
            s.nh, s.why, s.since_max = int(st[3]), int(st[4]), int(st[5])

    def _state_dict(self) -> dict:
        """State captured by native checkpoints; engines with more state
        extend it."""
        d = self._host_state()
        d.update(gamma=self.gamma, lam=self.lam)
        return d

    def _restore_state(self, state) -> None:
        self.gamma = state["gamma"].to(self.device, torch.float32)
        self.lam = state["lam"].to(self.device, torch.float32)
        self._restore_host_state(state)

    def _resume_if_requested(self) -> None:
        """Engines call this last in __init__: -resume restores the newest
        native checkpoint in the output directory."""
        if self.cfg.resume and self.try_restore():
            print(f"+ resumed from checkpoint at iteration {self.iteration}")

    def _ckpt_dir(self) -> str:
        """Where checkpoints live: the output directory, or under a mesh
        rank 0's, which every rank restores from
        (svinet_tpu/svi/base.py:352-359)."""
        return self.cfg.ckpt_outdir or self.cfg.outdir

    def save_checkpoint(self, iteration: "int | None" = None) -> None:
        """`iteration` overrides the stored step; checkpoints store the
        NEXT iteration to run. Under a mesh rank 0 saves, the others
        only restart their clock (svinet_tpu/io/checkpoint.py:38-43)."""
        if self.primary:
            state = self._state_dict()
            if iteration is not None:
                state["iteration"] = int(iteration)
            checkpoint.save_checkpoint(self._ckpt_dir(), state,
                                       state["iteration"])
        self._last_ckpt = time.time()

    def try_restore(self) -> bool:
        """Restore the newest native checkpoint of the output directory;
        False when there is none (the -load TSV model is the other way
        in). Under a mesh every rank restores the same state and
        iteration (svinet_tpu/io/checkpoint.py:185-188)."""
        state = checkpoint.load_checkpoint(self._ckpt_dir())
        if state is None:
            return False
        self._restore_state(state)
        return True

    def _maybe_periodic_checkpoint(self) -> None:
        """At report boundary `iteration`, with its report complete: save
        when -checkpoint-freq seconds have passed since the last save."""
        freq = self.cfg.checkpoint_freq
        if freq and time.time() - self._last_ckpt >= freq:
            self.save_checkpoint(self.iteration + self.ckpt_boundary_offset)

    # -- the step's eval tail (svinet_tpu/svi/base.py:432-515) -----------
    # The per-report pair-set sums (the stopping split, the validation
    # split of a dual engine, the training sample) are computed on the
    # step's final state, one launch of kernel 6 a set, and the report
    # reads them from the stash.

    def _tail_device_sets(self):
        """Cached padded tensors of the tail's pair sets, in order: the
        stopping split, the validation split (dual engines), the training
        sample. Returns (pairs, ys, ws, blocks, names), tuples of one entry
        a set, or None when there is nothing to evaluate."""
        if hasattr(self, "_tail_cache"):
            return self._tail_cache
        net = self.network

        def pad(pairs, y):
            m = len(pairs)
            blk = min(1 << 17, max(64, 1 << int(np.ceil(
                np.log2(max(m, 1))))))
            pp, ww = pad_edges(pairs, blk)
            yy = np.zeros(len(pp), np.int32)
            yy[:m] = y
            return (self._device_pairs(pp), self._device_pairs(yy),
                    self._device_pairs(ww), len(pp) // blk)

        names, raw = [], []
        stop_np = net.heldout_pairs if self._dual else net.validation_pairs
        stop_y = net.heldout_y if self._dual else net.validation_y
        if len(stop_np):
            names.append("stop")
            raw.append(pad(stop_np, stop_y))
        if self._dual and len(net.validation_pairs):
            names.append("val")
            raw.append(pad(net.validation_pairs, net.validation_y))
        tsn = getattr(self, "_train_sample_np", None)
        if tsn is not None:
            names.append("train")
            raw.append(pad(tsn[0], tsn[1]))
        self._tail_cache = (tuple(zip(*raw)) + (tuple(names),)
                            if names else None)
        return self._tail_cache

    def _eval_tail(self) -> None:
        """Evaluate the tail's sets on the current state and stash them."""
        tail = self._tail_device_sets()
        if tail is None:
            self._tail_res = None
            return
        pp, yy, ww, nb, names = tail
        self._stash_tail(multi_heldout_sums(self.gamma, self.lam, pp, yy, ww,
                                            self.cfg.epsilon, nb), names)

    def _stash_tail(self, rows, names) -> None:
        """rows: (S, 6) sums in _tail_device_sets order; under a mesh rank
        0's, on every rank."""
        if self._group is not None:
            mesh.broadcast(rows)
        rows = rows.cpu()
        self._tail_res = {nm: rows[i] for i, nm in enumerate(names)}

    def _heldout(self, pairs, y) -> HeldoutResult:
        """Heldout likelihood over a pair set; the sets whose sums rode the
        step's tail are served from the stash (identity match)."""
        tr = self._tail_res
        if tr:
            if pairs is self.stop_pairs and "stop" in tr:
                return result_from_sums(tr["stop"])
            if pairs is self.val_pairs:
                key = "val" if "val" in tr else (
                    "stop" if not self._dual else None)
                if key:
                    return result_from_sums(tr[key])
            ts = self._train_sample
            if ts is not None and pairs is ts[0] and "train" in tr:
                return result_from_sums(tr["train"])
        return heldout_stats(self.gamma, self.lam, pairs, y,
                             self.cfg.epsilon)

    # ------------------------------------------------------------------
    def report(self) -> bool:
        """Stopping-split likelihood + stopping logic. Returns True to
        stop. Dual-split engines stop on the heldout split and record the
        validation split only at new maxima (reference:
        src/mmsbinfer.cc:2085-2170); single-split engines write the same
        rows to both files. A light report (-report-batch replay) skips
        the test-set eval, the training-sample rows, the communities and
        mrstats.txt."""
        cfg = self.cfg
        light = self._light_report
        _mr0 = time.time()
        res = self._heldout(self.stop_pairs, self.stop_y)
        nshol = self._hf.write(self.iteration, self.duration(), res,
                               cfg.zeros_prob, cfg.ones_prob)
        if not self._dual:
            self._vf.write(self.iteration, self.duration(), res,
                           cfg.zeros_prob, cfg.ones_prob)
        if self._tf is not None and not light:
            tres = self._heldout(self.test_pairs, self.test_y)
            self._tf.write(self.iteration, self.duration(), tres,
                           cfg.zeros_prob, cfg.ones_prob)
        if self._train_sample is not None and not light:
            self._report_training_sample()
        self.log("iteration %d: validation nshol %.5f", self.iteration, nshol)

        # time.txt: a wall-clock row per report (e.g. src/mmsbinfer.cc:114);
        # LinkSampling writes its own per-step rows instead
        if not self.writes_own_timefile:
            if not hasattr(self, "_timef"):
                self._timef = open(cfg.file_str("time.txt"),
                                   "a" if cfg.resume else "w")
            self._timef.write(f"{self.iteration}\t{self.duration()}\n")
            self._timef.flush()

        stop = self._stop_and_write_max(nshol, self._heldout)
        _mr1 = time.time()
        # per-report communities feed the NMI trace; without -nmi huge
        # runs extract them only at stop
        if ((self._mutual is not None or self.n * self.k <= (1 << 24))
                and not light):
            self.log_communities()
        if not light:
            self._write_mrstats(_mr0, _mr1, time.time())
        if not self.defer_report_hooks:
            self._end_of_report()
        return stop and cfg.use_validation_stop

    def _stop_and_write_max(self, nshol: float, eval_fn):
        """Update the stopper with the stopping split's nshol; at a NEW
        max under dual splits, evaluate the validation split with eval_fn
        and append its 8-column row to validation.txt (reference:
        src/mmsbinfer.cc:2214-2217); then rewrite max.txt (7 columns with
        the validation average at the max when dual,
        src/mmsbinfer.cc:2165-2169). Returns the raw stop decision."""
        prev_max = self.stopper.max_h
        stop = self.stopper.update(self.iteration, nshol)
        self._last_stop_raw = stop
        if self._dual and self.stopper.max_h > prev_max:
            vres = eval_fn(self.val_pairs, self.val_y)
            self._max_v = vres.avg
            self._vf.write8(self.iteration, self.duration(), vres)
        write_max(self.cfg.file_str("max.txt"), self.iteration,
                  self.duration(), nshol, self.stopper.max_t,
                  self.stopper.max_h, self.stopper.why,
                  max_v=self._max_v if self._dual else None)
        return stop

    def _report_training_sample(self) -> None:
        """training.txt + stats.txt rows, and -accuracy's done.txt on the
        first training-likelihood plateau (reference:
        src/mmsbinfer.cc:2366, src/fastamm.cc:1238-1255)."""
        if not self.primary:
            return
        cfg = self.cfg
        tp, ty = self._train_sample
        trres = self._heldout(tp, ty)
        self._trf.write(self.iteration, self.duration(), trres,
                        cfg.zeros_prob, cfg.ones_prob)
        if not hasattr(self, "_statsf"):
            self._statsf = open(cfg.file_str("stats.txt"),
                                "a" if cfg.resume else "w")
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
                        f.write(f"mutual3:\t"
                                f"{overlapping_nmi(self._gt(), ours):g}\n")
            self._prev_train_avg = a

    def _write_mrstats(self, t_report0: float, t_evals: float,
                       t_comm: float) -> None:
        """mrstats.txt: iteration, duration_s, t_train (since the previous
        report ended), t_eval (likelihood evals + metric files),
        t_communities (community extraction + NMI)."""
        now = time.time()
        prev = getattr(self, "_mr_prev_end", self._start)
        if not hasattr(self, "_mrf"):
            self._mrf = open(self.cfg.file_str("mrstats.txt"),
                             "a" if self.cfg.resume else "w")
        self._mrf.write(
            f"{self.iteration}\t{self.duration()}\t"
            f"{t_report0 - prev:.4f}\t{t_evals - t_report0:.4f}\t"
            f"{t_comm - t_evals:.4f}\n")
        self._mrf.flush()
        self._mr_prev_end = now

    def _end_of_report(self) -> None:
        """The periodic checkpoint and the SIGTERM save at the end of a
        report (reference: src/linksampling.cc:763-766: save the model
        files and keep running). Skipped on a light report, whose state
        is not its iteration's: the batch's last row fires both."""
        if self._light_report:
            return
        self._maybe_periodic_checkpoint()
        # the flag is taken before the ranks agree on it, so that a SIGTERM
        # landing during the agreement waits for the next boundary instead
        # of being overwritten
        requested, self.terminate_requested = self.terminate_requested, False
        if self._group is not None:
            # the SIGTERM reached rank 0 (the launcher forwards it there):
            # every rank saves at this same boundary
            requested = mesh.agree_flag(requested, self._group)
        if requested:
            self.log("SIGTERM: saving model state at iteration %d",
                     self.iteration)
            nxt = self.iteration + self.ckpt_boundary_offset
            self.do_on_stop(next_iteration=nxt)
            if not self.cfg.checkpoint_freq:
                try:
                    self.save_checkpoint(nxt)
                except Exception as e:
                    # the TSV model files above were written; say plainly
                    # that the resumable checkpoint was not
                    self.log("SIGTERM checkpoint save FAILED (%r): TSV "
                             "model files written, -resume state NOT saved",
                             e)

    def _gt(self):
        """The ground-truth cover, read once."""
        if self._gt_cover is None:
            self._gt_cover = read_cover_file(
                self.cfg.file_str("ground_truth.txt"))
        return self._gt_cover

    def _community_edges(self):
        """The padded training links (and their mask) of the community
        extraction, on the device, with kernel 9's CSR of them."""
        if not hasattr(self, "_ce_cache"):
            e, m = pad_edges(self.network.training_links,
                             self.cfg.edge_block)
            e_d = self._device_pairs(e)
            self._ce_cache = (e_d, self._device_pairs(m),
                              owner_csr(e_d[:, 0], self.n))
        return self._ce_cache

    def log_communities(self) -> None:
        """communities.txt, mcount.txt, aggregate.txt and a mutual.txt row
        (reference: src/linksampling.cc:839-852, src/fastamm.cc:734-735,
        826, 858-882). The counting runs on the device; the NMI reads the
        cover in memory, as communities.txt holds it. Rank 0's work under a
        mesh."""
        if not self.primary:
            return
        cfg = self.cfg
        edges, mask, csr = self._community_edges()
        argmax, maxval = edge_assignments(self.gamma, self.lam, edges, mask,
                                          csr=csr)
        self._communities = extract_communities(
            argmax, maxval, edges, mask, self.n, self.k, cfg.link_thresh,
            cfg.lt_min_deg)
        # communities.txt as io/writers.py:write_communities writes it (one
        # community a line, its sorted external ids, a space after each)
        seq2id = self.network.seq2id
        cover = [np.sort(seq2id[g]) for g in self._communities.values()]
        with open(cfg.file_str("communities.txt"), "w") as f:
            f.writelines(("%d " * len(ids)) % tuple(ids.tolist()) + "\n"
                         for ids in cover)
        # mcount.txt (seq, ext-id, #memberships) + aggregate.txt
        mcount = np.bincount(
            np.concatenate([np.zeros(0, np.int64),
                            *self._communities.values()]), minlength=self.n)
        held = np.nonzero(mcount)[0]
        with open(cfg.file_str("mcount.txt"), "w") as f:
            f.writelines(f"{i}\t{int(seq2id[i])}\t{int(mcount[i])}\n"
                         for i in held)
        with open(cfg.file_str("aggregate.txt"), "w") as f:
            vals, counts = np.unique(mcount[held], return_counts=True)
            f.writelines(f"{int(v)}\t{int(c)}\n"
                         for v, c in zip(vals, counts))
        if self._mutual is not None:
            # the cover in memory, as communities.txt holds it
            ours = [ids.tolist() for ids in cover]
            self._mutual.write(
                f"mutual3:\t{overlapping_nmi(self._gt(), ours):g}\n")
            self._mutual.flush()

    def do_on_stop(self, next_iteration: "int | None" = None) -> None:
        """Communities, the model files, groups, communities_size and
        summary; with -checkpoint-freq a last checkpoint (callers at a
        completed report boundary pass the next iteration). Under a mesh
        rank 0 writes."""
        if self.primary:
            self._write_model()
        if self.cfg.checkpoint_freq:
            self.save_checkpoint(next_iteration)
        self.log("stopped at iteration %d (%d s)", self.iteration,
                 self.duration())

    def _write_model(self) -> None:
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

    def _out_of_time(self, max_seconds: float) -> bool:
        """Whether max_seconds of wall time have passed since the engine
        was made: under a mesh, rank 0's clock decides for every rank."""
        late = time.time() - self._start > max_seconds
        return (late if self._group is None
                else mesh.from_primary(late, self._group))
