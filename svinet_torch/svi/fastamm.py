"""FastAMM, the -infset engine: stratified-subset SVI for large sparse
graphs (svinet_tpu/svi/fastamm.py; reference: src/fastamm.cc:548-672).

Each iteration flips a coin, True with probability 1e-4:
(a) False: an informative step, a random node's training links and its
    informative zeros (the -preprocess sets, neighbors.bin), scale n/2;
(b) True: a non-informative step, 200 nonlink partners of a random node
    from the shuffled ring (svi/sampling.py), its informative zeros and
    the held-out pairs left out, scale n^2 / (2 1e-4 200).
The pairs are cut to a fixed length (the next power of two of the largest
training degree + 101, at least 200), and the JAX engine pads them to it
with pairs (0, 0) of weight 0: the whole minibatch is one block of the
phi fixed point's exit rule. Only the touched nodes (the minibatch's,
with the start node first) take a gamma step, each with its own
Robbins-Monro counter, advanced on the host as the minibatch is drawn;
lambda steps every iteration. A report interval's minibatches are all
drawn first, as the JAX engine draws them, then stepped.

The dense step never touches all n rows: E[log pi] is a row's own
function, so kernel 1 runs on the touched rows and node 0 (the padding
pairs' row), kernel 8 solves the pairs at block = the padded length over
those rows and writes their next gamma in its node pass, each with its
own rho (ops/phicomp.py, NodeUpdate), and the rows go back into gamma.
Under -fastqueue W the state is the sparse top-W one
(ops/sparse_gamma.py): kernel 10 runs the step's fixed point and sums,
kernel 11 the held-out rows and the edge assignments.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from svinet_torch.config import Config
from svinet_torch.evals.likelihood import HeldoutResult
from svinet_torch.graph import Network
from svinet_torch.io.writers import write_communities
from svinet_torch.ops.edges import SEG_LEN, Adjacency, owner_csr
from svinet_torch.ops.expectations import dirichlet_expectation
from svinet_torch.ops.phicomp import NodeUpdate, phi_fixed_point
from svinet_torch.ops.sparse_gamma import (
    K10_SEG_LEN, SparseWorkspace, densify, sparse_edge_assignments,
    sparse_fastamm_step, sparse_pair_scores)
from svinet_torch.svi.base import EngineBase
from svinet_torch.svi.mmsb import init_gamma_random
from svinet_torch.svi.sampling import nonlink_accept, ring_nonlink_scan

INF_EPSILON = 1e-4       # reference: src/fastamm.cc:18
NONINF_SETSIZE = 200     # reference: src/fastamm.cc:18


class Batch(NamedTuple):
    """One prepared step on the host. rows: the nodes whose rows the step
    reads, distinct; pairs: the minibatch, its ends as indices into rows
    (dense) or as node ids (sparse); ends: the ends' indices into rows,
    interleaved (the endpoint CSR's owners); rho: each row's rate."""
    rows: np.ndarray      # (U,) int64
    pairs: np.ndarray     # (m, 2) int32
    y: np.ndarray         # (m,) int32
    w: np.ndarray         # (m,) f32
    ends: np.ndarray      # (2m,) int64
    rho: np.ndarray       # (U,) f32
    scale: float
    rhot: float


def touched_rows(touched: np.ndarray, rho: np.ndarray, n: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The distinct nodes of a touched list (padding n left out), sorted,
    each with the rho of its last place in the list: the place the JAX
    step's scatter keeps (svinet_tpu/svi/fastamm.py:66-67)."""
    keep = touched < n
    t, r = touched[keep], rho[keep]
    nodes, rev = np.unique(t[::-1], return_index=True)
    return nodes.astype(np.int64), r[len(t) - 1 - rev]


def node_rates(nodes: np.ndarray, nodec: np.ndarray, tau0: float,
               kappa: float) -> np.ndarray:
    """(tau0 + c)^-kappa for each place of `nodes`, c the node's counter
    plus its earlier places in the list, and the counters advanced: the
    JAX engine's loop (svinet_tpu/svi/fastamm.py:280-284) at numpy
    speed."""
    order = np.argsort(nodes, kind="stable")
    sv = nodes[order]
    start = np.r_[0, np.nonzero(sv[1:] != sv[:-1])[0] + 1]
    run = np.repeat(start, np.diff(np.r_[start, len(sv)]))
    before = np.empty(len(nodes), np.int64)
    before[order] = np.arange(len(sv)) - run
    rho = (tau0 + (nodec[nodes] + before)) ** (-kappa)
    np.add.at(nodec, nodes, 1)
    return rho.astype(np.float32)


class Step(NamedTuple):
    """A prepared step on the device: Batch's arrays, the scalars as ()
    f32 tensors, the endpoint CSR over the rows, and the ends' rows as
    two int32 columns (lp, lq)."""
    rows: torch.Tensor
    pairs: torch.Tensor
    y: torch.Tensor
    w: torch.Tensor
    rho: torch.Tensor
    scale: torch.Tensor
    rhot: torch.Tensor
    csr: Adjacency
    lp: torch.Tensor
    lq: torch.Tensor


def to_device(batches, device, seg_len: int = SEG_LEN) -> list:
    """Steps of `batches` on `device`: every array of the interval packed
    into one buffer a dtype, copied once, and cut into views (each step's
    endpoint CSR made on the host, its rows cut into segments of seg_len
    entries), so that a step copies nothing."""
    parts = {np.int64: [], np.int32: [], np.float32: []}
    at = {dt: 0 for dt in parts}
    spans = []

    def put(a, dt):
        a = np.ascontiguousarray(a, dt).reshape(-1)
        parts[dt].append(a)
        at[dt] += len(a)
        return at[dt] - len(a), len(a)

    for b in batches:
        csr = owner_csr(torch.from_numpy(b.ends), len(b.rows), seg_len)
        spans.append((put(b.rows, np.int64), put(b.pairs, np.int32),
                      put(b.y, np.int32), put(b.w, np.float32),
                      put(b.rho, np.float32),
                      put([b.scale, b.rhot], np.float32),
                      [put(t.numpy(), np.int32) for t in csr.tensors()],
                      csr.seg_len, put(b.ends[0::2], np.int32),
                      put(b.ends[1::2], np.int32)))
    buf = {dt: torch.from_numpy(np.concatenate(a) if a else
                                np.zeros(0, dt)).to(device)
           for dt, a in parts.items()}

    def view(span, dt):
        return buf[dt][span[0]:span[0] + span[1]]

    steps = []
    for rows, pairs, y, w, rho, sc, csr, seg_len, lp, lq in spans:
        f = view(sc, np.float32)
        steps.append(Step(
            view(rows, np.int64), view(pairs, np.int32).view(-1, 2),
            view(y, np.int32), view(w, np.float32), view(rho, np.float32),
            f[0], f[1],
            Adjacency(*(view(c, np.int32) for c in csr), seg_len),
            view(lp, np.int32), view(lq, np.int32)))
    return steps


def fastamm_step(gamma, lam, rows, pairs, y, w, rho, alpha: float, eta,
                 scale, rhot, do_lambda: float, log_eps: float,
                 max_iters: int, thresh: float, block: int, csr=None):
    """One dense FastAMM step, gamma in place
    (svinet_tpu/svi/fastamm.py:40-70). rows (U,) int64: node 0, then the
    touched nodes; pairs (m, 2) int32 index rows; rho (U,) f32 each row's
    rate; block the padded length (m <= block); scale and rhot () f32
    tensors. Row 0 is the JAX padding pairs' row (0, 0); it is read, and
    written back only as a touched node. Returns lambda."""
    g = gamma[rows]
    elogpi = dirichlet_expectation(g)
    elogbeta = dirichlet_expectation(lam)
    out, lacc, _ = phi_fixed_point(
        elogpi, elogbeta, pairs, y, w, log_eps, max_iters, thresh,
        block=block, csr=csr, update=NodeUpdate(g, alpha, scale, rho))
    gamma[rows[1:]] = out[1:]
    if do_lambda > 0:
        lambdat = eta + scale * lacc
        lam = (1.0 - rhot) * lam + rhot * lambdat
    return lam


def link_communities(path, tl: np.ndarray, cids: np.ndarray,
                     mx: np.ndarray, k: int, link_thresh: float,
                     lt_min_deg: int, seq2id: np.ndarray) -> dict:
    """The sparse state's communities from each training link's community
    `cids` and its phi `mx`: a link above link_thresh counts for both
    ends, a (node, community) key counted more than lt_min_deg times is a
    membership. Writes communities.txt, mcount.txt and aggregate.txt at
    path(name); returns {community: [nodes]}."""
    sel = mx > link_thresh
    nodes = np.concatenate([tl[sel, 0], tl[sel, 1]]).astype(np.int64)
    cs = np.concatenate([cids[sel], cids[sel]]).astype(np.int64)
    keys, counts = np.unique(nodes * k + cs, return_counts=True)
    keep = counts > lt_min_deg
    comms: dict = {}
    for key in keys[keep]:
        comms.setdefault(int(key % k), []).append(int(key // k))
    write_communities(path("communities.txt"), comms, seq2id)
    m_nodes, m_counts = np.unique(keys[keep] // k, return_counts=True)
    with open(path("mcount.txt"), "w") as f:
        for node, c in zip(m_nodes, m_counts):
            f.write(f"{int(node)}\t{int(seq2id[int(node)])}\t{int(c)}\n")
    with open(path("aggregate.txt"), "w") as f:
        vs, cc = np.unique(m_counts, return_counts=True)
        for v, c in zip(vs, cc):
            f.write(f"{int(v)}\t{int(c)}\n")
    return comms


class FastAMM(EngineBase):
    """The engine on the host (a -preprocess run's neighbors.bin, or the
    sets computed inline)."""

    dual_heldout_splits = True   # src/fastamm.cc:319-320
    # cmap.txt's row comes after EngineBase's report, and a checkpoint of
    # the report after it
    defer_report_hooks = True

    def __init__(self, cfg: Config, network: Network, device: torch.device):
        super().__init__(cfg, network, device)
        n, k = self.n, self.k
        if network.sparse_zeros_ptr is None:
            nb = cfg.file_str("neighbors.bin")
            if os.path.exists(nb):
                network.load_neighborhood_sets(nb)
            elif os.path.exists("neighbors.bin"):
                network.load_neighborhood_sets("neighbors.bin")
            else:
                print("+ neighbors.bin not found; preprocessing inline")
                network.set_neighborhood_sets(cfg)

        self._W = int(cfg.fastqueue_width)
        if self._W > 0:
            if self._W >= k:
                raise SystemExit("-fastqueue width must be < k")
            # the top-W compression of the dense Gamma(100, 0.01) init,
            # drawn blockwise as the JAX engine draws it
            # (svinet_tpu/svi/fastamm.py:153-181)
            w = self._W
            ids = np.empty((n, w), np.int32)
            vals = np.empty((n, w), np.float32)
            rest = np.empty(n, np.float32)
            bsz = max(1, (1 << 24) // max(k, 1))
            for lo in range(0, n, bsz):
                g = self.rng.gamma(100.0, 0.01,
                                   size=(min(bsz, n - lo), k))
                top = np.argpartition(-g, w - 1, axis=1)[:, :w]
                v = np.take_along_axis(g, top, 1)
                hi = lo + len(g)
                ids[lo:hi] = top
                vals[lo:hi] = v
                rest[lo:hi] = np.maximum(g.sum(1) - v.sum(1), 0.0)
            self.ids = torch.as_tensor(ids, device=device)
            self.vals = torch.as_tensor(vals, device=device)
            self.rest = torch.as_tensor(rest, device=device)
            self.gamma = None
            # kernel 10's outputs and scratch, kept across the steps, and
            # kernel 11's across the reports
            self._k10 = SparseWorkspace(device)
            self._k11 = SparseWorkspace(device)
            cfg.plog("fastqueue width", self._W)
        else:
            self.gamma = torch.as_tensor(init_gamma_random(self.rng, n, k),
                                         dtype=torch.float32, device=device)
        l0 = np.tile([cfg.eta0, cfg.eta1], (k, 1))
        self.lam = torch.as_tensor(l0, dtype=torch.float32, device=device)
        self.eta = torch.as_tensor(l0, dtype=torch.float32, device=device)
        self.alpha = float(np.float32(cfg.alpha))
        self.log_eps = float(np.float32(np.log(cfg.epsilon)))

        self._nodec = np.zeros(n, np.int64)
        self._shuffled = self.rng.permutation(n)
        self._lambda_start_iter = 0
        # cmap.txt: per report the mean and stdev of the informative sets'
        # sizes (reference: src/fastamm.cc:223-227, 636-640)
        self._nbr_sizes: list = []
        self._cmapf = open(cfg.file_str("cmap.txt"),
                           "a" if cfg.resume else "w")
        max_deg = int(network.training_deg.max()) if n else 0
        self._pad = 1 << int(np.ceil(np.log2(
            max(max_deg + 100 + 1, NONINF_SETSIZE, 64))))
        self._resume_if_requested()

    def close(self) -> None:
        super().close()
        self._cmapf.close()

    # ------------------------------------------------------------------
    def report(self) -> bool:
        stop = super().report()
        sizes = self._nbr_sizes or [0]
        self._cmapf.write(f"{self.iteration}\t{self.duration()}\t"
                          f"{np.mean(sizes):.5f}\t{np.std(sizes):.5f}\n")
        self._cmapf.flush()
        self._nbr_sizes = []
        self._end_of_report()
        return stop

    def _informative_sample(self):
        r = int(self.rng.integers(0, self.n))
        nbrs = self.network.neighbors(r).astype(np.int64)
        zeros = self.network.sparse_zeros(r).astype(np.int64)
        others = np.concatenate([nbrs, zeros])
        ys = np.concatenate([np.ones(len(nbrs), np.int32),
                             np.zeros(len(zeros), np.int32)])
        lo = np.minimum(r, others)
        hi = np.maximum(r, others)
        ok = self.network.edge_ok_mask(lo, hi) & (others != r)
        pairs = np.stack([lo[ok], hi[ok]], 1).astype(np.int32)
        self._nbr_sizes.append(int(ok.sum()))
        return pairs, ys[ok], np.r_[r, others[ok]]

    def _noninf_sample(self):
        r = int(self.rng.integers(0, self.n))
        inf_sorted = np.sort(self.network.sparse_zeros(r).astype(np.int64))
        start = int(self.rng.integers(0, self.n))
        others = ring_nonlink_scan(
            self._shuffled, self.n, start, NONINF_SETSIZE,
            nonlink_accept(self.network, r, inf_sorted,
                           require_edge_ok=True))
        pairs = np.stack([np.minimum(r, others), np.maximum(r, others)],
                         1).astype(np.int32).reshape(-1, 2)
        return pairs, np.zeros(len(others), np.int32), np.r_[r, others]

    def _prepare(self, it: int) -> Batch:
        """One iteration's minibatch and schedule, drawn in the JAX
        engine's order (svinet_tpu/svi/fastamm.py:255-292): the coin, then
        the sample; the touched nodes' counters advance here."""
        cfg = self.cfg
        n = self.n
        if not self.rng.uniform() < INF_EPSILON:
            pairs, ys, nodes = self._informative_sample()
            scale = n / 2.0
        else:
            pairs, ys, nodes = self._noninf_sample()
            scale = (float(n) * n) / (2.0 * INF_EPSILON * NONINF_SETSIZE)
        m = min(len(pairs), self._pad)
        touched = nodes[:self._pad + 8].astype(np.int64)
        rho = node_rates(touched, self._nodec, cfg.nodetau0, cfg.nodekappa)
        rhot = (cfg.tau0 + (it - self._lambda_start_iter + 1)
                ) ** (-cfg.kappa)
        rows, rho = touched_rows(touched, rho, n)
        pairs = pairs[:m]
        local = np.searchsorted(rows, pairs.astype(np.int64))
        if not self._W:
            # row 0 of the step is node 0, the padding pairs' row
            rows = np.r_[0, rows]
            rho = np.r_[np.float32(0.0), rho]
            local = local + 1
            pairs = local.astype(np.int32)
        return Batch(rows, pairs.reshape(-1, 2), ys[:m].astype(np.int32),
                     np.ones(m, np.float32), local.reshape(-1), rho,
                     scale, rhot)

    def _step_many(self, count: int) -> None:
        """`count` steps, their minibatches all drawn first, then (dense)
        the report's sums on the final state."""
        cfg = self.cfg
        batches = [self._prepare(self.iteration + b) for b in range(count)]
        dl = 0.0 if cfg.nolambda else 1.0
        seg_len = K10_SEG_LEN if self._W else SEG_LEN
        for st in to_device(batches, self.device, seg_len):
            if self._W:
                self.lam = sparse_fastamm_step(
                    self.ids, self.vals, self.rest, self.lam, st.pairs, st.y,
                    st.w, st.lp, st.lq, st.rows, st.rho, self.alpha,
                    self.eta, st.scale, st.rhot, dl, self.log_eps, self.k,
                    cfg.online_iterations, cfg.meanchangethresh, self._pad,
                    st.csr, self._k10)
            else:
                self.lam = fastamm_step(
                    self.gamma, self.lam, st.rows, st.pairs, st.y, st.w,
                    st.rho, self.alpha, self.eta, st.scale, st.rhot, dl,
                    self.log_eps, cfg.online_iterations,
                    cfg.meanchangethresh, self._pad, st.csr)
        if not self._W:
            self._eval_tail()

    # ------------------------------------------------------------------
    def _heldout(self, pairs, y) -> HeldoutResult:
        if not self._W:
            return super()._heldout(pairs, y)
        s_one, inner = sparse_pair_scores(self.ids, self.vals, self.rest,
                                           self.lam, pairs, self.k,
                                           self._k11)
        s_one = s_one.cpu().numpy()
        inner = inner.cpu().numpy()
        eps = self.cfg.epsilon
        s_zero = inner - s_one + (1.0 - inner) * (1.0 - eps)
        yy = y.cpu().numpy()
        s = np.where(yy == 1, s_one, s_zero)
        ll = np.log(np.maximum(s, 1e-30))
        ones = yy == 1
        return HeldoutResult(
            avg=float(ll.mean()), count=len(ll),
            avg0=float(ll[~ones].mean()) if (~ones).any() else 0.0,
            count0=int((~ones).sum()),
            avg1=float(ll[ones].mean()) if ones.any() else 0.0,
            count1=int(ones.sum()))

    def log_communities(self) -> None:
        """On the sparse state: each training link's community from
        kernel 11, then the files of link_communities
        (svinet_tpu/svi/fastamm.py:357-404)."""
        if not self._W:
            return super().log_communities()
        cfg = self.cfg
        tl = self.network.training_links
        cids, mx = sparse_edge_assignments(
            self.ids, self.vals, self.rest, self.lam,
            self._device_pairs(tl.astype(np.int32)), self.k, self._k11)
        self._communities = link_communities(
            cfg.file_str, tl, cids.cpu().numpy(), mx.cpu().numpy(), self.k,
            cfg.link_thresh, cfg.lt_min_deg, self.network.seq2id)
        if self._mutual is not None:
            from svinet_torch.evals.nmi import (overlapping_nmi,
                                                read_cover_file)
            ours = read_cover_file(cfg.file_str("communities.txt"))
            self._mutual.write(
                f"mutual3:\t{overlapping_nmi(self._gt(), ours):g}\n")
            self._mutual.flush()

    def _state_dict(self) -> dict:
        if not self._W:
            d = super()._state_dict()
        else:
            d = self._host_state()
            d.update(ids=self.ids, vals=self.vals, rest=self.rest,
                     lam=self.lam)
        # the per-node Robbins-Monro counters are schedule state
        # (src/fastamm.cc:594)
        d["nodec"] = torch.from_numpy(self._nodec)
        return d

    def _restore_state(self, state) -> None:
        if not self._W:
            super()._restore_state(state)
        else:
            self.ids = state["ids"].to(self.device, torch.int32)
            self.vals = state["vals"].to(self.device, torch.float32)
            self.rest = state["rest"].to(self.device, torch.float32)
            self.lam = state["lam"].to(self.device, torch.float32)
            self._restore_host_state(state)
        nc = state.get("nodec")
        if nc is not None:
            self._nodec = np.asarray(nc, np.int64).copy()

    def do_on_stop(self, next_iteration=None) -> None:
        if not self._W:
            return super().do_on_stop(next_iteration=next_iteration)
        # gamma.txt is (n, K) text whatever the state in memory
        self.gamma = densify(self.ids, self.vals, self.rest, self.k)
        super().do_on_stop(next_iteration=next_iteration)
        self.gamma = None

    def infer(self) -> None:
        cfg = self.cfg
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
