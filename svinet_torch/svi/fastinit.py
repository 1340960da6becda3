"""FastInit, the -findk engine: community-count estimation by sparse label
propagation (svinet_tpu/svi/fastinit.py; reference: src/fastinit.cc:240-287).

Each node keeps its top `width` communities (width = -findk-width, else
min(max degree, 64)). A sweep takes, per node, the labels of its training
neighbours, counts each label's votes and keeps the `width` most voted
(count descending, then label ascending); the top label becomes the
node's label. int(log10(n)) + 1 sweeps run, with a report after each; the
line count of communities.txt is the estimated K.

Kernel 12 (csrc/fastinit_vote.cu) runs the sweep's vote, pulling each
node's neighbour labels over the training links' adjacency and sorting
them in shared memory; kernel 13 (csrc/fastinit_overlap.cu) the overlap
pass of the held-out rows and of the community extraction, a pair's two
top-width lists matched through a table keyed by community. A CPU tensor
takes the plain versions below; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from svinet_torch.config import Config
from svinet_torch.evals.likelihood import HeldoutResult
from svinet_torch.graph import Network
from svinet_torch.io.writers import write_communities
from svinet_torch.kernels import build
from svinet_torch.ops.edges import Adjacency, build_adjacency
from svinet_torch.svi.base import EngineBase

# Longest neighbour list kernel 12 sorts in one warp's shared memory; a
# node with more (a hub) takes a block of its own over global scratch.
VOTE_WARP_MAX = 256


def _next_pow2(x: torch.Tensor) -> torch.Tensor:
    """Next power of two of each entry (>= 1), int64."""
    x = x.clamp_min(1).to(torch.float64)
    return torch.exp2(torch.ceil(torch.log2(x))).to(torch.int64)


# ---------------------------------------------------------------------
# Kernel 12: the vote.

def vote_topk_plain(labels: torch.Tensor, adj: Adjacency, n: int,
                    width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One label-propagation sweep over the adjacency's entries (every
    training link in both directions): per node the `width` most voted
    neighbour labels, count descending then label ascending, as the JAX
    function's two lexsorts order them (svinet_tpu/svi/fastinit.py:39-92).
    Returns (ids (n, width) int32, sentinel n in empty slots; counts (n,
    width) f32)."""
    dev = labels.device
    rowptr = adj.rowptr.long()
    deg = rowptr[1:] - rowptr[:-1]
    owner = torch.repeat_interleave(torch.arange(n, device=dev), deg)
    lab = labels.long()[adj.nbr.long()]
    # runs of equal (owner, label)
    key = torch.sort(owner * n + lab).values
    uniq, counts = torch.unique_consecutive(key, return_counts=True)
    run_owner = uniq // n
    run_lab = uniq - run_owner * n
    # by owner, count descending; the stable sort keeps labels ascending
    top = int(counts.max()) + 1 if counts.numel() else 1
    order = torch.sort(run_owner * top + (top - counts), stable=True).indices
    so, sl, sc = run_owner[order], run_lab[order], counts[order]
    start = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(so, minlength=n), 0, out=start[1:])
    rank = torch.arange(so.numel(), device=dev) - start[so]
    keep = rank < width
    ids = torch.full((n, width), n, dtype=torch.int32, device=dev)
    cnt = torch.zeros((n, width), dtype=torch.float32, device=dev)
    ids[so[keep], rank[keep]] = sl[keep].to(torch.int32)
    cnt[so[keep], rank[keep]] = sc[keep].to(torch.float32)
    return ids, cnt


class VotePlan(NamedTuple):
    """Kernel 12's hubs (nodes with more than VOTE_WARP_MAX neighbours)
    and each one's place in the global scratch: a power of two of at
    least its degree, for its labels (int32) and its run keys (uint64)."""
    hub_node: torch.Tensor    # (H,) int32
    hub_off: torch.Tensor     # (H,) int64
    scratch: int              # entries in all


def vote_plan(adj: Adjacency) -> VotePlan:
    """The hubs of `adj` and their scratch, made once an adjacency."""
    rowptr = adj.rowptr.long()
    deg = rowptr[1:] - rowptr[:-1]
    hubs = torch.nonzero(deg > VOTE_WARP_MAX).flatten()
    size = _next_pow2(deg[hubs])
    off = torch.zeros_like(size)
    if hubs.numel():
        off[1:] = torch.cumsum(size, 0)[:-1]
    return VotePlan(hubs.to(torch.int32), off, int(size.sum()))


def vote_topk(labels: torch.Tensor, adj: Adjacency, n: int, width: int,
              plan: "VotePlan | None" = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 12 (csrc/fastinit_vote.cu) on CUDA tensors, vote_topk_plain
    on CPU tensors. labels (n,) int32; `adj` the training links'
    adjacency on labels' device; `plan` its vote_plan (made here when not
    given). Integers only: the kernel equals the plain version bit for
    bit."""
    if labels.device.type == "cpu":
        return vote_topk_plain(labels, adj, n, width)
    build.require_cuda(labels, "vote_topk")
    dev = labels.device
    if width < 1:
        raise ValueError(f"width must be positive, got {width}")
    build.check_cuda(labels, "labels", torch.int32, (n,), dev)
    build.check_cuda(adj.rowptr, "rowptr", torch.int32, (n + 1,), dev)
    build.check_cuda(adj.nbr, "nbr", torch.int32, tuple(adj.nbr.shape), dev)
    if plan is None:
        plan = vote_plan(adj)
    ids = torch.empty((n, width), dtype=torch.int32, device=dev)
    cnt = torch.empty((n, width), dtype=torch.float32, device=dev)
    lab_s = torch.empty(max(plan.scratch, 1), dtype=torch.int32, device=dev)
    key_s = torch.empty(max(plan.scratch, 1), dtype=torch.int64, device=dev)
    build.launch("svt_fastinit_vote", dev, labels.data_ptr(),
                 adj.rowptr.data_ptr(), adj.nbr.data_ptr(),
                 plan.hub_node.data_ptr(), plan.hub_off.data_ptr(),
                 lab_s.data_ptr(), key_s.data_ptr(), ids.data_ptr(),
                 cnt.data_ptr(), n, plan.hub_node.shape[0], width)
    build.count_launch(vote_topk, "hubs" if plan.hub_node.numel() else "f32")
    return ids, cnt


vote_topk.launches = 0
vote_topk.forms = {}


def label_propagation(adj: Adjacency, n: int, width: int, sweeps: int,
                      labels: "torch.Tensor | None" = None,
                      plan: "VotePlan | None" = None) -> torch.Tensor:
    """`sweeps` sweeps from `labels` (each node its own label when not
    given): each takes its node's top voted label, an isolated node
    keeps its own (svinet_tpu/svi/fastinit.py:196-201)."""
    dev = adj.rowptr.device
    if labels is None:
        labels = torch.arange(n, dtype=torch.int32, device=dev)
    if plan is None and dev.type == "cuda":
        plan = vote_plan(adj)
    for _ in range(sweeps):
        ids, _ = vote_topk(labels, adj, n, width, plan)
        top = ids[:, 0]
        labels = torch.where(top < n, top, labels)
    return labels


# ---------------------------------------------------------------------
# The sparse pi and kernel 13: the overlap pass.

def sparse_pi(ids: torch.Tensor, cnt: torch.Tensor, alpha: float
              ) -> torch.Tensor:
    """E[pi] over each node's top-width support: counts + alpha normalized,
    empty slots 0 (svinet_tpu/svi/fastinit.py:96-101). alpha is taken in
    f32."""
    del ids
    a = float(np.float32(alpha))
    val = torch.where(cnt > 0, cnt + a, 0.0)
    return val / val.sum(1, keepdim=True).clamp_min(1e-30)


def overlap_block_plain(ids, pi, pairs):
    """The JAX block function (svinet_tpu/svi/fastinit.py:104-123): per
    pair, the sum of pi_p pi_q over shared ids (< n), the largest such
    product and p's id at the first largest in (p slot, q slot) order; a
    pair with no shared id gives 0, 0 and ids_p[0]."""
    n = ids.shape[0]
    p, q = pairs[:, 0].long(), pairs[:, 1].long()
    ip = ids[p][:, :, None]
    iq = ids[q][:, None, :]
    same = (ip == iq) & (ip < n)
    prod = torch.where(same, pi[p][:, :, None] * pi[q][:, None, :], 0.0)
    ssum = prod.sum((1, 2))
    flat = prod.reshape(prod.shape[0], -1)
    amax = flat.argmax(1, keepdim=True)     # the first of equal maxima
    w = ids.shape[1]
    return (ssum, flat.gather(1, amax)[:, 0],
            ids[p].gather(1, amax // w)[:, 0])


def overlap_block_size(w: int) -> int:
    """Pairs a block of the plain pass: its (B, w, w) intermediate near
    32M floats, as the JAX engine blocks it."""
    return max(64, min(2048, (1 << 25) // max(w * w, 1)))


def overlap_stats_plain(ids, pi, pairs, block: int = 0):
    """overlap_block_plain over blocks of `block` pairs (default
    overlap_block_size)."""
    if block == 0:
        block = overlap_block_size(int(ids.shape[1]))
    out = [overlap_block_plain(ids, pi, pairs[lo:lo + block])
           for lo in range(0, pairs.shape[0], block)]
    if not out:
        return (torch.zeros(0, dtype=pi.dtype, device=pi.device),
                torch.zeros(0, dtype=pi.dtype, device=pi.device),
                torch.zeros(0, dtype=ids.dtype, device=ids.device))
    return tuple(torch.cat(parts) for parts in zip(*out))


def overlap_stats(ids, pi, pairs):
    """Kernel 13 (csrc/fastinit_overlap.cu) on CUDA tensors, the plain
    version on CPU tensors. ids (n, w) int32, pi (n, w) f32, pairs (m, 2)
    int32. Returns (ssum (m,) f32, the largest product (m,) f32, its id
    (m,) int32). One group of lanes a pair for w <= 64, a block above, its
    table in device scratch above 4,096 (the scratch sized by the kernel's
    query, svt_fastinit_overlap_scratch); no atomics on floats, so two
    launches give the same bits."""
    if pi.device.type == "cpu":
        return overlap_stats_plain(ids, pi, pairs)
    build.require_cuda(pi, "overlap_stats")
    dev = pi.device
    n, w = ids.shape
    m = pairs.shape[0]
    if w < 1:
        raise ValueError(f"overlap_stats takes a width of 1 or more, "
                         f"got {w}")
    build.check_cuda(ids, "ids", torch.int32, (n, w), dev)
    build.check_cuda(pi, "pi", torch.float32, (n, w), dev)
    build.check_cuda(pairs, "pairs", torch.int32, (m, 2), dev)
    ssum = torch.empty(m, dtype=torch.float32, device=dev)
    mx = torch.empty(m, dtype=torch.float32, device=dev)
    mid = torch.empty(m, dtype=torch.int32, device=dev)
    scratch = build.scratch("svt_fastinit_overlap_scratch", w, dev,
                            torch.int32)
    build.launch("svt_fastinit_overlap", dev, ids.data_ptr(), pi.data_ptr(),
                 pairs.data_ptr(), ssum.data_ptr(), mx.data_ptr(),
                 mid.data_ptr(), m, n, w,
                 None if scratch is None else scratch.data_ptr())
    build.count_launch(overlap_stats,
                       "scratch" if scratch is not None
                       else ("block" if w > 64 else "group"))
    return ssum, mx, mid


overlap_stats.launches = 0
overlap_stats.forms = {}


def heldout_result(s: np.ndarray, y: np.ndarray) -> HeldoutResult:
    """The held-out rows of the sparse model from each pair's ssum, in the
    JAX engine's numpy (svinet_tpu/svi/fastinit.py:210-223)."""
    ll = np.log(np.maximum(np.where(y == 1, s, 1.0 - s), 1e-30))
    ones = y == 1
    return HeldoutResult(
        avg=float(ll.mean()), count=len(ll),
        avg0=float(ll[~ones].mean()) if (~ones).any() else 0.0,
        count0=int((~ones).sum()),
        avg1=float(ll[ones].mean()) if ones.any() else 0.0,
        count1=int(ones.sum()))


def link_groups(tl: np.ndarray, ssum: np.ndarray, max_val: np.ndarray,
                max_id: np.ndarray, n: int, link_thresh: float) -> dict:
    """{community: sorted nodes}: each training link whose normalized max
    reaches link_thresh puts both ends into the community of its argmax
    shared id (svinet_tpu/svi/fastinit.py:257-262), vectorised."""
    norm = np.where(ssum > 0, max_val / np.maximum(ssum, 1e-30), 0.0)
    sel = norm >= link_thresh
    c = max_id[sel].astype(np.int64)
    nodes = np.concatenate([tl[sel, 0], tl[sel, 1]]).astype(np.int64)
    keys = np.unique(np.concatenate([c, c]) * n + nodes)
    comm, node = keys // n, keys % n
    cut = np.flatnonzero(np.diff(comm)) + 1
    return {int(g[0]): [int(v) for v in nd]
            for g, nd in zip(np.split(comm, cut), np.split(node, cut))
            if len(g)}


class FastInit(EngineBase):
    """The -findk engine on the host; the sweeps and the overlap passes on
    the device."""

    dual_heldout_splits = True   # src/fastinit.cc (init_heldout)
    stop_min_iter = 0            # no guard (src/fastinit.cc:548-560)
    stop_decline_reports = 10    # nh > 10 (src/fastinit.cc:560)

    def __init__(self, cfg: Config, network: Network, device: torch.device):
        super().__init__(cfg, network, device)
        n = self.n
        # max-degree-many slots in the reference (src/main.cc:321-327),
        # capped at 64 unless -findk-width says otherwise
        self.width = (cfg.findk_width if cfg.findk_width > 0
                      else min(max(int(network.deg.max()), 2), 64))
        self.labels = torch.arange(n, dtype=torch.int32, device=device)
        self.adj = build_adjacency(network.training_links, n, device)
        self._plan = vote_plan(self.adj) if device.type == "cuda" else None
        self.stop_pairs = self.stop_pairs.to(torch.int32).contiguous()
        self.val_pairs = self.val_pairs.to(torch.int32).contiguous()
        self._links = self._device_pairs(
            network.training_links.astype(np.int32))
        self.ids = None
        self.cnt = None
        self._resume_if_requested()

    def _state_dict(self) -> dict:
        d = self._host_state()
        d["labels"] = self.labels
        if self.ids is not None:
            d.update(ids=self.ids, cnt=self.cnt)
        return d

    def _restore_state(self, state) -> None:
        self.labels = state["labels"].to(self.device, torch.int32)
        if "ids" in state:
            self.ids = state["ids"].to(self.device, torch.int32)
            self.cnt = state["cnt"].to(self.device, torch.float32)
        self._restore_host_state(state)

    def batch_infer(self) -> None:
        sweeps = int(math.log10(max(self.n, 10))) + 1
        for _ in range(self.iteration, sweeps):
            self.ids, self.cnt = vote_topk(self.labels, self.adj, self.n,
                                           self.width, self._plan)
            # the top label becomes the node's; an isolated node keeps its
            top = self.ids[:, 0]
            self.labels = torch.where(top < self.n, top, self.labels)
            self.iteration += 1
            self.report()
        self.do_on_stop()

    # ------------------------------------------------------------------
    def _pi(self) -> torch.Tensor:
        return sparse_pi(self.ids, self.cnt, self.cfg.alpha)

    def _sparse_res(self, pairs, y) -> HeldoutResult:
        """The held-out rows over a pair set from the top-width model."""
        ssum, _, _ = overlap_stats(self.ids, self._pi(), pairs)
        return heldout_result(ssum.cpu().numpy(), y.cpu().numpy())

    def report(self) -> bool:
        """The stopping split's rows, at new maxima the validation split's
        (max.txt column 6), then the communities
        (svinet_tpu/svi/fastinit.py:225-240)."""
        cfg = self.cfg
        res = self._sparse_res(self.stop_pairs, self.stop_y)
        nshol = self._hf.write(self.iteration, self.duration(), res,
                               cfg.zeros_prob, cfg.ones_prob)
        if not self._dual:
            self._vf.write(self.iteration, self.duration(), res,
                           cfg.zeros_prob, cfg.ones_prob)
        stop = self._stop_and_write_max(nshol, self._sparse_res)
        self.log_communities()
        self._end_of_report()
        return stop and cfg.use_validation_stop

    def log_communities(self) -> None:
        """communities.txt (its line count the estimated K),
        communities_size.txt and, under -nmi, a mutual.txt row
        (svinet_tpu/svi/fastinit.py:242-274)."""
        cfg = self.cfg
        if self.ids is None:
            return
        ssum, mv, mi = (t.cpu().numpy() for t in overlap_stats(
            self.ids, self._pi(), self._links))
        self._communities = link_groups(self.network.training_links, ssum,
                                        mv, mi, self.n, cfg.link_thresh)
        write_communities(cfg.file_str("communities.txt"),
                          self._communities, self.network.seq2id)
        with open(cfg.file_str("communities_size.txt"), "w") as f:
            for c in sorted(self._communities):
                f.write(f"{c}\t{len(self._communities[c])}\n")
        if self._mutual is not None:
            from svinet_torch.evals.nmi import overlapping_nmi, read_cover_file
            ours = read_cover_file(cfg.file_str("communities.txt"))
            self._mutual.write(
                f"mutual3:\t{overlapping_nmi(self._gt(), ours):g}\n")
            self._mutual.flush()

    def do_on_stop(self, next_iteration=None) -> None:
        self.log_communities()
        # groups.txt: node, its external id, its label (no dense gamma)
        lab = self.labels.cpu().numpy()
        seq2id = self.network.seq2id
        with open(self.cfg.file_str("groups.txt"), "w") as f:
            f.writelines(f"{i}\t{int(seq2id[i])}\t{int(lab[i])}\n"
                         for i in range(self.n))
        if self.cfg.checkpoint_freq:
            self.save_checkpoint(next_iteration)
