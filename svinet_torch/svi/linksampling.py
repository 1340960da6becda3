"""LinkSampling engine, on one device or as a rank of a mesh (-mesh N,
-mesh-rowshard, -mesh-locality: parallel/mesh.py), with -fuse-s3,
-report-batch, -bf16, -freeze, -prune, -sparse-w, -init-communities,
-load-test-sets and -profile (svinet_tpu/svi/linksampling.py).

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

import contextlib
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from svinet_torch.config import Config
from svinet_torch.graph import Network
from svinet_torch.io.writers import ReportFile, load_model, write_edgelist
from svinet_torch.evals.likelihood import (
    heldout_stats, heldout_sums_blocked, link_probs, result_from_sums)
from svinet_torch.evals.precision import auc as auc_fn
from svinet_torch.ops.edges import (
    Adjacency, build_adjacency, choose_edge_block, owner_csr, pad_edges)
from svinet_torch.ops import threefry
from svinet_torch.ops.expectations import dirichlet_expectation
from svinet_torch.parallel import mesh
from svinet_torch.parallel.locality import locality_edge_layout
from svinet_torch.parallel.mesh import (
    LOCAL, LocalComm, LocalityComm, MeshComm)
from svinet_torch.svi.base import EngineBase
from svinet_torch.svi.sweep_math import (
    LSConsts, edge_blocks, finish_lambda, fused_phi_s3_pass,
    mean_indicator_update, phi_pass, s3_pass, sparse_union_sweep)

# the logit bias that keeps a padded column of a compacted sweep out of
# the phi softmax (svinet_tpu/svi/sweep_math.py:317)
PAD_LOGIT = -1e30

# E*K above which the init phis are drawn on the device, blocked: the host
# (E,K) float64 phi matrix of the n=1M, K=500 shape would need 80 GB
DEVICE_INIT_MIN = 1 << 28


@dataclasses.dataclass(frozen=True)
class SweepExtras:
    """What a sweep takes beside (gamma, lam, mphi) under -bf16, -freeze and
    -prune. Read-only: a function that is given one returns, last in its
    tuple, the one for the sweep after (`conv` and `mphi_bf16` replaced),
    as the JAX package's loops return conv when they are given it; without
    one it returns what it always did.

    bf16: gather Elogpi and mphi as bfloat16 rows; logits, softmax and
      every sum stay f32 (svinet_tpu/svi/linksampling.py:67-81, 141-145).
      The caller sets it only once annealing is over.
    conv: the sticky converged flags (n,) int32 of -freeze, None without
      it. A sweep uses the flags it is given for both passes over the links
      and returns converged_of(gnext, alpha, conv): the flags are taken
      from gnext after the annealing scale
      (svinet_tpu/svi/linksampling.py:121-128).
    mphi_bf16: under -fuse-s3 with bf16, the mean indicators of the sweep
      before as bf16 rows, written by that sweep's kernel 3 beside the
      carried f32 ones. None when the last sweep did not run bf16: the next
      bf16 sweep then casts the f32 mphi once.
    colmask, rest: a sweep over column-compacted state (-prune,
      svinet_tpu/svi/sweep_math.py:302-340). colmask (K_pad,) f32 is 1 for
      a real column and 0 for padding, rest the Dirichlet mass of the
      columns left out. Such a sweep never anneals and runs f32 whatever
      `bf16` says, as the JAX engine's does."""
    bf16: bool = False
    conv: Optional[torch.Tensor] = None
    mphi_bf16: Optional[torch.Tensor] = None
    colmask: Optional[torch.Tensor] = None
    rest: float = 0.0


def _expectations(gamma, lam, annealing: bool, x: SweepExtras,
                  c: LocalComm = LOCAL):
    """Elogpi (bf16 rows where the sweep runs them, written where `c`
    wants them) and Elogbeta0 of the sweep `x` describes. Returns
    (elogpi, elb0, annealing, bf16 rows?)."""
    compact = x.colmask is not None
    bf16 = x.bf16 and not compact
    dtype = torch.bfloat16 if bf16 else torch.float32
    elogpi = dirichlet_expectation(
        gamma, rest=x.rest if compact else 0.0, out_dtype=dtype,
        out=c.rows_out("elogpi", *gamma.shape, dtype, gamma.device))
    elb0 = dirichlet_expectation(lam)[:, 0].contiguous()
    if compact:
        elb0 = torch.where(x.colmask > 0, elb0, PAD_LOGIT)
        annealing = False
    return elogpi, elb0, annealing, bf16


def _sweep(gamma, lam, adj: Adjacency, deg, consts: LSConsts,
           annealing: bool, x: SweepExtras, c: LocalComm = LOCAL):
    """sweep's body: (gamma, lam, the extras of the sweep after). `c` puts
    in the collectives of a mesh (parallel/mesh.py), at the points where
    the JAX package's sharded sweeps have them
    (svinet_tpu/parallel/mesh.py:110-128, 824-847)."""
    elogpi, elb0, annealing, bf16 = _expectations(gamma, lam, annealing, x)
    gacc, sumk = phi_pass(c.rows(elogpi), elb0, adj, x.conv)
    del elogpi
    gacc, sumk = c.stat(gacc), c.total(sumk)
    # with bf16 rows mphi serves the s3 pass only, so only its bf16 form is
    # made
    out = mean_indicator_update(gacc, sumk, deg, consts, annealing,
                                mphi_f32=not bf16, mphi_bf16=bf16,
                                conv=x.conv)
    s3 = c.total(s3_pass(c.rows(out.mphi_bf16 if bf16 else out.mphi), adj,
                         x.conv))
    lam = finish_lambda(c.row_total(out.s1), c.row_total(out.s2), s3,
                        out.lam0, consts)
    return out.gnext, lam, dataclasses.replace(x, conv=out.conv)


def sweep(gamma, lam, adj: Adjacency, deg, consts: LSConsts,
          annealing: bool, extras: Optional[SweepExtras] = None):
    """One full sweep over the training links, whose adjacency `adj` the
    phi pass and the s3 pass walk. Returns the new (gamma, lam), and after
    them the next sweep's extras when `extras` is given (see SweepExtras);
    the inputs are not modified."""
    out = _sweep(gamma, lam, adj, deg, consts, annealing,
                 extras or SweepExtras())
    return out if extras is not None else out[:2]


def _fused_sweep(gamma, lam, mphi, adj: Adjacency, deg, consts: LSConsts,
                 annealing: bool, x: SweepExtras, c: LocalComm = LOCAL):
    """fused_sweep's body: (gamma, lam, mphi, the extras of the sweep
    after); `c` as in _sweep (svinet_tpu/parallel/mesh.py:180-196,
    250-271: the row-sharded layout gathers Elogpi and mphi, each after
    the -bf16 cast)."""
    if x.conv is not None:
        raise ValueError("the -fuse-s3 sweep has no converged-freezing "
                         "form; run -freeze unfused")
    elogpi, elb0, annealing, bf16 = _expectations(gamma, lam, annealing, x,
                                                  c)
    prev = mphi
    if bf16:
        prev = (x.mphi_bf16 if x.mphi_bf16 is not None
                else mphi.to(torch.bfloat16))
    gacc, sumk, s3 = fused_phi_s3_pass(c.rows(elogpi), c.rows(prev), elb0,
                                       adj)
    del elogpi, prev
    gacc, sumk, s3 = c.stat(gacc), c.total(sumk), c.total(s3)
    out = mean_indicator_update(gacc, sumk, deg, consts, annealing,
                                mphi_out=mphi, mphi_bf16=bf16)
    lam = finish_lambda(c.row_total(out.s1), c.row_total(out.s2), s3,
                        out.lam0, consts)
    return (out.gnext, lam, out.mphi,
            dataclasses.replace(x, mphi_bf16=out.mphi_bf16))


def fused_sweep(gamma, lam, mphi, adj: Adjacency, deg, consts: LSConsts,
                annealing: bool, extras: Optional[SweepExtras] = None):
    """The -fuse-s3 sweep (svinet_tpu/svi/linksampling.py:132-150): one
    pass over the links gives the phi sums and the s3 cross-moment of
    `mphi`, the mean indicators of the sweep BEFORE, so s3 lags one sweep
    while s1 and s2 are current; with mphi = 0 (the first sweep) s3 is 0.
    Returns (gamma, lam, mphi of this sweep), and after them the next
    sweep's extras when `extras` is given (see SweepExtras). gamma and lam
    are not modified; `mphi` is overwritten with the new mean indicators
    and returned, on the CPU as on the card, so a caller that still needs
    the old ones passes a clone. The fused sweep has no -freeze form."""
    out = _fused_sweep(gamma, lam, mphi, adj, deg, consts, annealing,
                       extras or SweepExtras())
    return out if extras is not None else out[:3]


def multi_sweep(gamma, lam, mphi, adj: Adjacency, deg, consts: LSConsts,
                annealing: bool, n_sweeps: int, fused: bool,
                extras: Optional[SweepExtras] = None,
                comm: LocalComm = LOCAL):
    """n_sweeps sweeps back to back; `fused` takes the -fuse-s3 body,
    which carries mphi, otherwise mphi passes through untouched. Under a
    mesh `comm` is the rank's MeshComm, adj the CSR of its shard of the
    links and gamma, mphi and deg its rows. Returns (gamma, lam, mphi, the
    extras of the sweep after the last)."""
    x = extras or SweepExtras()
    for _ in range(n_sweeps):
        if fused:
            gamma, lam, mphi, x = _fused_sweep(gamma, lam, mphi, adj, deg,
                                               consts, annealing, x, comm)
        else:
            gamma, lam, x = _sweep(gamma, lam, adj, deg, consts, annealing,
                                   x, comm)
    return gamma, lam, mphi, x


def sweep_ho_trace(gamma, lam, mphi, adj: Adjacency, deg, consts: LSConsts,
                   annealing: bool, ho_pairs, ho_y, ho_w, epsilon: float,
                   r: int, n_batches: int, ho_blocks: int, fused: bool,
                   extras: Optional[SweepExtras] = None,
                   comm: LocalComm = LOCAL):
    """n_batches report boundaries, r sweeps apart, with the six
    validation heldout sums of the state at EVERY boundary
    (svinet_tpu/svi/linksampling.py:194-234); `fused` and `comm` as in
    multi_sweep (under a mesh this is make_mesh_trace_sweep,
    svinet_tpu/parallel/mesh.py:293-455, the program every mesh report
    interval runs). Nothing in here reads a value back to the host.
    Returns (gamma, lam, mphi, trace (n_batches, 6)), and after them the
    next sweep's extras when `extras` is given."""
    x = extras
    trace = []
    for _ in range(n_batches):
        gamma, lam, mphi, x = multi_sweep(gamma, lam, mphi, adj, deg, consts,
                                          annealing, r, fused, x, comm)
        trace.append(comm.heldout(gamma, lam, ho_pairs, ho_y, ho_w, epsilon,
                                  ho_blocks))
    out = (gamma, lam, mphi, torch.stack(trace))
    return out if extras is None else (*out, x)


def multi_sweep_ho(gamma, lam, adj: Adjacency, deg, consts: LSConsts,
                   annealing: bool, ho_pairs, ho_y, ho_w, epsilon: float,
                   n_sweeps: int, ho_blocks: int,
                   extras: Optional[SweepExtras] = None):
    """n_sweeps sweeps, then the six validation heldout sums on the final
    state (svinet_tpu/svi/linksampling.py:240-260). Returns
    (gamma, lam, sums), and after them the next sweep's extras when
    `extras` is given."""
    gamma, lam, _, trace, *x = sweep_ho_trace(
        gamma, lam, None, adj, deg, consts, annealing, ho_pairs, ho_y, ho_w,
        epsilon, n_sweeps, 1, ho_blocks, False, extras)
    return (gamma, lam, trace[0], *x)


def fused_multi_sweep_ho(gamma, lam, mphi, adj: Adjacency, deg,
                         consts: LSConsts, annealing: bool, ho_pairs, ho_y,
                         ho_w, epsilon: float, n_sweeps: int, ho_blocks: int,
                         extras: Optional[SweepExtras] = None):
    """n_sweeps -fuse-s3 sweeps with the heldout-sums tail
    (svinet_tpu/svi/linksampling.py:170-188). Returns
    (gamma, lam, mphi, sums), and after them the next sweep's extras when
    `extras` is given."""
    gamma, lam, mphi, trace, *x = sweep_ho_trace(
        gamma, lam, mphi, adj, deg, consts, annealing, ho_pairs, ho_y, ho_w,
        epsilon, n_sweeps, 1, ho_blocks, True, extras)
    return (gamma, lam, mphi, trace[0], *x)


def sparse_multi_sweep(gamma, lam, rows, adj: Adjacency, deg,
                       consts: LSConsts, annealing: bool, w: int,
                       n_sweeps: int, ho=None, donate_gamma: bool = False):
    """n_sweeps -sparse-w sweeps (sweep_math.sparse_union_sweep), then,
    when `ho` = (pairs, y, weights, epsilon, blocks) is given, the six
    validation heldout sums on the final state
    (svinet_tpu/svi/linksampling.py:263-285). `rows`, (n, K, 2) f32,
    carries the mean indicators from sweep to sweep in its odd half and is
    overwritten; `donate_gamma` hands gamma's storage to the first sweep
    (sparse_union_sweep). Returns (gamma, lam, rows), and the sums after
    them with `ho`."""
    for i in range(n_sweeps):
        gamma, lam, rows = sparse_union_sweep(
            gamma, lam, rows, adj, deg, consts, annealing, w,
            donate_gamma=donate_gamma or i > 0)
    if ho is None:
        return gamma, lam, rows
    return gamma, lam, rows, heldout_sums_blocked(gamma, lam, *ho)


# ---------------------------------------------------------------------
# Active-K column compaction (-prune, svinet_tpu/svi/linksampling.py:
# 295-334). Columns where no node has gamma - alpha >= 1 sit at
# (alpha, eta), where a pruned sweep leaves them, so the active columns are
# gathered into a narrow (n, K_pad) layout once per report interval, the
# same kernels sweep at that width, and the expansion at the next report
# is lossless. Plain PyTorch: it runs once per report, not per sweep.

def _active_cols(gamma, alpha: float) -> torch.Tensor:
    """(K,) bool: column k is active when any node has gamma - alpha >= 1."""
    return (gamma - alpha >= 1.0).any(dim=0)


def compact_columns(gamma, lam, idx, colmask, alpha: float, eta):
    """Gather the active columns (idx (K_pad,), padded with the
    out-of-range K) into (n, K_pad) and (K_pad, 2); padded slots get
    (alpha, eta). eta is (eta0, eta1)."""
    take = idx.clamp(max=gamma.shape[1] - 1).long()
    gc = torch.where(colmask[None, :] > 0, gamma[:, take], alpha)
    lc = torch.where(colmask[:, None] > 0, lam[take],
                     lam.new_tensor(eta)[None, :])
    return gc.contiguous(), lc.contiguous()


def expand_columns(gamma_c, lam_c, idx, alpha: float, eta, k: int):
    """Scatter compacted columns back to full width K; every other column
    is (alpha, eta), the pruned sweep's fixed point for it. Entries of idx
    that are K (padding) are dropped."""
    real = idx < k
    cols = idx[real].long()
    gamma = gamma_c.new_full((gamma_c.shape[0], k), alpha)
    lam = lam_c.new_tensor(eta).repeat(k, 1)
    gamma[:, cols] = gamma_c[:, real]
    lam[cols] = lam_c[real]
    return gamma, lam


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


def init_gamma_from_communities(members, deg: np.ndarray, n: int, k: int,
                                alpha: float) -> np.ndarray:
    """-init-communities: gamma_p = alpha + deg_p * phi_p, where phi_p is
    the normalised membership vector (alpha everywhere, plus n / (number
    of p's memberships) at each of p's initial communities; reference:
    LinkSampling::init_gamma_external, src/linksampling.cc:403-453).
    Community ids >= k are ignored. A numpy copy of
    svinet_tpu/svi/linksampling.py:372-385."""
    phi = np.full((n, k), alpha)
    for p, comms in enumerate(members):
        cs = [c for c in comms if c < k]
        if cs:
            phi[p, cs] += float(n) / len(comms)
    phi /= phi.sum(axis=1, keepdims=True)
    return alpha + deg[:, None] * phi


def init_gamma_from_links_device(seed: int, edges, mask, n: int, k: int,
                                 alpha: float, num_blocks: int):
    """init_gamma_from_links drawn on the device block by block, for edge
    sets whose host (E,K) phi matrix would not fit
    (svinet_tpu/svi/linksampling.py:387-411): block b's phi is
    uniform(split(PRNGKey(seed), num_blocks)[b], (block, K)), JAX's
    threefry stream (kernel 17 on the card, ops/threefry.py), normalised
    by its row sum, masked, and added into both ends' rows. So the init is
    the JAX package's up to the order of the f32 adds."""
    keys = threefry.split_keys(threefry.prng_key(seed), num_blocks)
    gamma = torch.zeros((n, k), dtype=torch.float32, device=edges.device)
    phi = torch.empty((edges.shape[0] // max(num_blocks, 1), k),
                      dtype=torch.float32, device=edges.device)
    for (blk, msk), key in zip(edge_blocks(edges, mask, num_blocks), keys):
        threefry.uniform_rows(key, phi)
        p = phi / phi.sum(dim=1, keepdim=True) * msk[:, None]
        gamma.index_add_(0, blk[:, 0], p)
        gamma.index_add_(0, blk[:, 1], p)
    empty = gamma.sum(dim=1, keepdim=True) == 0
    return torch.where(empty, alpha, gamma)


class LinkSampling(EngineBase):
    """Host side of the engine: owns the annealing phase and the device
    state; file output, stopping, and community logging live in
    EngineBase."""

    writes_own_timefile = True   # per-step rows in _infer_loop
    # guard iter > 10, plateau why 100 (src/linksampling.cc:1008-1013)
    stop_min_iter = 10
    stop_plateau_why = 100
    # the annealing decision runs after EngineBase.report(); report() calls
    # _end_of_report last, so a checkpoint never sees a half-made report
    defer_report_hooks = True
    # at a report boundary self.iteration is the sweep just done, so a
    # boundary checkpoint stores the next one
    ckpt_boundary_offset = 1

    def __init__(self, cfg: Config, network: Network, device: torch.device,
                 group: "mesh.Group | None" = None):
        super().__init__(cfg, network, device, group)
        n, k = self.n, self.k
        block = choose_edge_block(len(network.training_links), k)
        edges_p, mask = pad_edges(network.training_links, block)
        self.edges = torch.as_tensor(edges_p, device=device)
        self.mask = torch.as_tensor(mask, device=device)
        # under a mesh (-mesh N, -mesh-rowshard: parallel/mesh.py) this
        # rank's shard of the links, in the JAX package's order
        # (shard_edges), and under -mesh-rowshard n padded to whole rows a
        # rank (svinet_tpu/svi/linksampling.py:558-595)
        links = network.training_links
        self._rowshard = self._group is not None and bool(cfg.mesh_rowshard)
        # -mesh-locality: the fused row-sharded sweep over the locality
        # layout (svinet_tpu/svi/linksampling.py:571-584)
        self._locality = (self._rowshard and bool(cfg.mesh_locality)
                          and bool(cfg.fuse_s3))
        self._n_pad = n
        rows = n
        exports = None
        if self._group is not None:
            nd, rank = self._group.size, self._group.rank
            if self._rowshard:
                self._n_pad = rows = -(-n // nd) * nd
            if self._locality:
                links, exports, rows = self._locality_shard(links, block)
            else:
                links = links[np.array_split(np.arange(len(links)),
                                             nd)[rank]]
        # the links as a symmetric CSR, built once: what the phi and s3
        # passes walk (padding rows are absent from it); the padded list
        # serves the community extraction
        self.adj = build_adjacency(links, rows, device)
        self.deg = torch.as_tensor(network.training_deg.astype(np.float32),
                                   device=device)

        if cfg.model_load and cfg.gamma_location:
            g0, l0 = load_model(cfg.gamma_location, n, k, cfg.t)
        elif cfg.use_init_communities and cfg.init_communities_fname:
            network.load_init_communities(cfg.init_communities_fname)
            with open(cfg.file_str("init_memberships.txt"), "w") as f:
                for p, comms in enumerate(network.init_communities_seq):
                    row = "\t".join(str(c) for c in comms)
                    f.write(f"{int(network.seq2id[p])}\t{row}\n")
            # the degree over all links, held-out ones included
            deg_all = (network.row_ptr[1:] - network.row_ptr[:-1]).astype(
                np.float64)
            g0 = init_gamma_from_communities(
                network.init_communities_seq, deg_all, n, k, cfg.alpha)
            l0 = np.tile([cfg.eta0, cfg.eta1], (k, 1))
        elif len(network.edges) * k > DEVICE_INIT_MIN:
            ie, im = pad_edges(network.edges, block)
            g0 = init_gamma_from_links_device(
                cfg.seed, torch.as_tensor(ie, device=device),
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
        # -prune: the compaction of the current report interval, or None
        self._compact = None
        # -freeze: sticky per-node converged flags, carried through every
        # sweep (reference: _converged assigned by prune() and never
        # cleared, src/linksampling.cc:472-473); 0 = free, else column + 1
        self._conv = (torch.zeros(n, dtype=torch.int32, device=device)
                      if cfg.freeze_converged else None)
        # -sparse-w W: the top-W union sweep once annealing is over
        # (svinet_tpu/svi/linksampling.py:502-518). It carries its own mean
        # indicators for the lagged s3, zeros before its first sweep, so
        # that sweep's s3 is 0: the odd half of its (n, K, 2) rows, whose
        # even half each sweep fills with Elogpi (sweep_math.union_rows).
        # They are not self.mphi, whose presence makes a dense sweep fused
        self._sparse_rows = None
        if cfg.sparse_w:
            if self._group is not None:
                raise SystemExit("-sparse-w is single-device; drop -mesh")
            if cfg.freeze_converged:
                raise SystemExit("-sparse-w does not support -freeze")
            if cfg.sparse_w >= k:
                print(f"+ -sparse-w {cfg.sparse_w} >= k={k}; running dense")
                cfg.sparse_w = 0
            else:
                cfg.prune = False
                cfg.fuse_s3 = False
                cfg.plog("sparse union width", cfg.sparse_w)
        if cfg.fuse_s3 and cfg.freeze_converged:
            print("+ -fuse-s3 has no converged-freezing fast path; "
                  "running unfused to honor -freeze")
            cfg.fuse_s3 = False
        if cfg.freeze_converged and self._group is not None:
            raise SystemExit("-freeze is not supported under -mesh / "
                             "-mesh-rowshard; drop one of the flags")
        # -fuse-s3 carries the mean indicators across sweeps; zeros before
        # the first sweep (and after -load), so its s3 is 0. Under -bf16
        # their bf16 rows ride beside them once annealing is over
        self.mphi = None
        self._mphi_bf16 = None
        if cfg.fuse_s3:
            cfg.plog("fuse s3", True)
            self.mphi = torch.zeros((n, k), dtype=torch.float32,
                                    device=device)
        if cfg.bf16_rows:
            cfg.plog("bf16 rows", True)
        if self._group is not None:
            if self._n_pad != n:
                cfg.plog("rowshard padded rows", self._n_pad - n)
            cfg.plog("mesh devices", self._group.size)
            cfg.plog("mesh rowshard", self._rowshard)

        # -load-test-sets: fixed uniform/biased heldout pair files from the
        # cwd, each with its own per-report likelihood trace (reference:
        # LinkSampling::load_test_sets, src/linksampling.cc:1075-1145)
        self._test_sets = []
        if cfg.load_test_sets:
            present = [name for name in ("uniform", "biased")
                       if os.path.exists(f"{name}-heldout-pairs.txt")]
            if not present:
                raise SystemExit(
                    "+ -load-test-sets: neither uniform-heldout-pairs.txt "
                    "nor biased-heldout-pairs.txt found in the cwd")
            for name in present:
                pairs, ys = network.load_pairs_file(
                    f"{name}-heldout-pairs.txt")
                write_edgelist(cfg.file_str(f"{name}-test-pairs.txt"),
                               pairs, ys, network.seq2id)
                cfg.plog(f"loaded {name} test pairs:", len(pairs))
                self._test_sets.append(
                    (name, self._device_pairs(pairs),
                     self._device_pairs(ys.astype(np.int32)),
                     ReportFile(cfg.file_str(f"{name}-hol.txt"),
                                append=bool(cfg.resume))))

        # the validation pairs, padded once to whole blocks, ride the tail
        # of every step; _ho_res holds the sums of the last step. Under
        # -mesh-rowshard each rank holds its share of the pairs over the
        # compact table of heldout-touched rows (rowshard_heldout_layout)
        self._ho = None
        self._ho_res = None
        self._comm = LOCAL
        if self._locality:
            self._comm = LocalityComm(self._group, None,
                                      self._device_pairs(exports[0]),
                                      exports[1])
        m = len(network.validation_pairs)
        if m and self._rowshard:
            g = self._group
            hidx, pp, yy, ww, nb = mesh.rowshard_heldout_layout(
                network.validation_pairs,
                network.validation_y.astype(np.int32), self._n_pad, g.size)
            h, t = len(hidx) // g.size, len(pp) // g.size
            mine = slice(g.rank * t, (g.rank + 1) * t)
            hidx = self._device_pairs(
                hidx[g.rank * h:(g.rank + 1) * h].astype(np.int64))
            if self._locality:
                self._comm.hidx = hidx
            else:
                self._comm = MeshComm(g, True, hidx)
            self._ho = (self._device_pairs(pp[mine]),
                        self._device_pairs(yy[mine]),
                        self._device_pairs(ww[mine]), nb)
        elif m:
            blk = min(1 << 17, max(64, 1 << int(np.ceil(np.log2(m)))))
            pp, ww = pad_edges(network.validation_pairs, blk)
            yy = np.zeros(len(pp), np.int32)
            yy[:m] = network.validation_y
            self._ho = (self._device_pairs(pp), self._device_pairs(yy),
                        self._device_pairs(ww), len(pp) // blk)
        if self._group is not None and self._comm is LOCAL:
            self._comm = MeshComm(self._group, self._rowshard)
        # under -mesh-rowshard the (n, K) gamma and mphi of a report, a
        # stop or a checkpoint while _full_rows holds them; else None
        self._local_rows = None
        self._resume_if_requested()
        if self._group is not None:
            self._distribute_state()

    def _locality_shard(self, links, block: int):
        """-mesh-locality: this rank's links remapped into its [owned rows
        | boundary table] space, the owned rows it exports into its slots
        of the table with the number of them that are real, and the rows of
        that space (parallel/locality.py, on the padded n as in
        svinet_tpu/svi/linksampling.py:576-584). Only the real entries of
        the layout are kept: its padding is (0, 0) pairs, which would be
        self-links of owned row 0."""
        g = self._group
        es, ms, exp_idx, info = locality_edge_layout(links, self._n_pad,
                                                     g.size, block)
        self.cfg.plog("locality internal frac",
                      round(info["internal_frac"], 4))
        self.cfg.plog("locality boundary rows", info["boundary_rows"])
        per, xmax, rows_per = info["per_shard"], info["xmax"], info["rows_per"]
        # a rank's real exports fill the first slots of its part of the
        # table, and every real slot is a link's remote end
        real = es[ms > 0]
        used = np.zeros(g.size * xmax, bool)
        used[real[real >= rows_per] - rows_per] = True
        slots = slice(g.rank * xmax, (g.rank + 1) * xmax)
        exports = (exp_idx[slots].astype(np.int64), int(used[slots].sum()))
        chunk = slice(g.rank * per, (g.rank + 1) * per)
        return (es[chunk][ms[chunk] > 0], exports,
                rows_per + g.size * xmax)

    def _distribute_state(self) -> None:
        """Under a mesh: rank 0's state on every rank (at start and after
        -resume), then under -mesh-rowshard each rank's rows, n padded with
        rows at (alpha, deg 0) that no link or heldout pair touches
        (svinet_tpu/svi/linksampling.py:558-595)."""
        n, k, n_pad = self.n, self.k, self._n_pad

        def padded(t, fill):
            if t is None or n_pad == n:
                return t
            return torch.cat([t, t.new_full((n_pad - n, *t.shape[1:]),
                                            fill)])

        self.gamma = mesh.broadcast(padded(self.gamma, self.cfg.alpha)
                                    .contiguous())
        self.lam = mesh.broadcast(self.lam.contiguous())
        if self.mphi is not None:
            self.mphi = mesh.broadcast(padded(self.mphi, 0.0).contiguous())
            self._mphi_bf16 = None
        self.deg = padded(self.deg, 0.0)
        if self._rowshard:
            g = self._group
            rows = slice(g.rank * n_pad // g.size,
                         (g.rank + 1) * n_pad // g.size)
            self.gamma = self.gamma[rows].clone()
            self.deg = self.deg[rows].clone()
            if self.mphi is not None:
                # under -mesh-locality the carried mphi lies in front of
                # the boundary table its sweeps gather
                mine = self.mphi[rows]
                self.mphi = (self._comm.rows_out(
                    "mphi", *mine.shape, mine.dtype, mine.device).copy_(mine)
                    if self._locality else mine.clone())

    @contextlib.contextmanager
    def _full_rows(self):
        """Under -mesh-rowshard, the whole (n, K) gamma and mphi, gathered
        from the ranks (a collective: every rank enters it at the same
        point), for what a report, a stop or a checkpoint reads of the
        state; the rank's rows come back after. Else nothing happens."""
        if not self._rowshard or self._local_rows is not None:
            yield
            return
        self._local_rows = (self.gamma, self.mphi)
        self.gamma = mesh.all_gather(self.gamma, self._group)[:self.n]
        if self.mphi is not None:
            self.mphi = mesh.all_gather(self.mphi, self._group)[:self.n]
        try:
            yield
        finally:
            self.gamma, self.mphi = self._local_rows
            self._local_rows = None

    def _resume_if_requested(self) -> None:
        """-resume: restore the newest checkpoint; under -prune compact at
        once, as the uninterrupted run did after the report whose
        checkpoint this is (the checkpoint holds the full layout)."""
        super()._resume_if_requested()
        if self.iteration > 0:
            self._maybe_compact()

    def _state_dict(self) -> dict:
        """EngineBase's state, the annealing phase and its exit history,
        the carried mean indicators of -fuse-s3 and -sparse-w (an (n,K)
        mphi, as the JAX engine stores) and -freeze's flags
        (svinet_tpu/svi/linksampling.py:736-752)."""
        d = super()._state_dict()
        d["annealing"] = bool(self.annealing)
        d["anneal_hist"] = [float(x) for x in
                            getattr(self, "_anneal_hist", [])]
        d["anneal_decl"] = [float(getattr(self, "_anneal_decl", 0)),
                            float(getattr(self, "_anneal_prev_h", 0.0))]
        if self.cfg.fuse_s3 or self.cfg.sparse_w:
            if self.mphi is not None:
                d["mphi"] = self.mphi
            elif self._sparse_rows is not None:
                d["mphi"] = self._sparse_rows[..., 1]
            else:
                d["mphi"] = torch.zeros((self.n, self.k),
                                        dtype=torch.float32)
        if self._conv is not None:
            d["conv"] = self._conv
        return d

    def _restore_state(self, state) -> None:
        super()._restore_state(state)
        self.annealing = bool(state.get("annealing", False))
        self._anneal_hist = [float(x) for x in state.get("anneal_hist", [])]
        ad = state.get("anneal_decl")
        if ad is not None:
            self._anneal_decl = int(float(ad[0]))
            self._anneal_prev_h = float(ad[1])
        m = state.get("mphi")
        if m is not None and self.cfg.fuse_s3:
            self.mphi = m.to(self.device, torch.float32).contiguous()
            self._mphi_bf16 = None
        elif m is not None and self.cfg.sparse_w and not self.annealing:
            # the (n, K, 2) rows carry mphi in their odd half
            self._sparse_rows = torch.zeros((self.n, self.k, 2),
                                            dtype=torch.float32,
                                            device=self.device)
            self._sparse_rows[..., 1] = m.to(self.device)
        cv = state.get("conv")
        if cv is not None and self.cfg.freeze_converged:
            self._conv = cv.to(self.device, torch.int32)

    def _community_edges(self):
        """The engine's padded training links, with kernel 9's CSR."""
        if not hasattr(self, "_ce_cache"):
            self._ce_cache = (self.edges, self.mask,
                              owner_csr(self.edges[:, 0], self.n))
        return self._ce_cache

    # ------------------------------------------------------------------
    def step(self, n_sweeps: int = 1) -> None:
        """n_sweeps sweeps over all training links; the validation heldout
        sums are computed on the final state as the step's tail, unless
        the state is column-compacted (the report expands it first and
        evaluates then)."""
        self._ho_res = None
        if self.cfg.sparse_w and not self.annealing:
            self._sparse_step(n_sweeps)
            return
        if self._locality and self._ho is None:
            raise RuntimeError(
                "-mesh-locality requires a validation split (the "
                "trace program carries the heldout tail)")
        if self._ho is None or self._compact is not None:
            self.gamma, self.lam, self.mphi, x = multi_sweep(
                self.gamma, self.lam, self.mphi, self.adj, self.deg,
                self.consts, self.annealing, n_sweeps, self.mphi is not None,
                self._sweep_extras(), self._comm)
            self._conv, self._mphi_bf16 = x.conv, x.mphi_bf16
            return
        self._ho_res = self._run_trace(n_sweeps, 1)[0]

    def _sparse_step(self, n_sweeps: int) -> None:
        """-sparse-w's sweeps, with the heldout tail when there is a
        validation split (svinet_tpu/svi/linksampling.py:816-838). -bf16
        does nothing here, as in the JAX engine, which returns before its
        bf16 gate."""
        if self._sparse_rows is None:
            self._sparse_rows = torch.zeros((self.n, self.k, 2),
                                            dtype=torch.float32,
                                            device=self.device)
        ho = None
        if self._ho is not None:
            hp, hy, hw, nb = self._ho
            ho = (hp, hy, hw, self.cfg.epsilon, nb)
        # gamma's storage becomes the first sweep's phi sums and then the
        # new gamma: one (n, K) array less at the step's peak
        out = sparse_multi_sweep(
            self.gamma, self.lam, self._sparse_rows, self.adj, self.deg,
            self.consts, self.annealing, int(self.cfg.sparse_w), n_sweeps, ho,
            donate_gamma=True)
        self.gamma, self.lam, self._sparse_rows = out[:3]
        if ho is not None:
            self._ho_res = out[3]

    def _sweep_extras(self) -> SweepExtras:
        """The engine's -bf16, -freeze and -prune state for the sweeps of
        one step or one batch. -bf16 engages only after annealing: the
        anneal-exit plateau detector needs the f32-resolution nshol trace
        (svinet_tpu/svi/linksampling.py:839-844); the gate is read here,
        once per step and once per batch."""
        c = self._compact
        return SweepExtras(
            bf16=bool(self.cfg.bf16_rows) and not self.annealing,
            conv=self._conv, mphi_bf16=self._mphi_bf16,
            colmask=None if c is None else c["colmask"],
            rest=0.0 if c is None else c["rest"])

    def _run_trace(self, r: int, n_batches: int) -> torch.Tensor:
        """Advance the state by n_batches intervals of r sweeps; returns
        the (n_batches, 6) heldout sums, still on the device. Under a mesh
        every rank holds rank 0's sums, from which the stop and the
        annealing exit are decided."""
        hp, hy, hw, nb = self._ho
        self.gamma, self.lam, self.mphi, trace, x = sweep_ho_trace(
            self.gamma, self.lam, self.mphi, self.adj, self.deg, self.consts,
            self.annealing, hp, hy, hw, self.cfg.epsilon, r, n_batches, nb,
            self.mphi is not None, self._sweep_extras(), self._comm)
        self._conv, self._mphi_bf16 = x.conv, x.mphi_bf16
        if self._group is not None:
            mesh.broadcast(trace)
        return trace

    # ------------------------------------------------------------------
    def _expand_if_compacted(self) -> None:
        """Restore the full (n,K) layout before anything host-facing
        (reports, model dumps) touches the state
        (svinet_tpu/svi/linksampling.py:924-944)."""
        c = self._compact
        if c is None:
            return
        eta = (self.consts.eta0, self.consts.eta1)
        self.gamma, self.lam = expand_columns(
            self.gamma, self.lam, c["idx"], self.consts.alpha, eta, self.k)
        real = c["idx"] < self.k
        cols = c["idx"][real].long()
        if self.mphi is not None:
            mphi = torch.zeros((self.n, self.k), dtype=torch.float32,
                               device=self.device)
            mphi[:, cols] = self.mphi[:, real]
            self.mphi, self._mphi_bf16 = mphi, None
        if self._conv is not None:
            # sticky flags back to full column ids: compacted flag c > 0
            # refers to compacted column c - 1 = full column idx[c - 1]
            cv = self._conv
            full = c["idx"][(cv - 1).clamp_min(0).long()]
            self._conv = torch.where(cv > 0, full + 1, 0).to(torch.int32)
        self._compact = None

    def _maybe_compact(self) -> None:
        """Engage active-K column compaction for the next report interval
        (svinet_tpu/svi/linksampling.py:946-1008; reference:
        src/linksampling.cc:634-664): once annealing is over, columns
        where no node has gamma - alpha >= 1 are dropped to their fixed
        point (alpha, eta) and the sweep runs at the padded active width.
        A dropped community can never re-enter. The replayed rows of a
        -report-batch batch never compact: the state belongs to the
        batch's last iteration."""
        cfg = self.cfg
        if (not cfg.prune or self.annealing or self._light_report
                or self._group is not None):
            # never under a mesh (svinet_tpu/svi/linksampling.py:955)
            return
        act = _active_cols(self.gamma, self.consts.alpha).cpu().numpy()
        ka = int(act.sum())
        if ka == 0:
            return
        kpad = max(8, 1 << int(np.ceil(np.log2(ka))))
        if kpad > cfg.prune_frac * self.k:
            return
        idx = np.full(kpad, self.k, np.int32)   # pads point out of range
        idx[:ka] = np.nonzero(act)[0].astype(np.int32)
        idx_d = torch.as_tensor(idx, device=self.device)
        colmask = torch.as_tensor((np.arange(kpad) < ka).astype(np.float32),
                                  device=self.device)
        self.gamma, self.lam = compact_columns(
            self.gamma, self.lam, idx_d, colmask, self.consts.alpha,
            (self.consts.eta0, self.consts.eta1))
        if self.mphi is not None:
            take = idx_d.clamp(max=self.k - 1).long()
            self.mphi = torch.where(colmask[None, :] > 0,
                                    self.mphi[:, take], 0.0).contiguous()
            self._mphi_bf16 = None
        # rest counts the columns NOT represented in gamma_c: the
        # (kpad - ka) pad slots already sit inside gamma_c at alpha, so
        # the scalar covers K - kpad columns, not K - ka
        self._compact = {"idx": idx_d, "colmask": colmask,
                         "rest": float(np.float32((self.k - kpad)
                                                  * cfg.alpha)),
                         "kpad": kpad, "ka": ka}
        if self._conv is not None:
            # sticky flags into compacted column ids (a frozen node's
            # column always stays active, since it keeps receiving the
            # hard +1, so every flagged column is in idx; 0 if not)
            inv = np.zeros(self.k + 1, np.int32)      # full col -> c + 1
            inv[idx[:ka]] = np.arange(1, ka + 1, dtype=np.int32)
            inv_d = torch.as_tensor(inv, device=self.device)
            cv = self._conv
            self._conv = torch.where(
                cv > 0, inv_d[(cv - 1).clamp_min(0).long()],
                0).to(torch.int32)
        self.log("prune: %d/%d active communities, sweeping at width %d",
                 ka, self.k, kpad)

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
        is a backstop. A column-compacted state (-prune) is expanded first
        and compacted again last, for the next interval's sweeps. Under
        -mesh-rowshard a report that is not a batch's replayed row reads
        the gathered (n, K) state (_full_rows)."""
        if self._light_report:
            return self._report()
        with self._full_rows():
            return self._report()

    def _report(self) -> bool:
        self._expand_if_compacted()
        stop = super().report()
        if not self._light_report:
            self._log_convergence()
            self._report_test_sets()
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
        if not stop:
            self._maybe_compact()
        return stop

    def _report_test_sets(self) -> None:
        """-load-test-sets: a {name}-hol.txt row per report and
        {name}_auc.txt ("y P(link)" rows) rewritten (reference:
        src/linksampling.cc:1056-1074, ~1150)."""
        cfg = self.cfg
        if not self.primary:
            return
        for name, pairs, ys, rf in self._test_sets:
            res = heldout_stats(self.gamma, self.lam, pairs, ys, cfg.epsilon)
            rf.write(self.iteration, self.duration(), res, cfg.zeros_prob,
                     cfg.ones_prob)
            probs = link_probs(self.gamma, self.lam, pairs).cpu().numpy()
            with open(cfg.file_str(f"{name}_auc.txt"), "w") as f:
                for yy, u in zip(ys.cpu().numpy(), probs):
                    f.write(f"{int(yy)} {u:.3f}\n")

    def close(self) -> None:
        super().close()
        for *_, rf in self._test_sets:
            rf.close()

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
        if not self.primary:
            return
        if not hasattr(self, "_convf"):
            app = bool(self.cfg.resume)
            self._convf = open(self.cfg.file_str("convergence.txt"),
                               "a" if app else "w")
            self._first_conv = np.zeros(self.n, np.int64)
            hosts = self.cfg.file_str("convergence_hosts.txt")
            if app and os.path.exists(hosts):
                # a resumed run keeps the first-converged times
                for line in open(hosts):
                    parts = line.split()
                    if len(parts) == 3:
                        self._first_conv[int(parts[0])] = int(parts[2])
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
        if not self.primary:
            return
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

    def do_on_stop(self, next_iteration: "int | None" = None) -> None:
        with self._full_rows():
            self._expand_if_compacted()
            super().do_on_stop(next_iteration=next_iteration)
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
                self.do_on_stop(next_iteration=self.iteration + 1)
                return True
        self.iteration = j + (b_eff - 1) * r + 1
        return False

    def infer(self, max_seconds: Optional[float] = None) -> None:
        """Sweep until the stopping rule, -max-iterations or max_seconds
        (wall seconds since the engine was made, checked before each
        step); reports fire at iterations 0, r, 2r, ... (r = -rfreq), and
        every sweep up to the next boundary runs in one step. With
        -report-batch B > 1 and a validation split, B whole intervals run
        per host round trip (_trace_intervals), except under -freeze (the
        batched trace does not thread the converged flags), under
        -sparse-w and while the state is column-compacted
        (svinet_tpu/svi/linksampling.py:1288-1316). -profile DIR traces the
        loop with torch.profiler into DIR (:1199-1211)."""
        if not self.cfg.profile_dir or not self.primary:
            self._infer_loop(max_seconds)
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        # started before the iteration-0 report, whose launches are the
        # first the profiler meets: it drops the first kernels after it
        # starts, and this way they are not the first sweep's
        with profile(activities=acts) as prof:
            self._infer_loop(max_seconds)
        prof.export_chrome_trace(
            os.path.join(self.cfg.profile_dir, "svinet_torch_trace.json"))

    def _infer_loop(self, max_seconds: Optional[float]) -> None:
        cfg = self.cfg
        timef = open(cfg.file_str("time.txt"), "a" if cfg.resume else "w")
        try:
            last_t = time.time()
            r = max(cfg.reportfreq, 1)
            # a resumed run makes no iteration-0 report: the stopper and
            # the annealing history would see a report the uninterrupted
            # run never made
            if self.iteration == 0:
                self.report()
                self.iteration = 1
            batch = max(1, int(cfg.report_batch))
            # without a validation split there are no sums to trace
            use_trace = (batch > 1 and self._ho is not None
                         and not cfg.freeze_converged and not cfg.sparse_w)
            while True:
                if cfg.max_iterations and self.iteration > cfg.max_iterations:
                    self.do_on_stop()
                    return
                # the time budget gates both paths (the -report-batch
                # branch continues before the loop's tail)
                if max_seconds is not None and self._out_of_time(max_seconds):
                    self.do_on_stop()
                    return
                j = ((self.iteration + r - 1) // r) * r
                if cfg.max_iterations:
                    j = min(j, cfg.max_iterations)
                todo = j - self.iteration + 1
                if use_trace and todo == r and self._compact is None:
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
                    # sweep j and its report are done: a final checkpoint
                    # stores j + 1
                    self.do_on_stop(next_iteration=j + 1)
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
