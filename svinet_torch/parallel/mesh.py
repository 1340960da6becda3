"""Multi-GPU data parallelism over edge shards on torch.distributed
(svinet_tpu/parallel/mesh.py).

The JAX package's `-mesh N` is one process driving N devices through
shard_map; here it is one rank a GPU, each running the same engine loop
(SPMD) on its own process. The CLI keeps its surface: `python -m
svinet_torch ... -mesh N` spawns N ranks (`launch`), rank r on cuda:r
with NCCL, or on the CPU with gloo when $SVINET_TORCH_DEVICE=cpu. Only
rank 0 writes the output directory and prints; the other ranks write
their report files into a private directory that is removed at the end.

Two layouts, as in the JAX package:
- replicated (`-mesh N`): the training links are split into N shards
  (shard_edges, the JAX order), gamma, lambda and deg are replicated,
  and each sweep all-reduces the shard's sufficient statistics (gamma_hat
  (n,K), sum_k (K,), s3 (K,)); kernels 3 and finish_lambda then run on
  every rank on the same bits;
- row-sharded (`-mesh-rowshard`): gamma and deg rows are split too (n
  padded to a multiple of N with rows at (alpha, deg 0)); each sweep
  all-gathers Elogpi (after the -bf16 cast) and the mean indicators,
  reduce-scatters gamma_hat and all-reduces s1 and s2.
The sweep body is the single-device one (svi/linksampling.py) with its
collectives taken from a Comm: LOCAL does nothing, MeshComm calls the
collectives below in the places where the JAX sweeps psum, all_gather
and psum_scatter.

Decisions that change control flow come from values every rank holds
bit for bit (a ring all-reduce hands every rank the same bits, and the
per-rank work after it runs on identical inputs) or are broadcast from
rank 0: the heldout sums that drive the stop and the annealing exit, a
SIGTERM (agree_flag at each report boundary), a time limit.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import multiprocessing.connection
import os
import shutil
import signal
import sys
import tempfile
import traceback
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from svinet_torch.evals.likelihood import heldout_sums_blocked


@dataclasses.dataclass
class Group:
    """This process's place in the mesh: rank, number of ranks, the
    device it computes on and the backend of its collectives. `ready`,
    when the launcher started the rank, counts the ranks whose engine is
    built (the launcher's SIGTERM handler reads it); `engine` is this
    rank's, once built."""
    rank: int
    size: int
    device: torch.device
    backend: str
    ready: Optional[object] = None
    engine: Optional[object] = None
    # whether this is the first rank its process started (under
    # -dist-nprocs it writes the process's directory)
    lead: bool = False

    @property
    def primary(self) -> bool:
        return self.rank == 0


def init_group(rank: int, size: int, device, backend: Optional[str] = None,
               init_method: Optional[str] = None, ready=None,
               lead: bool = False) -> Group:
    """Join torch.distributed's default process group, which the
    collectives below use, as rank `rank` of `size`. `backend` defaults to
    nccl on a CUDA device and gloo on the CPU; nothing falls back to
    another backend. `init_method` defaults to a private rendezvous file,
    which serves a group of one rank. `lead`: see Group."""
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if init_method is None:
        if size != 1:
            raise ValueError("a group of several ranks needs the "
                             "init_method they share")
        path = os.path.join(tempfile.mkdtemp(prefix="svinet_torch_pg_"),
                            "rendezvous")
        init_method = "file://" + path
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=size, rank=rank)
    return Group(rank, size, device, backend, ready, lead=lead)


def shutdown() -> None:
    """Leave the process group (every rank calls this at its end)."""
    dist.destroy_process_group()


def engine_ready(group: Group, engine) -> None:
    """Called once this rank's engine is built: from then on the launcher
    forwards a SIGTERM to rank 0 instead of ending the run."""
    group.engine = engine
    if group.ready is not None:
        with group.ready.get_lock():
            group.ready.value += 1


# ---------------------------------------------------------------------
# Collectives: thin wrappers of torch.distributed over the default process
# group (init_group), used in place of the JAX package's psum,
# all_gather(tiled=True) and psum_scatter(tiled=True). They run even on a
# group of one rank, so that one card exercises the real calls.

def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """Sum over the ranks, in place; returns t."""
    dist.all_reduce(t)
    return t


def broadcast(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank src's t on every rank, in place; returns t."""
    dist.broadcast(t, src)
    return t


# torch.distributed's names for the tiled collectives; newer releases
# rename them (the old names still work there, with a warning)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def all_gather(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Every rank's rows, stacked in rank order along dim 0 (the tiled
    all_gather); f32 or bf16 rows."""
    out = t.new_empty((group.size * t.shape[0], *t.shape[1:]))
    _ALL_GATHER(out, t.contiguous())
    return out


def reduce_scatter(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum over the ranks of t, of which each rank keeps its own block
    of rows (the tiled psum_scatter); t's rows must divide by the ranks."""
    rows = t.shape[0] // group.size
    if rows * group.size != t.shape[0]:
        raise ValueError(f"{t.shape[0]} rows do not split over "
                         f"{group.size} ranks")
    out = t.new_empty((rows, *t.shape[1:]))
    _REDUCE_SCATTER(out, t.contiguous())
    return out


def agree_flag(flag: bool, group: Group) -> bool:
    """True on every rank when it is True on any: a decision that one rank
    took (a SIGTERM reached it) taken by all at the same point."""
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=group.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def from_primary(flag: bool, group: Group) -> bool:
    """Rank 0's value of a host decision (a wall-clock limit), on every
    rank."""
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=group.device)
    dist.broadcast(t, 0)
    return bool(t.item())


# ---------------------------------------------------------------------
# Host layouts, numpy copies of the JAX package's.

def shard_edges(edges: np.ndarray, n_shards: int, block: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Split an (E,2) edge list into n_shards equal padded shards
    (svinet_tpu/parallel/mesh.py:40-55): shard s holds the edges of
    np.array_split(arange(E), n_shards)[s], then padding.
    Returns (edges (n_shards*Es, 2), mask (n_shards*Es,))."""
    per = -(-len(edges) // n_shards)  # ceil
    per = max(block, ((per + block - 1) // block) * block)
    out = np.zeros((n_shards * per, 2), np.int32)
    mask = np.zeros(n_shards * per, np.float32)
    idx = np.array_split(np.arange(len(edges)), n_shards)
    for s, ids in enumerate(idx):
        out[s * per: s * per + len(ids)] = edges[ids]
        mask[s * per: s * per + len(ids)] = 1.0
    return out, mask


def rowshard_heldout_layout(pairs: np.ndarray, y: np.ndarray, n: int,
                            n_shards: int):
    """Host-side layout for the row-sharded heldout tail
    (svinet_tpu/parallel/mesh.py:457-495): the compact table of the
    heldout-touched rows and the sharded pair set.

    Returns (hidx (d*Hmax,) local-row indices per table slot,
    pairs_sh (d*per, 2) table-slot pairs, y_sh, w_sh, nb) where nb is
    the per-shard block count. Slots/pairs are zero-padded (weight 0);
    every real pair's endpoints are remapped to table slots."""
    rows_per = n // n_shards
    uniq = np.unique(pairs)
    if len(uniq) == 0:
        uniq = np.zeros(1, pairs.dtype)
    owner = uniq // rows_per
    counts = np.bincount(owner, minlength=n_shards)
    hmax = max(int(counts.max()), 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(uniq)) - starts[owner]
    slot = (owner * hmax + rank).astype(np.int64)
    hidx = np.zeros(n_shards * hmax, np.int32)
    hidx[slot] = (uniq - owner * rows_per).astype(np.int32)
    mapped = slot[np.searchsorted(uniq, pairs)].astype(np.int32)

    m = len(pairs)
    per = -(-max(m, 1) // n_shards)
    blk = min(1 << 17, max(64, 1 << int(np.ceil(np.log2(per)))))
    nb = -(-per // blk)
    tot = nb * blk
    pp = np.zeros((n_shards * tot, 2), np.int32)
    yy = np.zeros(n_shards * tot, np.int32)
    ww = np.zeros(n_shards * tot, np.float32)
    idx = np.array_split(np.arange(m), n_shards)
    for s, ids in enumerate(idx):
        pp[s * tot: s * tot + len(ids)] = mapped[ids]
        yy[s * tot: s * tot + len(ids)] = y[ids]
        ww[s * tot: s * tot + len(ids)] = 1.0
    return hidx, pp, yy, ww, nb


# ---------------------------------------------------------------------
# Where a sweep communicates.

class LocalComm:
    """The single-device sweep: every hook passes its tensor through."""
    rowshard = False

    def rows(self, t):
        """Local rows -> the rows every link of this rank may touch."""
        return t

    def stat(self, t):
        """A rank's gamma_hat over its links -> this rank's rows of the
        sum over all links."""
        return t

    def total(self, t):
        """A column sum over this rank's links -> over all links."""
        return t

    def row_total(self, t):
        """A column sum over this rank's rows -> over all rows."""
        return t

    def rows_out(self, name: str, n: int, k: int, dtype, device):
        """Where a kernel should write the (n, K) rows that rows() will be
        given, or None for a new tensor."""
        return None

    def heldout(self, gamma, lam, pairs, y, w, epsilon: float,
                num_blocks: int):
        """The six validation heldout sums of the state."""
        return heldout_sums_blocked(gamma, lam, pairs, y, w, epsilon,
                                    num_blocks)


LOCAL = LocalComm()


class MeshComm(LocalComm):
    """The collectives of make_sharded_multi_sweep and
    make_rowsharded_multi_sweep (svinet_tpu/parallel/mesh.py:91-158,
    812-864, and their -fuse-s3 forms :161-290). Under rowshard, `hidx`
    are this rank's slots of the compact heldout table
    (rowshard_heldout_layout)."""

    def __init__(self, group: Group, rowshard: bool, hidx=None):
        self.group = group
        self.rowshard = rowshard
        self.hidx = hidx

    def rows(self, t):
        return all_gather(t, self.group) if self.rowshard else t

    def stat(self, t):
        return (reduce_scatter(t, self.group) if self.rowshard
                else all_reduce(t))

    def total(self, t):
        return all_reduce(t)

    def row_total(self, t):
        return all_reduce(t) if self.rowshard else t

    def heldout(self, gamma, lam, pairs, y, w, epsilon: float,
                num_blocks: int):
        """Replicated gamma: every rank evaluates the sums itself, no
        collective. Row-sharded gamma (make_mesh_trace_sweep's rowshard
        branch, svinet_tpu/parallel/mesh.py:406-424): each rank takes its
        heldout-touched rows, one all_gather makes the compact table, each
        rank sums its share of the pairs (kernel 6 divides each gathered
        row by its own sum, as the JAX tail normalises the rows before the
        gather) and the six sums are all-reduced."""
        if not self.rowshard:
            return heldout_sums_blocked(gamma, lam, pairs, y, w, epsilon,
                                        num_blocks)
        table = all_gather(gamma[self.hidx], self.group)
        return all_reduce(heldout_sums_blocked(table, lam, pairs, y, w,
                                               epsilon, num_blocks))


class LocalityComm(MeshComm):
    """-mesh-locality: the row-sharded sweep whose collectives carry the
    boundary rows only (make_mesh_trace_sweep's locality branch,
    svinet_tpu/parallel/mesh.py:343-365). The rank's links index the
    space [its rows_per owned rows | the d*Xmax boundary table]
    (parallel/locality.py); `exp_idx` (Xmax,) are the owned rows this rank
    exports into its slots of the table, the first `n_exp` of them real
    and the rest 0. Each row array a sweep gathers (Elogpi, mphi, after
    the -bf16 cast) is gathered by itself, so a kernel reads it
    contiguous. Rows that a kernel wrote into the leading rows of a buffer
    from rows_out have their table gathered in place behind them; other
    rows are copied in front of it. The padded slots carry copies of row
    0, which no link reads, and their gamma_hat is 0."""

    def __init__(self, group: Group, hidx, exp_idx, n_exp: int):
        super().__init__(group, True, hidx)
        self.exp_idx = exp_idx
        self.n_exp = n_exp
        self.table = group.size * exp_idx.shape[0]
        self._bufs = {}

    def rows_out(self, name: str, n: int, k: int, dtype, device):
        """The leading (n, K) rows of this comm's (n + table, K) buffer
        `name`, made on first use."""
        buf = self._bufs.get(name)
        if buf is None or buf.shape != (n + self.table, k) or \
                buf.dtype != dtype:
            buf = torch.empty((n + self.table, k), dtype=dtype,
                              device=device)
            self._bufs[name] = buf
        return buf[:n]

    def rows(self, t):
        """[t | the table]: every rank's exported rows of t, in rank
        order."""
        n = t.shape[0]
        for buf in self._bufs.values():
            if (buf.data_ptr() == t.data_ptr() and buf.dtype == t.dtype
                    and buf.shape == (n + self.table, *t.shape[1:])):
                _ALL_GATHER(buf[n:], t[self.exp_idx])
                return buf
        return torch.cat([t, all_gather(t[self.exp_idx], self.group)])

    def stat(self, t):
        """The owned rows of gamma_hat plus the boundary rows' sums over
        the ranks, added at the rows they were exported from (owned first,
        then the boundary sum, as the JAX package adds them; the padded
        slots' sums are 0 and are left out)."""
        rows_per = t.shape[0] - self.table
        bnd = reduce_scatter(t[rows_per:], self.group)
        return t[:rows_per].index_add_(0, self.exp_idx[:self.n_exp],
                                       bnd[:self.n_exp])


# ---------------------------------------------------------------------
# MMSBInfer under a mesh.

def sharded_nonuniform_weights(gamma, pairs, y, mask, infthresh: float,
                               group: Group):
    """The -nonuniform weights of this rank's shard of a minibatch
    (svinet_tpu/parallel/mesh.py:539-599): the category counts (links,
    informative zeros, non-informative zeros) are summed over the ranks so
    every kept pair carries the global count, and the single kept
    non-informative zero and the 0.1% informative-zero cap select the
    globally first pairs in shard order, through an exclusive prefix of the
    ranks' counts (gathered as an all-reduce of a one-hot vector, which
    every backend carries). Returns (weights, the global number of pairs
    processed)."""
    g = group
    gp = gamma[pairs[:, 0].long()]
    gq = gamma[pairs[:, 1].long()]
    pip = gp / gp.sum(-1, keepdim=True)
    piq = gq / gq.sum(-1, keepdim=True)
    p_i = (pip * piq).sum(-1).clamp(0.0, 1.0)
    valid = mask > 0
    is_link = (y == 1) & valid
    noninf = (y == 0) & valid & (p_i < infthresh)
    inf = (y == 0) & valid & (p_i >= infthresh)
    counts = all_reduce(torch.stack([is_link.sum(), inf.sum(),
                                     noninf.sum()]).to(torch.int64))
    nones, nz_inf, nz_noninf = (c.to(torch.int32) for c in counts)
    n3_max = (0.001 * nz_inf.to(torch.float32)).to(torch.int32)

    def global_first(sel, cap):
        per_rank = torch.zeros(g.size, dtype=torch.int64, device=g.device)
        per_rank[g.rank] = sel.sum()
        prefix = all_reduce(per_rank)[:g.rank].sum().to(sel.device)
        return sel & (prefix + torch.cumsum(sel.to(torch.int64), 0) <= cap)

    sel_noninf = global_first(noninf, 1)
    sel_inf = global_first(inf, n3_max)
    f = gamma.dtype
    w = (is_link.to(f) * nones.to(f)
         + sel_noninf.to(f) * nz_noninf.to(f)
         + sel_inf.to(f) * nz_inf.to(f))
    kept = all_reduce((sel_noninf.sum() + sel_inf.sum()).to(torch.int64)
                      .reshape(1))[0]
    return w, nones + kept.to(torch.int32)


def shard_span(m: int, pad_to: int, group: Group) -> Tuple[int, int]:
    """[lo, hi): the real pairs of this rank's shard of a minibatch of m
    pairs padded to pad_to = nd equal whole-block shards
    (svinet_tpu/svi/mmsb.py:430-438). Pairs keep their positions, so the
    trailing padding of a shard (pairs (0, 0) of weight 0) is left to
    kernel 8's virtual pad pair and its all-padding blocks add nothing."""
    per = pad_to // group.size
    lo = min(group.rank * per, m)
    return lo, min(lo + per, m)


# ---------------------------------------------------------------------
# The launcher: `-mesh N` on the command line.

def wants_mesh(cfg) -> bool:
    """Whether the CLI run takes the mesh path, as the JAX engines decide:
    LinkSampling under -mesh N > 1, -mesh 1 -mesh-rowshard
    (svinet_tpu/svi/linksampling.py:545-546) or -mesh-locality, which
    implies -mesh-rowshard on at least one device (svinet_tpu/cli.py:
    320-333); MMSBInfer and FastAMM2 under -mesh N > 1
    (svinet_tpu/svi/mmsb.py:314, svinet_tpu/svi/fastamm2.py:76). The
    generator family and the full blockmodel never read -mesh
    (svinet_tpu/svi/gen.py, svinet_tpu/svi/orig.py) and win over
    -link-sampling: -gen (before the network is read), -ppc, -lcstats and
    -gml (after -mesh-locality's reorder, before -findk), then FastInit
    (-findk), then -orig (svinet_tpu/cli.py:309-378). -preprocess alone
    runs no engine, and SBM (-single, after -link-sampling) and FastAMM
    (-infset, before -stratified -rnode in svinet_tpu/cli.py:379-414) have
    no mesh either: each of these runs one process on one device under any
    -mesh N."""
    if cfg.gen or cfg.ppc or cfg.lcstats or cfg.gml or cfg.findk \
            or cfg.orig:
        return False
    if cfg.link_sampling:
        return (cfg.mesh_devices > 1 or cfg.mesh_locality
                or (cfg.mesh_devices == 1 and cfg.mesh_rowshard))
    if cfg.single:
        return False
    if cfg.preprocess and not cfg.batch:
        return False
    if cfg.informative_sampling and not (cfg.single or cfg.batch):
        return False
    return cfg.mesh_devices > 1


def mesh_ranks(cfg) -> int:
    """The ranks of a mesh run, over all its processes: -mesh N, and at
    least one under -mesh-locality."""
    return max(cfg.mesh_devices, 1)


@dataclasses.dataclass(frozen=True)
class Dist:
    """-dist-coordinator/-dist-nprocs/-dist-procid
    (svinet_tpu/parallel/mesh.py:524, svinet_tpu/cli.py:287-307): this
    process is `procid` of `nprocs`, all of whose ranks rendezvous at
    tcp://<coordinator>, where global rank 0 (process 0's first) listens."""
    coordinator: str
    nprocs: int
    procid: int

    @classmethod
    def of(cls, cfg) -> "Optional[Dist]":
        """The processes of the run, or None for one: as the JAX CLI,
        -dist-nprocs of 1 or less is one process."""
        if cfg.dist_nprocs <= 1:
            return None
        if not 0 <= cfg.dist_procid < cfg.dist_nprocs:
            raise SystemExit(f"-dist-procid {cfg.dist_procid} is not a "
                             f"process of -dist-nprocs {cfg.dist_nprocs}")
        if not cfg.dist_coordinator:
            raise SystemExit("-dist-nprocs needs -dist-coordinator "
                             "<host:port>")
        return cls(cfg.dist_coordinator, cfg.dist_nprocs, cfg.dist_procid)

    def ranks(self, nd: int) -> range:
        """The global ranks of this process: process i of P starts
        [i*nd/P, (i+1)*nd/P)."""
        if nd % self.nprocs:
            raise SystemExit(f"-mesh {nd} does not split into "
                             f"-dist-nprocs {self.nprocs} equal parts")
        per = nd // self.nprocs
        return range(self.procid * per, (self.procid + 1) * per)

    def outdir(self, outdir: str) -> str:
        """This process's output directory: process 0's is the run's, the
        others write under <outdir>/proc<i> (svinet_tpu/cli.py:303-307)."""
        if self.procid == 0:
            return outdir
        return os.path.join(outdir, f"proc{self.procid}")


def default_devices(nd: int) -> list:
    """Rank r on cuda:r, or every rank on the CPU when
    $SVINET_TORCH_DEVICE=cpu. More ranks than cards is refused with the
    JAX package's message."""
    from svinet_torch import resolve_device
    dev = resolve_device()
    if dev.type == "cpu":
        return [torch.device("cpu")] * nd
    count = torch.cuda.device_count()
    if nd > count:
        raise SystemExit(f"-mesh {nd} but only {count} devices visible")
    return [torch.device("cuda", r) for r in range(nd)]


def launch_counts() -> dict:
    """Every kernel wrapper's launch counts in this process, by wrapper
    name: {"launches": n, "forms": {form: n}}."""
    from svinet_torch.evals import likelihood
    from svinet_torch.ops import digamma, phicomp
    from svinet_torch.svi import communities, sweep_math
    out = {}
    for mod in (digamma, phicomp, sweep_math, likelihood, communities):
        for name, fn in vars(mod).items():
            if callable(fn) and hasattr(fn, "launches") and hasattr(
                    fn, "forms"):
                out[name] = {"launches": fn.launches,
                             "forms": dict(fn.forms)}
    return out


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()
                          ).hexdigest()


def _rank_report(path: str, group: Optional[Group]) -> None:
    """This rank's kernel launch counts and digests of its engine's final
    gamma and lambda (the replicated layouts' ranks must agree bit for
    bit) and of its node order (-mesh-locality's permutation, which every
    rank computes)."""
    out = {"launches": launch_counts()}
    eng = group.engine if group is not None else None
    if eng is not None:
        out["gamma_sha256"] = _digest(eng.gamma)
        out["lam_sha256"] = _digest(eng.lam)
        out["order_sha256"] = hashlib.sha256(
            eng.network.seq2id.tobytes()).hexdigest()
    with open(path, "w") as f:
        json.dump(out, f)


def _rank_main(rank: int, size: int, device: str, backend: str, tmp: str,
               argv: list, ready, report_dir: Optional[str],
               init_method: str, lead: bool) -> None:
    """A spawned rank: join the group, run the CLI, leave a status file
    (named by the rank's place among its process's ranks)."""
    status = {"rc": None, "exit": None, "error": None}
    code = 0
    group = None
    if rank:
        sys.stdout = open(os.devnull, "w")
    if torch.device(device).type == "cpu":
        # the ranks share the host's cores: one thread each, as torchrun
        # sets OMP_NUM_THREADS=1 for its workers
        torch.set_num_threads(1)
    try:
        group = init_group(rank, size, device, backend, init_method, ready,
                           lead)
        from svinet_torch.cli import main
        status["rc"] = main(argv, group)
    except SystemExit as e:
        if isinstance(e.code, str):
            status["exit"] = e.code
            code = 1
        else:
            status["rc"] = e.code or 0
            code = int(e.code or 0)
    except BaseException:
        status["error"] = traceback.format_exc()
        code = 1
    finally:
        if report_dir:
            _rank_report(os.path.join(report_dir, f"rank{rank}.json"),
                         group)
        with open(os.path.join(tmp, f"status{rank}.json"), "w") as f:
            json.dump(status, f)
        if group is not None:
            shutdown()
    sys.stdout.flush()
    os._exit(code)


def launch(argv: Sequence[str], nd: int, backend: Optional[str] = None,
           devices: Optional[Sequence] = None,
           report_dir: Optional[str] = None,
           dist: Optional[Dist] = None) -> int:
    """Run the CLI `argv` on nd spawned ranks and wait for them. `devices`
    (rank -> device) and `backend` are the launcher's, not CLI flags: by
    default rank r takes cuda:r with nccl (or the CPU with gloo), and a
    caller may put several gloo ranks on one card. With `report_dir` each
    rank writes there (rank<r>.json) its kernels' launch counts and
    digests of its final gamma and lambda.

    Under `dist` (-dist-nprocs P > 1) nd counts the ranks of every
    process: this process starts its nd/P of them (Dist.ranks) on its own
    devices (`devices` then lists those), and all nd meet at the TCP
    rendezvous of -dist-coordinator; alone, the ranks meet at a private
    rendezvous file.

    A SIGTERM before every rank of this process has built its engine ends
    its ranks and the process with status 0, as the JAX CLI exits before
    its engine exists; after, it is forwarded to the process's first rank
    (global rank 0 in process 0), whose flag every rank agrees on at the
    next report boundary (agree_flag). A rank that fails ends the others
    of its process (they would wait in a collective). Returns the status
    of the process's first rank; a SystemExit of a rank is raised again
    here with its message."""
    ranks = dist.ranks(nd) if dist is not None else range(nd)
    local = len(ranks)
    devices = [torch.device(d) for d in (devices or default_devices(local))]
    if len(devices) != local:
        raise ValueError(f"{len(devices)} devices for {local} ranks")
    backend = backend or ("nccl" if devices[0].type == "cuda" else "gloo")
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="svinet_torch_mesh_")
    init = ("tcp://" + dist.coordinator if dist is not None
            else "file://" + os.path.join(tmp, "rendezvous"))
    ready = ctx.Value("i", 0)
    procs = [ctx.Process(target=_rank_main,
                         args=(r, nd, str(devices[i]), backend, tmp,
                               list(argv), ready, report_dir, init, i == 0))
             for i, r in enumerate(ranks)]

    def _term(_sig, _frm):
        if ready.value < local:
            sys.exit(0)
        if procs[0].pid is not None and procs[0].exitcode is None:
            os.kill(procs[0].pid, signal.SIGTERM)

    previous = signal.signal(signal.SIGTERM, _term)
    try:
        for p in procs:
            p.start()
        while any(p.exitcode is None for p in procs):
            multiprocessing.connection.wait([p.sentinel for p in procs
                                             if p.exitcode is None], 1.0)
            if any(p.exitcode not in (None, 0) for p in procs):
                break
        statuses = []
        for r, p in zip(ranks, procs):
            path = os.path.join(tmp, f"status{r}.json")
            if p.exitcode is not None and os.path.exists(path):
                with open(path) as f:
                    statuses.append(json.load(f))
            else:
                statuses.append(None)
    finally:
        signal.signal(signal.SIGTERM, previous)
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    for st in statuses:
        if st is not None and st["exit"]:
            raise SystemExit(st["exit"])
    for r, st in zip(ranks, statuses):
        if st is not None and st["error"]:
            raise RuntimeError(f"rank {r} of {nd} failed:\n{st['error']}")
    for r, p, st in zip(ranks, procs, statuses):
        if st is None or p.exitcode != 0:
            raise RuntimeError(f"rank {r} of {nd} ended with status "
                               f"{p.exitcode}")
    return int(statuses[0]["rc"] or 0)
