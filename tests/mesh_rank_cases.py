"""The rank side of tests/test_torch_mesh.py and tests/test_torch_locality.py:
inputs made from numpy seeds and the port's mesh functions run on each of
nd gloo ranks on the CPU.
Imports the port only (the spawned ranks never load JAX); the test
imports the same inputs for the JAX package's side."""

from __future__ import annotations

import os

import numpy as np
import torch

N, K = 61, 4            # odd n: the row-sharded layout pads rows
BLOCK = 64              # the JAX edge and pair block of these cases
SWEEPS = 2
EPS = 1e-30
MAX_ITERS, THRESH = 50, 1e-5
SVI_N, SVI_M = 64, 300  # MMSBInfer's step: nodes, pairs of a minibatch
BATCH_N = 40            # -batch: every pair of this many nodes
NU_M = 64               # the -nonuniform weights' pairs


def sweep_inputs():
    """A planted 4-block graph on N nodes: (edges (E,2) int32, deg (N,)
    f32, gamma0 (N,K) f32, lam0 (K,2) f32, (alpha, eta0, eta1, ones, n),
    validation pairs (40,2) int32, their y (40,) int32)."""
    from svinet_torch.svi.linksampling import init_gamma_from_links
    rng = np.random.default_rng(0)
    size = N // 4
    e = []
    for p in range(N):
        for q in range(p + 1, N):
            same = p // size == q // size
            if rng.uniform() < (0.5 if same else 0.02):
                e.append((p, q))
    edges = np.array(e, np.int32)
    deg = np.zeros(N, np.float32)
    np.add.at(deg, edges[:, 0], 1)
    np.add.at(deg, edges[:, 1], 1)
    gamma0 = init_gamma_from_links(np.random.default_rng(1), edges, N, K,
                                   1.0 / K).astype(np.float32)
    lam0 = np.ones((K, 2), np.float32)
    consts = (1.0 / K, 1.0, 1.0, float(len(edges)), float(N))
    a = rng.integers(0, N, 40)
    b = (a + 1 + rng.integers(0, N - 1, 40)) % N
    vp = np.stack([np.minimum(a, b), np.maximum(a, b)], 1).astype(np.int32)
    vy = rng.integers(0, 2, 40).astype(np.int32)
    return edges, deg, gamma0, lam0, consts, vp, vy


def svi_inputs():
    """MMSBInfer's state and one minibatch: (gamma (n,K), lam (K,2),
    pairs (m,2) int32, y (m,) int32)."""
    rng = np.random.default_rng(2)
    gamma = rng.gamma(100.0, 0.01, (SVI_N, K)).astype(np.float32)
    gamma[: SVI_N // 2, 0] += 3.0
    gamma[SVI_N // 2:, 1] += 3.0
    lam = np.tile([[2.0, 1.5]], (K, 1)).astype(np.float32)
    a = rng.integers(0, SVI_N, SVI_M)
    b = (a + 1 + rng.integers(0, SVI_N - 1, SVI_M)) % SVI_N
    pairs = np.stack([np.minimum(a, b), np.maximum(a, b)], 1)
    y = (rng.uniform(size=SVI_M) < 0.3).astype(np.int32)
    return gamma, lam, pairs.astype(np.int32), y


def batch_inputs():
    """Every pair of BATCH_N nodes with a planted y: (gamma, lam, pairs,
    y)."""
    rng = np.random.default_rng(3)
    iu = np.triu_indices(BATCH_N, k=1)
    pairs = np.stack(iu, 1).astype(np.int32)
    same = pairs[:, 0] // (BATCH_N // 2) == pairs[:, 1] // (BATCH_N // 2)
    y = (rng.uniform(size=len(pairs)) < np.where(same, 0.4, 0.03)
         ).astype(np.int32)
    gamma = rng.gamma(100.0, 0.01, (BATCH_N, K)).astype(np.float32)
    lam = np.tile([[1.0, 1.0]], (K, 1)).astype(np.float32)
    return gamma, lam, pairs, y


def nonuniform_inputs(nd: int):
    """Pairs of which the first shard of nd holds links and informative
    zeros only: (gamma, pairs, y, mask, infthresh)."""
    rng = np.random.default_rng(4)
    n = 32
    gamma = rng.gamma(1.0, 1.0, (n, K)).astype(np.float32)
    gamma[: n // 2, 0] += 20.0
    gamma[n // 2:, 1] += 20.0
    within = np.stack([rng.integers(0, n // 2, NU_M),
                       rng.integers(0, n // 2, NU_M)], 1)
    across = np.stack([rng.integers(0, n // 2, NU_M),
                       rng.integers(n // 2, n, NU_M)], 1)
    per = NU_M // nd
    pairs = np.concatenate([within[:per], across[: NU_M - per]])
    pairs[:, 1] = np.where(pairs[:, 1] == pairs[:, 0],
                           (pairs[:, 0] + 1) % (n // 2), pairs[:, 1])
    y = (rng.uniform(size=NU_M) < 0.25).astype(np.int32)
    mask = np.ones(NU_M, np.float32)
    mask[-3:] = 0.0
    return gamma, pairs.astype(np.int32), y, mask, 0.3


def pad_to(m: int, nd: int, block: int = BLOCK) -> int:
    """The JAX engine's minibatch padding under -mesh
    (svinet_tpu/svi/mmsb.py:430-438)."""
    pt = max(block, -(-m // block) * block)
    return max(block, (-(-pt // nd) + block - 1) // block * block) * nd


def _sweeps(g, rank, nd, dev):
    """Every sweep case of this rank: {name: tensors}."""
    from svinet_torch.ops.edges import build_adjacency
    from svinet_torch.parallel import mesh
    from svinet_torch.parallel.mesh import MeshComm
    from svinet_torch.svi.linksampling import (
        SweepExtras, multi_sweep, sweep_ho_trace)
    from svinet_torch.svi.sweep_math import LSConsts
    edges, deg, gamma0, lam0, consts, vp, vy = sweep_inputs()
    c = LSConsts.make(*consts)
    shard = edges[np.array_split(np.arange(len(edges)), nd)[rank]]
    out = {}
    for rowshard in (False, True):
        n_pad = -(-N // nd) * nd if rowshard else N
        rows = slice(rank * n_pad // nd, (rank + 1) * n_pad // nd)
        gam = np.full((n_pad, K), consts[0], np.float32)
        gam[:N] = gamma0
        dg = np.zeros(n_pad, np.float32)
        dg[:N] = deg
        if rowshard:
            gam, dg = gam[rows], dg[rows]
        adj = build_adjacency(shard, n_pad, dev)
        comm = MeshComm(g, rowshard)
        hp = hy = hw = None
        if rowshard:
            hidx, pp, yy, ww, nb = mesh.rowshard_heldout_layout(
                vp, vy, n_pad, nd)
            h, t = len(hidx) // nd, len(pp) // nd
            comm.hidx = torch.as_tensor(
                hidx[rank * h:(rank + 1) * h].astype(np.int64))
            mine = slice(rank * t, (rank + 1) * t)
            hp, hy, hw = (torch.as_tensor(a[mine]) for a in (pp, yy, ww))
        else:
            nb = 1
            hp = torch.zeros((64, 2), dtype=torch.int32)
            hp[:len(vp)] = torch.as_tensor(vp)
            hy = torch.zeros(64, dtype=torch.int32)
            hy[:len(vy)] = torch.as_tensor(vy)
            hw = torch.zeros(64)
            hw[:len(vp)] = 1.0
        tag = "rs" if rowshard else "rep"
        for fused in (False, True):
            for bf16 in ((False, True) if not rowshard else (False,)):
                gi = torch.as_tensor(gam).clone()
                mi = torch.zeros_like(gi) if fused else None
                gg, ll, mm, _ = multi_sweep(
                    gi, torch.as_tensor(lam0), mi, adj, torch.as_tensor(dg),
                    c, True, SWEEPS, fused, SweepExtras(bf16=bf16), comm)
                name = f"{tag}-{'fused' if fused else 'plain'}" + (
                    "-bf16" if bf16 else "")
                out[name] = (gg, ll) + ((mm,) if fused else ())
            for nbat in (1, 3):
                gi = torch.as_tensor(gam).clone()
                mi = torch.zeros_like(gi) if fused else None
                gg, ll, mm, trace = sweep_ho_trace(
                    gi, torch.as_tensor(lam0), mi, adj, torch.as_tensor(dg),
                    c, True, hp, hy, hw, EPS, SWEEPS, nbat, nb, fused,
                    None, comm)
                out[f"{tag}-trace{nbat}-{'fused' if fused else 'plain'}"] = (
                    gg, ll, trace)
    return out


def _mmsb(g, rank, nd, dev):
    """The sharded SVI steps, the -batch step and the -nonuniform
    weights of this rank."""
    from svinet_torch.parallel import mesh
    from svinet_torch.svi.mmsb import batch_step, svi_step
    out = {}
    f32 = lambda x: torch.tensor(np.float32(x))
    gamma, lam, pairs, y = svi_inputs()
    eta = torch.ones((K, 2))
    lo, hi = mesh.shard_span(SVI_M, pad_to(SVI_M, nd), g)
    for name, inf, nu, gs in (("svi", 0.0, False, 50.0),
                              ("svi-inf", 0.2, False, 50.0),
                              ("svi-nonuniform", 0.2, True, 1.0)):
        gg, ll = svi_step(
            torch.as_tensor(gamma), torch.as_tensor(lam),
            torch.as_tensor(pairs[lo:hi]), torch.as_tensor(y[lo:hi]),
            torch.ones(hi - lo), 1.0 / K, eta, f32(gs), f32(gs), f32(0.4),
            f32(0.3), 1.0, float(np.float32(np.log(EPS))), MAX_ITERS,
            THRESH, inf, nu, block=BLOCK, group=g)
        out[name] = (gg, ll)
    gamma, lam, pairs, y = batch_inputs()
    lo, hi = mesh.shard_span(len(pairs), pad_to(len(pairs), nd), g)
    gg, ll = batch_step(
        torch.as_tensor(gamma), torch.as_tensor(lam),
        torch.as_tensor(pairs[lo:hi]), torch.as_tensor(y[lo:hi]),
        torch.ones(hi - lo), 1.0 / K, eta, 1.0,
        float(np.float32(np.log(EPS))), MAX_ITERS, THRESH, block=BLOCK,
        group=g)
    out["batch"] = (gg, ll)
    gamma, pairs, y, mask, inf = nonuniform_inputs(nd)
    per = NU_M // nd
    mine = slice(rank * per, (rank + 1) * per)
    w, n_proc = mesh.sharded_nonuniform_weights(
        torch.as_tensor(gamma), torch.as_tensor(pairs[mine]),
        torch.as_tensor(y[mine]), torch.as_tensor(mask[mine]), inf, g)
    out["nonuniform"] = (w, n_proc.reshape(1))
    return out


def run(rank: int, nd: int, init: str, outdir: str) -> None:
    """A spawned rank: every case, saved to outdir/rank<r>.pt."""
    from svinet_torch.parallel import mesh
    torch.set_num_threads(1)
    g = mesh.init_group(rank, nd, "cpu", "gloo", init)
    try:
        dev = torch.device("cpu")
        out = _sweeps(g, rank, nd, dev)
        if nd == 2:
            out.update(_mmsb(g, rank, nd, dev))
        torch.save({k: tuple(t.detach().float() for t in v)
                    for k, v in out.items()},
                   os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        mesh.shutdown()


def locality_layout(nd: int):
    """The -mesh-locality layout of sweep_inputs' links on nd ranks: (n
    padded, locality_edge_layout's (edges, mask, exp_idx, info))."""
    from svinet_torch.parallel.locality import locality_edge_layout
    edges = sweep_inputs()[0]
    n_pad = -(-N // nd) * nd
    return n_pad, locality_edge_layout(edges, n_pad, nd, BLOCK)


def _locality(g, rank, nd, dev):
    """The locality sweep of this rank (mesh.LocalityComm): SWEEPS sweeps
    a boundary, 1 and 3 boundaries, f32 and bf16 rows, while annealing."""
    from svinet_torch.ops.edges import build_adjacency
    from svinet_torch.parallel import mesh
    from svinet_torch.parallel.mesh import LocalityComm
    from svinet_torch.svi.linksampling import SweepExtras, sweep_ho_trace
    from svinet_torch.svi.sweep_math import LSConsts
    edges, deg, gamma0, lam0, consts, vp, vy = sweep_inputs()
    c = LSConsts.make(*consts)
    n_pad, (es, ms, exp_idx, info) = locality_layout(nd)
    per, xmax, rows_per = info["per_shard"], info["xmax"], info["rows_per"]
    mine = slice(rank * per, (rank + 1) * per)
    adj = build_adjacency(es[mine][ms[mine] > 0], rows_per + nd * xmax, dev)
    rows = slice(rank * rows_per, (rank + 1) * rows_per)
    gam = np.full((n_pad, K), consts[0], np.float32)
    gam[:N] = gamma0
    dg = np.zeros(n_pad, np.float32)
    dg[:N] = deg
    hidx, pp, yy, ww, nb = mesh.rowshard_heldout_layout(vp, vy, n_pad, nd)
    h, t = len(hidx) // nd, len(pp) // nd
    real = es[ms > 0]
    used = np.zeros(nd * xmax, bool)
    used[real[real >= rows_per] - rows_per] = True
    comm = LocalityComm(
        g, torch.as_tensor(hidx[rank * h:(rank + 1) * h].astype(np.int64)),
        torch.as_tensor(exp_idx[rank * xmax:(rank + 1) * xmax]
                        .astype(np.int64)),
        int(used[rank * xmax:(rank + 1) * xmax].sum()))
    hp, hy, hw = (torch.as_tensor(a[rank * t:(rank + 1) * t])
                  for a in (pp, yy, ww))
    out = {}
    for bf16 in (False, True):
        for nbat in (1, 3):
            gg, ll, mm, trace, _ = sweep_ho_trace(
                torch.as_tensor(gam[rows]).clone(), torch.as_tensor(lam0),
                torch.zeros((rows_per, K)), adj, torch.as_tensor(dg[rows]),
                c, True, hp, hy, hw, EPS, SWEEPS, nbat, nb, True,
                SweepExtras(bf16=bf16), comm)
            out[f"loc-trace{nbat}" + ("-bf16" if bf16 else "")] = (
                gg, ll, trace, mm)
    return out


def run_locality(rank: int, nd: int, init: str, outdir: str) -> None:
    """A spawned rank: the locality cases, saved to outdir/rank<r>.pt."""
    from svinet_torch.parallel import mesh
    torch.set_num_threads(1)
    g = mesh.init_group(rank, nd, "cpu", "gloo", init)
    try:
        out = _locality(g, rank, nd, torch.device("cpu"))
        torch.save({k: tuple(t.detach().float() for t in v)
                    for k, v in out.items()},
                   os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        mesh.shutdown()
