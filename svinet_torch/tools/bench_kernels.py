"""Time the present kernels beside their earlier and alternative designs,
in one process on one card.

    python -m svinet_torch.tools.bench_kernels [--quick] [--no-stretch]
                                               [--out DIR]

Kernel 1 (Dirichlet expectation): the present csrc/dirichlet_expectation.cu
against its first version (csrc/alt/dirichlet_v1.cu). Kernel 2 (phi pass):
the present pull kernel (csrc/phi_pass.cu) against the first version,
which pushes phi into both endpoint rows with atomics
(csrc/alt/phi_edge_atomic.cu), and against the half-push design
(csrc/alt/phi_half_push.cu), at n=20k, K=20 with 200k uniform random
links, at shapes between that one and n=1M (n=50k to 300k, K=20 to 500),
at n=1M with 10M links and K=20, 64, 128 and 256, and at n=1M, K=500
with 2M and (unless --no-stretch) 20M. At the same shapes, the passes that follow kernel 2 in a sweep: kernel 3 (the
mean-indicator update, csrc/mean_indicator.cu) beside its plain version;
kernel 4 (s3, csrc/s3_pass.cu) beside the plain blocked edge-list pass;
and kernel 5 (the fused phi + s3 pass of -fuse-s3) beside kernel 2
followed by kernel 4, which read the same rows in two walks. Every
design is first held to the plain PyTorch version, then the designs are
timed in turns (a, b, c, c, b, a) with CUDA events. Last, one report
interval of the engine (a sweep and the heldout tail) on a planted n=20k,
K=20 graph, default and -fuse-s3, run eagerly and as replays of one
torch.cuda.CUDAGraph: host time per interval of each, whether the two end
in the same bits, and the launch counts a replay does not advance. The
engine captures no graph; this is the measurement behind that. At every
shape the forms of -bf16 and -freeze are timed beside the f32 kernels:
kernels 2, 4 and 5 over bf16 rows (kernel 5 again beside kernel 2 then
kernel 4, which is what sweep_math.FUSED_MAX_WORK decides between), and
kernels 2 and 4 with 40% of the nodes frozen to random columns, and kernel
2 over bf16 rows as built (exp as __expf) beside a second build of the same
source with expf. Last but one, a -prune sweep: the whole sweep at full K beside the same sweep over
the state compacted to K_pad columns. Kernel 4 also beside the slab
design around the L2 that is kept off the path (csrc/alt/s3_slab.cu through
tools/s3_slab.py), at n = 250k to 2M with K = 500 and 20 links a node and
at narrower shapes; kernel 5 against kernel 2 then kernel 4 around
sweep_math.FUSED_MAX_WORK; kernel 6 (the held-out sums) beside the plain
tail it replaces; the card's rate for random 32-byte sectors of a 2 GB
array with 1, 2, 4 and 8 loads of 4 or 8 bytes in flight a lane
(csrc/alt/sector_probe.cu); -sparse-w's top-W form of kernel 1 and kernel
7 (the union pass, csrc/sparse_union.cu) against the first designs of both
(csrc/alt/topw_v1.cu, csrc/alt/sparse_union_v1.cu), against kernel 1,
kernel 2 then kernel 4 (the dense passes they replace) and as whole
sweeps, at W = 8, 16, 32, 64 on the stretch graph (n=1M, K=500, 20M links;
the engine's state after three annealing sweeps and a late-fit state) and
on the planted n=20k graph at K = 500, 2000 and 8000, with kernel 7's
registers, shared memory and warps an SM; kernel 8 (MMSBInfer's per-pair
phi fixed point) against its first design (csrc/alt/phi_fixed_point_v1.cu,
which stops each pair on its own), split by kernel, and an MMSBInfer step
with each, at n=1M, K=500 (random pairs, -rnode, the stretch engine's
state), n=20k at K = 20, 1024, 2000, and its ELBO form. --only names the
parts to run (sectors, sparse, fixedpoint, ...). --quick
builds, launches every kernel once at these widths, compares and stops.

Prints the card and its power limit first; writes the compiler's report
to DIR/ptxas.log and the results to DIR/bench_kernels.json (DIR defaults
to build/svinet_torch).
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from svinet_torch.kernels import build
from svinet_torch.ops.digamma import (
    dirichlet_expectation, dirichlet_expectation_plain,
    dirichlet_expectation_topw, dirichlet_expectation_topw_plain)
from svinet_torch.ops.edges import (
    build_adjacency, choose_edge_block, pad_edges)
from svinet_torch.svi.linksampling import (
    SweepExtras, compact_columns, from_edges, init_gamma_from_links_device,
    sweep, sweep_ho_trace)
from svinet_torch.evals.likelihood import (
    _pi_beta, heldout_sums, heldout_sums_from_pi, heldout_sums_rows_plain)
from svinet_torch.svi.sweep_math import (
    LSConsts, fused_phi_s3_pass, fused_phi_s3_pass_pull_plain,
    mean_indicator_update, mean_indicator_update_plain, phi_pass,
    phi_pass_pull_plain, s3_pass, s3_pass_plain, s3_pass_pull_plain,
    sparse_union_occupancy, sparse_union_pass, sparse_union_pass_pull_plain,
    sparse_union_sweep, union_rows)
from svinet_torch.synth import planted_blocks, random_edges
from svinet_torch.tools import s3_slab

_P, _I64, _I32, _F32 = build._P, build._I64, build._I32, build._F32
ALT_SIGNATURES = {
    "svt_dirichlet_expectation_v1": (_P, _P, _I64, _I32, _P),
    # the first designs of the top-W form and kernel 7 (csrc/alt/topw_v1.cu,
    # csrc/alt/sparse_union_v1.cu): x, out, ids, topvals, rows, k, w; and
    # elogpi, ids, topvals, elb0, mphi, the seven adjacency arrays,
    # seg_rows, partial, gacc, sumk, s3, n, n_hubs, n_segs, k, w, seg_len
    "svt_dirichlet_topw_v1": (_P, _P, _P, _P, _I64, _I32, _I32, _P),
    "svt_sparse_union_v1": (_P,) * 17 + (_I64, _I64, _I64, _I32, _I32, _I32,
                                         _P),
    # csrc/alt/sector_probe.cu: src, log2 of its sectors, bytes a load,
    # loads in flight a lane, rounds, seed, out, threads launched (out)
    "svt_sector_probe": (_P, _I32, _I32, _I32, _I32, _I32, _P, _P, _P),
    # src, log2 of its sectors, pattern, requests in flight, rounds, seed,
    # out, threads (out); and dst, values, layout
    "svt_sector_pair_probe": (_P, _I32, _I32, _I32, _I32, _I32, _P, _P, _P),
    # src, rows, k, bytes an element, lanes a row, rounds in flight, rounds,
    # seed, out, threads (out)
    "svt_row_probe": (_P, _I64, _I32, _I32, _I32, _I32, _I32, _I32, _P, _P,
                      _P),
    "svt_write_probe": (_P, _I64, _I32, _P),
    # kernel 8 as first designed (csrc/alt/phi_fixed_point_v1.cu): the
    # arguments svt_phi_fixed_point took then; its info (6 ints out)
    "svt_phi_fixed_point_v1": (_P,) * 18 + (_I64, _I64, _I64, _I64, _I32,
                                            _I32, _I32, _F32, _F32, _I32, _P),
    "svt_phi_fixed_point_v1_info": (_P,),
    # kernel 9 as PR 8 designed it (csrc/alt/edge_assign_v1.cu): the
    # library's arguments
    "svt_edge_assign_v1": build.SIGNATURES["svt_edge_assign"],
    "svt_phi_pass_edge_atomic": (_P, _P, _P, _P, _P, _I64, _I32, _P),
    "svt_phi_half_push": (_P, _P, _P, _P, _P, _I64, _I32, _P),
    **s3_slab.SIGNATURES,
}


def log(msg: str) -> None:
    print(msg, flush=True)


def alt_library() -> build.Library:
    srcs = sorted((build.CSRC / "alt").glob("*.cu")) + [
        build.CSRC / "runtime.cu"]
    return build.build_library("svinet_torch_alt", srcs, ALT_SIGNATURES)


@functools.cache
def exact_exp_library() -> build.Library:
    """Kernels 2 and 5 over bf16 rows built with expf in place of the
    __expf the package's build gives them (csrc/phi_pull.cuh)."""
    names = ("svt_phi_pass_bf16", "svt_phi_s3_pass_bf16")
    return build.build_library(
        "svinet_torch_exact_exp",
        [build.CSRC / "phi_pass_bf16.cu", build.CSRC / "runtime.cu"],
        {name: build.SIGNATURES[name] for name in names},
        defines=("SVT_EXACT_EXP",))


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def phi_bf16_entry(lib: build.Library, elogpi_b, elb0, adj):
    """A call of `lib`'s svt_phi_pass_bf16 into fixed buffers, returning
    gacc: the kernel alone, without the wrapper's allocations."""
    n, k = elogpi_b.shape
    n_hubs, n_segs = adj.hub_node.shape[0], adj.seg_node.shape[0]
    gacc = torch.empty((n, k), dtype=torch.float32, device="cuda")
    sumk = torch.empty(k, dtype=torch.float32, device="cuda")
    partial = torch.empty((n_segs, k), dtype=torch.float32, device="cuda")
    sumk_partial = torch.empty((build.REDUCE_SCRATCH_ROWS, k),
                               dtype=torch.float32, device="cuda")

    def call():
        lib.call("svt_phi_pass_bf16", elogpi_b.data_ptr(), elb0.data_ptr(),
                 None, *(t.data_ptr() for t in adj.tensors()),
                 partial.data_ptr(), gacc.data_ptr(), sumk_partial.data_ptr(),
                 sumk.data_ptr(), n, n_hubs, n_segs, k, adj.seg_len, stream())
        return gacc

    return call


def timed(fns: dict, reps: int) -> dict:
    """Mean ms of each fn over reps launches, the fns taken in turns
    forwards then backwards so that none always runs on a warmer card."""
    names = list(fns)
    total = {name: 0.0 for name in names}
    for name in names:
        fns[name]()
    torch.cuda.synchronize()
    for order in (names, names[::-1]):
        for name in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fns[name]()
            end.record()
            torch.cuda.synchronize()
            total[name] += start.elapsed_time(end) / reps / 2
    return total


def bench_dirichlet(lib, alt, quick: bool) -> list:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows_out = []
    for rows, k in ((1_000_000, 500), (17_903, 20), (500, 2)):
        x = 0.01 + 9.99 * torch.rand((rows, k), generator=gen, device="cuda")
        out_v1 = torch.empty_like(x)

        def v1():
            alt.call("svt_dirichlet_expectation_v1", x.data_ptr(),
                     out_v1.data_ptr(), rows, k, stream())

        def present():
            # the entry point itself, as v1 is called: at the small shapes
            # the wrapper's checks and allocation cost more than the kernel
            lib.call("svt_dirichlet_expectation", x.data_ptr(),
                     out_v1.data_ptr(), rows, k, 0.0, 0, stream())

        v1()
        want = dirichlet_expectation_plain(x)
        got = dirichlet_expectation(x)
        torch.cuda.synchronize()
        errs = {"v1": float((out_v1 - want).abs().max()),
                "present": float((got - want).abs().max())}
        assert max(errs.values()) < 5e-5, errs
        row = {"kernel": "dirichlet_expectation", "shape": [rows, k],
               "max_abs_err_vs_plain": errs}
        if not quick:
            row["ms"] = timed({
                "v1": v1, "present": present,
                "present_wrapper": lambda: dirichlet_expectation(x),
                "present_bf16_out": lambda: dirichlet_expectation(
                    x, out_dtype=torch.bfloat16),
                "present_then_cast": lambda: dirichlet_expectation(x).to(
                    torch.bfloat16),
                "plain": lambda: dirichlet_expectation_plain(x)},
                20 if rows * k >= 10**7 else 200)
        log(json.dumps(row))
        rows_out.append(row)
        del x, out_v1, want, got
    return rows_out


def forward_adjacency(links: np.ndarray, n: int):
    """CSR of the links p < q listed under p only (the half-push input)."""
    e = torch.as_tensor(links, device="cuda").long()
    key = torch.sort(e[:, 0] * n + e[:, 1]).values
    owner = key // n
    rowptr = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
    torch.cumsum(torch.bincount(owner, minlength=n), 0, out=rowptr[1:])
    return rowptr.to(torch.int32), (key - owner * n).to(torch.int32)


def bench_phi(alt, n: int, k: int, n_edges: int, quick: bool) -> list:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    links = np.unique(random_edges(n, n_edges, 2), axis=0)
    block = choose_edge_block(len(links), k)
    edges_np, mask_np = pad_edges(links, block)
    edges = torch.as_tensor(edges_np, device="cuda")
    mask = torch.as_tensor(mask_np, device="cuda")
    adj = build_adjacency(links, n, "cuda")
    f_rowptr, f_nbr = forward_adjacency(links, n)
    gamma = 0.01 + 9.99 * torch.rand((n, k), generator=gen, device="cuda")
    elogpi = dirichlet_expectation_plain(gamma)
    del gamma
    lam = 0.5 + 4.5 * torch.rand((k, 2), generator=gen, device="cuda")
    elb0 = dirichlet_expectation_plain(lam)[:, 0].contiguous()

    def edge_atomic():
        gacc = torch.zeros((n, k), dtype=torch.float32, device="cuda")
        alt.call("svt_phi_pass_edge_atomic", elogpi.data_ptr(),
                 elb0.data_ptr(), edges.data_ptr(), mask.data_ptr(),
                 gacc.data_ptr(), edges.shape[0], k, stream())
        return gacc

    def half_push():
        gacc = torch.zeros((n, k), dtype=torch.float32, device="cuda")
        alt.call("svt_phi_half_push", elogpi.data_ptr(), elb0.data_ptr(),
                 f_rowptr.data_ptr(), f_nbr.data_ptr(), gacc.data_ptr(), n,
                 k, stream())
        return gacc

    def pull():
        return phi_pass(elogpi, elb0, adj)[0]

    want, _ = phi_pass_pull_plain(elogpi, elb0, adj, block)
    errs = {}
    for name, fn in (("edge_atomic", edge_atomic), ("half_push", half_push),
                     ("pull", pull)):
        got = fn()
        torch.cuda.synchronize()
        errs[name] = float((got - want).abs().max())
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), (name, errs)
        del got
    row = {"kernel": "phi_pass", "n": n, "k": k, "links": len(links),
           "max_abs_err_vs_plain": errs}
    if not quick:
        gacc = want
        row["ms"] = timed({
            "edge_atomic": edge_atomic, "half_push": half_push,
            "pull": pull,
            # what surrounds the kernels: the zero-fill the push designs
            # need, and the column sum that gives sumk
            "zero_fill": lambda: gacc.zero_(),
            "gacc_sum0": lambda: gacc.sum(dim=0)},
            3 if n * k >= 10**7 else 100)
        row["ms"]["plain"] = timed(
            {"plain": lambda: phi_pass_pull_plain(elogpi, elb0, adj, block)},
            1)["plain"]
    log(json.dumps(row))
    del want
    return [row, bench_after_phi(links, n, k, edges, mask, block, adj, elogpi,
                                 elb0, gen, quick)]


def bench_after_phi(links, n, k, edges, mask, block, adj, elogpi, elb0, gen,
                    quick: bool) -> dict:
    """Kernels 3, 4 and 5 on the inputs of bench_phi: gacc and sumk are
    kernel 2's output, mphi is kernel 3's."""
    tol = dict(rtol=1e-4, atol=1e-4)
    nb = edges.shape[0] // block
    deg = torch.as_tensor(
        np.bincount(links.ravel(), minlength=n).astype(np.float32),
        device="cuda")
    consts = LSConsts.make(1.0 / k, 1.0, 1.0, len(links), n)
    gacc, sumk = phi_pass(elogpi, elb0, adj)
    errs = {}
    for annealing in (False, True):
        got = mean_indicator_update(gacc.clone(), sumk, deg, consts, annealing)
        again = mean_indicator_update(gacc.clone(), sumk, deg, consts,
                                      annealing)
        want = mean_indicator_update_plain(gacc.clone(), sumk, deg, consts,
                                           annealing)
        torch.cuda.synchronize()
        for name, a, b, c in zip(("gnext", "mphi", "s1", "s2", "lam0"), got,
                                 again, want):
            assert torch.equal(a, b), (name, "two launches differ")
            errs[f"{name}_anneal{int(annealing)}"] = float(
                ((a - c).abs() / c.abs().clamp_min(1.0)).max())
            assert torch.allclose(a, c, **tol), (name, annealing, errs)
        del again, want
    mphi = got[1].clone()
    del got
    s3_k = s3_pass(mphi, adj)
    assert torch.equal(s3_k, s3_pass(mphi, adj))
    s3_p = s3_pass_pull_plain(mphi, adj, block)
    s3_e = s3_pass_plain(mphi, edges, mask, nb)
    errs["s3_vs_pull_plain"] = float(((s3_k - s3_p).abs() / s3_p.abs()).max())
    assert torch.allclose(s3_k, s3_p, **tol), errs
    assert torch.allclose(s3_k, s3_e, **tol), errs
    f_g, f_s, f_3 = fused_phi_s3_pass(elogpi, mphi, elb0, adj, True)
    f_g2, _, f_32 = fused_phi_s3_pass(elogpi, mphi, elb0, adj, True)
    assert torch.equal(f_g, f_g2) and torch.equal(f_3, f_32)
    del f_g2
    p_g, p_s, p_3 = fused_phi_s3_pass_pull_plain(elogpi, mphi, elb0, adj,
                                                 block)
    errs["fused_gacc"] = float((f_g - p_g).abs().max())
    errs["fused_s3"] = float(((f_3 - p_3).abs() / p_3.abs()).max())
    assert torch.allclose(f_g, p_g, **tol), errs
    assert torch.allclose(f_s, p_s, **tol), errs
    assert torch.allclose(f_3, p_3, **tol), errs
    # kernel 5 against kernel 2 followed by kernel 4
    assert torch.allclose(f_g, gacc, **tol) and torch.allclose(f_3, s3_k, **tol)
    del f_g, p_g
    row = {"kernel": "mean_indicator, s3_pass, fused_phi_s3_pass", "n": n,
           "k": k, "links": len(links), "max_rel_err_vs_plain": errs}
    if not quick:
        big = n * k >= 10**7
        # the update is in place, so repeated launches run on values that
        # grow past f32; the card's arithmetic takes the same time on them
        row["ms"] = timed({
            "mean_indicator": lambda: mean_indicator_update(
                gacc, sumk, deg, consts, True, mphi_out=mphi),
            "mean_indicator_plain": lambda: mean_indicator_update_plain(
                gacc, sumk, deg, consts, True)}, 3 if big else 100)
        mphi = torch.rand((n, k), generator=gen, device="cuda") / k
        row["ms"].update(timed({
            "s3": lambda: s3_pass(mphi, adj),
            "phi": lambda: phi_pass(elogpi, elb0, adj),
            # the one launch, whatever the wrapper would choose
            "fused_phi_s3": lambda: fused_phi_s3_pass(elogpi, mphi, elb0,
                                                      adj, True),
            "phi_then_s3": lambda: (phi_pass(elogpi, elb0, adj),
                                    s3_pass(mphi, adj))},
            3 if big else 100))
        row["ms"]["s3_plain_edge_list"] = timed(
            {"p": lambda: s3_pass_plain(mphi, edges, mask, nb)}, 1)["p"]
        # the same passes over bf16 rows, and with 40% of the nodes frozen
        # to random columns (48% of the links then have one frozen end and
        # fetch no row)
        elogpi_b, mphi_b = elogpi.to(torch.bfloat16), mphi.to(torch.bfloat16)
        conv = torch.where(
            torch.rand(n, generator=gen, device="cuda") < 0.4,
            torch.randint(1, k + 1, (n,), generator=gen, device="cuda"),
            0).to(torch.int32)
        # kernel 2 over bf16 rows as built (exp as __expf) beside the same
        # source built with expf, both through the bare entry point
        fast_exp = phi_bf16_entry(build.library(), elogpi_b, elb0, adj)
        exact_exp = phi_bf16_entry(exact_exp_library(), elogpi_b, elb0, adj)
        row["max_abs_diff_gacc_fast_exp_vs_expf"] = float(
            (fast_exp() - exact_exp()).abs().max())
        assert row["max_abs_diff_gacc_fast_exp_vs_expf"] < 1e-4, row
        row["ms"].update(timed({
            "phi_bf16_entry_fast_exp": fast_exp,
            "phi_bf16_entry_expf": exact_exp}, 3 if big else 100))
        del fast_exp, exact_exp
        row["ms"].update(timed({
            "phi_bf16": lambda: phi_pass(elogpi_b, elb0, adj),
            "s3_bf16": lambda: s3_pass(mphi_b, adj),
            "fused_phi_s3_bf16": lambda: fused_phi_s3_pass(
                elogpi_b, mphi_b, elb0, adj, True),
            "phi_then_s3_bf16": lambda: (phi_pass(elogpi_b, elb0, adj),
                                         s3_pass(mphi_b, adj)),
            "phi_conv": lambda: phi_pass(elogpi, elb0, adj, conv),
            "s3_conv": lambda: s3_pass(mphi, adj, conv),
            "phi_bf16_conv": lambda: phi_pass(elogpi_b, elb0, adj, conv),
            "s3_bf16_conv": lambda: s3_pass(mphi_b, adj, conv)},
            3 if big else 100))
    log(json.dumps(row))
    return row


def bench_compact_sweep(n: int, k: int, n_edges: int, alive: int) -> dict:
    """One whole sweep (kernels 1 to 4) at full width K beside the same
    sweep over the state compacted to its `alive` active columns, padded
    to a power of two (-prune): ms per sweep of each."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    links = np.unique(random_edges(n, n_edges, 4), axis=0)
    adj = build_adjacency(links, n, "cuda")
    deg = torch.as_tensor(
        np.bincount(links.ravel(), minlength=n).astype(np.float32),
        device="cuda")
    consts = LSConsts.make(1.0 / k, 1.0, 1.0, len(links), n)
    gamma = torch.full((n, k), consts.alpha, device="cuda")
    gamma[:, :alive] += 5.0 * torch.rand((n, alive), generator=gen,
                                         device="cuda")
    lam = torch.ones((k, 2), device="cuda")
    lam[:alive] += torch.rand((alive, 2), generator=gen, device="cuda")
    kpad = max(8, 1 << int(np.ceil(np.log2(alive))))
    idx = torch.full((kpad,), k, dtype=torch.int32, device="cuda")
    idx[:alive] = torch.arange(alive, dtype=torch.int32, device="cuda")
    colmask = (torch.arange(kpad, device="cuda") < alive).float()
    gamma_c, lam_c = compact_columns(gamma, lam, idx, colmask, consts.alpha,
                                     (consts.eta0, consts.eta1))
    x = SweepExtras(colmask=colmask,
                    rest=float(np.float32((k - kpad) * consts.alpha)))
    full_g, full_l = sweep(gamma, lam, adj, deg, consts, False)
    comp_g, comp_l, _ = sweep(gamma_c, lam_c, adj, deg, consts, False, x)
    torch.cuda.synchronize()
    err = float((comp_g[:, :alive] - full_g[:, :alive]).abs().max()
                / full_g[:, :alive].abs().max())
    assert err < 2e-3, err
    del full_g, comp_g
    ms = timed({"full": lambda: sweep(gamma, lam, adj, deg, consts, False),
                "compacted": lambda: sweep(gamma_c, lam_c, adj, deg, consts,
                                           False, x)}, 3)
    row = {"kernel": "sweep, full width and compacted (-prune)", "n": n,
           "k": k, "links": len(links), "alive": alive, "k_pad": kpad,
           "max_rel_diff_alive_columns": err, "ms_per_sweep": ms}
    log(json.dumps(row))
    return row


def bench_graph_capture(n: int, k: int, intervals: int) -> list:
    """Report intervals of one sweep and the heldout tail on a planted
    graph from the engine's initial state, eagerly and as replays of one
    CUDA graph captured over fixed state buffers; the device is
    synchronised once, by the copy of all heldout rows, as a batch is."""
    wrappers = (dirichlet_expectation, phi_pass, mean_indicator_update,
                s3_pass, fused_phi_s3_pass)
    raw, _ = planted_blocks(n, k, 20, 7)
    out = []
    for fused in (False, True):
        with tempfile.TemporaryDirectory() as workdir:
            eng = from_edges(raw, n, k, torch.device("cuda", 0), workdir,
                             fuse_s3=fused)
            eng.close()
        net = eng.network
        pairs, w = pad_edges(net.validation_pairs, len(net.validation_pairs))
        ho = [torch.as_tensor(a, device="cuda") for a in
              (pairs, net.validation_y.astype(np.int32), w)]

        def interval(gamma, lam, mphi):
            return sweep_ho_trace(gamma, lam, mphi, eng.adj, eng.deg,
                                  eng.consts, True, *ho, eng.cfg.epsilon, 1,
                                  1, 1, fused)

        def start():
            return (eng.gamma.clone(), eng.lam.clone(),
                    eng.mphi.clone() if fused else None)

        def eager():
            gamma, lam, mphi = start()
            rows = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(intervals):
                gamma, lam, mphi, trace = interval(gamma, lam, mphi)
                rows.append(trace[0])
            rows = torch.stack(rows).cpu()
            ms = (time.perf_counter() - t0) * 1e3 / intervals
            return ms, (gamma, lam, mphi, rows)

        eager()                                    # builds, warms up
        eager_ms, want = eager()
        gamma, lam, mphi = start()
        sums = torch.zeros(6, dtype=torch.float32, device="cuda")
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            # -fuse-s3 updates mphi in place; gamma and lambda are copied
            # back into the buffers the next replay reads
            new_gamma, new_lam, _, trace = interval(gamma, lam, mphi)
            gamma.copy_(new_gamma)
            lam.copy_(new_lam)
            sums.copy_(trace[0])
        torch.cuda.synchronize()
        capture_ms = (time.perf_counter() - t0) * 1e3
        rows = torch.empty((intervals, 6), dtype=torch.float32, device="cuda")
        before = [fn.launches for fn in wrappers]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(intervals):
            graph.replay()
            rows[i].copy_(sums)
        rows = rows.cpu()
        replay_ms = (time.perf_counter() - t0) * 1e3 / intervals
        counted = sum(fn.launches - b for fn, b in zip(wrappers, before))
        eager_ms_again, _ = eager()
        row = {"kernel": "report interval, eager and CUDA graph",
               "flags": "-fuse-s3" if fused else "default", "n": n, "k": k,
               "intervals": intervals,
               "ms_per_interval": {"eager": eager_ms, "replay": replay_ms,
                                   "eager_again": eager_ms_again},
               "capture_ms": capture_ms,
               "bitwise_equal": all(
                   a is None or torch.equal(a, b)
                   for a, b in zip(want, (gamma, lam, mphi, rows))),
               "launches_counted_in_replays": counted}
        log(json.dumps(row))
        out.append(row)
    return out


def bench_s3_forms(alt, n: int, k: int, n_edges: int, quick: bool) -> dict:
    """Kernel 4 (the pull kernel) beside the slab design kept in
    csrc/alt/s3_slab.cu, over f32 and bf16 rows and with 40% of the nodes
    frozen: the slab kernel at every row width whose slab is smaller than
    the L2, copied slab-major through its scratch (one cooperative launch
    a batch of slabs, or a launch a slab), gathering from a slab-major
    array made beforehand (the copy's cost is the difference), in place
    from the row-major array, with one or two 16-byte units of a row to a
    lane, and without the L2 policy. Every variant is held to the pull
    kernel at 1e-4 and to its own second launch bit for bit."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    links = np.unique(random_edges(n, n_edges, 6), axis=0)
    adj = build_adjacency(links, n, "cuda")
    fwd = s3_slab.forward_lists(adj)
    mphi = torch.rand((n, k), generator=gen, device="cuda") / k
    conv = torch.where(
        torch.rand(n, generator=gen, device="cuda") < 0.4,
        torch.randint(1, k + 1, (n,), generator=gen, device="cuda"),
        0).to(torch.int32)
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    row = {"kernel": "s3_pass, the pull kernel and the slab design", "n": n,
           "k": k, "links": len(links), "l2_bytes": l2, "ms": {},
           "max_rel_err": {}}

    def slab(rows, b, cv=None, **how):
        return s3_slab.s3_slab_pass(alt, rows, fwd, b, cv, **how)

    for name, rows in (("f32", mphi), ("bf16", mphi.to(torch.bfloat16))):
        size = rows.element_size()
        widths = [b for b in (32, 64, 128)
                  if n * b <= l2 and 2 * b <= k * size]
        fns = {f"{name}_pull": lambda rows=rows: s3_pass(rows, adj)}
        for b in widths:
            given = s3_slab.to_slabs(rows, b)
            for lanes in (1, 2):
                tag = f"{name}_slab{b}" + ("_lane2" if lanes == 2 else "")
                fns[tag] = (lambda rows=rows, b=b, lanes=lanes: slab(
                    rows, b, lane_units=lanes, persistent=False))
                fns[tag + "_given"] = (
                    lambda given=given, b=b, lanes=lanes: slab(
                        given, b, layout="slabs", k=k, lane_units=lanes,
                        persistent=False))
            # two units a lane, one cooperative launch a batch of slabs
            fns[f"{name}_slab{b}_lane2_persistent"] = (
                lambda rows=rows, b=b: slab(rows, b))
            fns[f"{name}_slab{b}_lane2_given_persistent"] = (
                lambda given=given, b=b: slab(given, b, layout="slabs", k=k))
            if b == 32:
                fns[f"{name}_slab32_lane2_nohint"] = (
                    lambda rows=rows: slab(rows, 32, hint=False))
            if k * size % 16 == 0:
                fns[f"{name}_slab{b}_lane2_strided"] = (
                    lambda rows=rows, b=b: slab(rows, b, layout="strided",
                                                persistent=False))
        fns[f"{name}_conv_pull"] = (
            lambda rows=rows: s3_pass(rows, adj, conv))
        for b in widths:
            fns[f"{name}_conv_slab{b}_lane2"] = (
                lambda rows=rows, b=b: slab(rows, b, conv))
        want = {False: s3_pass(rows, adj), True: s3_pass(rows, adj, conv)}
        for fname, fn in fns.items():
            got, again = fn(), fn()
            torch.cuda.synchronize()
            ref = want["conv" in fname]
            err = float(((got - ref).abs() / ref.abs().clamp_min(1.0)).max())
            row["max_rel_err"][fname] = err
            assert torch.equal(got, again), (fname, "two launches differ")
            assert torch.allclose(got, ref, rtol=1e-4, atol=1e-4), (fname, err)
        if n * k <= 10**7:
            block = choose_edge_block(2 * len(links), k)
            for cv in (None, conv):
                plain = s3_slab.s3_pass_slab_plain(rows, fwd, 32 // size,
                                                   block, cv)
                assert torch.allclose(want[cv is not None], plain, rtol=1e-4,
                                      atol=1e-4), (name, cv is not None)
        if not quick:
            row["ms"].update(timed(fns, 3 if n * k >= 10**7 else 50))
    # the rate at which the L2 served the gathered sectors: the links'
    # gathered bytes over the time of the passes over a ready slab-major
    # array
    row["l2_gather_tb_s"] = {
        name: len(links) * k * (4 if name.startswith("f32") else 2)
        / (ms * 1e-3) / 1e12
        for name, ms in row["ms"].items() if "_given" in name}
    log(json.dumps(row))
    return row


def bench_fused_crossover(n: int, k: int, n_edges: int) -> dict:
    """Kernel 5 in one launch against kernel 2 then kernel 4, f32 and bf16
    rows: what sweep_math.FUSED_MAX_WORK decides between."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    links = np.unique(random_edges(n, n_edges, 8), axis=0)
    adj = build_adjacency(links, n, "cuda")
    gamma = 0.01 + 9.99 * torch.rand((n, k), generator=gen, device="cuda")
    elogpi = dirichlet_expectation_plain(gamma)
    del gamma
    lam = 0.5 + 4.5 * torch.rand((k, 2), generator=gen, device="cuda")
    elb0 = dirichlet_expectation_plain(lam)[:, 0].contiguous()
    mphi = torch.rand((n, k), generator=gen, device="cuda") / k
    bf = torch.bfloat16
    elogpi_b, mphi_b = elogpi.to(bf), mphi.to(bf)
    ms = timed({
        "fused": lambda: fused_phi_s3_pass(elogpi, mphi, elb0, adj, True),
        "phi_then_s3": lambda: fused_phi_s3_pass(elogpi, mphi, elb0, adj,
                                                 False),
        "fused_bf16": lambda: fused_phi_s3_pass(elogpi_b, mphi_b, elb0, adj,
                                                True),
        "phi_then_s3_bf16": lambda: fused_phi_s3_pass(elogpi_b, mphi_b, elb0,
                                                      adj, False)},
        3 if n * k >= 10**7 else 200)
    row = {"kernel": "fused_phi_s3_pass against phi_pass then s3_pass",
           "n": n, "k": k, "links": len(links),
           "gathered_values": 2 * len(links) * k, "ms": ms}
    log(json.dumps(row))
    return row


def bench_heldout(n: int, k: int, n_pairs: int, quick: bool) -> dict:
    """Kernel 6 beside the plain tail it replaces (the (n,K) pi, then the
    blocked sums) and beside its own arithmetic in plain PyTorch; the six
    sums of the three within 1e-5 relative."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    gamma = 0.002 + torch.rand((n, k), generator=gen, device="cuda") ** 8 * 40
    lam = 0.5 + 4.5 * torch.rand((k, 2), generator=gen, device="cuda")
    block = min(1 << 17, max(64, 1 << int(np.ceil(np.log2(n_pairs)))))
    padded = -(-n_pairs // block) * block
    pairs = torch.zeros((padded, 2), dtype=torch.int32, device="cuda")
    pairs[:n_pairs] = torch.randint(0, n, (n_pairs, 2), generator=gen,
                                    device="cuda")
    y = torch.zeros(padded, dtype=torch.int32, device="cuda")
    y[:n_pairs:2] = 1
    w = (torch.arange(padded, device="cuda") < n_pairs).float()
    nb = padded // block
    eps = 1e-30

    def plain_tail():
        pi, beta = _pi_beta(gamma, lam)
        return heldout_sums_from_pi(pi, beta, pairs, y, w, eps, nb)

    got = heldout_sums(gamma, lam, pairs, y, w, eps)
    again = heldout_sums(gamma, lam, pairs, y, w, eps)
    want = plain_tail()
    rows = heldout_sums_rows_plain(gamma, lam, pairs, y, w, eps, nb)
    torch.cuda.synchronize()
    assert torch.equal(got, again), "two launches differ"
    errs = {"vs_plain_tail": float(((got - want) / want).abs().max()),
            "vs_rows_plain": float(((got - rows) / rows).abs().max())}
    assert max(errs.values()) < 1e-5, (errs, got, want)
    row = {"kernel": "heldout_sums", "n": n, "k": k, "pairs": n_pairs,
           "padded_pairs": padded, "max_rel_err": errs}
    if not quick:
        row["ms"] = timed({
            "kernel": lambda: heldout_sums(gamma, lam, pairs, y, w, eps),
            "plain_tail": plain_tail,
            "rows_plain": lambda: heldout_sums_rows_plain(
                gamma, lam, pairs, y, w, eps, nb)},
            5 if n * k >= 10**7 else 100)
    log(json.dumps(row))
    return row


def _late_gamma(member, k: int, gen) -> torch.Tensor:
    """A state such as a fit with K far above the true number of
    communities reaches: each node's mass (about its degree, here 20) in
    its planted block's column and a little in three random ones, every
    other column at alpha = 1/K exactly."""
    n = member.shape[0]
    alpha = 1.0 / k
    gamma = torch.full((n, k), alpha, device="cuda")
    rows = torch.arange(n, device="cuda")
    home = torch.as_tensor(member, device="cuda").long() % k
    gamma[rows, home] += 16.0 + 4.0 * torch.rand(n, generator=gen,
                                                 device="cuda")
    for _ in range(3):
        col = torch.randint(0, k, (n,), generator=gen, device="cuda")
        gamma[rows, col] += torch.rand(n, generator=gen, device="cuda")
    return gamma


def _engine_gamma(links, adj, deg, n: int, k: int) -> torch.Tensor:
    """The state the engine holds when annealing ends early on a graph
    with no communities (chip_smoke.py phase 3 on the stretch shape): its
    device-side init (init_gamma_from_links_device, seed 0), then three
    annealing sweeps. No column is tied."""
    block = choose_edge_block(len(links), k)
    edges_np, mask_np = pad_edges(links, block)
    gamma = init_gamma_from_links_device(
        0, torch.as_tensor(edges_np, device="cuda"),
        torch.as_tensor(mask_np, device="cuda"), n, k, 1.0 / k,
        edges_np.shape[0] // block)
    lam = torch.tensor([[1.0, 1.0]] * k, device="cuda")
    consts = LSConsts.make(1.0 / k, 1.0, 1.0, len(links), n)
    for _ in range(3):
        gamma, lam = sweep(gamma, lam, adj, deg, consts, True)
    return gamma


def _sparse_v1_calls(alt, gamma, w, elb0, mphi, adj):
    """The first designs of the top-W form and kernel 7 (csrc/alt/) as
    calls into fixed
    buffers: (topw(), kernel7(), and the buffers (elogpi, ids, topvals,
    gacc, sumk, s3))."""
    n, k = gamma.shape
    n_hubs, n_segs = adj.hub_node.shape[0], adj.seg_node.shape[0]
    elogpi = torch.empty_like(gamma)
    ids = torch.empty((n, w), dtype=torch.int32, device="cuda")
    topvals = torch.empty((n, w), device="cuda")
    gacc = torch.empty_like(gamma)
    sumk = torch.empty(k, device="cuda")
    s3 = torch.empty(k, device="cuda")
    seg_rows = torch.empty((n_segs, k), device="cuda")
    partial = torch.empty((build.REDUCE_SCRATCH_ROWS, k), device="cuda")

    def topw():
        alt.call("svt_dirichlet_topw_v1", gamma.data_ptr(),
                 elogpi.data_ptr(), ids.data_ptr(), topvals.data_ptr(), n, k,
                 w, stream())

    def kernel7():
        alt.call("svt_sparse_union_v1", elogpi.data_ptr(), ids.data_ptr(),
                 topvals.data_ptr(), elb0.data_ptr(), mphi.data_ptr(),
                 *(t.data_ptr() for t in adj.tensors()), seg_rows.data_ptr(),
                 partial.data_ptr(), gacc.data_ptr(), sumk.data_ptr(),
                 s3.data_ptr(), n, n_hubs, n_segs, k, w, adj.seg_len,
                 stream())

    return topw, kernel7, (elogpi, ids, topvals, gacc, sumk, s3)


def bench_sparse(alt, label: str, links, member, n: int, k: int, widths,
                 quick: bool, states=("late-fit",)) -> list:
    """-sparse-w at each W of `widths` on one graph, in each of `states`
    ("late-fit": _late_gamma; "engine": _engine_gamma): the top-W form of
    kernel 1 then kernel 7 against the first designs of both (csrc/alt/) and
    against kernel 1, kernel 2 then kernel 4 (the passes they replace),
    and a whole sparse sweep against a whole dense unfused sweep;
    torch.topk beside the form as a yardstick (it orders ties otherwise).
    Each W's kernels are held to their plain versions (ids and topm
    exactly) and to the first designs; then all are timed in turns."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    adj = build_adjacency(links, n, "cuda")
    deg = torch.as_tensor(np.bincount(links.ravel(), minlength=n).astype(
        np.float32), device="cuda")
    lam = 0.5 + 4.5 * torch.rand((k, 2), generator=gen, device="cuda")
    elb0 = dirichlet_expectation(lam)[:, 0].contiguous()
    mphi = torch.rand((n, k), generator=gen, device="cuda") / k
    consts = LSConsts.make(1.0 / k, 1.0, 1.0, len(links), n)
    big = n * k >= 10**8
    reps = 2 if big else 10
    out = []
    for state in states:
        gamma = (_engine_gamma(links, adj, deg, n, k)
                 if state == "engine" else _late_gamma(member, k, gen))
        elogpi = dirichlet_expectation(gamma)
        dense = timed({
            "kernel1": lambda: dirichlet_expectation(gamma),
            "kernel2": lambda: phi_pass(elogpi, elb0, adj),
            "kernel4": lambda: s3_pass(mphi, adj),
            "dense_sweep": lambda: sweep(gamma, lam, adj, deg, consts,
                                         False)}, reps)
        del elogpi
        rows = union_rows(torch.zeros_like(gamma), mphi)
        for w in widths:
            _, ids, tv, tm = dirichlet_expectation_topw(gamma, w, pair=rows)
            _, ids_p, tv_p, tm_p = dirichlet_expectation_topw_plain(
                gamma, w, pair=rows.clone())
            assert torch.equal(ids, ids_p), (label, state, w)
            assert torch.equal(tm, tm_p), (label, state, w)
            # kernel 1's bar: 5e-5, or 2^-22 of the value (psi near -2000
            # at alpha = 1/2000)
            assert torch.allclose(tv, tv_p, rtol=2.0**-22, atol=5e-5), (
                label, state, w)
            del ids_p, tv_p, tm_p
            got = sparse_union_pass(rows, ids, tv, tm, elb0, adj)
            want = sparse_union_pass_pull_plain(
                rows, ids, tv, tm, elb0, adj,
                choose_edge_block(adj.nbr.shape[0], max(k, 2 * w)))
            for a, b in zip(got, want):
                assert torch.allclose(a, b, rtol=1e-4, atol=1e-4), (
                    label, state, w)
            del want
            topw_v1, k7_v1, v1_out = _sparse_v1_calls(alt, gamma, w, elb0,
                                                      mphi, adj)
            topw_v1()
            k7_v1()
            assert torch.equal(v1_out[1], ids), (label, state, w)
            for a, b in zip(got, v1_out[3:]):
                assert torch.allclose(a, b, rtol=1e-4, atol=1e-4), (
                    label, state, w)
            del got
            sparse_rows = rows.clone()
            g_in = gamma.clone()
            ms = timed({
                "topw_form": lambda: dirichlet_expectation_topw(
                    gamma, w, pair=rows),
                "topw_form_v1": topw_v1,
                "torch_topk": lambda: torch.topk(gamma, w, dim=1),
                "kernel7": lambda: sparse_union_pass(rows, ids, tv, tm, elb0,
                                                     adj),
                "kernel7_v1": k7_v1,
                "sparse_sweep": lambda: sparse_union_sweep(
                    g_in, lam, sparse_rows, adj, deg, consts, False, w)},
                reps)
            ms.update(dense)
            ms["topw_then_kernel7"] = ms["topw_form"] + ms["kernel7"]
            ms["v1_topw_then_kernel7"] = (ms["topw_form_v1"]
                                          + ms["kernel7_v1"])
            ms["kernel1_2_4"] = dense["kernel1"] + dense["kernel2"] + \
                dense["kernel4"]
            row = {"kernel": "sparse_union_pass", "graph": label,
                   "state": state, "n": n, "k": k, "w": w,
                   "links": len(links), "ms": ms,
                   "occupancy": sparse_union_occupancy(k, w),
                   "sparse_over_dense_passes": ms["topw_then_kernel7"]
                   / ms["kernel1_2_4"],
                   "sparse_over_dense_sweep": ms["sparse_sweep"]
                   / ms["dense_sweep"]}
            log(json.dumps(row))
            out.append(row)
            del ids, tv, tm, sparse_rows, g_in, v1_out, topw_v1, k7_v1
            if quick:
                break
        del gamma, rows
        torch.cuda.empty_cache()
    return out


def bench_sectors(alt, quick: bool) -> list:
    """The card's rate for random 32-byte sectors of a 2 GB array
    (csrc/alt/sector_probe.cu): every lane of a full card keeps 1, 2, 4 or
    8 loads in flight, each of 4 bytes (one value) or 8 (an (Elogpi,
    mphi) pair) from its own random sector. Then kernel 7's access: groups
    of W lanes read W random columns of one random row of the stretch
    shape's (1M, 500) array, 4-byte values (2 GB, the first design's
    Elogpi) or 8-byte pairs (4 GB, the (n, K, 2) rows)."""
    log_sectors = 26                   # 2^26 sectors of 32 bytes: 2 GB
    src = torch.rand(2**log_sectors * 8, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(2048 * sms, device="cuda")
    threads = ctypes.c_int64()
    rows = []
    for nbytes in (4, 8):
        for depth in (1, 2, 4, 8):
            iters = (256 if quick else 2048) // depth

            def probe():
                alt.call("svt_sector_probe", src.data_ptr(), log_sectors,
                         nbytes, depth, iters, 1234, out.data_ptr(),
                         ctypes.byref(threads), stream())

            ms = timed({"probe": probe}, 1 if quick else 5)["probe"]
            loads = threads.value * iters * depth
            row = {"kernel": "sector_probe", "bytes": nbytes, "depth": depth,
                   "threads_per_sm": threads.value / sms, "ms": ms,
                   "g_sectors_s": loads / ms / 1e6,
                   "tb_s_of_sectors": loads * 32 / ms / 1e9}
            log(json.dumps(row))
            rows.append(row)
    # two 4-byte values a request: the two sectors of a 64-byte block, or
    # the same sector of two arrays
    for pattern, what in ((1, "one 64-byte block"), (2, "two arrays")):
        for depth in (1, 4):
            iters = (256 if quick else 2048) // depth

            def pair():
                alt.call("svt_sector_pair_probe", src.data_ptr(),
                         log_sectors, pattern, depth, iters, 1234,
                         out.data_ptr(), ctypes.byref(threads), stream())

            ms = timed({"pair": pair}, 1 if quick else 5)["pair"]
            requests = threads.value * iters * depth
            row = {"kernel": "sector_pair_probe", "two_sectors_in": what,
                   "depth": depth, "ms": ms,
                   "g_requests_s": requests / ms / 1e6}
            log(json.dumps(row))
            rows.append(row)
    n_rows, k = 1_000_000, 500
    for nbytes in (4, 8):
        arr = src if nbytes == 4 else torch.rand(n_rows * k * 2,
                                                 device="cuda")
        for w in (1, 4, 8, 16, 32):
            for depth in (1, 2, 4):
                iters = (256 if quick else 2048) // depth

                def row_probe():
                    alt.call("svt_row_probe", arr.data_ptr(), n_rows, k,
                             nbytes, w, depth, iters, 1234, out.data_ptr(),
                             ctypes.byref(threads), stream())

                ms = timed({"rows": row_probe}, 1 if quick else 5)["rows"]
                loads = threads.value * iters * depth
                row = {"kernel": "row_probe", "bytes": nbytes,
                       "row_bytes": k * nbytes, "lanes_a_row": w,
                       "depth": depth, "ms": ms,
                       "g_values_s": loads / ms / 1e6}
                log(json.dumps(row))
                rows.append(row)
        del arr
    # 2 GB of values written in the layouts a sweep could keep mphi in,
    # the other half of the pairs untouched
    del src
    n_values = 2**29
    dst = torch.zeros(2 * n_values, device="cuda")
    names = ("contiguous", "odd half of (n,K,2) pairs, 4-byte stores",
             "16-byte halves of 32-byte sectors (blocks of 4 columns)",
             "whole sectors of 64-byte blocks (blocks of 8 columns)",
             "whole pairs (0, value)")
    for layout, name in enumerate(names):
        def write():
            alt.call("svt_write_probe", dst.data_ptr(), n_values, layout,
                     stream())

        ms = timed({"write": write}, 1 if quick else 5)["write"]
        row = {"kernel": "write_probe", "layout": name, "ms": ms,
               "gb_s_of_values": 4 * n_values / ms / 1e6}
        log(json.dumps(row))
        rows.append(row)
    return rows


# kernel 8's shapes: (n, K, pairs), -1 for one -rnode minibatch (node n // 3
# with every other); the stretch engine's state is added unless --quick
FP_BENCH_SHAPES = ((1_000_000, 500, 500_000), (1_000_000, 500, -1),
                   (20_000, 20, 10_000), (20_000, 2_000, 10_000),
                   (20_000, 1_024, -1))
FP_LOG_EPS = float(np.float32(np.log(1e-30)))


def _fp_random_state(gen, n: int, k: int):
    """gamma and lambda of a mid-fit-like state (chip_smoke.py:_fp_state)."""
    gamma = 0.05 + torch.rand((n, k), generator=gen, device="cuda") ** 4 * 10
    lam = 1.0 + 19.0 * torch.rand((k, 2), generator=gen, device="cuda")
    return gamma, lam


def _fp_random_pairs(gen, n: int, m: int):
    """m random pairs (10% links, all of weight 1), or one -rnode
    minibatch for m = -1."""
    if m < 0:
        r = n // 3
        other = torch.cat([torch.arange(r, device="cuda"),
                           torch.arange(r + 1, n, device="cuda")])
        pairs = torch.stack([other.clamp(max=r), other.clamp(min=r)], 1)
        m = n - 1
    else:
        pairs = torch.randint(0, n, (m, 2), generator=gen, device="cuda")
    y = (torch.rand(m, generator=gen, device="cuda") < 0.1).to(torch.int32)
    return pairs.to(torch.int32).contiguous(), y, torch.ones(m, device="cuda")


def _stretch_mmsb_inputs(gen, s: int):
    """The stretch graph (n=1M, K=500, 20M random links), the engine's
    state after three annealing sweeps (_engine_gamma), and s random pairs
    labelled by the graph, as chip_smoke.py phase 3 draws them."""
    n, k = 1_000_000, 500
    links = np.unique(random_edges(n, 20_000_000, 0), axis=0)
    adj = build_adjacency(links, n, "cuda")
    deg = torch.as_tensor(np.bincount(links.ravel(), minlength=n)
                          .astype(np.float32), device="cuda")
    gamma = _engine_gamma(links, adj, deg, n, k)
    del adj
    keys = torch.as_tensor(links[:, 0].astype(np.int64) * n + links[:, 1],
                           device="cuda")
    rng = np.random.default_rng(3)
    a, b = rng.integers(0, n, 2 * s), rng.integers(0, n, 2 * s)
    ok = a != b
    lo, hi = np.minimum(a, b)[ok][:s], np.maximum(a, b)[ok][:s]
    pairs = torch.as_tensor(np.stack([lo, hi], 1).astype(np.int32),
                            device="cuda")
    y = torch.isin(pairs[:, 0].long() * n + pairs[:, 1].long(), keys).to(
        torch.int32)
    lam = torch.ones((k, 2), device="cuda")
    return gamma, lam, pairs, y, torch.ones(s, device="cuda")


def _fp_v1_call(alt, elogpi, elogbeta, pairs, y, w, csr):
    """Kernel 8's first design (csrc/alt/phi_fixed_point_v1.cu) into fixed
    buffers, as its wrapper called it: returns call() -> (gacc, sums,
    rounds)."""
    n, k = elogpi.shape
    m = pairs.shape[0]
    elogf = elogbeta.t().contiguous()
    staged = torch.empty((2 * m, k), device="cuda")
    gacc = torch.empty((n, k), device="cuda")
    rounds = torch.empty(m, dtype=torch.int32, device="cuda")
    partial = torch.empty((build.REDUCE_SCRATCH_ROWS // 2, 2 * k),
                          device="cuda")
    sums = torch.empty(2 * k, device="cuda")
    seg_partial = torch.empty((csr.seg_node.shape[0], k), device="cuda")

    def call():
        alt.call("svt_phi_fixed_point_v1", elogpi.data_ptr(),
                 elogf.data_ptr(), pairs.data_ptr(), y.data_ptr(),
                 w.data_ptr(), staged.data_ptr(), rounds.data_ptr(),
                 partial.data_ptr(), sums.data_ptr(),
                 *(t.data_ptr() for t in csr.tensors()),
                 seg_partial.data_ptr(), gacc.data_ptr(), n, m,
                 csr.hub_node.shape[0], csr.seg_node.shape[0], k,
                 csr.seg_len, 50, FP_LOG_EPS, 1e-5, 0, stream())
        return gacc, sums, rounds

    return call


def _device_split(fn) -> list:
    """fn() once under torch.profiler after an unrecorded warm-up call:
    [(kernel name, device us)] in launch order."""
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                 ) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return [(ev.name, ev.device_time_total) for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and not ev.name.startswith("ProfilerStep")]


def _split_by(events, table) -> dict:
    """Device ms by the first label of `table` ((label, name parts)) whose
    part is in the kernel's name; "other" for the rest."""
    out = {}
    for name, us in events:
        label = next((lb for lb, parts in table
                      if any(p in name for p in parts)), "other")
        out[label] = out.get(label, 0.0) + us / 1e3
    return out


FP_SPLIT_TABLE = (("pass 2 (reruns, lacc)", ("pair_finish",)),
                  ("block rounds", ("block_rounds",)),
                  ("per-pair pass", ("fixed_point_kernel", "pair_pass")),
                  ("node pass", ("staged_pull", "node_pass")),
                  ("hub combine (f64)", ("combine_segments",)),
                  ("lacc colsum", ("colsum_partials",)),
                  ("kernel 1", ("dirichlet",)),
                  ("owner_csr sort", ("sort", "Sort", "radix", "Radix")))


def _v1_step(alt, gamma, lam, pairs, y, w, k: int):
    """svi_step as it ran on the card with kernel 8's first design: kernel 1
    twice, owner_csr, the first design (staging buffer and pull into
    gamma_hat), the plain Robbins-Monro update."""
    from svinet_torch.ops.edges import owner_csr
    from svinet_torch.ops.expectations import dirichlet_expectation
    n = gamma.shape[0]
    nr = torch.tensor(0.7, device="cuda")
    gs = torch.tensor(float(n) * (n - 1) / 2 / pairs.shape[0],
                      device="cuda")

    def step():
        elogpi = dirichlet_expectation(gamma)
        elogbeta = dirichlet_expectation(lam)
        csr = owner_csr(pairs.reshape(-1), n)
        gacc, sums, _ = _fp_v1_call(alt, elogpi, elogbeta, pairs, y, w,
                                    csr)()
        lacc = torch.stack([sums[:k], sums[k:]], dim=1)
        gammat = 1.0 / k + gs * gacc
        g = (1.0 - nr) * gamma + nr * gammat
        return g, (1.0 - 0.01) * lam + 0.01 * (1.0 + gs * lacc)

    return step, nr, gs


def bench_fixed_point(alt, quick: bool) -> list:
    """Kernel 8, its first design (csrc/alt/phi_fixed_point_v1.cu) beside the
    present one (ops/phicomp.py:phi_fixed_point); the first design stops
    each pair on its own (the rule before the block rule), so the
    comparison with it (error of the largest entry, gamma_hat bitwise
    equal, pairs whose rounds differ) spans the two rules; above K=512
    the present one against the plain version in float64 on its rounds;
    each
    kernel's device time split by the kernels it launches (torch.profiler),
    the endpoint CSR timed apart; then a whole svi_step with the first
    design (plain update) beside the present one, split the same way, with
    its peak memory; and the ELBO form at planted n=2,000, K=20. The first
    design takes K <= 512 only."""
    from svinet_torch.ops.edges import owner_csr
    from svinet_torch.ops.expectations import dirichlet_expectation
    from svinet_torch.ops.phicomp import (
        fixed_point_plan, pair_block_stats_plain, phi_fixed_point)
    from svinet_torch.svi.mmsb import svi_step
    info = (ctypes.c_int * 6)()
    rc = alt._dll.svt_phi_fixed_point_v1_info(info)
    assert rc == 0, rc
    log(f"kernel 8, first design: training form <4,32,4> at K=500 "
        f"{info[0]} registers, {info[1]} bytes of local memory a thread, "
        f"{info[2]} warps an SM; ELBO form <4,8,1> at K=20 {info[3]} "
        f"registers, {info[4]} bytes local, {info[5]} warps an SM")
    for name, lib in (("csrc/alt", alt), ("present", build.library())):
        lines = lib.log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and any(
                    kern in line for kern in ("fixed_point_kernel",
                                              "pair_pass",
                                              "node_pass_kernel")):
                log(f"ptxas ({name}): {line.split(chr(39))[1]}: "
                    + "; ".join(nxt.split(":")[-1].strip()
                                for nxt in lines[i + 2:i + 4]))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    rows = [_bench_fp_elbo(alt, gen, quick)]
    shapes = [(n, k, m, None) for n, k, m in FP_BENCH_SHAPES]
    if not quick:
        shapes.insert(3, (1_000_000, 500, 500_000, "stretch"))
    for n, k, m, state in shapes:
        if state == "stretch":
            gamma, lam, pairs, y, w = _stretch_mmsb_inputs(gen, m)
        else:
            gamma, lam = _fp_random_state(gen, n, k)
            pairs, y, w = _fp_random_pairs(gen, n, m)
        m = pairs.shape[0]
        elogpi = dirichlet_expectation(gamma)
        elogbeta = dirichlet_expectation(lam)
        csr = owner_csr(pairs.reshape(-1), n)
        label = (f"n={n} K={k} pairs={m}" + (" (-rnode)" if m == n - 1
                                             else "")
                 + (" stretch engine state" if state else ""))

        def present():
            return phi_fixed_point(elogpi, elogbeta, pairs, y, w, FP_LOG_EPS,
                                   50, 1e-5, csr=csr)

        g_n, l_n, r_n = present()
        row = {"part": "fixedpoint", "shape": label,
               "rounds_mean": float(r_n.double().mean()),
               "plan": fixed_point_plan(k, False, m, gamma.device)}
        fns = {"present": present}
        if k > 512:
            # no first design here: the plain version in float64 on the
            # kernel's rounds
            g_p, l_p, _ = pair_block_stats_plain(
                elogpi.double(), elogbeta.double(), pairs, y, w.double(),
                FP_LOG_EPS, 50, 1e-5, given=r_n)
            row["err_vs_plain_f64"] = max(
                float((g_n - g_p).abs().max() / g_p.abs().max()),
                float((l_n - l_p).abs().max() / l_p.abs().max()))
            del g_p
        if k <= 512:
            v1 = _fp_v1_call(alt, elogpi, elogbeta, pairs, y, w, csr)
            g_1, s_1, r_1 = v1()
            l_1 = torch.stack([s_1[:k], s_1[k:]], dim=1)
            torch.cuda.synchronize()
            err = max(float((g_n - g_1).abs().max() / g_1.abs().max()),
                      float((l_n - l_1).abs().max() / l_1.abs().max()))
            row["err_vs_v1"] = err
            row["gamma_hat_bitwise_equal_v1"] = bool(torch.equal(g_n, g_1))
            row["rounds_differ"] = int((r_n != r_1).sum())
            fns["v1"] = v1
            del g_1
        del g_n
        big = n * k >= 10**7
        row.update({f"{name}_ms": v for name, v in
                    timed(fns, 2 if quick else (3 if big else 20)).items()})
        for name, fn in fns.items():
            row[f"{name}_split_ms"] = _split_by(_device_split(fn),
                                                FP_SPLIT_TABLE)
        row["owner_csr_ms"] = timed(
            {"csr": lambda: owner_csr(pairs.reshape(-1), n)}, 3)["csr"]
        if k == 500 and m == 500_000:
            step, nr, gs = _v1_step(alt, gamma, lam, pairs, y, w, k)
            eta = torch.ones((k, 2), device="cuda")

            def present_step():
                return svi_step(gamma, lam, pairs, y, w, 1.0 / k, eta, gs,
                                gs, nr, torch.tensor(0.01, device="cuda"),
                                1.0, FP_LOG_EPS, 50, 1e-5)

            steps = {"v1": step, "present": present_step}
            a, b = step(), present_step()
            torch.cuda.synchronize()
            row["step_err"] = float((a[0] - b[0]).abs().max()
                                    / a[0].abs().max())
            del a, b
            for name, fn in steps.items():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                row[f"{name}_step_wall_ms"] = (time.perf_counter() - t0) * 1e3
                row[f"{name}_step_peak_gib"] = (
                    torch.cuda.max_memory_allocated() - base) / 2**30
                del out
                row[f"{name}_step_split_ms"] = _split_by(
                    _device_split(fn), FP_SPLIT_TABLE)
            row.update({f"{name}_step_ms": v
                        for name, v in timed(steps, 3).items()})
        log(f"kernel 8 {label}: " + json.dumps(row))
        rows.append(row)
        del gamma, elogpi, csr, pairs
        torch.cuda.empty_cache()
    return rows


def _bench_fp_elbo(alt, gen, quick: bool) -> dict:
    """The ELBO form on all 1,999,000 pairs of the planted n=2,000, K=20
    graph of chip_smoke.py, the first design beside the present one."""
    from svinet_torch.ops.expectations import dirichlet_expectation
    from svinet_torch.ops.phicomp import phi_fixed_point
    n, k = 2_000, 20
    raw, _ = planted_blocks(n, k, 20, 7)
    iu = torch.triu_indices(n, n, 1, device="cuda").t().to(
        torch.int32).contiguous()
    keys = torch.as_tensor(np.minimum(raw[:, 0], raw[:, 1]).astype(np.int64)
                           * n + np.maximum(raw[:, 0], raw[:, 1]),
                           device="cuda")
    y = torch.isin(iu[:, 0].long() * n + iu[:, 1].long(), keys).to(
        torch.int32).contiguous()
    w = torch.ones(iu.shape[0], device="cuda")
    gamma, lam = _fp_random_state(gen, n, k)
    elogpi = dirichlet_expectation(gamma)
    elogbeta = dirichlet_expectation(lam)
    elogf = elogbeta.t().contiguous()
    m = iu.shape[0]
    rounds = torch.empty(m, dtype=torch.int32, device="cuda")
    partial = torch.empty((build.REDUCE_SCRATCH_ROWS // 2, 1), device="cuda")
    sums = torch.empty(1, device="cuda")

    def v1():
        alt.call("svt_phi_fixed_point_v1", elogpi.data_ptr(),
                 elogf.data_ptr(), iu.data_ptr(), y.data_ptr(), w.data_ptr(),
                 None, rounds.data_ptr(), partial.data_ptr(),
                 sums.data_ptr(), *(None,) * 7, None, None, n, m, 0, 0, k,
                 256, 50, FP_LOG_EPS, 1e-5, 1, stream())
        return sums

    def present():
        return phi_fixed_point(elogpi, elogbeta, iu, y, w, FP_LOG_EPS, 50,
                               1e-5, elbo=True)[0]

    a, b = float(v1()[0]), float(present())
    row = {"part": "fixedpoint", "shape": f"ELBO form, all {m} pairs of "
           f"planted n={n} K={k}", "rel_err_vs_v1": abs(a - b) / abs(a)}
    row.update({f"{name}_ms": v for name, v in
                timed({"v1": v1, "present": present},
                      2 if quick else 10).items()})
    log(f"kernel 8 ELBO form: " + json.dumps(row))
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--no-stretch", action="store_true")
    ap.add_argument("--only", default="",
                    help="comma-separated parts to run: designs, compact, "
                         "graph, s3forms, crossover, heldout, sectors, "
                         "sparse, fixedpoint (default all)")
    ap.add_argument("--out", default=str(build.BUILD_DIR),
                    help="directory for the result files")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_kernels: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)
    os.makedirs(args.out, exist_ok=True)
    lib, alt, exact = build.library(), alt_library(), exact_exp_library()
    log(f"built in {lib.build_seconds:.1f} s, {alt.build_seconds:.1f} s and "
        f"{exact.build_seconds:.1f} s")
    with open(os.path.join(args.out, "ptxas.log"), "w") as f:
        f.write(lib.log + alt.log + exact.log)
    for line in (lib.log + alt.log).splitlines():
        if "spill" in line and "0 bytes spill stores" not in line:
            log(f"ptxas: {line.strip()}")
    only = set(filter(None, args.only.split(",")))

    def part(name: str) -> bool:
        return not only or name in only

    results = {"card": card, "rows": []}
    stretch = not (args.quick or args.no_stretch)
    if part("designs"):
        results["rows"] += bench_dirichlet(lib, alt, args.quick)
        # the shapes between the first and the last place
        # sweep_math.FUSED_MAX_WORK: where the one fused launch stops
        # beating kernel 2 followed by kernel 4
        shapes = [(20_000, 20, 200_000), (50_000, 20, 500_000),
                  (100_000, 20, 1_000_000), (20_000, 128, 200_000),
                  (300_000, 20, 3_000_000), (100_000, 64, 1_000_000),
                  (20_000, 500, 200_000), (300_000, 64, 3_000_000),
                  (1_000_000, 20, 10_000_000),
                  (1_000_000, 64, 10_000_000), (1_000_000, 128, 10_000_000),
                  (1_000_000, 256, 10_000_000), (1_000_000, 500, 2_000_000)]
        if stretch:
            shapes.append((1_000_000, 500, 20_000_000))
        for n, k, e in shapes:
            results["rows"].extend(bench_phi(alt, n, k, e, args.quick))
            torch.cuda.empty_cache()
    if part("s3forms"):
        # the stretch graph's degree at n from 250k to 2M, K = 500; then
        # narrower rows, a K that is no multiple of 4, and a small shape
        shapes = [(20_000, 20, 200_000), (100_000, 37, 1_000_000),
                  (250_000, 500, 5_000_000), (500_000, 500, 10_000_000),
                  (1_000_000, 500, 2_000_000), (1_000_000, 64, 10_000_000),
                  (1_000_000, 128, 10_000_000), (4_000_000, 32, 20_000_000)]
        if stretch:
            shapes += [(1_000_000, 500, 20_000_000),
                       (1_500_000, 500, 30_000_000),
                       (2_000_000, 500, 40_000_000)]
        for n, k, e in shapes:
            results["rows"].append(bench_s3_forms(alt, n, k, e, args.quick))
            torch.cuda.empty_cache()
    if part("crossover") and not args.quick:
        shapes = [(20_000, 20, 200_000), (50_000, 20, 500_000),
                  (100_000, 20, 1_000_000), (300_000, 20, 3_000_000)]
        if stretch:
            shapes.append((1_000_000, 500, 20_000_000))
        for n, k, e in shapes:
            results["rows"].append(bench_fused_crossover(n, k, e))
            torch.cuda.empty_cache()
    if part("sectors"):
        results["rows"] += bench_sectors(alt, args.quick)
        torch.cuda.empty_cache()
    if part("sparse"):
        widths = (8, 16, 32, 64)
        planted, member = planted_blocks(20_000, 20, 20, 7)
        links = np.unique(np.sort(planted[planted[:, 0] != planted[:, 1]],
                                  axis=1), axis=0)
        for k in (500, 2_000, 8_000):
            results["rows"] += bench_sparse(alt, "planted-20k", links,
                                            member, 20_000, k, widths,
                                            args.quick)
            torch.cuda.empty_cache()
        if stretch:
            n = 1_000_000
            links = np.unique(random_edges(n, 20_000_000, 0), axis=0)
            member = np.random.default_rng(5).integers(0, 500, n)
            results["rows"] += bench_sparse(alt, "stretch", links, member, n,
                                            500, widths, False,
                                            ("engine", "late-fit"))
            torch.cuda.empty_cache()
    if part("fixedpoint"):
        results["rows"] += bench_fixed_point(alt, args.quick)
        torch.cuda.empty_cache()
    if part("heldout"):
        for n, k, m in ((20_000, 20, 4_000), (100_000, 640, 50_000),
                        (1_000_000, 500, 400_000)):
            results["rows"].append(bench_heldout(n, k, m, args.quick))
            torch.cuda.empty_cache()
    if not args.quick:
        compact = [(20_000, 20, 200_000, 5)]
        if not args.no_stretch:
            compact += [(1_000_000, 500, 20_000_000, 40),
                        (1_000_000, 500, 20_000_000, 5)]
        for shape in compact if part("compact") else ():
            results["rows"].append(bench_compact_sweep(*shape))
            torch.cuda.empty_cache()
        if part("graph"):
            results["rows"].extend(bench_graph_capture(20_000, 20, 40))
    with open(os.path.join(args.out, "bench_kernels.json"), "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
