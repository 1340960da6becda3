"""The sparse top-W gamma state of FastAMM's -fastqueue W
(svinet_tpu/ops/sparse_gamma.py; reference: FastQueue,
src/fastqueue.hh:22-307): per node its W largest gamma entries and the
summed mass of the other K - W, taken as uniform,

  ids  (n, W) int32, vals (n, W) f32, rest (n,) f32,

so that no (n, K) state exists. A pair works over the 2W union slots
[ids_p | ids_q], a slot whose community came earlier being dead.

Kernel 10 (csrc/sparse_fastamm.cu) runs FastAMM's step on it, in one
launch: the union-slot phi fixed point under the JAX exit rule (the whole
minibatch one block, its rounds on chip) and its sums, gamma_hat over the
touched rows and lambda_hat, into a SparseWorkspace the caller keeps; the
update of the touched rows after it is plain PyTorch on (T, K) rows.
Kernel 11 (csrc/sparse_scores.cu) takes the two closed-form union passes,
the held-out link probabilities and the edge assignments. A CPU tensor
takes the plain versions below, the JAX functions' expressions in their
order; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from svinet_torch.kernels import build
from svinet_torch.ops.digamma import dirichlet_expectation
from svinet_torch.ops.edges import Adjacency, owner_csr

# pairs of one chunk of kernel 10's lambda_hat pass
LAM_CHUNK = 256
# entries of the endpoint CSR's segments in a -fastqueue step: a row with
# more (the minibatch's start node) is cut into segments that kernel 10's
# warps sum at once, their rows then added in segment order
K10_SEG_LEN = 32
# links a chunk of the plain edge assignments: its (E, 2W, W) match
# tensor (svinet_tpu/svi/fastamm.py:370-376)
ASSIGN_CHUNK = 8192
DEAD = -1e30
# above this W, kernel 11 takes its wide form (a block of one warp a pair,
# each slot's facts in a region of shared memory, or of device scratch
# past the card's shared memory: csrc/sparse_slots.cuh), and kernel 10 a
# warp a pair; their launches there count as the "wide" forms
NARROW_MAX_W = 64


def _check_width(w: int, k: int) -> None:
    """Any top-W width the JAX engine takes, 1 <= W < K
    (svinet_tpu/svi/fastamm.py:153-156)."""
    if not 1 <= w < k:
        raise ValueError(f"-fastqueue {w}: the width must be in [1, K) "
                         f"with K = {k}")


def top_w(x: torch.Tensor, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, ids int32) of the w largest entries of each row, largest
    first and the lower column first among equal values, as jax.lax.top_k
    orders them: a stable descending sort (torch.topk leaves the order of
    ties unspecified, and a densified row's tail entries are all equal)."""
    s = torch.sort(x, dim=-1, descending=True, stable=True)
    return s.values[:, :w], s.indices[:, :w].to(torch.int32)


def topw_from_dense(gamma: torch.Tensor, w: int):
    """Dense (n, K) gamma as (ids, vals, rest); rest is clamped at 0 where
    f32 cancellation leaves it negative."""
    vals, ids = top_w(gamma, w)
    rest = (gamma.sum(-1) - vals.sum(-1)).clamp_min(0.0)
    return ids, vals, rest


def densify(ids, vals, rest, k: int) -> torch.Tensor:
    """(n, K): the top entries exact, the tail mass spread uniformly over
    the K - W others."""
    n, w = ids.shape
    tail = rest / max(k - w, 1)
    out = tail[:, None].expand(n, k).clone()
    return out.scatter_(1, ids.long(), vals)


def _value_at_slots(ids, vals, tail_val, slots):
    """(B, S): each row's gamma value at each slot's community, its top
    value there or else tail_val."""
    match = slots[:, :, None] == ids[:, None, :]
    top = (match * vals[:, None, :]).sum(-1)
    return torch.where(match.any(-1), top, tail_val[:, None])


def _dup_mask(slots):
    """(B, S) bool: True at the first slot of each community."""
    s = slots.shape[1]
    eq = slots[:, :, None] == slots[:, None, :]
    earlier = torch.ones((s, s), dtype=torch.bool,
                         device=slots.device).tril(-1)
    return ~(eq & earlier).any(-1)


def sparse_phi_fixed_point(ids_p, vals_p, rest_p, ids_q, vals_q, rest_q,
                           elogbeta, y, log_eps: float, k: int,
                           max_iters: int = 50, thresh: float = 1e-5):
    """The coupled phi fixed point over the 2W union slots of B pairs, all
    of them one block of the exit rule: rounds until the largest change
    over the block is below thresh, or max_iters. Returns (slots (B, 2W)
    int32, first (B, 2W) bool, phi1, phi2 (B, 2W), the rounds)."""
    w = ids_p.shape[1]
    slots = torch.cat([ids_p, ids_q], dim=1)
    first = _dup_mask(slots)
    tot_p = vals_p.sum(-1) + rest_p
    tot_q = vals_q.sum(-1) + rest_q
    # the tail value's floor: digamma(0) would put NaNs in the softmax
    tail_p = torch.clamp_min(rest_p / max(k - w, 1), 1e-10)
    tail_q = torch.clamp_min(rest_q / max(k - w, 1), 1e-10)
    gp = _value_at_slots(ids_p, vals_p, tail_p, slots)
    gq = _value_at_slots(ids_q, vals_q, tail_q, slots)
    ep = torch.special.digamma(gp) - torch.special.digamma(tot_p)[:, None]
    eq = torch.special.digamma(gq) - torch.special.digamma(tot_q)[:, None]
    yf = (y == 1)[:, None]
    eb = elogbeta[slots.long().clamp(0, elogbeta.shape[0] - 1)]
    elogf = torch.where(yf, eb[:, :, 0], eb[:, :, 1])
    dead = torch.where(first, 0.0, DEAD).to(vals_p.dtype)
    phi1 = torch.softmax(torch.zeros_like(dead) + dead, dim=-1)
    phi2 = phi1
    r = 0
    while r < max_iters:
        u1 = torch.where(yf, (1.0 - phi2) * log_eps, 0.0)
        n1 = torch.softmax(ep + elogf * phi2 + u1 + dead, dim=-1)
        u2 = torch.where(yf, (1.0 - phi1) * log_eps, 0.0)
        n2 = torch.softmax(eq + elogf * phi1 + u2 + dead, dim=-1)
        change = torch.maximum((n1 - phi1).abs().mean(-1),
                               (n2 - phi2).abs().mean(-1)).max()
        phi1, phi2 = n1, n2
        r += 1
        if not bool(change >= thresh):
            break
    return slots, first, phi1, phi2, r


def sparse_fastamm_stats_plain(ids, vals, rest, elogbeta, pairs, y, w, lp,
                               lq, t: int, log_eps: float, max_iters: int,
                               thresh: float, block: int):
    """Kernel 10 in plain PyTorch: (gacc (t, K), lacc (K, 2), rounds (B,)
    int32). The minibatch of B <= block pairs is one block of the rule;
    where B < block the JAX padding pairs (0, 0), y = 0, w = 0 fill it,
    all alike, so one of them stands for the rest."""
    k = elogbeta.shape[0]
    m = pairs.shape[0]
    dev = vals.device
    if m < block:
        pairs = torch.cat([pairs, pairs.new_zeros((1, 2))])
        y = torch.cat([y, y.new_zeros(1)])
    p, q = pairs[:, 0].long(), pairs[:, 1].long()
    slots, first, phi1, phi2, r = sparse_phi_fixed_point(
        ids[p], vals[p], rest[p], ids[q], vals[q], rest[q], elogbeta, y,
        log_eps, k, max_iters, thresh)
    slots, first, phi1, phi2, y = (a[:m] for a in (slots, first, phi1,
                                                  phi2, y))
    wc = w[:, None] * first
    cols = slots.long()
    gacc = torch.zeros((t, k), dtype=vals.dtype, device=dev)
    gacc.index_put_((lp.long()[:, None].expand_as(cols), cols), phi1 * wc,
                    accumulate=True)
    gacc.index_put_((lq.long()[:, None].expand_as(cols), cols), phi2 * wc,
                    accumulate=True)
    pp = phi1 * phi2 * wc
    yf = (y == 1)[:, None]
    lacc = torch.zeros((k, 2), dtype=vals.dtype, device=dev)
    lacc[:, 0].index_put_((cols,), torch.where(yf, pp, 0.0),
                          accumulate=True)
    lacc[:, 1].index_put_((cols,), torch.where(yf, 0.0, pp),
                          accumulate=True)
    return gacc, lacc, torch.full((m,), r, dtype=torch.int32, device=dev)


class SparseWorkspace:
    """Kernel 10's or kernel 11's outputs and scratch on one device, kept
    by a caller across calls (the engine keeps one for its -fastqueue
    steps, one for its reports). Each buffer only grows, so that a call
    allocates nothing once the buffers have reached its sizes. The tensors
    a call returns are views of them, overwritten by the next call given
    this workspace."""

    def __init__(self, device):
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._bufs = {}

    def take(self, name: str, numel: int, dtype: torch.dtype):
        """The first numel elements of buffer `name`, grown (by a quarter
        at least) when it is shorter."""
        buf = self._bufs.get(name)
        if buf is None or buf.numel() < numel:
            grown = numel if buf is None else max(numel,
                                                  buf.numel() * 5 // 4)
            buf = torch.empty(max(grown, 1), dtype=dtype,
                              device=self.device)
            self._bufs[name] = buf
        return buf[:numel]


@functools.lru_cache(maxsize=None)
def _device_words(w: int, device: torch.device) -> int:
    """Floats of kernel 10's workspace that depend on the card at width w
    (its grid form's changes, and its regions where they outgrow shared
    memory), by the kernel's own query, asked once a width and card."""
    return build.ask("svt_sparse_fastamm_scratch", device, w, 2)[0]


def sparse_fastamm_stats(ids, vals, rest, elogbeta, pairs, y, w, lp, lq,
                         t: int, log_eps: float, max_iters: int,
                         thresh: float, block: int,
                         csr: Optional[Adjacency] = None,
                         workspace: Optional[SparseWorkspace] = None):
    """Kernel 10 (csrc/sparse_fastamm.cu) on CUDA tensors, its plain
    version on CPU tensors. ids (n, W) int32, vals (n, W), rest (n,),
    elogbeta (K, 2) f32; pairs (B, 2) int32 global ids, y (B,) int32, w
    (B,) f32; lp, lq (B,) int32, the pair ends' rows among the t touched
    rows; block, the minibatch's padded length (B <= block). Returns
    (gamma_hat (t, K), lambda_hat (K, 2), rounds (B,) int32, the block's
    R). `csr`: owner_csr of [lp | lq] interleaved over t rows (segments of
    K10_SEG_LEN entries in the engine's steps), made so here when not
    given. On the card one launch, its outputs and scratch in
    `workspace` (the returned tensors are views of it, good until its next
    call), a new one when not given. No atomics: two launches give the
    same bits."""
    if vals.device.type == "cpu":
        return sparse_fastamm_stats_plain(ids, vals, rest, elogbeta, pairs,
                                          y, w, lp, lq, t, log_eps,
                                          max_iters, thresh, block)
    build.require_cuda(vals, "sparse_fastamm_stats")
    dev = vals.device
    n, wt = ids.shape
    k = elogbeta.shape[0]
    m = pairs.shape[0]
    if m > block:
        raise ValueError(f"{m} pairs exceed the block of {block}")
    _check_width(wt, k)
    build.check_cuda(ids, "ids", torch.int32, (n, wt), dev)
    build.check_cuda(vals, "vals", torch.float32, (n, wt), dev)
    build.check_cuda(rest, "rest", torch.float32, (n,), dev)
    build.check_cuda(elogbeta, "elogbeta", torch.float32, (k, 2), dev)
    build.check_cuda(pairs, "pairs", torch.int32, (m, 2), dev)
    build.check_cuda(y, "y", torch.int32, (m,), dev)
    build.check_cuda(w, "w", torch.float32, (m,), dev)
    if csr is None:
        ends = torch.stack([lp, lq], 1).reshape(-1)
        csr = owner_csr(ends, t, K10_SEG_LEN)
    if csr.nbr.shape[0] != 2 * m or csr.n != t:
        raise ValueError("csr is not the CSR of these pairs' ends")
    ws = SparseWorkspace(dev) if workspace is None else workspace
    if ws.device != dev:
        raise ValueError(f"the workspace is on {ws.device}, not {dev}")
    n_hubs, n_segs = csr.hub_node.shape[0], csr.seg_node.shape[0]
    chunks = -(-m // LAM_CHUNK)
    # the pairs' records (16W floats each), the hub segments' rows,
    # lambda_hat's chunk rows (more than one chunk), the card's part
    # (csrc/sparse_fastamm.cu)
    words = ((m + 1) * 16 * wt + n_segs * k
             + (chunks * 2 * k if chunks > 1 else 0)
             + _device_words(wt, dev))
    work = ws.take("work", words, torch.float32)
    gacc = ws.take("gacc", t * k, torch.float32).view(t, k)
    sums = ws.take("sums", 2 * k, torch.float32)
    rounds = ws.take("rounds", m, torch.int32)
    build.launch("svt_sparse_fastamm", dev, ids.data_ptr(), vals.data_ptr(),
                 rest.data_ptr(), elogbeta.data_ptr(), pairs.data_ptr(),
                 y.data_ptr(), w.data_ptr(),
                 *(a.data_ptr() for a in csr.tensors()), work.data_ptr(),
                 words, gacc.data_ptr(), sums.data_ptr(), rounds.data_ptr(),
                 m, t, n_hubs, n_segs, k, wt, csr.seg_len, int(max_iters),
                 float(log_eps), float(thresh), int(block))
    build.count_launch(sparse_fastamm_stats,
                       "wide" if wt > NARROW_MAX_W else "f32")
    return gacc, sums.view(2, k).t(), rounds


sparse_fastamm_stats.launches = 0
sparse_fastamm_stats.forms = {}


def sparse_fastamm_step(ids, vals, rest, lam, pairs, y, w, lp, lq, rows,
                        rho, alpha: float, eta, scale, rhot,
                        do_lambda: float, log_eps: float, k: int,
                        max_iters: int, thresh: float, block: int,
                        csr: Optional[Adjacency] = None,
                        workspace: Optional[SparseWorkspace] = None):
    """One FastAMM step on the sparse state, in place
    (svinet_tpu/ops/sparse_gamma.py:133-187): kernel 10's sums over the
    touched rows (rows (t,) int64, distinct nodes; lp and lq index them),
    then each row takes (1 - rho) gamma + rho (alpha + scale gamma_hat) in
    dense K space, is cut to its top W, and goes back into ids, vals and
    rest; lambda steps unless do_lambda is 0. rho is (t,); scale and rhot
    are () f32 tensors; `workspace` is kernel 10's, kept across steps.
    Returns lambda."""
    elogbeta = dirichlet_expectation(lam)
    gacc, lacc, _ = sparse_fastamm_stats(
        ids, vals, rest, elogbeta, pairs, y, w, lp, lq, rows.shape[0],
        log_eps, max_iters, thresh, block, csr, workspace)
    wt = ids.shape[1]
    old = densify(ids[rows], vals[rows], rest[rows], k)
    r = rho[:, None]
    new = (1.0 - r) * old + r * (alpha + scale * gacc)
    nv, ni = top_w(new, wt)
    ids[rows] = ni
    vals[rows] = nv
    rest[rows] = (new.sum(-1) - nv.sum(-1)).clamp_min(0.0)
    if do_lambda > 0:
        lambdat = eta + scale * lacc
        lam = (1.0 - rhot) * lam + rhot * lambdat
    return lam


def _union_scores_plain(ids, vals, rest, table, pairs, k: int,
                        assign: bool):
    w = ids.shape[1]
    p, q = pairs[:, 0].long(), pairs[:, 1].long()
    slots = torch.cat([ids[p], ids[q]], dim=1)
    first = _dup_mask(slots)
    tot_p = vals[p].sum(-1) + rest[p]
    tot_q = vals[q].sum(-1) + rest[q]
    gp = _value_at_slots(ids[p], vals[p], rest[p] / max(k - w, 1), slots)
    gq = _value_at_slots(ids[q], vals[q], rest[q] / max(k - w, 1), slots)
    cols = slots.long().clamp(0, k - 1)
    if assign:
        logits = (torch.special.digamma(gp)
                  - torch.special.digamma(tot_p)[:, None]
                  + torch.special.digamma(gq)
                  - torch.special.digamma(tot_q)[:, None]
                  + table[cols, 0])
        logits = torch.where(first, logits, DEAD)
        phi = torch.softmax(logits, dim=-1)
        # torch.argmax returns the first of equal maxima, as jnp.argmax
        amax = phi.argmax(-1, keepdim=True)
        return (slots.gather(1, amax)[:, 0].to(torch.int32),
                phi.gather(1, amax)[:, 0])
    beta = table
    tail_p = rest[p] / max(k - w, 1) / tot_p
    tail_q = rest[q] / max(k - w, 1) / tot_q
    pip = gp / tot_p[:, None]
    piq = gq / tot_q[:, None]
    bs = beta[cols]
    fm = first.to(vals.dtype)
    s_one = (pip * piq * bs * fm).sum(-1)
    inner = (pip * piq * fm).sum(-1)
    tail_cross = tail_p * tail_q
    s_one = s_one + tail_cross * (beta.sum() - (bs * fm).sum(-1))
    inner = inner + tail_cross * (k - fm.sum(-1))
    return s_one, inner


@functools.lru_cache(maxsize=None)
def _scores_scratch_words(w: int, device: torch.device) -> int:
    """Floats of kernel 11's wide-form scratch on the card at width w (0
    where its regions fit in shared memory), asked once a width and
    card."""
    return build.ask("svt_sparse_scores_scratch", device, w)[0]


def union_scores(ids, vals, rest, table, pairs, k: int, assign: bool,
                 workspace: Optional[SparseWorkspace] = None):
    """Kernel 11 (csrc/sparse_scores.cu) on CUDA tensors, the plain
    version on CPU tensors. assign=False: table is beta (K,), returns
    (s_one, inner) (B,); assign=True: table is Elogbeta (K, 2), returns
    (community (B,) int32, its phi (B,)). On the card its outputs, the
    node pass's digammas and the wide form's scratch lie in `workspace`
    (the returned tensors are views of it, good until its next call), a
    new one when not given: a call into a grown workspace allocates
    nothing."""
    if vals.device.type == "cpu":
        return _union_scores_plain(ids, vals, rest, table, pairs, k, assign)
    build.require_cuda(vals, "union_scores")
    dev = vals.device
    n, wt = ids.shape
    m = pairs.shape[0]
    _check_width(wt, k)
    build.check_cuda(ids, "ids", torch.int32, (n, wt), dev)
    build.check_cuda(vals, "vals", torch.float32, (n, wt), dev)
    build.check_cuda(rest, "rest", torch.float32, (n,), dev)
    build.check_cuda(table, "table", torch.float32,
                     (k, 2) if assign else (k,), dev)
    build.check_cuda(pairs, "pairs", torch.int32, (m, 2), dev)
    ws = SparseWorkspace(dev) if workspace is None else workspace
    if ws.device != dev:
        raise ValueError(f"the workspace is on {ws.device}, not {dev}")
    out0 = ws.take("k11_out0", m, torch.float32)
    out1 = None if assign else ws.take("k11_out1", m, torch.float32)
    cid = ws.take("k11_cid", m, torch.int32) if assign else None
    # the sum of beta, or the narrow node pass's (psi(tot), psi(tail)) a
    # row and psi of its values
    node = ws.take("k11_node", n * (wt + 2) if assign and
                   wt <= NARROW_MAX_W else 1, torch.float32)
    if not assign:
        torch.sum(table, 0, out=node[0])
    words = _scores_scratch_words(wt, dev)
    scratch = ws.take("k11_scratch", words, torch.float32) if words else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    build.launch("svt_sparse_scores", dev, ids.data_ptr(), vals.data_ptr(),
                 rest.data_ptr(), table.data_ptr(), pairs.data_ptr(),
                 out0.data_ptr(), ptr(out1), ptr(cid), node.data_ptr(),
                 ptr(scratch), n, m, k, wt, int(assign))
    # one a call: the pair pass, after the node pass where it ran
    build.count_launch(union_scores, ("assign" if assign else "scores")
                       + ("+wide" if wt > NARROW_MAX_W else ""))
    return (cid, out0) if assign else (out0, out1)


union_scores.launches = 0
union_scores.forms = {}


def sparse_pair_scores(ids, vals, rest, lam, pairs, k: int,
                       workspace: Optional[SparseWorkspace] = None):
    """(s_one, inner) of each pair under the top-W and uniform-tail state
    (svinet_tpu/ops/sparse_gamma.py:212-243): sum_k pi_p pi_q beta_k and
    sum_k pi_p pi_q, exact over the union slots, the K - |union| others
    at tail_p tail_q each. `workspace`: union_scores'."""
    beta = lam[:, 0] / (lam[:, 0] + lam[:, 1])
    return union_scores(ids, vals, rest, beta.contiguous(), pairs, k,
                        assign=False, workspace=workspace)


def sparse_edge_assignments(ids, vals, rest, lam, edges, k: int,
                            workspace: Optional[SparseWorkspace] = None):
    """(community (E,) int32, its phi (E,)) of each link: the first slot of
    the largest closed-form phi over its union slots
    (svinet_tpu/ops/sparse_gamma.py:246-270). The plain version takes the
    links in chunks of ASSIGN_CHUNK, as the JAX engine does; the card one
    launch (`workspace`: union_scores')."""
    elogbeta = dirichlet_expectation(lam)
    if vals.device.type != "cpu":
        return union_scores(ids, vals, rest, elogbeta, edges, k, assign=True,
                            workspace=workspace)
    cids, mx = [], []
    for lo in range(0, edges.shape[0], ASSIGN_CHUNK):
        c, v = _union_scores_plain(ids, vals, rest, elogbeta,
                                   edges[lo:lo + ASSIGN_CHUNK], k, True)
        cids.append(c)
        mx.append(v)
    if not cids:
        return (torch.zeros(0, dtype=torch.int32),
                torch.zeros(0, dtype=vals.dtype))
    return torch.cat(cids), torch.cat(mx)
