"""Held-out edge likelihood, the convergence metric
(svinet_tpu/evals/likelihood.py:24-159).

Mixture likelihood of a pair under the a-MMSB point estimates
(reference: LinkSampling::edge_likelihood, src/linksampling.hh:258-292):

  y=1:  s = sum_k  pi_p[k] pi_q[k] beta_k
  y=0:  s = sum_k  pi_p[k] pi_q[k] (1-beta_k) + (1 - sum_k pi_p[k] pi_q[k])(1-eps)

with s clamped at 1e-30 before the log; nshol = zeros_prob*avg0 +
ones_prob*avg1. On the card the six sums are one hand-written kernel
(csrc/heldout_sums.cu) that gathers the pairs' gamma rows and never makes
the (n,K) pi; a CPU tensor takes the plain version, blocked over pairs so
the (B,K) gathers stay bounded whatever the pair-set size.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from svinet_torch.kernels import build

PAIR_BLOCK = 1 << 17


class HeldoutResult(NamedTuple):
    avg: float      # mean log-likelihood over all heldout pairs
    count: int
    avg0: float     # mean over nonlinks
    count0: int
    avg1: float     # mean over links
    count1: int

    def nshol(self, zeros_prob: float, ones_prob: float) -> float:
        return zeros_prob * self.avg0 + ones_prob * self.avg1


def _pi_beta(gamma, lam):
    pi = gamma / gamma.sum(dim=1, keepdim=True)
    beta = lam[:, 0] / (lam[:, 0] + lam[:, 1])
    return pi, beta


def _block_sums(pi, beta, pairs, y, w, epsilon: float) -> torch.Tensor:
    """The six sums of one block: (sum ll, sum w, nonlink ll, nonlink w,
    link ll, link w)."""
    prod = pi[pairs[:, 0]] * pi[pairs[:, 1]]
    inner = prod.sum(dim=-1)
    s_one = (prod * beta).sum(dim=-1)
    s_zero = ((prod * (1.0 - beta)).sum(dim=-1)
              + (1.0 - inner) * (1.0 - epsilon))
    ones = y == 1
    s = torch.where(ones, s_one, s_zero)
    ll = torch.log(s.clamp_min(1e-30)) * w
    zero = torch.zeros((), dtype=ll.dtype, device=ll.device)
    return torch.stack([
        ll.sum(), w.sum(),
        torch.where(ones, zero, ll).sum(), torch.where(ones, zero, w).sum(),
        torch.where(ones, ll, zero).sum(), torch.where(ones, w, zero).sum(),
    ])


def heldout_sums_from_pi(pi, beta, pairs, y, w, epsilon: float,
                         num_blocks: int) -> torch.Tensor:
    """Six heldout sums over padded pairs (weight 0 on padding), blocked
    into num_blocks equal blocks; f32 accumulation as in the JAX scan."""
    acc = torch.zeros(6, dtype=torch.float32, device=pi.device)
    for pb, yb, wb in zip(pairs.chunk(num_blocks), y.chunk(num_blocks),
                          w.chunk(num_blocks)):
        acc += _block_sums(pi, beta, pb, yb, wb, epsilon)
    return acc


def heldout_sums_rows_plain(gamma, lam, pairs, y, w, epsilon: float,
                            num_blocks: int) -> torch.Tensor:
    """The six sums in the kernel's form, in plain PyTorch: gather the
    pairs' gamma rows as they are and normalise those, each by its own sum;
    pi of the other nodes is never made."""
    beta = lam[:, 0] / (lam[:, 0] + lam[:, 1])
    acc = torch.zeros(6, dtype=torch.float32, device=gamma.device)
    for pb, yb, wb in zip(pairs.chunk(num_blocks), y.chunk(num_blocks),
                          w.chunk(num_blocks)):
        # the block's 2B rows, normalised: pair i is rows 2i and 2i + 1
        rows = gamma[pb.reshape(-1).long()]
        pi = rows / rows.sum(dim=1, keepdim=True)
        two = torch.arange(pi.shape[0], device=gamma.device).view(-1, 2)
        acc += _block_sums(pi, beta, two, yb, wb, epsilon)
    return acc


def heldout_sums(gamma, lam, pairs, y, w, epsilon: float) -> torch.Tensor:
    """Kernel 6 (csrc/heldout_sums.cu): the six heldout sums over padded
    pairs (weight 0 on padding) of gamma/lambda on the card, in one launch
    over all pairs and a small one that adds the blocks' sums in order.
    gamma (n,K) f32; pairs (m,2) and y (m,) integers; w (m,) f32."""
    build.require_cuda(gamma, "heldout_sums")
    dev = gamma.device
    if gamma.dim() != 2:
        raise ValueError(f"gamma must be (n, k), got {tuple(gamma.shape)}")
    n, k = gamma.shape
    m = pairs.shape[0]
    build.check_cuda(gamma, "gamma", torch.float32, (n, k), dev)
    build.check_cuda(lam, "lam", torch.float32, (k, 2), dev)
    pairs = pairs.to(torch.int32).contiguous()
    y = y.to(torch.int32).contiguous()
    build.check_cuda(pairs, "pairs", torch.int32, (m, 2), dev)
    build.check_cuda(y, "y", torch.int32, (m,), dev)
    build.check_cuda(w, "w", torch.float32, (m,), dev)
    beta = (lam[:, 0] / (lam[:, 0] + lam[:, 1])).contiguous()
    out = torch.empty(6, dtype=torch.float32, device=dev)
    partial = torch.empty((build.REDUCE_SCRATCH_ROWS // 2, 6),
                          dtype=torch.float32, device=dev)
    build.launch("svt_heldout_sums", dev, gamma.data_ptr(), beta.data_ptr(),
                 pairs.data_ptr(), y.data_ptr(), w.data_ptr(),
                 partial.data_ptr(), out.data_ptr(), m, k,
                 float(np.float32(1.0 - epsilon)))
    build.count_launch(heldout_sums, "f32")
    return out


heldout_sums.launches = 0
heldout_sums.forms = {}


def heldout_sums_blocked(gamma, lam, pairs, y, w, epsilon: float,
                         num_blocks: int) -> torch.Tensor:
    """The six heldout sums on gamma/lambda, the tail of a sweep step:
    kernel 6 on a CUDA tensor, heldout_sums_from_pi on a CPU tensor."""
    if gamma.device.type != "cpu":
        return heldout_sums(gamma, lam, pairs, y, w, epsilon)
    pi, beta = _pi_beta(gamma, lam)
    return heldout_sums_from_pi(pi, beta, pairs, y, w, epsilon, num_blocks)


def multi_heldout_sums(gamma, lam, pairs, ys, ws, epsilon: float,
                       blocks) -> torch.Tensor:
    """The six sums of several padded pair sets on one state, stacked
    (S, 6) (svinet_tpu/evals/likelihood.py:131): one launch of kernel 6 a
    set on the card. pairs, ys, ws and blocks are tuples, one entry a
    set."""
    return torch.stack([
        heldout_sums_blocked(gamma, lam, p, y, w, epsilon, nb)
        for p, y, w, nb in zip(pairs, ys, ws, blocks)])


def result_from_sums(sums) -> HeldoutResult:
    s, k, s0, k0, s1, k1 = (float(v) for v in sums.tolist())
    return HeldoutResult(
        avg=s / max(k, 1), count=int(k),
        avg0=s0 / max(k0, 1), count0=int(k0),
        avg1=s1 / max(k1, 1), count1=int(k1))


def heldout_stats(gamma, lam, pairs, y, epsilon: float,
                  block: int = PAIR_BLOCK) -> HeldoutResult:
    """Heldout likelihood summary of an unpadded pair set."""
    m = pairs.shape[0]
    if m == 0:
        return HeldoutResult(0.0, 0, 0.0, 0, 0.0, 0)
    if gamma.device.type != "cpu":
        ones = torch.ones(m, dtype=torch.float32, device=gamma.device)
        return result_from_sums(heldout_sums(gamma, lam, pairs, y, ones,
                                             epsilon))
    pi, beta = _pi_beta(gamma, lam)
    acc = torch.zeros(6, dtype=torch.float32, device=gamma.device)
    for lo in range(0, m, block):
        pb, yb = pairs[lo:lo + block], y[lo:lo + block]
        wb = torch.ones(pb.shape[0], dtype=torch.float32, device=gamma.device)
        acc += _block_sums(pi, beta, pb, yb, wb, epsilon)
    return result_from_sums(acc)


def link_probs(gamma, lam, pairs, block: int = PAIR_BLOCK) -> torch.Tensor:
    """P(y=1) under point estimates, for AUC
    (reference: LinkSampling::link_prob, src/linksampling.hh:239-257)."""
    pi, beta = _pi_beta(gamma, lam)
    return torch.cat([
        (pi[pairs[lo:lo + block, 0]] * pi[pairs[lo:lo + block, 1]]
         * beta).sum(dim=-1)
        for lo in range(0, pairs.shape[0], block)]
        or [torch.zeros(0, dtype=torch.float32, device=gamma.device)])
