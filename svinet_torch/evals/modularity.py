"""Soft modularity of the mixed-membership assignment
(svinet_tpu/evals/modularity.py; reference: MMSBInfer::compute_modularity,
src/mmsbinfer.cc:2372-2397):

  q_raw = sum_ij (y_ij - d_i d_j / 2E) pi_i . pi_j   (ordered pairs)
  q     = q_raw / 2E
  assor = q_raw / (2E - sum_ij (d_i d_j / 2E) pi_i . pi_j)

with sum_ij y_ij pi_i.pi_j = 2 sum_links pi_p.pi_q and the null term
||sum_i d_i pi_i||^2 / 2E. Plain PyTorch, blocked over links so the
gathered (B,K) rows stay near 2^26 floats; once per report.
"""

from __future__ import annotations

import torch


def modularity(gamma, edges, mask, deg):
    """(q, assortativity) as () f32 tensors. deg: (n,) f32 training
    degrees; edges/mask: the padded training links."""
    pi = gamma / gamma.sum(dim=1, keepdim=True)
    two_e = deg.sum().clamp_min(1.0)
    block = max(1, (1 << 26) // max(int(gamma.shape[1]), 1))
    link_term = torch.zeros((), dtype=gamma.dtype, device=gamma.device)
    for lo in range(0, edges.shape[0], block):
        e = edges[lo:lo + block].long()
        link_term = link_term + ((pi[e[:, 0]] * pi[e[:, 1]]).sum(-1)
                                 * mask[lo:lo + block]).sum()
    link_term = 2.0 * link_term
    dpi = (deg[:, None] * pi).sum(0)
    null_term = (dpi * dpi).sum() / two_e
    q_raw = link_term - null_term
    return q_raw / two_e, q_raw / (two_e - null_term).clamp_min(1e-30)
