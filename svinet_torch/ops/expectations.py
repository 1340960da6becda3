"""Dirichlet/Beta expectation primitives (svinet_tpu/ops/expectations.py).

E[log pi]_ik = psi(gamma_ik) - psi(sum_k gamma_ik) runs through kernel 1
(ops/digamma.py) on the card; the point estimate is plain torch.
"""

from __future__ import annotations

import torch

from svinet_torch.ops.digamma import (
    dirichlet_expectation, dirichlet_expectation_plain)


def dirichlet_mean(x: torch.Tensor) -> torch.Tensor:
    """Point estimate E[p]_k = x_k / sum(x) over the last axis
    (reference: LinkSampling::estimate_pi, src/linksampling.hh:204-214)."""
    return x / x.sum(dim=-1, keepdim=True)


__all__ = ["dirichlet_expectation", "dirichlet_expectation_plain",
           "dirichlet_mean"]
