"""Approximate ELBO, -logl's logl.txt (svinet_tpu/evals/elbo.py;
reference: MMSBInfer::approx_log_likelihood, src/mmsbinfer.cc:1947-2083).

The global Beta and Dirichlet terms are plain PyTorch; the per-pair local
terms (each pair's phi fixed point, its expected log-likelihood and
entropy) are kernel 8's ELBO form (ops/phicomp.py).
"""

from __future__ import annotations

import torch

from svinet_torch.ops.expectations import dirichlet_expectation
from svinet_torch.ops.phicomp import BLOCK, phi_fixed_point


def approx_elbo(gamma, lam, pairs, y, w, alpha: float, eta, log_eps: float,
                max_iters: int = 50, thresh: float = 1e-5,
                block: int = BLOCK) -> torch.Tensor:
    """pairs: all non-heldout training pairs (links and nonlinks); w their
    weights; `block` the exit rule's (ops/phicomp.py). Returns a () f32
    tensor."""
    n, k = gamma.shape
    lg = torch.lgamma
    elogpi = dirichlet_expectation(gamma)
    elogbeta = dirichlet_expectation(lam)

    # global Beta terms (lambda against the eta prior)
    s = (lg(eta.sum(1)) - lg(eta).sum(1)
         + ((eta - 1.0) * elogbeta).sum(1)).sum()
    s = s - (lg(lam.sum(1)) - lg(lam).sum(1)
             + ((lam - 1.0) * elogbeta).sum(1)).sum()

    pair_s, _ = phi_fixed_point(elogpi, elogbeta, pairs, y, w, log_eps,
                                max_iters, thresh, block=block, elbo=True)
    s = s + pair_s

    # per-node Dirichlet terms (gamma against the alpha prior)
    a = torch.tensor(alpha, dtype=torch.float32, device=gamma.device)
    alpha_row = a.expand(k)
    s = s + n * (lg(alpha_row.sum()) - lg(alpha_row).sum())
    s = s + ((a - 1.0) * elogpi).sum()
    s = s - (lg(gamma.sum(1)) - lg(gamma.clamp_min(1e-30)).sum(1)).sum()
    s = s - ((gamma - 1.0) * elogpi).sum()
    return s
