"""Carry model state between the JAX package and the port.

The (gamma, lambda) pair is this system's model: gamma (n,K) holds the
per-node Dirichlet parameters, lambda (K,2) the per-community Beta
parameters. The JAX engine's arrays come over as numpy arrays, or as the
gamma.txt/lambda.txt files its runs write.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from svinet_torch.io.writers import load_model


def state_from_numpy(gamma, lam, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """numpy (or array-like) gamma/lambda -> contiguous f32 tensors."""
    g = torch.as_tensor(np.array(gamma, np.float32), device=device)
    l = torch.as_tensor(np.array(lam, np.float32), device=device)
    if g.dim() != 2 or l.shape != (g.shape[1], 2):
        raise ValueError(f"gamma {tuple(g.shape)} / lambda {tuple(l.shape)}"
                         f": expected (n,K) and (K,2)")
    return g.contiguous(), l.contiguous()


def state_to_numpy(gamma: torch.Tensor, lam: torch.Tensor
                   ) -> Tuple[np.ndarray, np.ndarray]:
    return gamma.detach().cpu().numpy(), lam.detach().cpu().numpy()


def load_state(outdir: str, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """gamma.txt/lambda.txt of a run (either package's) -> tensors. n is
    the number of gamma rows and K the number of values in a row."""
    with open(os.path.join(outdir, "gamma.txt")) as f:
        rows = [line.split() for line in f if line.strip()]
    if not rows:
        raise ValueError(f"{outdir}/gamma.txt is empty")
    n, k = len(rows), len(rows[0]) - 2
    gamma, lam = load_model(outdir, n, k)
    return state_from_numpy(gamma, lam, device)
