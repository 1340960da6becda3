"""Carry model state between the JAX package and the port.

The (gamma, lambda) pair is this system's model: gamma (n,K) holds the
per-node Dirichlet parameters, lambda (K,2) the per-community Beta
parameters. A -fuse-s3 run also carries mphi (n,K), the mean indicators
of its last sweep, which the next sweep's s3 is made from. The JAX
engine's arrays come over as numpy arrays, or as the gamma.txt/lambda.txt
files its runs write (mphi is in no file: a loaded run starts from
mphi = 0, as the JAX engine does).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from svinet_torch.io.writers import load_model


def state_from_numpy(gamma, lam, device, mphi=None
                     ) -> Tuple[torch.Tensor, ...]:
    """numpy (or array-like) gamma/lambda -> contiguous f32 tensors
    (gamma, lam); with `mphi`, the -fuse-s3 state (gamma, lam, mphi)."""
    g = torch.as_tensor(np.array(gamma, np.float32), device=device)
    l = torch.as_tensor(np.array(lam, np.float32), device=device)
    if g.dim() != 2 or l.shape != (g.shape[1], 2):
        raise ValueError(f"gamma {tuple(g.shape)} / lambda {tuple(l.shape)}"
                         f": expected (n,K) and (K,2)")
    if mphi is None:
        return g.contiguous(), l.contiguous()
    m = torch.as_tensor(np.array(mphi, np.float32), device=device)
    if m.shape != g.shape:
        raise ValueError(f"mphi {tuple(m.shape)}: expected gamma's shape "
                         f"{tuple(g.shape)}")
    return g.contiguous(), l.contiguous(), m.contiguous()


def state_to_numpy(*state: torch.Tensor) -> Tuple[np.ndarray, ...]:
    """(gamma, lam) or (gamma, lam, mphi) tensors -> numpy arrays."""
    return tuple(t.detach().cpu().numpy() for t in state)


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
