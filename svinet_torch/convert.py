"""Carry model state between the JAX package and the port.

The (gamma, lambda) pair is this system's model: gamma (n,K) holds the
per-node Dirichlet parameters, lambda (K,2) the per-community Beta
parameters. A -fuse-s3 run also carries mphi (n,K), the mean indicators
of its last sweep, which the next sweep's s3 is made from, and a -freeze
run conv (n,), its sticky converged flags (0 = free, else the frozen
column + 1). The JAX engine's arrays come over as numpy arrays, or as the
gamma.txt/lambda.txt files its runs write (mphi and conv are in no file:
a loaded run starts from mphi = 0 and no frozen node, as the JAX engine
does). FastInit's state (labels, ids, cnt), SBM's (phi, gamma_k, lam,
eta) and MMSBOrig's (gamma, and the K x K beta) come over by name into an
engine of the port (set_engine_state), and go back as numpy arrays
(engine_state).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from svinet_torch.io.writers import load_model


def state_from_numpy(gamma, lam, device, mphi=None, conv=None
                     ) -> Tuple[torch.Tensor, ...]:
    """numpy (or array-like) gamma/lambda -> contiguous f32 tensors
    (gamma, lam); with `mphi`, the -fuse-s3 state (gamma, lam, mphi); with
    `conv`, the -freeze flags follow as an int32 tensor, last."""
    g = torch.as_tensor(np.array(gamma, np.float32), device=device)
    l = torch.as_tensor(np.array(lam, np.float32), device=device)
    if g.dim() != 2 or l.shape != (g.shape[1], 2):
        raise ValueError(f"gamma {tuple(g.shape)} / lambda {tuple(l.shape)}"
                         f": expected (n,K) and (K,2)")
    state = [g.contiguous(), l.contiguous()]
    if mphi is not None:
        m = torch.as_tensor(np.array(mphi, np.float32), device=device)
        if m.shape != g.shape:
            raise ValueError(f"mphi {tuple(m.shape)}: expected gamma's "
                             f"shape {tuple(g.shape)}")
        state.append(m.contiguous())
    if conv is not None:
        c = torch.as_tensor(np.array(conv, np.int32), device=device)
        if c.shape != g.shape[:1] or int(c.min()) < 0 \
                or int(c.max()) > g.shape[1]:
            raise ValueError(f"conv {tuple(c.shape)}: expected "
                             f"({g.shape[0]},) flags in [0, {g.shape[1]}]")
        state.append(c.contiguous())
    return tuple(state)


def state_to_numpy(*state: torch.Tensor) -> Tuple[np.ndarray, ...]:
    """(gamma, lam), with mphi and conv where the run has them, as
    tensors -> numpy arrays."""
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


# the arrays of each engine's state that cross between the packages, with
# their dtypes
ENGINE_STATE = {
    "FastInit": {"labels": np.int32, "ids": np.int32, "cnt": np.float32},
    "SBM": {"phi": np.float32, "gamma_k": np.float32, "lam": np.float32,
            "eta": np.float32},
    "MMSBOrig": {"gamma": np.float32, "beta": np.float32},
}


def _state_shapes(engine) -> dict:
    n, k = engine.n, engine.k
    if type(engine).__name__ == "FastInit":
        w = engine.width
        return {"labels": (n,), "ids": (n, w), "cnt": (n, w)}
    if type(engine).__name__ == "MMSBOrig":
        return {"gamma": (n, k), "beta": (k, k)}
    return {"phi": (n, k), "gamma_k": (k,), "lam": (k + 1, 2),
            "eta": (k + 1, 2)}


def set_engine_state(engine, **arrays) -> None:
    """Put numpy arrays (a JAX FastInit's, SBM's or MMSBOrig's, by
    attribute name) into the port's engine of the same kind, on its
    device."""
    kind = type(engine).__name__
    dtypes, shapes = ENGINE_STATE[kind], _state_shapes(engine)
    for name, a in arrays.items():
        if name not in dtypes:
            raise ValueError(f"{kind} has no state array {name!r}")
        a = np.array(a, dtypes[name])
        if a.shape != shapes[name]:
            raise ValueError(f"{name} {a.shape}: expected {shapes[name]}")
        setattr(engine, name, torch.as_tensor(a, device=engine.device))


def engine_state(engine) -> dict:
    """The engine's state arrays (those set) as numpy arrays, by name."""
    return {name: getattr(engine, name).detach().cpu().numpy()
            for name in ENGINE_STATE[type(engine).__name__]
            if getattr(engine, name, None) is not None}
