"""Overlapping-cover normalized mutual information (NMI).

In-process reimplementation of the Lancichinetti/Fortunato/Kertesz NMI for
covers ("mutual3"), which the reference shells out to as an external binary
(reference: LinkSampling::log_communities, src/linksampling.cc:839-852;
definition: Lancichinetti et al. 2009, New J. Phys. 11 033015, Appendix B).

Each community is a binary membership vector over the node universe (the
union of nodes in both covers). For communities Xi, Yj with joint counts
a (neither), b (Yj only), c (Xi only), d (both):

  H(Xi|Yj) = h(a)+h(b)+h(c)+h(d) - h(b+d) - h(a+c)      [counts-based h]
  valid only when h(d)+h(a) >= h(b)+h(c), else H(Xi|Yj) := H(Xi)
  H(Xi|Y) = min_j H(Xi|Yj)
  NMI(X,Y) = 1 - 0.5*( <H(Xi|Y)/H(Xi)>_i + <H(Yj|X)/H(Yj)>_j )

A copy of svinet_tpu/evals/nmi.py: the port cannot import it from
there, because svinet_tpu/evals/__init__.py imports JAX. Tests hold
the two equal.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np


def _h(w: np.ndarray, n: float) -> np.ndarray:
    """Entropy contribution -p*log(p) with h(0) = 0, in nats."""
    p = np.asarray(w, np.float64) / n
    out = np.zeros_like(p)
    nz = p > 0
    out[nz] = -p[nz] * np.log(p[nz])
    return out


def _conditional_norm(X: np.ndarray, Y: np.ndarray, n: int) -> float:
    """<H(Xi|Y)/H(Xi)> averaged over communities Xi (rows of X)."""
    cx = X.sum(axis=1).astype(np.float64)          # (Cx,)
    cy = Y.sum(axis=1).astype(np.float64)          # (Cy,)
    d = (X.astype(np.float64) @ Y.T.astype(np.float64))   # (Cx,Cy) in both
    c = cx[:, None] - d                            # Xi only
    b = cy[None, :] - d                            # Yj only
    a = n - b - c - d                              # neither

    H_xi = _h(cx, n) + _h(n - cx, n)               # (Cx,)
    H_yj = _h(cy, n) + _h(n - cy, n)               # (Cy,)
    joint = _h(a, n) + _h(b, n) + _h(c, n) + _h(d, n)
    cond = joint - H_yj[None, :]

    valid = (_h(d, n) + _h(a, n)) >= (_h(b, n) + _h(c, n))
    cond = np.where(valid, cond, H_xi[:, None])
    h_cond = cond.min(axis=1) if Y.shape[0] else H_xi

    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(H_xi > 0, h_cond / np.maximum(H_xi, 1e-300), 0.0)
    return float(terms.mean()) if len(terms) else 0.0


def _to_matrix(cover: Sequence[Iterable[int]], node_index: dict) -> np.ndarray:
    mat = np.zeros((len(cover), len(node_index)), bool)
    for i, comm in enumerate(cover):
        for v in comm:
            mat[i, node_index[int(v)]] = True
    return mat


def overlapping_nmi(cover_a: Sequence[Iterable[int]],
                    cover_b: Sequence[Iterable[int]]) -> float:
    """NMI between two covers given as lists of node-id collections."""
    cover_a = [list(c) for c in cover_a if len(list(c))]
    cover_b = [list(c) for c in cover_b if len(list(c))]
    if not cover_a or not cover_b:
        return 0.0
    nodes = sorted({int(v) for c in cover_a for v in c} |
                   {int(v) for c in cover_b for v in c})
    index = {v: i for i, v in enumerate(nodes)}
    n = len(nodes)
    X = _to_matrix(cover_a, index)
    Y = _to_matrix(cover_b, index)
    hxy = _conditional_norm(X, Y, n)
    hyx = _conditional_norm(Y, X, n)
    return 1.0 - 0.5 * (hxy + hyx)


def read_cover_file(path: str) -> List[List[int]]:
    """Read a communities file: one community per line, space-separated ids."""
    cover = []
    with open(path) as f:
        for line in f:
            ids = [int(t) for t in line.split()]
            if ids:
                cover.append(ids)
    return cover
