"""Output-file writers in the reference's exact TSV schemas.

These text files are the interop surface: gamma.txt / lambda.txt
(reference: LinkSampling::save_model, src/linksampling.cc:804-837),
communities.txt (write_communities, src/linksampling.cc:942-975),
groups.txt (write_groups, src/linksampling.cc:1455-1476),
the 11-column validation/test/heldout rows
(validation_likelihood, src/linksampling.cc:996-1001), and max.txt
(src/linksampling.cc:1030-1034).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional

import numpy as np


def save_model(outdir: str, gamma: np.ndarray, lam: np.ndarray,
               seq2id: np.ndarray) -> None:
    """Write gamma.txt (seq, ext-id, K values) and lambda.txt (k, lam0, lam1).
    gamma.txt goes through the native buffered writer when available."""
    gamma = np.asarray(gamma)
    lam = np.asarray(lam)
    n, k = gamma.shape
    from svinet_torch.io.native import write_matrix_tsv
    if not write_matrix_tsv(os.path.join(outdir, "gamma.txt"), gamma,
                            np.asarray(seq2id)):
        with open(os.path.join(outdir, "gamma.txt"), "w") as f:
            for i in range(n):
                vals = "\t".join(f"{gamma[i, j]:.5f}" for j in range(k))
                f.write(f"{i}\t{int(seq2id[i])}\t{vals}\n")
    with open(os.path.join(outdir, "lambda.txt"), "w") as f:
        for i in range(lam.shape[0]):
            vals = "\t".join(f"{lam[i, t]:.5f}" for t in range(lam.shape[1]))
            f.write(f"{i}\t{vals}\n")


def load_model(dirname: str, n: int, k: int, t: int = 2):
    """Parse gamma.txt/lambda.txt back (reference: LinkSampling::load_model,
    src/linksampling.cc:1266-1352)."""
    gamma = np.zeros((n, k), np.float64)
    with open(os.path.join(dirname, "gamma.txt")) as f:
        for line in f:
            toks = line.split()
            if len(toks) < k + 2:
                continue
            seq = int(toks[0])
            gamma[seq] = [float(x) for x in toks[2: k + 2]]
    lam = np.zeros((k, t), np.float64)
    with open(os.path.join(dirname, "lambda.txt")) as f:
        for line in f:
            toks = line.split()
            if len(toks) < t + 1:
                continue
            lam[int(toks[0])] = [float(x) for x in toks[1: t + 1]]
    return gamma, lam


def write_communities(path: str, communities: Dict[int, Iterable[int]],
                      seq2id: np.ndarray) -> None:
    """One community per line: sorted external node ids, space separated."""
    with open(path, "w") as f:
        for c in sorted(communities.keys()):
            members = communities[c]
            ids = sorted({int(seq2id[int(s)]) for s in members})
            if not ids:
                continue
            f.write(" ".join(str(i) for i in ids) + " \n")


def write_groups(path: str, gamma: np.ndarray, seq2id: np.ndarray,
                 with_argmax: bool = True) -> None:
    """groups.txt: seq, ext-id, E[pi] row (3 decimals), argmax group."""
    gamma = np.asarray(gamma)
    pi = gamma / gamma.sum(axis=1, keepdims=True)
    arg = pi.argmax(axis=1)
    if with_argmax:
        from svinet_torch.io.native import write_matrix_tsv_extra
        if write_matrix_tsv_extra(path, pi, np.asarray(seq2id), arg,
                                  decimals=3):
            return
    with open(path, "w") as f:
        for i in range(gamma.shape[0]):
            vals = "\t".join(f"{v:.3f}" for v in pi[i])
            row = f"{i}\t{int(seq2id[i])}\t{vals}"
            if with_argmax:
                row += f"\t{int(arg[i])}"
            f.write(row + "\n")


class ReportFile:
    """An 11-column per-report metric file (validation.txt / test.txt /
    heldout.txt): iter, duration, avg, count, avg0, count0, avg1, count1,
    zeros_prob*avg0, ones_prob*avg1, nshol."""

    def __init__(self, path: str, append: bool = False):
        self._f = open(path, "a" if append else "w")

    def write(self, iteration: int, duration: int, res, zeros_prob: float,
              ones_prob: float) -> float:
        nshol = res.nshol(zeros_prob, ones_prob)
        self._f.write(
            f"{iteration}\t{duration}\t{res.avg:.9f}\t{res.count}\t"
            f"{res.avg0:.9f}\t{res.count0}\t{res.avg1:.9f}\t{res.count1}\t"
            f"{zeros_prob * res.avg0:.9f}\t{ones_prob * res.avg1:.9f}\t"
            f"{nshol:.9f}\n")
        self._f.flush()
        return nshol

    def write8(self, iteration: int, duration: int, res) -> None:
        """8-column at-max validation row (the classic-SVI engines'
        validation.txt entries, written only when a new heldout max is
        reached: src/mmsbinfer.cc:2214-2217): iter, duration, avg, count,
        avg0, count0, avg1, count1."""
        self._f.write(
            f"{iteration}\t{duration}\t{res.avg:.5f}\t{res.count}\t"
            f"{res.avg0:.5f}\t{res.count0}\t{res.avg1:.5f}\t"
            f"{res.count1}\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def write_max(path: str, iteration: int, duration: int, a: float,
              max_t: float, max_h: float, why: int,
              max_v: "float | None" = None) -> None:
    """max.txt: 6 columns for LinkSampling (src/linksampling.cc:1030-1034)
    or 7 with the validation-at-max column for the classic-SVI engines
    (src/mmsbinfer.cc:2165-2169: iter, dur, a, max_t, max_h, max_v, why)."""
    with open(path, "w") as f:
        if max_v is None:
            f.write(f"{iteration}\t{duration}\t{a:.5f}\t{max_t:.5f}\t"
                    f"{max_h:.5f}\t{why}\n")
        else:
            f.write(f"{iteration}\t{duration}\t{a:.5f}\t{max_t:.5f}\t"
                    f"{max_h:.5f}\t{max_v:.5f}\t{why}\n")


def write_edgelist(path: str, pairs: np.ndarray, ys: np.ndarray,
                   seq2id: np.ndarray) -> None:
    """validation-edges.txt / test-edges.txt: ext-id pairs + observed y."""
    with open(path, "w") as f:
        for (p, q), y in zip(pairs, ys):
            f.write(f"{int(seq2id[p])}\t{int(seq2id[q])}\t{int(y)}\n")
        f.write("\n")
