"""Link-prediction precision: ranked hitcurves and the Adamic-Adar baseline.

Reference: FastAMM2::compute_precision (src/fastamm2.cc:1394-1460) scores
every pair in the precision set by P(y=1) under the model, ranks them, and
counts hits (true links) in the top 10/100/1000, writing hitcurve_<i>.txt
checkpoints and a precision.txt row per report.
FastAMM2::compute_adamic_adar_score (src/fastamm2.cc:1503-1588) is the
non-model baseline: score(p,q) = sum over common neighbors w of
1/log(deg_w).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def precision_counts(scores: np.ndarray, y: np.ndarray
                     ) -> Tuple[int, int, int, np.ndarray]:
    """Rank pairs by score desc; cumulative hits at 10/100/1000 and the
    full cumulative-hit curve."""
    order = np.argsort(-scores, kind="stable")
    hits = (np.asarray(y)[order] == 1).astype(np.int64)
    cum = np.cumsum(hits)
    c10 = int(cum[min(9, len(cum) - 1)]) if len(cum) else 0
    c100 = int(cum[min(99, len(cum) - 1)]) if len(cum) else 0
    c1000 = int(cum[min(999, len(cum) - 1)]) if len(cum) else 0
    return c10, c100, c1000, cum


def write_hitcurve(path: str, cum: np.ndarray, step: int = 1000) -> None:
    """Rank/hits rows, thinned exactly as the reference thins them:
    step_size = 1000, emitting rank 1 and every 1000th rank
    (reference: src/fastamm2.cc:1431-1452,
    `if (i == 0 || (i+1) % step_size == 0) fprintf(_hcf, ...)`)."""
    with open(path, "w") as f:
        for i in range(len(cum)):
            if i == 0 or (i + 1) % step == 0:
                f.write(f"{i + 1}\t{int(cum[i])}\n")


def auc(scores: np.ndarray, y: np.ndarray) -> float:
    """Area under the ROC curve via the rank-sum statistic (the reference
    exports score files for an external `roc` binary,
    src/linksampling.cc:854-879; here computed natively)."""
    y = np.asarray(y)
    pos = scores[y == 1]
    neg = scores[y == 0]
    if len(pos) == 0 or len(neg) == 0:
        return 0.5
    allv = np.concatenate([pos, neg])
    # midranks for ties
    uniq, inv, cnt = np.unique(allv, return_inverse=True,
                               return_counts=True)
    cum = np.cumsum(cnt)
    mid = cum - (cnt - 1) / 2.0
    ranks = mid[inv]
    rp = ranks[: len(pos)].sum()
    return float((rp - len(pos) * (len(pos) + 1) / 2) /
                 (len(pos) * len(neg)))


def adamic_adar_scores(network, pairs: np.ndarray) -> np.ndarray:
    """score(p,q) = sum_{w in N(p) ∩ N(q)} 1 / log(deg_w)
    (reference: src/fastamm2.cc:1503-1588)."""
    deg = network.deg.astype(np.float64)
    inv_log = np.where(deg > 1, 1.0 / np.log(np.maximum(deg, 2)), 0.0)
    out = np.zeros(len(pairs))
    for i, (p, q) in enumerate(pairs):
        np_ = network.neighbors(int(p))
        nq = network.neighbors(int(q))
        common = np.intersect1d(np_, nq)
        out[i] = inv_log[common].sum()
    return out
