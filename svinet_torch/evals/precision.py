"""Link-prediction AUC (svinet_tpu/evals/precision.py:43-61).

A copy of svinet_tpu/evals/precision.py: the port cannot import it from
there, because svinet_tpu/evals/__init__.py imports JAX. Tests hold
the two equal.
"""

from __future__ import annotations

import numpy as np


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
