"""Validation-plateau stopping rule.

Replicates the reference's controller (src/linksampling.cc:1003-1050;
src/mmsbinfer.cc:2133-2173): stop when the held-out likelihood at network
sparsity (nshol) plateaus (relative change < stopthresh while increasing)
or declines for 3 consecutive reports. During the annealing phase the first
"stop" instead ends annealing (src/linksampling.cc:1036-1043).

A copy of svinet_tpu/evals/stopping.py: the port cannot import it from
there, because svinet_tpu/evals/__init__.py imports JAX. Tests hold
the two equal.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ValidationStop:
    """Per-engine parameters mirror the reference controllers exactly:

    - LinkSampling: guard ``iter > 10``, plateau why=100, >2 declines
      (src/linksampling.cc:1008-1028)
    - MMSBInfer/FastAMM/FastAMM2: guard ``iter > min(n, 5000)``, plateau
      why=0, >2 declines (src/mmsbinfer.cc:2135-2163,
      src/fastamm.cc:1310, src/fastamm2.cc:1339)
    - SBM: guard ``iter > 5000``, why=0, >3 declines (src/sbm.cc:895-911)
    - FastInit: no guard, why=0, >10 declines (src/fastinit.cc:548-560)

    max_h (and the dual-split at-max validation eval) latch only inside
    the guard, exactly like every reference controller — early annealing
    spikes before the guard never count as the recorded max."""
    stopthresh: float = 1e-5
    min_iter: int = 10
    plateau_why: int = 100
    decline_reports: int = 2     # stop when nh EXCEEDS this

    prev_h: float = -2147483647.0
    max_h: float = -2147483647.0
    max_t: float = 0.0
    nh: int = 0
    why: int = -1
    since_max: int = 0   # reports since a new best nshol was set

    def update(self, iteration: int, nshol: float) -> bool:
        """Feed one report; returns True when the run should stop."""
        a = nshol
        stop = False
        self.why = -1
        if iteration > self.min_iter:
            if (a > self.prev_h and self.prev_h != 0 and
                    abs((a - self.prev_h) / self.prev_h) < self.stopthresh):
                stop = True
                self.why = self.plateau_why
            elif a < self.prev_h:
                self.nh += 1
            elif a > self.prev_h:
                self.nh = 0
            if a > self.max_h:
                self.max_h = a
                self.max_t = 0.0
                self.since_max = 0
            else:
                self.since_max += 1
            if self.nh > self.decline_reports:
                self.why = 1
                stop = True
        self.prev_h = a
        return stop

    def reset_after_annealing(self) -> None:
        """The first plateau ends the annealing phase instead of the run."""
        self.nh = 0
        self.why = 0
        self.prev_h = 0.0
        self.since_max = 0
