"""Local differential privacy: Theorem 1 calibration and a moments accountant.

A numpy copy of ``src/repro/core/privacy.py``.

The paper (Theorem 1) shows PORTER-DP is (eps, delta)-LDP over T iterations
with batch size b = 1 and sampling probability q = 1/m when

    sigma_p^2 = T tau^2 log(1/delta) / (m^2 eps^2)  =  T tau^2 phi_m^2 / d,

where phi_m = sqrt(d log(1/delta)) / (m eps) is the centralized baseline
utility (Eq. 4).  The smooth clipping operator guarantees every per-sample
gradient has norm < tau, so the subsampled-Gaussian sensitivity is 2*tau...
actually <= tau per sample for add/remove and <= 2 tau for replace; the paper
uses the [ACG+16] moments bound with sensitivity tau, which we follow.

This module provides:

* ``phi_m`` -- the baseline utility (Eq. 4).
* ``calibrate_sigma`` -- Theorem 1's noise scale (Eq. 5).
* ``MomentsAccountant`` -- tracks the [ACG+16, Lemma 3] log-MGF bound
  alpha(lambda) <= q^2 lambda (lambda+1) / ((1-q) s^2) + O(q^3 lambda^3 / s^3)
  with s = sigma_p / tau (the noise multiplier), composed over steps, and
  converts to (eps, delta) via the tail bound
  delta = min_lambda exp(T alpha(lambda) - lambda eps).

The accountant is an upper bound; tests check that Theorem 1's sigma indeed
yields eps' <= O(eps) under the accountant and that eps decreases
monotonically in sigma and increases in T.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

__all__ = [
    "phi_m",
    "calibrate_sigma",
    "MomentsAccountant",
    "ldp_epsilon",
]


def phi_m(d: int, m: int, eps: float, delta: float) -> float:
    """Baseline utility phi_m = sqrt(d log(1/delta)) / (m eps)   (Eq. 4)."""
    return math.sqrt(d * math.log(1.0 / delta)) / (m * eps)


def calibrate_sigma(tau: float, T: int, m: int, eps: float, delta: float) -> float:
    """Theorem 1 / Eq. (5): sigma_p = tau sqrt(T log(1/delta)) / (m eps).

    Note the paper states sigma_p^2 = T tau^2 log(1/delta) / (m^2 eps^2) and
    also writes the experiment setting sigma_p = tau sqrt(T log(1/delta))/(m eps);
    these agree.
    """
    if eps <= 0 or not (0 < delta < 1):
        raise ValueError("need eps > 0 and delta in (0,1)")
    return tau * math.sqrt(T * math.log(1.0 / delta)) / (m * eps)


@dataclasses.dataclass
class MomentsAccountant:
    """[ACG+16]-style moments accountant for the subsampled Gaussian mechanism.

    q: per-sample inclusion probability (= b/m; paper uses b=1 -> q=1/m).
    noise_multiplier: s = sigma_p / tau.
    """

    q: float
    noise_multiplier: float
    steps: int = 0
    max_lambda: int = 64

    def step(self, n: int = 1) -> None:
        self.steps += n

    def _log_mgf_one_step(self, lam: float) -> float:
        """Lemma-3 style bound on alpha_M(lambda) for one subsampled step."""
        q, s = self.q, self.noise_multiplier
        if s <= 0:
            return math.inf
        main = q * q * lam * (lam + 1.0) / max((1.0 - q) * s * s, 1e-12)
        tail = (q ** 3) * (lam ** 3) / (s ** 3)
        return main + 2.0 * tail

    def epsilon(self, delta: float) -> float:
        """Smallest eps such that the composed mechanism is (eps, delta)-DP."""
        best = math.inf
        for lam in range(1, self.max_lambda + 1):
            a = self.steps * self._log_mgf_one_step(float(lam))
            if not math.isfinite(a):
                continue
            eps = (a + math.log(1.0 / delta)) / lam
            best = min(best, eps)
        return best

    def delta(self, eps: float) -> float:
        best = 1.0
        for lam in range(1, self.max_lambda + 1):
            a = self.steps * self._log_mgf_one_step(float(lam))
            x = a - lam * eps
            # x >= 0 is a vacuous tail bound (delta >= 1) and would
            # overflow exp for large compositions; it can never beat the
            # 1.0 cap, so skip it
            if not math.isfinite(x) or x >= 0.0:
                continue
            best = min(best, math.exp(x))
        return best


def ldp_epsilon(tau: float, sigma_p: float, T: int, m: int,
                delta: float, b: int = 1) -> float:
    """eps achieved by T rounds of PORTER-DP with given noise, per accountant."""
    acct = MomentsAccountant(q=b / m, noise_multiplier=sigma_p / tau)
    acct.step(T)
    return acct.epsilon(delta)
