# Copied from repro/core/agent/predictor.py; imports renamed.
"""Negative-exponential accuracy forecaster (paper §3.3, ref [25]).

Model: acc(r) = a - b * exp(-c * r). Fit by grid search over the rate c with
closed-form linear least squares for (a, b) at each c — robust for the 2-8
point histories PSHEA works with, no optimizer dependencies.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class NegExpFit:
    a: float
    b: float
    c: float
    sse: float

    def predict(self, r) -> np.ndarray:
        r = np.asarray(r, np.float64)
        return self.a - self.b * np.exp(-self.c * r)


def fit_neg_exp(rounds: Sequence[float], accs: Sequence[float],
                c_grid: np.ndarray | None = None) -> NegExpFit:
    r = np.asarray(rounds, np.float64)
    y = np.asarray(accs, np.float64)
    assert r.shape == y.shape and r.size >= 2
    if c_grid is None:
        c_grid = np.logspace(-3, 1.2, 120)
    best = None
    for c in c_grid:
        basis = np.stack([np.ones_like(r), -np.exp(-c * r)], axis=1)
        coef, *_ = np.linalg.lstsq(basis, y, rcond=None)
        a, b = float(coef[0]), float(coef[1])
        pred = a - b * np.exp(-c * r)
        sse = float(np.sum((pred - y) ** 2))
        # monotone-increasing saturating curves only (b, c > 0)
        if b <= 0:
            sse += 1e3
        if best is None or sse < best.sse:
            best = NegExpFit(a, b, float(c), sse)
    return best


def predict_next(rounds: Sequence[float], accs: Sequence[float],
                 next_round: float) -> float:
    """One-shot helper: fit history, forecast accuracy at ``next_round``.

    With fewer than 3 points, falls back to last-value (no reliable fit)."""
    if len(accs) < 3:
        return float(accs[-1])
    fit = fit_neg_exp(rounds, accs)
    return float(np.clip(fit.predict(next_round), 0.0, 1.0))
