"""Theorem 1: convergence bound of one cloud aggregation (paper §3.7).

    E[f(w(k+1))] - E[f(w(k))]
      <= (L²η³/4)·γ̃1·γ̃2·((γ̃1-1) + (M/N)·γ̃1·(γ̃2-1))·σ²
       + (Lη²/2)·(1/N)·γ̃1·γ̃2·σ²
       - (η/2)·γ̃1·γ̃2·E‖∇f(w(k))‖²                                  (16)

plus the stepsize feasibility condition (29). Used by tests (the bound
must be an upper bound on measured per-round loss decrease for smooth
quadratic problems) and by the benchmark that tabulates bound-vs-actual.

A copy of ``repro.core.convergence`` (numpy only), so the port imports
nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class BoundParams:
    L: float          # smoothness
    eta: float        # learning rate
    sigma2: float     # gradient-noise variance bound
    M: int            # edges
    N: int            # devices


def one_round_bound(bp: BoundParams, g1_max: float, g2_max: float,
                    grad_norm_sq: float) -> float:
    """RHS of (16) for γ̃1 = g1_max, γ̃2 = g2_max."""
    t1 = (bp.L ** 2 * bp.eta ** 3 / 4.0) * g1_max * g2_max * (
        (g1_max - 1.0) + (bp.M / bp.N) * g1_max * (g2_max - 1.0)
    ) * bp.sigma2
    t2 = (bp.L * bp.eta ** 2 / 2.0) * (1.0 / bp.N) * g1_max * g2_max \
        * bp.sigma2
    t3 = -(bp.eta / 2.0) * g1_max * g2_max * grad_norm_sq
    return t1 + t2 + t3


def stepsize_feasible(bp: BoundParams, g1: np.ndarray,
                      g2: np.ndarray) -> bool:
    """Condition (29) for every edge j (vectorized over edges)."""
    g1 = np.asarray(g1, np.float64)
    g2 = np.asarray(g2, np.float64)
    g1_max = float(g1.max())
    lhs = 1.0 - bp.L ** 2 * bp.eta ** 2 * (
        g1 * (g1 - 1.0) / 2.0 + g1_max ** 2 * g2 * (g2 - 1.0) / 2.0
    ) - bp.L * bp.eta * g1 * g2
    return bool((lhs >= 0).all())


def max_feasible_eta(bp: BoundParams, g1_max: float, g2_max: float) -> float:
    """Largest η satisfying (29) at the max frequencies (quadratic root)."""
    a = bp.L ** 2 * (g1_max * (g1_max - 1) / 2.0
                     + g1_max ** 2 * g2_max * (g2_max - 1) / 2.0)
    b = bp.L * g1_max * g2_max
    if a <= 0:
        return 1.0 / max(b, 1e-12)
    return float((-b + np.sqrt(b * b + 4 * a)) / (2 * a))
