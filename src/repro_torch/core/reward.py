"""Reward (paper 3.4, Eqs. 11-12); a copy of ``repro.core.reward``.

r(k) = U^{A(k)} - U^{A(k-1)} - eps * E(k), U = 64: the exponential
shaping amplifies late-training accuracy gains so the agent still sees
signal near convergence; eps trades accuracy against device energy.
"""
from __future__ import annotations

UPSILON = 64.0


def reward(acc_new: float, acc_old: float, energy: float,
           epsilon: float) -> float:
    return (UPSILON ** acc_new) - (UPSILON ** acc_old) - epsilon * energy
