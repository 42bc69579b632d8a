"""Profiling module (paper §3.1); a numpy copy of ``repro.core.profiling``
that makes the same draws in the same order from the same generator.

Each device runs a fixed profiling task; the cloud records the 5-element
characteristic V_i = [T_pro, E_pro, Fl_pro, Fr_pro, Ut_pro] and clusters
devices onto edges with k-means seeded by AFK-MC² (Bachem et al.,
NeurIPS'16 [22]) — assumption-free MCMC seeding — followed by
size-balanced Lloyd iterations ("minimizes the mean square error and
balances the cluster size").
"""
from __future__ import annotations

import numpy as np


def profile_features(profiles) -> np.ndarray:
    """Build V_i from simulator device profiles (repro_torch.sim.hardware)."""
    feats = np.stack([
        profiles.profile_time,      # T_pro
        profiles.profile_energy,    # E_pro
        profiles.flops,             # Fl_pro
        profiles.freq,              # Fr_pro
        profiles.cpu_usage,         # Ut_pro
    ], axis=1)
    mu = feats.mean(0, keepdims=True)
    sd = feats.std(0, keepdims=True) + 1e-9
    return (feats - mu) / sd


def afkmc2_seed(rng: np.random.Generator, x: np.ndarray, k: int,
                chain: int = 64) -> np.ndarray:
    """AFK-MC² seeding: k-means++ with the D² distribution replaced by an
    assumption-free MCMC proposal (uniform + regularization), O(N) total.
    Returns (k, dim) initial centers."""
    n = x.shape[0]
    centers = [x[rng.integers(n)]]
    # proposal q(x) = 0.5 * d(x,c1)^2 / sum + 0.5 / n  (paper's q)
    d2 = np.sum((x - centers[0]) ** 2, axis=1)
    q = 0.5 * d2 / max(d2.sum(), 1e-12) + 0.5 / n
    q = q / q.sum()
    for _ in range(1, k):
        cand = rng.choice(n, size=chain, p=q)
        c_arr = np.stack(centers)
        # current shortest distances for candidates, MCMC over the chain
        xi = x[cand]
        dist = np.min(((xi[:, None, :] - c_arr[None]) ** 2).sum(-1), axis=1)
        cur = cand[0]
        cur_d = dist[0]
        for j in range(1, chain):
            a = min(1.0, (dist[j] * q[cur]) / max(cur_d * q[cand[j]], 1e-20))
            if rng.random() < a:
                cur, cur_d = cand[j], dist[j]
        centers.append(x[cur])
    return np.stack(centers)


def balanced_kmeans(rng: np.random.Generator, x: np.ndarray, k: int,
                    iters: int = 50) -> np.ndarray:
    """Size-balanced k-means: AFK-MC² seeding, then Lloyd steps where
    assignment fills clusters greedily by distance under a ±1 size cap.
    Returns assignment (N,) int."""
    n = x.shape[0]
    cap = -(-n // k)
    centers = afkmc2_seed(rng, x, k)
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)     # (N, k)
        order = np.argsort(d.min(1))
        counts = np.zeros(k, np.int64)
        new_assign = np.full(n, -1, np.int64)
        for i in order:
            for c in np.argsort(d[i]):
                if counts[c] < cap:
                    new_assign[i] = c
                    counts[c] += 1
                    break
        if (new_assign == assign).all():
            assign = new_assign
            break
        assign = new_assign
        for c in range(k):
            if (assign == c).any():
                centers[c] = x[assign == c].mean(0)
    return assign


def cluster_devices(profiles, n_edges: int, seed: int = 0) -> np.ndarray:
    """The profiling module's output: device -> edge assignment."""
    rng = np.random.default_rng(seed)
    return balanced_kmeans(rng, profile_features(profiles), n_edges)
