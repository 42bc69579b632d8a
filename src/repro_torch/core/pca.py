"""PCA model compression for the DRL state (paper 3.2, Eq. 6).

The port of ``repro.core.pca``. Fit once on the models of the first
cloud aggregation (cloud + M edges, flattened); the loading vectors are
reused for every later round. ``torch.linalg.eigh`` fixes no sign for
an eigenvector, so a loading vector (and its projection column) may
differ from the reference's by a factor of -1.
"""
from __future__ import annotations

import torch


def flatten_model(params: dict):
    """g(.): flatten a model dict into one f32 vector, sorted-key order."""
    return torch.cat([params[k].to(torch.float32).reshape(-1)
                      for k in sorted(params)])


def fit(x, n_components: int) -> dict:
    """x: (n_samples, dim). Returns {mean (1, dim), loadings (k, dim)}
    from the eigendecomposition of the (n, n) Gram matrix of the
    centered samples (n_samples is M+1, tiny; dim is 20k-450k)."""
    mean = x.mean(dim=0, keepdim=True)
    xc = x - mean
    g = xc @ xc.T                                     # (n, n)
    w, v = torch.linalg.eigh(g)                       # ascending
    order = torch.argsort(-w)
    w = w[order].clamp_min(1e-12)
    v = v[:, order]
    k = min(n_components, x.shape[0])
    comps = (xc.T @ v[:, :k]) / torch.sqrt(w[:k])     # (dim, k) orthonormal
    # centered n-sample data has rank n-1: zero the degenerate
    # directions (1/sqrt(w->0) amplifies numerical noise)
    good = (w[:k] > 1e-6 * w[0]).to(comps.dtype)
    loadings = (comps * good[None, :]).T              # (k, dim)
    if k < n_components:
        pad = torch.zeros((n_components - k, x.shape[1]),
                          dtype=loadings.dtype, device=loadings.device)
        loadings = torch.cat([loadings, pad], dim=0)
    return {"mean": mean, "loadings": loadings}


def transform(pca_state: dict, x):
    """x: (n, dim) -> (n, k)."""
    return (x - pca_state["mean"]) @ pca_state["loadings"].T
