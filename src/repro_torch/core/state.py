"""DRL state construction (paper 3.2, Eqs. 6-10, Fig. 6).

The port of ``repro.core.state``. s(k) is an (M+1) x (n_PCA + 3) matrix:
  row 0   : [ PCA(cloud model) | k, T_re, A_test ]           (s1 row + s3)
  row j>0 : [ PCA(edge model j) | T_SGD_j, T_ec_j, E_j ]     (s1 rows + s2)
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import pca


def build_state(pca_state: dict, cloud_model: dict, edge_models: dict,
                h_edges: np.ndarray, k: int, t_re: float, acc: float, *,
                t_threshold: float, norm_time: float = 100.0,
                norm_energy: float = 50.0,
                max_rounds: float = 50.0) -> np.ndarray:
    """h_edges: (M, 3) raw [T_SGD, T_ec, E] of the last cloud round.
    Times/energies are normalized to O(1) for the CNN actor."""
    m = h_edges.shape[0]
    flat = [pca.flatten_model(cloud_model)]
    for j in range(m):
        flat.append(pca.flatten_model({n: v[j]
                                       for n, v in edge_models.items()}))
    x = torch.stack(flat)                                 # (M+1, dim)
    s1 = pca.transform(pca_state, x).cpu().numpy()        # (M+1, n_pca)
    s3 = np.array([[k / max_rounds, t_re / t_threshold, acc]], np.float32)
    s2 = h_edges.astype(np.float32) / np.array(
        [[norm_time, norm_time, norm_energy]], np.float32)
    right = np.concatenate([s3, s2], axis=0)              # (M+1, 3)
    return np.concatenate([s1.astype(np.float32), right], axis=1)
