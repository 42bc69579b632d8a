"""Federated data pipeline; the port of ``repro.data.federated``.

The non-IID partitioners (paper Fig. 10) are numpy and make the same
draws as the reference. ``make_federated`` gathers the fixed-size
per-device shards on the dataset's device, stacked as
``(N_devices, n_local, ...)`` tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

N_CLASSES = 10


def partition_iid(rng: np.random.Generator, labels: np.ndarray,
                  n_devices: int, n_local: int) -> np.ndarray:
    idx = rng.permutation(len(labels))
    need = n_devices * n_local
    reps = -(-need // len(idx))
    idx = np.tile(idx, reps)[:need]
    return idx.reshape(n_devices, n_local)


def partition_label_k(rng: np.random.Generator, labels: np.ndarray,
                      n_devices: int, n_local: int, k: int = 2) -> np.ndarray:
    """Each device holds samples from k random labels, equal amounts
    (paper's default: k=2, 'Label non-IID' Fig. 10a uses k=5)."""
    by_class = [np.where(labels == c)[0] for c in range(N_CLASSES)]
    out = np.empty((n_devices, n_local), np.int64)
    per = n_local // k
    for d in range(n_devices):
        classes = rng.choice(N_CLASSES, size=k, replace=False)
        parts = []
        for j, c in enumerate(classes):
            take = per if j < k - 1 else n_local - per * (k - 1)
            parts.append(rng.choice(by_class[c], size=take, replace=True))
        out[d] = np.concatenate(parts)
    return out


def partition_dirichlet(rng: np.random.Generator, labels: np.ndarray,
                        n_devices: int, n_local: int,
                        alpha: float = 0.5) -> np.ndarray:
    """Dirichlet(alpha) class mixture per device (paper Fig. 10b)."""
    by_class = [np.where(labels == c)[0] for c in range(N_CLASSES)]
    out = np.empty((n_devices, n_local), np.int64)
    for d in range(n_devices):
        p = rng.dirichlet(np.full(N_CLASSES, alpha))
        counts = rng.multinomial(n_local, p)
        parts = [rng.choice(by_class[c], size=counts[c], replace=True)
                 for c in range(N_CLASSES) if counts[c] > 0]
        out[d] = np.concatenate(parts)
    return out


@dataclasses.dataclass
class FederatedDataset:
    """Per-device shards: x (N, n_local, ...), y (N, n_local)."""
    x: torch.Tensor
    y: torch.Tensor
    test_x: torch.Tensor
    test_y: torch.Tensor

    @property
    def n_devices(self) -> int:
        return self.x.shape[0]

    @property
    def n_local(self) -> int:
        return self.x.shape[1]

    def device_sizes(self) -> torch.Tensor:
        """|D_i| -- uniform by construction (paper: equal amounts/device)."""
        return torch.full((self.n_devices,), float(self.n_local),
                          dtype=torch.float32, device=self.x.device)


def make_federated(train: dict, test: dict, n_devices: int, n_local: int,
                   scheme: str = "label2", seed: int = 0,
                   alpha: float = 0.5) -> FederatedDataset:
    """Partition ``train`` (tensors from ``repro_torch.data.synthetic``)
    over devices; the shards stay on the dataset's device."""
    rng = np.random.default_rng(seed)
    labels = train["y"].cpu().numpy()
    if scheme == "iid":
        idx = partition_iid(rng, labels, n_devices, n_local)
    elif scheme.startswith("label"):
        k = int(scheme[len("label"):] or 2)
        idx = partition_label_k(rng, labels, n_devices, n_local, k=k)
    elif scheme == "dirichlet":
        idx = partition_dirichlet(rng, labels, n_devices, n_local,
                                  alpha=alpha)
    else:
        raise ValueError(scheme)
    idx = torch.from_numpy(idx).to(train["x"].device)
    return FederatedDataset(x=train["x"][idx], y=train["y"][idx],
                            test_x=test["x"], test_y=test["y"])
