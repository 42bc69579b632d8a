"""Synthetic MNIST/CIFAR-like datasets and LM token batches; the port of
``repro.data.synthetic``.

Class-conditional structured images: each class has a random
low-frequency template; samples are template + per-sample noise + a
random shift. The arrays are made with numpy exactly as the reference
makes them (same generator, same draws, same order) and handed over as
tensors on the requested device, so they are byte-identical per seed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

N_CLASSES = 10


def _make_templates(rng: np.random.Generator, hw: int, chans: int,
                    sharp: float) -> np.ndarray:
    """Class templates: smoothed random fields, distinct per class."""
    base = rng.normal(size=(N_CLASSES, hw + 8, hw + 8, chans))
    # cheap low-pass: box filter x3
    for _ in range(3):
        base = (base + np.roll(base, 1, 1) + np.roll(base, -1, 1)
                + np.roll(base, 1, 2) + np.roll(base, -1, 2)) / 5.0
    return base / base.std() * sharp


def _make_images(rng: np.random.Generator, base: np.ndarray, n: int,
                 hw: int, chans: int, labels: np.ndarray) -> np.ndarray:
    """Samples = shared class template (shifted crop) + per-sample noise."""
    xs = np.empty((n, hw, hw, chans), np.float32)
    offs = rng.integers(0, 8, size=(n, 2))
    noise = rng.normal(scale=1.0, size=(n, hw, hw, chans))
    for i in range(n):
        oy, ox = offs[i]
        xs[i] = base[labels[i], oy:oy + hw, ox:ox + hw] + noise[i]
    return xs.astype(np.float32)


def _split(rng, hw: int, chans: int, sharp: float, n_train: int,
           n_test: int, device):
    dev = resolve_device(device)
    base = _make_templates(rng, hw, chans, sharp)
    ytr = rng.integers(0, N_CLASSES, n_train).astype(np.int32)
    yte = rng.integers(0, N_CLASSES, n_test).astype(np.int32)
    xtr = _make_images(rng, base, n_train, hw, chans, ytr)
    xte = _make_images(rng, base, n_test, hw, chans, yte)
    t = lambda a: torch.from_numpy(a).to(dev)
    return {"x": t(xtr), "y": t(ytr)}, {"x": t(xte), "y": t(yte)}


def synth_mnist(n_train: int = 60000, n_test: int = 10000, seed: int = 0,
                device="cuda"):
    """(train, test) dicts of x (n, 28, 28, 1) f32 and y (n,) int32."""
    rng = np.random.default_rng(seed)
    return _split(rng, 28, 1, 0.42, n_train, n_test, device)


def synth_cifar(n_train: int = 50000, n_test: int = 10000, seed: int = 1,
                device="cuda"):
    """(train, test) dicts of x (n, 32, 32, 3) f32 and y (n,) int32.
    Lower sharpness than MNIST: a harder task, as in the paper."""
    rng = np.random.default_rng(seed)
    return _split(rng, 32, 3, 0.28, n_train, n_test, device)


def token_batch(rng_seed: int, batch: int, seq: int, vocab: int,
                device="cuda"):
    """LM smoke-test batch: structured random tokens (Zipf-ish) with
    shifted labels, the reference's numpy draws, as int32 tensors on
    ``device``: {"tokens": (batch, seq), "labels": (batch, seq)}."""
    dev = resolve_device(device)
    rng = np.random.default_rng(rng_seed)
    z = rng.zipf(1.3, size=(batch, seq + 1))
    toks = torch.from_numpy(np.minimum(z, vocab - 1).astype(np.int32))
    return {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
