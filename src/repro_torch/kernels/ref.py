"""Plain PyTorch versions of the aggregation kernels.

Each function states in tensor operations what a kernel of
``repro_torch.kernels.hier_agg`` computes. The kernel wrappers use them
for tensors that lie on the CPU, and ``chip_smoke.py`` holds each CUDA
kernel against them on the card. They mirror the oracles of
``repro.kernels.ref`` (``segment_agg_ref``, ``segment_broadcast_ref``,
``hier_agg_ref``).
"""
from __future__ import annotations

import torch


def segment_weight_sums(weights, segment_ids, num_segments: int):
    """(N,) weights x (N,) ids -> (E,) f32 per-segment weight sums.

    Each sum runs over a masked row of an (E, N) matrix, a plain
    reduction with no atomics, so the result is the same on every run
    on either device (``index_add_`` on CUDA is atomic). Ids outside
    ``[0, E)`` contribute nothing."""
    w = weights.to(torch.float32)
    seg = segment_ids.to(torch.int64)
    ids = torch.arange(int(num_segments), device=w.device)
    hit = seg[None, :] == ids[:, None]
    return torch.where(hit, w[None, :], torch.zeros((), device=w.device)
                       ).sum(dim=1)


def segment_scaled_sum_ref(bank, weights, segment_ids, scale,
                           num_segments: int):
    """What the ``segment_agg`` kernel computes:

        out[j] = scale[j] * sum_{i: seg_i = j} w_i * bank[i]

    bank (N, P) f32 or bf16, weights (N,) f32, segment ids (N,), scale
    (E,) f32 -> (E, P) f32, accumulated in f32. The scale multiplies
    (the reference normalizes by multiplying with the reciprocal)."""
    e = int(num_segments)
    seg = segment_ids.to(torch.int64)
    keep = (seg >= 0) & (seg < e)           # other ids add a zero row
    w = torch.where(keep, weights.to(torch.float32), 0.0)
    x = bank.to(torch.float32) * w[:, None]
    out = torch.zeros((e, bank.shape[1]), dtype=torch.float32,
                      device=bank.device)
    out.index_add_(0, torch.where(keep, seg, 0), x)
    return out * scale.to(torch.float32)[:, None]


def segment_agg_ref(bank, weights, segment_ids, num_segments: int):
    """(N, P) x (N,) x (N,) -> (E, P) f32 weighted segment means; empty
    segments give 0 through the weight-sum clamp. The division mirrors
    ``repro.kernels.ref.segment_agg_ref``."""
    wsum = segment_weight_sums(weights, segment_ids, num_segments)
    ones = torch.ones_like(wsum)
    s = segment_scaled_sum_ref(bank, weights, segment_ids, ones,
                               num_segments)
    return s / wsum.clamp_min(1e-9)[:, None]


def segment_broadcast_ref(models, segment_ids, out_dtype=None):
    """(E, P) x (N,) -> (N, P): out[i] = models[segment_ids[i]], cast to
    ``out_dtype`` (default: the models' dtype)."""
    out = models[segment_ids.to(torch.int64)]
    return out.to(out_dtype or models.dtype)


def hier_agg_ref(bank, weights):
    """bank (R, N), weights (R,) -> weighted mean (N,) f32."""
    w = weights.to(torch.float32)
    wsum = w.sum().clamp_min(1e-9)
    return (w[:, None] * bank.to(torch.float32)).sum(0) / wsum
