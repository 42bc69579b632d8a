"""Shared model components of the LLM families: initializers, RMS and
layer norms, the SwiGLU and GELU MLPs, standard and multimodal (M-RoPE)
rotary embeddings, sinusoidal positions and the chunked cross-entropy;
the port of ``repro.models.common``.

Plain functions on tensors over plain-dict parameters. Initializers draw
from an explicit ``torch.Generator`` with the laws of the reference (the
numbers differ from JAX's threefry draws; tests that need equal weights
load the reference's parameters through ``repro_torch.weights``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import tp as tp_mod


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, device,
               scale: Optional[float] = None,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init on ``device``, drawn from ``gen``: a
    normal truncated to [-3, 3], times ``scale`` if given, else
    ``1/sqrt(fan_in)`` (``fan_in = shape[0]``, or the only dim)."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (t * std).to(dtype)


def embed_init(gen: torch.Generator, shape, device,
               dtype=torch.float32) -> torch.Tensor:
    """Normal(0, 0.02) embedding init."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.normal_(0.0, 1.0, generator=gen)
    return (t * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms, MLPs
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-6):
    """RMS norm over the last dim, computed in f32, returned in x's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """Layer norm over the last dim: statistics in f32, then ``y * weight
    + bias`` with the weight and bias in their own dtype (an f32 y times
    an f32 or bf16 weight stays f32, as in the reference), returned in
    x's dtype."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(dt)


def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int, device,
                dtype=torch.float32) -> dict:
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), device, dtype=dtype),
        "w_up": dense_init(gen, (d_model, d_ff), device, dtype=dtype),
        "w_down": dense_init(gen, (d_ff, d_model), device, dtype=dtype),
    }


def swiglu(params, x, tp=None):
    """silu(x W_gate) * (x W_up) W_down, in x's dtype. ``tp`` (a
    ``models.tp.TPContext``, the ft group's): ``w_gate``/``w_up`` are
    this rank's column blocks and ``w_down`` its row block
    (``tp.column``, ``tp.row``)."""
    wg, wu, wd = (params[n].to(x.dtype) for n in ("w_gate", "w_up",
                                                  "w_down"))
    if tp is None:
        return (F.silu(x @ wg) * (x @ wu)) @ wd
    g, u = tp_mod.column(x, [wg, wu], tp)
    return tp_mod.row(F.silu(g) * u, wd, tp)


def gelu_mlp_init(gen: torch.Generator, d_model: int, d_ff: int, device,
                  dtype=torch.float32) -> dict:
    return {
        "w_up": dense_init(gen, (d_model, d_ff), device, dtype=dtype),
        "b_up": torch.zeros((d_ff,), dtype=dtype, device=device),
        "w_down": dense_init(gen, (d_ff, d_model), device, dtype=dtype),
        "b_down": torch.zeros((d_model,), dtype=dtype, device=device),
    }


def gelu_mlp(params, x, tp=None):
    """gelu(x W_up + b_up) W_down + b_down in x's dtype; the GELU is the
    tanh form, ``jax.nn.gelu``'s default. ``tp`` (a
    ``models.tp.TPContext``, the ft group's): ``w_up`` and ``b_up`` are
    this rank's column blocks and ``w_down`` its row block
    (``tp.column``, ``tp.row``); ``b_down``, whole on every rank, is
    added once to the row product's sum."""
    wu, wd = params["w_up"].to(x.dtype), params["w_down"].to(x.dtype)
    if tp is None:
        h = x @ wu
    else:
        h, = tp_mod.column(x, [wu], tp)
    h = F.gelu(h + params["b_up"].to(x.dtype), approximate="tanh")
    h = h @ wd if tp is None else tp_mod.row(h, wd, tp)
    return h + params["b_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S). Rotates
    the INTERLEAVED pairs (x[..., ::2], x[..., 1::2]) as the reference
    does (not the rotate-half convention), in f32, returned in x's
    dtype."""
    if theta <= 0:
        return x
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (d/2,)
    ang = positions[..., None].to(torch.float32) * freqs      # (..., S, d/2)
    ang = ang[..., None, :]                               # (..., S, 1, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf = x.float()
    x1, x2 = xf[..., ::2], xf[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def m_rope_bands(half: int, sections=(2, 1, 1)) -> list:
    """The (lo, hi) frequency bands of M-RoPE's (temporal, height, width)
    sections over the ``half`` rotary pairs, the last band taking the
    remainder: (0, 32), (32, 48), (48, 64) at head dim 128."""
    tot, acc, bounds = sum(sections), 0, []
    for s in sections:
        n = half * s // tot
        bounds.append((acc, acc + n))
        acc += n
    bounds[-1] = (bounds[-1][0], half)
    return bounds


def apply_m_rope(x, mpos, theta: float, sections=(2, 1, 1)):
    """Qwen2-VL's multimodal rotary embedding. x: (..., S, H, D); mpos:
    (3, ..., S), the temporal, height and width position streams. The
    rotary pairs are split into ``m_rope_bands``, each band rotated by
    its own stream's position; pairs interleaved and angles in f32 as in
    ``apply_rope``, returned in x's dtype."""
    d = x.shape[-1]
    half = d // 2
    freqs = rope_freqs(d, theta, x.device)                    # (half,)
    pos = torch.zeros(x.shape[:-2] + (half,), dtype=torch.float32,
                      device=x.device)
    for (lo, hi), p in zip(m_rope_bands(half, sections), mpos):
        pos[..., lo:hi] = p[..., None].to(torch.float32)
    ang = (pos * freqs)[..., None, :]                     # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf = x.float()
    x1, x2 = xf[..., ::2], xf[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def sinusoidal_positions(seq: int, d_model: int, device) -> torch.Tensor:
    """(seq, d_model) f32 encoder positions: sin at the even columns, cos
    at the odd ones, of ``pos / 10000 ** (2i / d_model)``."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device),
                          dim / d_model)
    out = torch.zeros((seq, d_model), dtype=torch.float32, device=device)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def chunked_softmax_xent(h, w_out, labels, mask=None, chunk: int = 512,
                         tp=None):
    """Next-token cross-entropy computed in sequence chunks of ``chunk``
    (the last one the remainder), so the (B, S, vocab) logits never
    exist whole: per chunk the logits ``h @ w_out`` in h's dtype, then in
    f32 ``logsumexp`` minus the gold logit, times the mask, summed into
    an f32 total in chunk order; the mean over ``max(sum(mask), 1)``.

    h: (B, S, d); w_out: (d, V); labels: (B, S) int; mask: (B, S) or
    None. Returns the f32 scalar mean loss, differentiable in h and
    w_out. The gold logit is an index into the flattened logits, whose
    backward (``index_put_`` with accumulation) has a deterministic
    implementation on the card.

    ``tp`` (a ``models.tp.TPContext``, the ft group's): ``w_out`` is
    this rank's block of V / n vocab columns, ``[i V/n, (i + 1) V/n)``
    for the group's n ranks, this one at i, and the loss is
    vocab-parallel (``_vocab_parallel_xent``)."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=h.device)
    if tp is not None:
        return _vocab_parallel_xent(h, w_out, labels, mask, chunk, tp)
    w = w_out.to(h.dtype)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, s, chunk):
        hi = min(lo + chunk, s)
        logits = (h[:, lo:hi] @ w).float()               # (B, C, V)
        lse = torch.logsumexp(logits, dim=-1)
        flat = logits.reshape(-1, logits.shape[-1])
        rows = torch.arange(flat.shape[0], device=h.device)
        gold = flat[rows, labels[:, lo:hi].reshape(-1).long()]
        total = total + ((lse - gold.reshape(lse.shape))
                         * mask[:, lo:hi].float()).sum()
    return total / mask.float().sum().clamp_min(1.0)


def _vocab_parallel_xent(h, w_out, labels, mask, chunk: int, tp):
    """``chunked_softmax_xent`` over ``tp``'s group, each rank holding V /
    n vocab columns of ``w_out``: per chunk the local (B, C, V/T) logits
    (``tp.column``), an ``all_reduce(MAX)`` of their detached row maxima
    m, the sums of ``exp(logits - m)`` summed over the group (*g*),
    ``lse = m + log(sum)``, and the gold logit from the rank whose
    columns hold the label (zero on the others), summed over the group
    (*g*). The same f32 loss on every rank."""
    b, s, _ = h.shape
    w = w_out.to(h.dtype)
    n = w.shape[1]
    lo_col = tp.rank * n
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, s, chunk):
        hi = min(lo + chunk, s)
        logits = tp_mod.column(h[:, lo:hi], [w], tp)[0].float()
        m = tp_mod.all_max(logits.amax(dim=-1), tp)
        sums = tp_mod.reduce_from(torch.exp(logits - m[..., None]).sum(
            dim=-1), tp)
        lse = m + torch.log(sums)
        local = labels[:, lo:hi].reshape(-1).long() - lo_col
        mine = (local >= 0) & (local < n)
        flat = logits.reshape(-1, n)
        rows = torch.arange(flat.shape[0], device=h.device)
        gold = torch.where(mine, flat[rows, local.clamp(0, n - 1)], 0.0)
        gold = tp_mod.reduce_from(gold, tp)
        total = total + ((lse - gold.reshape(lse.shape))
                         * mask[:, lo:hi].float()).sum()
    return total / mask.float().sum().clamp_min(1.0)
