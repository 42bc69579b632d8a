"""GQA attention for the serving slice: full-sequence forward, prefill
(cache write) and one-token decode; the port of ``repro.models.attention``.

Every attention runs through the ``flash_attention`` kernel
(``repro_torch.kernels.ops``): the reference computes it with
``chunked_attention``, the pure-jnp oracle of the same Pallas kernel.
q/k/v stay in the reference's (B, S, H, D) layout and reach the kernel as
(B, H, S, D) transposed views (the kernel takes strides).

Supported: GQA, qk_norm (qwen3), qkv bias (qwen2), causal and
sliding-window masks on the full-sequence forward. Out of this slice, and
raising ``NotImplementedError``: ring-buffer (sliding-window) prefill and
decode, M-RoPE and cross-attention (ROADMAP.md, "Modules still to port",
item 11).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import common

ROADMAP_ITEM = "ROADMAP.md, 'Modules still to port', item 11"


def attn_init(gen: torch.Generator, cfg, device, dtype=None) -> dict:
    dtype = dtype or cfg.dtype
    d, hd = cfg.d_model, cfg.head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": common.dense_init(gen, (d, nh * hd), device, dtype=dtype),
        "wk": common.dense_init(gen, (d, nkv * hd), device, dtype=dtype),
        "wv": common.dense_init(gen, (d, nkv * hd), device, dtype=dtype),
        "wo": common.dense_init(gen, (nh * hd, d), device, dtype=dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((nh * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((nkv * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((nkv * hd,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def _check_supported(cfg) -> None:
    if cfg.m_rope:
        raise NotImplementedError(f"M-RoPE (qwen2-vl) is not ported yet: "
                                  f"see {ROADMAP_ITEM}")


def _project_qkv(params, cfg, x, positions):
    """x: (B, S, d) -> q (B, S, H, D), k/v (B, S, Hkv, D): projections in
    x's dtype, optional bias, per-head qk_norm, then interleaved RoPE."""
    _check_supported(cfg)
    b, s, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ params["wq"].to(x.dtype)
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = q.reshape(b, s, nh, hd)
    k = k.reshape(b, s, nkv, hd)
    v = v.reshape(b, s, nkv, hd)
    if cfg.qk_norm:
        q = common.rms_norm(q, params["q_norm"])
        k = common.rms_norm(k, params["k_norm"])
    if cfg.rope_theta > 0:
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend(q, k, v, *, causal=True, window=0, q_offset=0):
    """(B, Sq, H, D) x (B, Skv, Hkv, D) -> (B, Sq, H * D) through the
    flash_attention kernel."""
    b, sq, h, d = q.shape
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window, q_offset=q_offset)
    return out.transpose(1, 2).reshape(b, sq, h * d)


def self_attention(params, cfg, x, positions=None, *, causal=True,
                   window: int = 0):
    """Full-sequence self attention (forward / prefill compute)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = _attend(q, k, v, causal=causal, window=window if causal else 0)
    return out @ params["wo"].to(x.dtype)


def prefill_attention(params, cfg, x, *, window: int = 0):
    """Prefill: returns (out, (k, v, kvpos)) with k/v (B, S, Hkv, D) and
    kvpos (B, S) int32 absolute positions."""
    if window:
        raise NotImplementedError(f"ring-buffer (window > 0) prefill is "
                                  f"not ported yet: see {ROADMAP_ITEM}")
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = _attend(q, k, v) @ params["wo"].to(x.dtype)
    return out, (k, v, positions.expand(b, s))


def decode_attention(params, cfg, x, cache, pos: int, *, window: int = 0):
    """One-token decode. x: (B, 1, d); cache: (k, v, kvpos) with k/v
    (B, C, Hkv, D) and kvpos (B, C) absolute positions (-1 = empty); pos:
    the new token's absolute position (a host int).

    The new k/v/position are written into the cache tensors IN PLACE at
    slot ``pos`` (the reference returns updated copies; the port saves
    the copy of the whole cache per step), and the cache tuple is
    returned. Without a window every slot holds its own position and the
    empty slots lie above ``pos``, so causal attention with
    ``q_offset = pos`` over the kernel's implicit positions is exactly the
    reference's attention over ``kvpos``; the kernel reads only slots
    0..pos."""
    if window:
        raise NotImplementedError(f"ring-buffer (window > 0) decode is not "
                                  f"ported yet: see {ROADMAP_ITEM}")
    b = x.shape[0]
    k_cache, v_cache, kvpos = cache
    if not 0 <= pos < k_cache.shape[1]:
        raise ValueError(f"decode position {pos} outside the cache of "
                         f"{k_cache.shape[1]} slots")
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, cfg, x, positions)
    k_cache[:, pos] = k_new[:, 0]
    v_cache[:, pos] = v_new[:, 0]
    kvpos[:, pos] = pos
    out = _attend(q, k_cache, v_cache, q_offset=pos)
    return out @ params["wo"].to(x.dtype), (k_cache, v_cache, kvpos)
