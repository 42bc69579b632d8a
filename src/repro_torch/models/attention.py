"""GQA attention: full-sequence forward (serving and training), prefill
(cache write), one-token decode and the whisper decoder's
cross-attention; the port of ``repro.models.attention``.

Two routes compute the same attention. Serving (``self_attention`` and
``cross_attention`` with ``chunk=None``, prefill, decode) runs the
``flash_attention`` kernel (``repro_torch.kernels.ops``), which has no
backward and refuses autograd. Training (an int ``chunk``, which
``transformer.forward_hidden(attn_chunk=)`` sets) runs
``chunked_attention``, the reference's online-softmax scan over KV
chunks in plain tensor code, differentiated by autograd, as the
reference trains through its pure-jnp ``chunked_attention`` and never
through its Pallas kernel. q/k/v stay in the reference's (B, S, H, D)
layout and reach the kernel as (B, H, S, D) transposed views (the
kernel takes strides).

Supported: GQA, qk_norm (qwen3), qkv bias (qwen2), causal, non-causal
(the whisper encoder) and sliding-window masks, ring-buffer
(sliding-window) prefill and decode, cross-attention over precomputed
encoder K/V (whisper), and M-RoPE (qwen2-vl: ``mpos``, the three
position streams; without them a model with ``m_rope`` falls back to
standard RoPE, as the reference does).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import common, tp as tp_mod

NEG_INF = -1e30


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


def _project_qkv(params, cfg, x, positions, mpos=None, tp=None):
    """x: (B, S, d) -> q (B, S, H, D), k/v (B, S, Hkv, D): projections in
    x's dtype, optional bias, per-head qk_norm, then interleaved rotary:
    M-RoPE over ``mpos`` (3, B, S) when the model has ``m_rope`` and
    ``mpos`` is given, else standard RoPE at ``positions`` when
    ``rope_theta`` > 0. The head counts are the projections': under
    ``tp`` a rank's column blocks (``tp.column``), H / T and Hkv / T
    heads."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    ws = [params[n].to(x.dtype) for n in ("wq", "wk", "wv")]
    if tp is None:
        q, k, v = (x @ w for w in ws)
    else:
        q, k, v = tp_mod.column(x, ws, tp)
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, s, -1, hd)
    v = v.reshape(b, s, -1, hd)
    if cfg.qk_norm:
        q = common.rms_norm(q, params["q_norm"])
        k = common.rms_norm(k, params["k_norm"])
    if cfg.m_rope and mpos is not None:
        q = common.apply_m_rope(q, mpos, cfg.rope_theta)
        k = common.apply_m_rope(k, mpos, cfg.rope_theta)
    elif cfg.rope_theta > 0:
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


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      q_offset: int = 0, chunk: int = 1024,
                      kv_positions=None):
    """Online-softmax attention, looped over KV chunks of ``chunk`` rows
    (the reference's ``chunked_attention`` step for step): f32 scores,
    running max, sum and accumulator, masked scores at -1e30, the output
    divided by ``max(sum, 1e-30)``. Differentiable by autograd.

    q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D) with H % Hkv == 0; returns
    (B, Sq, H, D) in q's dtype. Query row t sits at ``q_offset + t``; kv
    row u at ``kv_positions[:, u]`` (default u) and is visible where its
    position is <= the query's and, with ``window`` > 0, above the
    query's minus ``window``. KV padded up to a whole chunk sits at
    position 2**30, never visible. ``causal`` is the reference's
    argument: a non-causal call passes all-zero ``kv_positions``."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    chunk = min(chunk, skv)
    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    dev = q.device
    if kv_positions is None:
        kv_positions = torch.arange(skv, dtype=torch.int32,
                                    device=dev).expand(b, skv)
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad),
                                               value=2 ** 30)
    qpos = q_offset + torch.arange(sq, dtype=torch.int32, device=dev)
    scale = 1.0 / torch.sqrt(torch.tensor(float(d), device=dev))  # in f32
    qf = (q.float() * scale).to(q.dtype)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=dev)
    l_ = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)

    def heads(t):          # (B, C, Hkv, D) -> (B, C, H, D): GQA repeat
        c = t.shape[1]
        return t[:, :, :, None, :].expand(b, c, hkv, rep, d).reshape(
            b, c, h, d)

    for c0 in range(0, n_chunks * chunk, chunk):
        kc, vc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        pc = kv_positions[:, c0:c0 + chunk]
        s_ = torch.einsum("bqhd,bchd->bhqc", qf, heads(kc)).float()
        mask = pc[:, None, None, :] <= qpos[None, None, :, None]
        if window:
            mask = mask & (pc[:, None, None, :]
                           > qpos[None, None, :, None] - window)
        s_ = torch.where(mask, s_, NEG_INF)
        m_new = torch.maximum(m, s_.amax(dim=-1))
        p = torch.exp(s_ - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_ = l_ * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqc,bchd->bhqd", p.to(vc.dtype), heads(vc))
        acc = acc * corr[..., None] + pv.float()
        m = m_new
    out = acc / l_[..., None].clamp_min(1e-30)
    return out.transpose(1, 2).to(q.dtype)


def self_attention(params, cfg, x, positions=None, *, causal=True,
                   window: int = 0, mpos=None, chunk=None, tp=None):
    """Full-sequence self attention. ``chunk=None`` runs the
    ``flash_attention`` kernel (serving; no autograd); an int runs
    ``chunked_attention`` over KV chunks of that size (training, as the
    reference's train and forward compute), non-causal as the reference
    does it: all-zero ``kv_positions``. ``mpos``: M-RoPE's position
    streams (``_project_qkv``).

    ``tp`` (a ``models.tp.TPContext``): ``wq``/``wk``/``wv`` are this
    rank's column blocks, whole heads (``tp.check``), ``wo`` its row
    block (``tp.column``, ``tp.row``)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
    q, k, v = _project_qkv(params, cfg, x, positions, mpos, tp)
    if chunk is None:
        out = _attend(q, k, v, causal=causal, window=window if causal else 0)
    elif causal:
        out = chunked_attention(q, k, v, causal=True, window=window,
                                chunk=chunk).reshape(b, s, -1)
    else:
        kvp = torch.zeros((b, k.shape[1]), dtype=torch.int32,
                          device=x.device)
        out = chunked_attention(q, k, v, causal=False, chunk=chunk,
                                kv_positions=kvp).reshape(b, s, -1)
    return _out_proj(params, out, tp)


def _out_proj(params, out, tp):
    """The output projection ``out @ wo``; under ``tp`` the row-parallel
    product of this rank's heads and its row block of ``wo``
    (``tp.row``: the f32 partials summed over the group, rounded once)."""
    wo = params["wo"].to(out.dtype)
    return out @ wo if tp is None else tp_mod.row(out, wo, tp)


def prefill_attention(params, cfg, x, *, window: int = 0, mpos=None,
                      tp=None):
    """Prefill: returns (out, (k, v, kvpos)) with k/v (B, C, Hkv, D) and
    kvpos (B, C) int32 absolute positions. The attention runs the
    kernel's causal mask, with ``window`` its sliding window. C = S,
    except with ``window`` and S > window: then the cache is a ring of
    the last ``window`` positions, position p at slot ``p % window``
    (the reference's ring buffer). ``mpos``: M-RoPE's position streams;
    the cache positions stay the slots' 0 .. S - 1. ``tp`` (serving over
    a serve mesh): ``params`` hold this rank's heads (``_project_qkv``),
    the kernel sees H / T query heads over Hkv / T kv heads, k/v are the
    rank's Hkv / T heads and ``out`` is whole (``_out_proj``)."""
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
    q, k, v = _project_qkv(params, cfg, x, positions, mpos, tp)
    out = _out_proj(params, _attend(q, k, v, window=window), tp)
    pos = positions.expand(b, s).contiguous()
    if window and s > window:
        # position s - window + j goes to slot (s + j) % window: the tail
        # rotated by s % window
        r = s % window
        k, v, pos = (torch.roll(t[:, -window:], r, dims=1)
                     for t in (k, v, pos))
    return out, (k, v, pos)


def decode_attention(params, cfg, x, cache, pos: int, *, window: int = 0,
                     mpos=None, tp=None):
    """One-token decode. x: (B, 1, d); cache: (k, v, kvpos) with k/v
    (B, C, Hkv, D) and kvpos (B, C) absolute positions (-1 = empty); pos:
    the new token's absolute position (a host int). ``mpos`` (3, B, 1):
    M-RoPE's position streams of the new token, which may differ from
    ``pos`` (qwen2-vl's ``pos + dpos``); slots and masks go by ``pos``.

    The new k/v/position are written into the cache tensors IN PLACE (the
    reference returns updated copies; the port saves the copy of the
    whole cache per step), at slot ``pos``, or ``pos % C`` with a
    ``window`` (the ring buffer), and the cache tuple is returned.

    The kernel has implicit kv positions (slot u at position u), so the
    call is chosen where they give the reference's attention over
    ``kvpos``. Slots are filled in position order from 0 (by prefill and
    the steps before), so:

    - while ``pos < C`` every slot holds its own position and the empty
      ones lie above ``pos``: causal attention with ``q_offset = pos``
      (and the ``window`` mask) over the implicit positions is exact;
    - once a ring has wrapped (``pos >= C``, window set) the new token's
      write leaves every slot holding a position in ``(pos - C, pos]``,
      all of them visible when ``C <= window`` (a full ring of ``window``
      slots after a prompt longer than the window, or the ``s`` slots of
      a shorter prompt's cache). The reference's mask then keeps every
      slot, which is **non-causal** attention over all C slots; softmax
      is order-free, so only the summation order differs. A wrapped ring
      longer than the window would need explicit positions and raises.

    ``tp``: as in ``prefill_attention``, the cache holding this rank's
    Hkv / T heads."""
    b = x.shape[0]
    k_cache, v_cache, kvpos = cache
    c = k_cache.shape[1]
    if pos < 0 or (pos >= c and not window):
        raise ValueError(f"decode position {pos} outside the cache of "
                         f"{c} slots")
    if window and pos >= c > window:
        raise ValueError(f"a wrapped ring of {c} slots is longer than the "
                         f"window {window}")
    slot = pos % c
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, cfg, x, positions, mpos, tp)
    k_cache[:, slot] = k_new[:, 0]
    v_cache[:, slot] = v_new[:, 0]
    kvpos[:, slot] = pos
    if pos >= c:
        out = _attend(q, k_cache, v_cache, causal=False)
    else:
        out = _attend(q, k_cache, v_cache, window=window, q_offset=pos)
    return _out_proj(params, out, tp), (k_cache, v_cache, kvpos)


# ---------------------------------------------------------------------------
# cross attention (whisper decoder)
# ---------------------------------------------------------------------------

def cross_attn_init(gen: torch.Generator, cfg, device, dtype=None) -> dict:
    return attn_init(gen, cfg, device, dtype)


def encode_cross_kv(params, cfg, enc_out):
    """The encoder output (B, Senc, d) projected once into the decoder
    layer's cross-attention k/v, each (B, Senc, Hkv, D), in its dtype."""
    b, s, _ = enc_out.shape
    nkv, hd = cfg.n_kv_heads, cfg.head_dim
    k = enc_out @ params["wk"].to(enc_out.dtype)
    v = enc_out @ params["wv"].to(enc_out.dtype)
    return k.reshape(b, s, nkv, hd), v.reshape(b, s, nkv, hd)


def cross_attention(params, cfg, x, enc_kv, *, chunk=None):
    """x: (B, Sq, d) attends to every row of ``enc_kv`` = (k, v) from
    ``encode_cross_kv``: the query projection (no bias, no rotary, as in
    the reference), non-causal attention, the output projection.
    ``chunk=None`` runs the ``flash_attention`` kernel; an int runs
    ``chunked_attention`` with all-zero ``kv_positions`` and KV chunks of
    ``min(chunk, Senc)``."""
    b, sq, _ = x.shape
    nh, hd = cfg.n_heads, cfg.head_dim
    q = (x @ params["wq"].to(x.dtype)).reshape(b, sq, nh, hd)
    k, v = enc_kv
    if chunk is None:
        out = _attend(q, k, v, causal=False)
    else:
        kvp = torch.zeros((b, k.shape[1]), dtype=torch.int32,
                          device=x.device)
        out = chunked_attention(q, k, v, causal=False, kv_positions=kvp,
                                chunk=min(chunk, k.shape[1])).reshape(
                                    b, sq, nh * hd)
    return out @ params["wo"].to(x.dtype)
