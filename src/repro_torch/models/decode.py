"""Serving paths of every family: cache init, prefill, single-token
decode for ``dense``, ``moe``, ``vlm``, ``ssm`` (rwkv6), ``hybrid``
(zamba2) and ``audio`` (whisper); the port of ``repro.models.decode``.

Cache layout (leaves stacked over layers, as in the reference):
  dense/moe/vlm : {"k": (L, B, C, Hkv, D), "v": ..., "pos": (L, B, C)
                  int32, "t": int}; C = cache_len, the ring's length with
                  a window; a vlm adds "dpos": int, the M-RoPE position of
                  a decode step minus its cache position
  ssm           : {"ax": (L, B, d), "S": (L, B, nh, hd, hd) f32,
                  "cx": (L, B, d), "t": int}
  hybrid        : {"h": (L, B, nh, hd, N) f32 (Mamba2 states), "tail":
                  (L, B, CONV_K - 1, din + 2N) (conv inputs), "ak"/"av":
                  (n_app, B, C, Hkv, D), "apos": (n_app, B, C) int32,
                  "t": int}; n_app = ``_n_app(cfg)``, one k/v cache per
                  application of the shared attention block
  audio         : the dense cache of the decoder's self-attention plus
                  "ck"/"cv": (L, B, Senc, Hkv, D), each layer's
                  cross-attention k/v, computed once at prefill
``t``, the position of the next token, and ``dpos`` are host ints (the
reference keeps device scalars): the decode step needs them on the host
to address the cache slot and the attention kernel's ``q_offset``.

With a ``window`` (ring-buffer serving, the reference's ``long_500k``
path) the prefill keeps ``window`` slots when the prompt is longer
(position p at slot ``p % window``) and the prompt's ``s`` slots when it
is not; either way there is no ``max_new`` headroom and decode wraps
over the ring (``attention.decode_attention``). As in the reference, an
``audio`` prefill attends without the window and keeps the prompt's
``s`` slots (no headroom).

``decode_step`` updates the cache tensors IN PLACE and returns the same
dict (the reference returns an updated copy; the port saves a copy of
the whole cache per generated token).

``tp`` (a ``models.tp.TPContext``; the dense family only,
``tp.check_serve``): serving on one rank of a serve mesh
(``launch.serve``). ``params`` are the rank's blocks under the
reference's serve specs, the cache holds the rank's batch rows and its
Hkv / T kv heads (``launch.serve.cache_specs``), attention runs on the
rank's heads, the FFN over its column and row blocks, the embedding
vocab-parallel, and the logits are the rank's vocabulary block
(``transformer.logits_from_hidden``).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention, common, rwkv, ssm, transformer
from repro_torch.models import tp as tp_mod


def _n_app(cfg) -> int:
    """Applications of a hybrid model's shared attention block: one per
    group of ``attn_every`` layers, the remainder a group of its own."""
    return len(transformer.groups(cfg))


def init_cache(cfg, batch: int, cache_len: int, *, window: int = 0,
               enc_seq=None, device="cuda", tp=None) -> dict[str, Any]:
    """Zeroed cache on ``device`` (empty kv slots have position -1).
    ``cache_len`` already equals the ring's length for windowed decode;
    ``window`` is the reference's argument and changes nothing here.
    ``enc_seq``: an audio model's encoder length (default
    ``cfg.enc_seq``). ``tp``: a rank's cache, Hkv / T kv heads."""
    transformer.check_family(cfg)
    _check_tp(cfg, tp)
    device = resolve_device(device)
    L, dt = cfg.n_layers, cfg.adtype
    if cfg.family == "hybrid":
        din, nh, hd, n = ssm.mamba2_dims(cfg)
        na = _n_app(cfg)
        kv = (na, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
        return {"h": torch.zeros((L, batch, nh, hd, n), dtype=torch.float32,
                                 device=device),
                "tail": torch.zeros((L, batch, ssm.CONV_K - 1, din + 2 * n),
                                    dtype=dt, device=device),
                "ak": torch.zeros(kv, dtype=dt, device=device),
                "av": torch.zeros(kv, dtype=dt, device=device),
                "apos": torch.full((na, batch, cache_len), -1,
                                   dtype=torch.int32, device=device),
                "t": 0}
    if cfg.family != "ssm":
        nkv = cfg.n_kv_heads // (1 if tp is None else tp.size)
        kv = (L, batch, cache_len, nkv, cfg.head_dim)
        out = {"k": torch.zeros(kv, dtype=dt, device=device),
               "v": torch.zeros(kv, dtype=dt, device=device),
               "pos": torch.full((L, batch, cache_len), -1,
                                 dtype=torch.int32, device=device),
               "t": 0}
        if cfg.family == "audio":
            ckv = (L, batch, enc_seq or cfg.enc_seq, cfg.n_kv_heads,
                   cfg.head_dim)
            out["ck"] = torch.zeros(ckv, dtype=dt, device=device)
            out["cv"] = torch.zeros(ckv, dtype=dt, device=device)
        if cfg.m_rope:
            out["dpos"] = 0
        return out
    nh, hd = rwkv.rwkv_dims(cfg)
    return {"ax": torch.zeros((L, batch, cfg.d_model), dtype=dt,
                              device=device),
            "S": torch.zeros((L, batch, nh, hd, hd), dtype=torch.float32,
                             device=device),
            "cx": torch.zeros((L, batch, cfg.d_model), dtype=dt,
                              device=device),
            "t": 0}


def _check_tp(cfg, tp) -> None:
    if tp is not None:
        tp_mod.check_serve(cfg, tp.size)


def prefill(params, cfg, tokens, *, extras=None, window: int = 0,
            max_new: int = 0, tp=None):
    """Processes the prompt, returns (last-position logits (B, V), cache).
    ``max_new`` reserves cache headroom for subsequent decode steps: the
    attention cache is allocated at S + max_new slots and each layer's
    k/v are written into it (the cache the reference's prefill builds and
    pads with ``_pad_kv``, without the copy). With a ``window`` the cache
    has ``window`` slots if S > window, else S, and no headroom (the
    reference pads only without a window).

    ``extras``: ``enc_embed`` (audio: the encoder runs once, and each
    decoder layer's cross k/v go into the cache's ``ck``/``cv``) or
    ``vision_embed`` (vlm: the projected vision embeddings precede the
    prompt, so S counts them, and ``dpos`` = the last text position's
    M-RoPE position + 1 - S). ``tp``: one rank of a serve mesh (module
    docstring); the logits are the rank's vocabulary block."""
    transformer.check_family(cfg)
    _check_tp(cfg, tp)
    b, s = tokens.shape
    x, mpos = transformer.embed_inputs(params, cfg, tokens, extras, tp)
    if cfg.family == "hybrid":
        x, cache = _hybrid_prefill(params, cfg, x, window=window,
                                   max_new=max_new)
    elif cfg.family == "audio":
        x, cache = _audio_prefill(params, cfg, x, extras["enc_embed"],
                                  window=window, max_new=max_new)
        h = common.layer_norm(x[:, -1:], params["final_norm"],
                              params["final_norm_b"])
        return transformer.logits_from_hidden(params, cfg, h)[:, 0], cache
    elif cfg.family != "ssm":
        s = x.shape[1]
        n = min(s, window) if window else s
        cache = init_cache(cfg, b, n if window else s + max_new,
                           device=x.device, tp=tp)
        for i in range(cfg.n_layers):
            lp = transformer.layer(params["layers"], i)
            h = common.rms_norm(x, lp["ln1"])
            out, (k, v, p) = attention.prefill_attention(
                lp["attn"], cfg, h, window=window, mpos=mpos, tp=tp)
            cache["k"][i, :, :n] = k
            cache["v"][i, :, :n] = v
            cache["pos"][i, :, :n] = p
            x = x + out
            h, _ = transformer.ffn(lp, cfg, common.rms_norm(x, lp["ln2"]),
                                   ft=tp)
            x = x + h
        if mpos is not None:
            # the last text token sits at M-RoPE position g + n_text - 1
            # (g the vision grid's width) and at slot n_vis + n_text - 1
            n_vis = s - tokens.shape[1]
            cache["dpos"] = transformer.mrope_grid(n_vis) - n_vis
    else:
        cache = init_cache(cfg, b, 0, device=x.device)
        for i in range(cfg.n_layers):
            lp = transformer.layer(params["layers"], i)
            h = common.rms_norm(x, lp["ln1"])
            out, (ax, st) = rwkv.time_mix_forward(lp["tmix"], cfg, h,
                                                  return_state=True)
            x = x + out
            h = common.rms_norm(x, lp["ln2"])
            out, cx = rwkv.channel_mix_forward(lp["cmix"], cfg, h,
                                               return_state=True)
            x = x + out
            cache["ax"][i], cache["S"][i], cache["cx"][i] = ax, st, cx
    cache["t"] = s
    h = common.rms_norm(x[:, -1:], params["final_norm"])
    return transformer.logits_from_hidden(params, cfg, h, tp)[:, 0], cache


def _hybrid_prefill(params, cfg, x, *, window: int, max_new: int):
    """The hybrid stack over the prompt, writing each layer's Mamba2
    state and conv tail and each shared-attention application's k/v into
    a preallocated cache (the reference concatenates and pads); with a
    ``window`` the attention caches keep the ring's slots, as in the
    dense branch."""
    b, s = x.shape[:2]
    n = min(s, window) if window else s
    cache = init_cache(cfg, b, n if window else s + max_new,
                       device=x.device)
    sa = params["shared_attn"]
    for a, g in enumerate(transformer.groups(cfg)):
        h = common.rms_norm(x, sa["ln"])
        out, (k, v, p) = attention.prefill_attention(sa["attn"], cfg, h,
                                                     window=window)
        cache["ak"][a, :, :n] = k
        cache["av"][a, :, :n] = v
        cache["apos"][a, :, :n] = p
        x = x + out
        for i in g:
            lp = transformer.layer(params["layers"], i)
            h = common.rms_norm(x, lp["ln1"])
            out, (cache["h"][i], cache["tail"][i]) = ssm.mamba2_forward(
                lp["mamba"], cfg, h, return_state=True)
            x = x + out
    return x, cache


def _audio_prefill(params, cfg, x, enc_embed, *, window: int,
                   max_new: int):
    """The whisper encoder over ``enc_embed``, then the decoder over the
    prompt (``dec_pos`` added), each layer's self-attention k/v and
    cross-attention k/v written into a preallocated cache. As in the
    reference the self-attention ignores ``window`` and a ``window``
    leaves no ``max_new`` headroom."""
    b, s = x.shape[:2]
    enc = transformer.encode(params, cfg, enc_embed)
    cache = init_cache(cfg, b, s if window else s + max_new,
                       enc_seq=enc.shape[1], device=x.device)
    x = x + params["dec_pos"][:s].to(cfg.adtype)
    for i in range(cfg.n_layers):
        lp = transformer.layer(params["layers"], i)
        ck, cv = attention.encode_cross_kv(lp["cross_attn"], cfg, enc)
        cache["ck"][i], cache["cv"][i] = ck, cv
        h = common.layer_norm(x, lp["ln1_w"], lp["ln1_b"])
        out, (k, v, p) = attention.prefill_attention(lp["self_attn"], cfg, h)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
        cache["pos"][i, :, :s] = p
        x = x + out
        h = common.layer_norm(x, lp["ln2_w"], lp["ln2_b"])
        x = x + attention.cross_attention(lp["cross_attn"], cfg, h, (ck, cv))
        h = common.layer_norm(x, lp["ln3_w"], lp["ln3_b"])
        x = x + common.gelu_mlp(lp["mlp"], h)
    cache["t"] = s
    return x, cache


def _audio_decode(params, cfg, cache, x, pos: int, *, window: int):
    """``decode_step``'s audio branch: ``dec_pos[pos]`` added, each
    layer's self-attention against its cache (updated in place) and its
    cross-attention against ``ck``/``cv``. Returns (logits, cache)."""
    x = x + params["dec_pos"][pos][None, None, :].to(cfg.adtype)
    for i in range(cfg.n_layers):
        lp = transformer.layer(params["layers"], i)
        h = common.layer_norm(x, lp["ln1_w"], lp["ln1_b"])
        out, _ = attention.decode_attention(
            lp["self_attn"], cfg, h,
            (cache["k"][i], cache["v"][i], cache["pos"][i]), pos,
            window=window)
        x = x + out
        h = common.layer_norm(x, lp["ln2_w"], lp["ln2_b"])
        x = x + attention.cross_attention(lp["cross_attn"], cfg, h,
                                          (cache["ck"][i], cache["cv"][i]))
        h = common.layer_norm(x, lp["ln3_w"], lp["ln3_b"])
        x = x + common.gelu_mlp(lp["mlp"], h)
    cache["t"] = pos + 1
    h = common.layer_norm(x, params["final_norm"], params["final_norm_b"])
    return transformer.logits_from_hidden(params, cfg, h)[:, 0], cache


def _hybrid_decode(params, cfg, cache, x, pos: int, *, window: int):
    """``decode_step``'s hybrid branch: one token through the hybrid
    stack, every cache leaf updated in place. Returns (logits, cache)."""
    sa = params["shared_attn"]
    for a, g in enumerate(transformer.groups(cfg)):
        h = common.rms_norm(x, sa["ln"])
        out, _ = attention.decode_attention(
            sa["attn"], cfg, h, (cache["ak"][a], cache["av"][a],
                                 cache["apos"][a]), pos, window=window)
        x = x + out
        for i in g:
            lp = transformer.layer(params["layers"], i)
            h = common.rms_norm(x, lp["ln1"])
            out, (cache["h"][i], cache["tail"][i]) = ssm.mamba2_step(
                lp["mamba"], cfg, h, (cache["h"][i], cache["tail"][i]))
            x = x + out
    cache["t"] = pos + 1
    h = common.rms_norm(x, params["final_norm"])
    return transformer.logits_from_hidden(params, cfg, h)[:, 0], cache


def decode_step(params, cfg, cache, tokens, *, window: int = 0, tp=None):
    """tokens: (B, 1) int. Returns (logits (B, V), cache), the cache
    updated in place and ``cache["t"]`` advanced by one. ``tp``: one rank
    of a serve mesh (module docstring); the logits are the rank's
    vocabulary block."""
    transformer.check_family(cfg)
    _check_tp(cfg, tp)
    pos = cache["t"]
    x = transformer.embed(params, cfg, tokens[:, :1], tp)
    if cfg.family == "hybrid":
        return _hybrid_decode(params, cfg, cache, x, pos, window=window)
    if cfg.family == "audio":
        return _audio_decode(params, cfg, cache, x, pos, window=window)
    mpos = None
    if cfg.m_rope:
        # M-RoPE position pos + dpos on all three streams; slot pos
        mpos = torch.full((3, x.shape[0], 1), pos + cache.get("dpos", 0),
                          dtype=torch.int32, device=x.device)
    for i in range(cfg.n_layers):
        lp = transformer.layer(params["layers"], i)
        h = common.rms_norm(x, lp["ln1"])
        if cfg.family != "ssm":
            out, _ = attention.decode_attention(
                lp["attn"], cfg, h,
                (cache["k"][i], cache["v"][i], cache["pos"][i]), pos,
                window=window, mpos=mpos, tp=tp)
            x = x + out
            h, _ = transformer.ffn(lp, cfg, common.rms_norm(x, lp["ln2"]),
                                   ft=tp)
            x = x + h
        else:
            out, (ax, st) = rwkv.time_mix_forward(
                lp["tmix"], cfg, h, state=(cache["ax"][i], cache["S"][i]),
                return_state=True)
            x = x + out
            h = common.rms_norm(x, lp["ln2"])
            out, cx = rwkv.channel_mix_forward(
                lp["cmix"], cfg, h, state=cache["cx"][i], return_state=True)
            x = x + out
            cache["ax"][i], cache["S"][i], cache["cx"][i] = ax, st, cx
    cache["t"] = pos + 1
    h = common.rms_norm(x, params["final_norm"])
    return transformer.logits_from_hidden(params, cfg, h, tp)[:, 0], cache
