"""Serving paths of the slice: cache init, prefill, single-token decode
for the ``dense`` and ``ssm`` (rwkv6) families; the port of
``repro.models.decode``.

Cache layout (leaves stacked over layers, as in the reference):
  dense : {"k": (L, B, C, Hkv, D), "v": ..., "pos": (L, B, C) int32,
           "t": int}
  ssm   : {"ax": (L, B, d), "S": (L, B, nh, hd, hd) f32, "cx": (L, B, d),
           "t": int}
``t``, the position of the next token, is a host int (the reference
keeps a device scalar): the decode step needs it on the host to address
the cache slot and the attention kernel's ``q_offset``.

``decode_step`` updates the cache tensors IN PLACE and returns the same
dict (the reference returns an updated copy; the port saves a copy of
the whole cache per generated token). Ring-buffer (``window`` > 0)
serving and the other families raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention, common, rwkv, transformer


def _check_window(window: int) -> None:
    if window:
        raise NotImplementedError(
            f"ring-buffer (window > 0) serving is not ported yet: see "
            f"{attention.ROADMAP_ITEM}")


def init_cache(cfg, batch: int, cache_len: int, *, window: int = 0,
               device="cuda") -> dict[str, Any]:
    """Zeroed cache on ``device`` (empty kv slots have position -1)."""
    transformer.check_family(cfg)
    _check_window(window)
    device = resolve_device(device)
    L, dt = cfg.n_layers, cfg.adtype
    if cfg.family == "dense":
        kv = (L, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(kv, dtype=dt, device=device),
                "v": torch.zeros(kv, dtype=dt, device=device),
                "pos": torch.full((L, batch, cache_len), -1,
                                  dtype=torch.int32, device=device),
                "t": 0}
    nh, hd = rwkv.rwkv_dims(cfg)
    return {"ax": torch.zeros((L, batch, cfg.d_model), dtype=dt,
                              device=device),
            "S": torch.zeros((L, batch, nh, hd, hd), dtype=torch.float32,
                             device=device),
            "cx": torch.zeros((L, batch, cfg.d_model), dtype=dt,
                              device=device),
            "t": 0}


def prefill(params, cfg, tokens, *, window: int = 0, max_new: int = 0):
    """Processes the prompt, returns (last-position logits (B, V), cache).
    ``max_new`` reserves cache headroom for subsequent decode steps: the
    dense cache is allocated at S + max_new slots and each layer's k/v
    are written into it (the cache the reference's prefill builds and
    pads with ``_pad_kv``, without the copy)."""
    transformer.check_family(cfg)
    _check_window(window)
    b, s = tokens.shape
    x = transformer.embed(params, cfg, tokens)
    if cfg.family == "dense":
        cache = init_cache(cfg, b, s + max_new, device=x.device)
        for i in range(cfg.n_layers):
            lp = transformer.layer(params["layers"], i)
            h = common.rms_norm(x, lp["ln1"])
            out, (k, v, p) = attention.prefill_attention(lp["attn"], cfg, h)
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
            cache["pos"][i, :, :s] = p
            x = x + out
            h = common.rms_norm(x, lp["ln2"])
            x = x + common.swiglu(lp["mlp"], h)
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
    return transformer.logits_from_hidden(params, cfg, h)[:, 0], cache


def decode_step(params, cfg, cache, tokens, *, window: int = 0):
    """tokens: (B, 1) int. Returns (logits (B, V), cache), the cache
    updated in place and ``cache["t"]`` advanced by one."""
    transformer.check_family(cfg)
    _check_window(window)
    pos = cache["t"]
    x = transformer.embed(params, cfg, tokens[:, :1])
    for i in range(cfg.n_layers):
        lp = transformer.layer(params["layers"], i)
        h = common.rms_norm(x, lp["ln1"])
        if cfg.family == "dense":
            out, _ = attention.decode_attention(
                lp["attn"], cfg, h,
                (cache["k"][i], cache["v"][i], cache["pos"][i]), pos)
            x = x + out
            h = common.rms_norm(x, lp["ln2"])
            x = x + common.swiglu(lp["mlp"], h)
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
    return transformer.logits_from_hidden(params, cfg, h)[:, 0], cache
