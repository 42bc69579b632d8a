"""Layer stacks of the serving slice: the ``dense`` family (pre-RMSNorm
GQA decoder with a SwiGLU FFN; qwen3) and the ``ssm`` family (RWKV6
time-mix + channel-mix blocks); the port of ``repro.models.transformer``.

Parameters keep the reference's layout leaf for leaf: each per-layer
leaf is stacked over layers with a leading ``n_layers`` axis, dense
weights are ``(in, out)``, so a JAX parameter tree loads unchanged
(``repro_torch.weights.tree_from_numpy``). Where the reference scans over
the stacked layers, the port loops over them in Python.

The other families (``moe``, ``hybrid``, ``audio``, ``vlm``) raise
``NotImplementedError`` (ROADMAP.md, "Modules still to port", item 11).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models import attention, common, rwkv

SERVED_FAMILIES = ("dense", "ssm")


def check_family(cfg) -> None:
    """Raise for a configuration this slice does not serve."""
    if cfg.family not in SERVED_FAMILIES or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (the port "
            f"serves {SERVED_FAMILIES} without MoE): see "
            f"{attention.ROADMAP_ITEM}")
    attention._check_supported(cfg)


def layer(layers: dict, i: int) -> dict:
    """The parameters of layer ``i``: views into the stacked leaves."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def _stacked(init_fn: Callable, gen, n: int, cfg, device) -> dict:
    """Init ``n`` layers with ``init_fn`` and stack each leaf on a
    leading axis, writing each layer into a preallocated stack."""
    def alloc(t):
        return {k: alloc(v) for k, v in t.items()} if isinstance(t, dict) \
            else torch.empty((n,) + t.shape, dtype=t.dtype, device=t.device)

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i] = v

    out = None
    for i in range(n):
        one = init_fn(gen, cfg, device)
        if out is None:
            out = alloc(one)
        put(out, one, i)
    return out


def _dense_block_init(gen, cfg, device) -> dict:
    ones = lambda: torch.ones((cfg.d_model,), dtype=cfg.dtype, device=device)
    return {
        "ln1": ones(),
        "attn": attention.attn_init(gen, cfg, device),
        "ln2": ones(),
        "mlp": common.swiglu_init(gen, cfg.d_model, cfg.d_ff, device,
                                  cfg.dtype),
    }


def _rwkv_block_init(gen, cfg, device) -> dict:
    ones = lambda: torch.ones((cfg.d_model,), dtype=cfg.dtype, device=device)
    return {
        "ln1": ones(),
        "tmix": rwkv.time_mix_init(gen, cfg, device),
        "ln2": ones(),
        "cmix": rwkv.channel_mix_init(gen, cfg, device),
    }


def init_params(gen: torch.Generator, cfg, device) -> dict[str, Any]:
    """Full parameter tree of a ``dense`` or ``ssm`` model on ``device``."""
    check_family(cfg)
    d, v = cfg.d_model, cfg.vocab
    params: dict[str, Any] = {
        "embed": common.embed_init(gen, (v, d), device, cfg.dtype),
        "final_norm": torch.ones((d,), dtype=cfg.dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = common.dense_init(gen, (d, v), device,
                                              scale=0.02, dtype=cfg.dtype)
    block = _dense_block_init if cfg.family == "dense" else _rwkv_block_init
    params["layers"] = _stacked(block, gen, cfg.n_layers, cfg, device)
    return params


def _dense_block_fwd(bp, cfg, x, *, window=0):
    h = common.rms_norm(x, bp["ln1"])
    x = x + attention.self_attention(bp["attn"], cfg, h, window=window)
    h = common.rms_norm(x, bp["ln2"])
    return x + common.swiglu(bp["mlp"], h)


def _rwkv_block_fwd(bp, cfg, x):
    h = common.rms_norm(x, bp["ln1"])
    x = x + rwkv.time_mix_forward(bp["tmix"], cfg, h)
    h = common.rms_norm(x, bp["ln2"])
    return x + rwkv.channel_mix_forward(bp["cmix"], cfg, h)


def embed(params, cfg, tokens):
    """(B, S) int tokens -> (B, S, d) activations in ``cfg.adtype``."""
    return params["embed"][tokens.long()].to(cfg.adtype)


def forward_hidden(params, cfg, tokens, *, window: int = 0):
    """Embeds ``tokens`` and runs the stack. Returns (hidden (B, S, d),
    aux_loss), aux_loss a zero f32 scalar (no MoE in this slice)."""
    check_family(cfg)
    x = embed(params, cfg, tokens)
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        if cfg.family == "dense":
            x = _dense_block_fwd(lp, cfg, x, window=window)
        else:
            x = _rwkv_block_fwd(lp, cfg, x)
    x = common.rms_norm(x, params["final_norm"])
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_from_hidden(params, cfg, h):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return h @ w.to(h.dtype)
