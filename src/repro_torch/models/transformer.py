"""Layer stacks of the ported families: ``dense`` (pre-RMSNorm GQA
decoder with a SwiGLU FFN; qwen3), ``moe`` (the same decoder with a
Mixture-of-Experts FFN, ``models.moe``; olmoe, grok-1), ``ssm`` (RWKV6
time-mix + channel-mix blocks) and ``hybrid`` (zamba2: Mamba2 blocks,
``models.ssm``, with ONE shared attention block, one set of weights,
applied before each group of ``attn_every`` of them and once more before
the remainder); the port of ``repro.models.transformer``.

Parameters keep the reference's layout leaf for leaf: each per-layer
leaf is stacked over layers with a leading ``n_layers`` axis, dense
weights are ``(in, out)``, so a JAX parameter tree loads unchanged
(``repro_torch.weights.tree_from_numpy``). Where the reference scans over
the stacked layers, the port loops over them in Python, taking each
stacked leaf apart once per forward (``unbind``, whose backward stacks
the layers' gradients in one tensor).

``forward_hidden`` serves two callers. Serving (``attn_chunk`` and
``wkv_chunked`` None, the defaults) runs the ``flash_attention`` and
``wkv6`` kernels, which refuse autograd. Training (``Model.loss``) sets
``attn_chunk`` to an int and ``wkv_chunked`` to a bool and runs the
reference's plain tensor math (``attention.chunked_attention``,
``rwkv.wkv_scan`` / ``wkv_chunked``) under autograd, each layer body
recomputed in the backward when ``remat`` (``torch.utils.checkpoint``,
the reference's ``jax.checkpoint``; in ``hybrid`` the Mamba2 bodies, not
the shared attention, as in the reference). Mamba2's SSD is plain
tensor math on both routes (``ssm.ssd_chunked``).

The other families (``audio``, ``vlm``) raise ``NotImplementedError``
(ROADMAP.md, "Modules still to port", item 11).
"""
from __future__ import annotations

import functools
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, common, moe, rwkv, ssm

SERVED_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def check_family(cfg) -> None:
    """Raise for a configuration the port does not serve: a family
    outside ``SERVED_FAMILIES``, or an MoE FFN outside the ``moe``
    family."""
    if cfg.family not in SERVED_FAMILIES or (
            (cfg.moe is not None) != (cfg.family == "moe")):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (the port "
            f"serves {SERVED_FAMILIES}, MoE only in 'moe'): see "
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
        **({"moe": moe.moe_init(gen, cfg, device)} if cfg.moe is not None
           else {"mlp": common.swiglu_init(gen, cfg.d_model, cfg.d_ff,
                                           device, cfg.dtype)}),
    }


def _rwkv_block_init(gen, cfg, device) -> dict:
    ones = lambda: torch.ones((cfg.d_model,), dtype=cfg.dtype, device=device)
    return {
        "ln1": ones(),
        "tmix": rwkv.time_mix_init(gen, cfg, device),
        "ln2": ones(),
        "cmix": rwkv.channel_mix_init(gen, cfg, device),
    }


def _mamba_block_init(gen, cfg, device) -> dict:
    return {
        "ln1": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=device),
        "mamba": ssm.mamba2_init(gen, cfg, device),
    }


def init_params(gen: torch.Generator, cfg, device) -> dict[str, Any]:
    """Full parameter tree of a ``dense``, ``moe``, ``ssm`` or ``hybrid``
    model on ``device``; a ``hybrid`` model adds ``shared_attn`` = {"ln",
    "attn"}, the one attention block its groups share."""
    check_family(cfg)
    d, v = cfg.d_model, cfg.vocab
    params: dict[str, Any] = {
        "embed": common.embed_init(gen, (v, d), device, cfg.dtype),
        "final_norm": torch.ones((d,), dtype=cfg.dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = common.dense_init(gen, (d, v), device,
                                              scale=0.02, dtype=cfg.dtype)
    block = {"ssm": _rwkv_block_init, "hybrid": _mamba_block_init}.get(
        cfg.family, _dense_block_init)
    params["layers"] = _stacked(block, gen, cfg.n_layers, cfg, device)
    if cfg.family == "hybrid":
        params["shared_attn"] = {
            "ln": torch.ones((d,), dtype=cfg.dtype, device=device),
            "attn": attention.attn_init(gen, cfg, device),
        }
    return params


def ffn(bp, cfg, h, *, ep_axis=None, ep_size=1):
    """The block's FFN: (out, aux), aux the MoE load-balance loss or None
    for a SwiGLU block."""
    if cfg.moe is not None:
        return moe.moe_ffn(bp["moe"], cfg, h, ep_axis=ep_axis,
                           ep_size=ep_size)
    return common.swiglu(bp["mlp"], h), None


def _dense_block_fwd(bp, cfg, x, *, window=0, chunk=None, ep_axis=None,
                     ep_size=1):
    h = common.rms_norm(x, bp["ln1"])
    x = x + attention.self_attention(bp["attn"], cfg, h, window=window,
                                     chunk=chunk)
    h, aux = ffn(bp, cfg, common.rms_norm(x, bp["ln2"]), ep_axis=ep_axis,
                 ep_size=ep_size)
    return x + h, aux


def _rwkv_block_fwd(bp, cfg, x, *, wkv_chunked=None):
    h = common.rms_norm(x, bp["ln1"])
    x = x + rwkv.time_mix_forward(bp["tmix"], cfg, h,
                                  use_chunked=wkv_chunked)
    h = common.rms_norm(x, bp["ln2"])
    return x + rwkv.channel_mix_forward(bp["cmix"], cfg, h), None


def _mamba_block_fwd(bp, cfg, x):
    h = common.rms_norm(x, bp["ln1"])
    return x + ssm.mamba2_forward(bp["mamba"], cfg, h), None


def _shared_attn_fwd(sp, cfg, x, *, window=0, chunk=None):
    h = common.rms_norm(x, sp["ln"])
    return x + attention.self_attention(sp["attn"], cfg, h, window=window,
                                        chunk=chunk)


def groups(cfg) -> list:
    """The hybrid stack's groups as layer ranges: the shared attention
    block runs before each (``cfg.attn_every`` layers, the last group the
    remainder); their number is the reference's ``decode._n_app``."""
    per, n = cfg.attn_every, cfg.n_layers
    return [range(g, min(g + per, n)) for g in range(0, n, per)]


def embed(params, cfg, tokens):
    """(B, S) int tokens -> (B, S, d) activations in ``cfg.adtype``."""
    return params["embed"][tokens.long()].to(cfg.adtype)


def unstack_layers(layers: dict) -> list:
    """The stacked layer tree as one tree per layer, each leaf taken
    apart once with ``unbind``."""
    def split(t):
        if isinstance(t, dict):
            parts = {k: split(v) for k, v in t.items()}
            n = len(next(iter(parts.values())))
            return [{k: v[i] for k, v in parts.items()} for i in range(n)]
        return t.unbind(0)
    return split(layers)


def forward_hidden(params, cfg, tokens, *, window: int = 0,
                   remat: bool = False, ep_axis=None, ep_size: int = 1,
                   attn_chunk=None, wkv_chunked=None, act_spec=None):
    """Embeds ``tokens`` and runs the stack. Returns (hidden (B, S, d),
    aux_loss): the layers' MoE load-balance losses summed in f32 (a zero
    f32 scalar without MoE).

    ``attn_chunk`` None runs attention through the kernel, an int through
    ``chunked_attention`` with KV chunks of that size; ``wkv_chunked``
    None runs the ``wkv6`` kernel, False / True ``wkv_scan`` /
    ``wkv_chunked`` (module docstring). ``remat`` recomputes each layer
    in the backward (``checkpoint(..., use_reentrant=False)``; the
    checkpointed body returns the pair (x, aux)). ``ep_axis`` set
    (expert parallelism) raises in an MoE block (``moe.moe_ffn``) and is
    ignored elsewhere, as in the reference. ``act_spec`` is the
    reference's activation sharding constraint, the identity on one
    device; only None is accepted."""
    if act_spec is not None:
        raise NotImplementedError(
            "act_spec (sequence-sharded activations) needs a multi-rank "
            "HFL mesh: see ROADMAP.md, 'Modules still to port', item 10 (b)")
    check_family(cfg)
    x = embed(params, cfg, tokens)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        x = _hybrid_forward(params, cfg, x, remat=remat, window=window,
                            attn_chunk=attn_chunk)
        return common.rms_norm(x, params["final_norm"]), aux_total
    if cfg.family == "ssm":
        body = functools.partial(_rwkv_block_fwd, cfg=cfg,
                                 wkv_chunked=wkv_chunked)
    else:
        body = functools.partial(_dense_block_fwd, cfg=cfg, window=window,
                                 chunk=attn_chunk, ep_axis=ep_axis,
                                 ep_size=ep_size)
    for lp in unstack_layers(params["layers"]):
        if remat:
            x, aux = checkpoint(body, lp, x=x, use_reentrant=False)
        else:
            x, aux = body(lp, x=x)
        if aux is not None:
            aux_total = aux_total + aux
    x = common.rms_norm(x, params["final_norm"])
    return x, aux_total


def _hybrid_forward(params, cfg, x, *, remat, window, attn_chunk):
    """zamba2: the shared attention block before each group of
    ``attn_every`` Mamba2 blocks (``groups``); ``remat`` recomputes each
    Mamba2 block in the backward, as the reference checkpoints its
    scanned body."""
    body = functools.partial(_mamba_block_fwd, cfg=cfg)
    layers = unstack_layers(params["layers"])
    for g in groups(cfg):
        x = _shared_attn_fwd(params["shared_attn"], cfg, x, window=window,
                             chunk=attn_chunk)
        for i in g:
            if remat:
                x, _ = checkpoint(body, layers[i], x=x, use_reentrant=False)
            else:
                x, _ = body(layers[i], x=x)
    return x


def logits_from_hidden(params, cfg, h):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return h @ w.to(h.dtype)
