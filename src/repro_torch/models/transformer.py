"""Layer stacks of every family: ``dense`` (pre-RMSNorm GQA decoder with
a SwiGLU FFN; qwen3), ``moe`` (the same decoder with a Mixture-of-Experts
FFN, ``models.moe``; olmoe, grok-1), ``vlm`` (the dense decoder under
M-RoPE, with projected vision embeddings before the text; qwen2-vl),
``ssm`` (RWKV6 time-mix + channel-mix blocks), ``hybrid`` (zamba2:
Mamba2 blocks, ``models.ssm``, with ONE shared attention block, one set
of weights, applied before each group of ``attn_every`` of them and once
more before the remainder) and ``audio`` (whisper: a LayerNorm / GELU
encoder-decoder, the decoder cross-attending to the encoder); the port
of ``repro.models.transformer``.

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
tensor math on both routes (``ssm.ssd_chunked``). The whisper blocks
take KV chunks of ``min(1024, S)`` on the training route, the
reference's own chunk, whatever ``attn_chunk`` says.

The stub front ends are inputs, as in the reference: ``extras``
carries whisper's frame embeddings ``enc_embed`` (B, enc_seq, d) and
qwen2-vl's patch embeddings ``vision_embed`` (B, n_vis, d).
"""
from __future__ import annotations

import functools
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, common, moe, rwkv, ssm
from repro_torch.models import tp as tp_mod

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")
EXTRAS = ("enc_embed", "vision_embed")     # the stub front ends' inputs


def check_family(cfg) -> None:
    """Raise ``ValueError`` for a family the reference does not have, or
    an MoE FFN outside the ``moe`` family (no configuration has one)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    if (cfg.moe is not None) != (cfg.family == "moe"):
        raise ValueError(f"{cfg.name}: an MoE FFN is built only in the "
                         f"'moe' family, not {cfg.family!r}")


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


def _layer_norms(cfg, device, *names) -> dict:
    """Layer norms' weights (ones) and biases (zeros): ``<name>_w`` and
    ``<name>_b`` for each name."""
    out = {}
    for n in names:
        out[n + "_w"] = torch.ones((cfg.d_model,), dtype=cfg.dtype,
                                   device=device)
        out[n + "_b"] = torch.zeros((cfg.d_model,), dtype=cfg.dtype,
                                    device=device)
    return out


def _whisper_enc_block_init(gen, cfg, device) -> dict:
    return {**_layer_norms(cfg, device, "ln1", "ln2"),
            "attn": attention.attn_init(gen, cfg, device),
            "mlp": common.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, device,
                                        cfg.dtype)}


def _whisper_dec_block_init(gen, cfg, device) -> dict:
    return {**_layer_norms(cfg, device, "ln1", "ln2", "ln3"),
            "self_attn": attention.attn_init(gen, cfg, device),
            "cross_attn": attention.cross_attn_init(gen, cfg, device),
            "mlp": common.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, device,
                                        cfg.dtype)}


def init_params(gen: torch.Generator, cfg, device) -> dict[str, Any]:
    """Full parameter tree of a model on ``device``. A ``hybrid`` model
    adds ``shared_attn`` = {"ln", "attn"}, the one attention block its
    groups share; a ``vlm`` model ``vis_proj`` (d, d), the vision
    embeddings' projection; an ``audio`` model ``enc_layers`` (the
    encoder blocks), ``enc_norm_w``/``enc_norm_b``, ``final_norm_b`` (its
    final norm is a layer norm) and ``dec_pos`` (dec_ctx, d), the learned
    decoder positions."""
    check_family(cfg)
    d, v = cfg.d_model, cfg.vocab
    params: dict[str, Any] = {
        "embed": common.embed_init(gen, (v, d), device, cfg.dtype),
        "final_norm": torch.ones((d,), dtype=cfg.dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = common.dense_init(gen, (d, v), device,
                                              scale=0.02, dtype=cfg.dtype)
    block = {"ssm": _rwkv_block_init, "hybrid": _mamba_block_init,
             "audio": _whisper_dec_block_init}.get(cfg.family,
                                                   _dense_block_init)
    params["layers"] = _stacked(block, gen, cfg.n_layers, cfg, device)
    if cfg.family == "hybrid":
        params["shared_attn"] = {
            "ln": torch.ones((d,), dtype=cfg.dtype, device=device),
            "attn": attention.attn_init(gen, cfg, device),
        }
    elif cfg.family == "vlm":
        params["vis_proj"] = common.dense_init(gen, (d, d), device,
                                               dtype=cfg.dtype)
    elif cfg.family == "audio":
        params["enc_layers"] = _stacked(_whisper_enc_block_init, gen,
                                        cfg.enc_layers, cfg, device)
        params.update(_layer_norms(cfg, device, "enc_norm"))
        params["final_norm_b"] = torch.zeros((d,), dtype=cfg.dtype,
                                             device=device)
        params["dec_pos"] = common.embed_init(gen, (cfg.dec_ctx, d), device,
                                              cfg.dtype)
    return params


def meta_params(cfg) -> dict:
    """The parameter tree's shapes and dtypes, as meta tensors (nothing
    allocated)."""
    return init_params(torch.Generator(), cfg, torch.device("meta"))


def ffn(bp, cfg, h, *, ep_axis=None, ep_size=1, ft=None):
    """The block's FFN: (out, aux), aux the MoE load-balance loss or None
    for a SwiGLU block. ``ft`` (the ft group's context): the SwiGLU's
    column and row blocks where its ``w_gate`` is split
    (``models.tp.split``)."""
    if cfg.moe is not None:
        return moe.moe_ffn(bp["moe"], cfg, h, ep_axis=ep_axis,
                           ep_size=ep_size)
    mlp = bp["mlp"]
    return common.swiglu(mlp, h, tp_mod.split(
        ft, mlp["w_gate"].shape[-1], cfg.d_ff)), None


def _gelu_mlp(mlp, cfg, h, ft):
    """The whisper blocks' GELU MLP, over the ft group where its ``w_up``
    is split."""
    return common.gelu_mlp(mlp, h, tp_mod.split(ft, mlp["w_up"].shape[-1],
                                                cfg.d_ff))


def _dense_block_fwd(bp, cfg, x, *, window=0, mpos=None, chunk=None,
                     ep_axis=None, ep_size=1, tp=None, ft=None):
    h = common.rms_norm(x, bp["ln1"])
    x = x + attention.self_attention(bp["attn"], cfg, h, window=window,
                                     mpos=mpos, chunk=chunk, tp=tp)
    h, aux = ffn(bp, cfg, common.rms_norm(x, bp["ln2"]), ep_axis=ep_axis,
                 ep_size=ep_size, ft=ft)
    return x + h, aux


def _rwkv_block_fwd(bp, cfg, x, *, wkv_chunked=None, tp=None):
    h = common.rms_norm(x, bp["ln1"])
    x = x + rwkv.time_mix_forward(bp["tmix"], cfg, h,
                                  use_chunked=wkv_chunked, tp=tp)
    h = common.rms_norm(x, bp["ln2"])
    return x + rwkv.channel_mix_forward(bp["cmix"], cfg, h, tp=tp), None


def _mamba_block_fwd(bp, cfg, x):
    h = common.rms_norm(x, bp["ln1"])
    return x + ssm.mamba2_forward(bp["mamba"], cfg, h), None


def _shared_attn_fwd(sp, cfg, x, *, window=0, chunk=None):
    h = common.rms_norm(x, sp["ln"])
    return x + attention.self_attention(sp["attn"], cfg, h, window=window,
                                        chunk=chunk)


def _whisper_chunk(attn_chunk, s: int):
    """The whisper blocks' route: None (the kernel) when serving, else
    the reference's own KV chunk ``min(1024, s)``."""
    return None if attn_chunk is None else min(1024, s)


def _whisper_enc_block_fwd(bp, cfg, x, *, attn_chunk=None, ft=None):
    h = common.layer_norm(x, bp["ln1_w"], bp["ln1_b"])
    x = x + attention.self_attention(
        bp["attn"], cfg, h, causal=False,
        chunk=_whisper_chunk(attn_chunk, x.shape[1]))
    h = common.layer_norm(x, bp["ln2_w"], bp["ln2_b"])
    return x + _gelu_mlp(bp["mlp"], cfg, h, ft), None


def _whisper_dec_block_fwd(bp, cfg, x, enc, *, attn_chunk=None, ft=None):
    """One decoder block over the whole sequence; ``enc`` is the
    encoder's output, projected here into the layer's cross k/v (inside
    the checkpointed body under ``remat``, as in the reference). ``ft``:
    the MLP over the ft group (attention is whole: audio takes no tp)."""
    enc_kv = attention.encode_cross_kv(bp["cross_attn"], cfg, enc)
    h = common.layer_norm(x, bp["ln1_w"], bp["ln1_b"])
    x = x + attention.self_attention(
        bp["self_attn"], cfg, h, chunk=_whisper_chunk(attn_chunk,
                                                      x.shape[1]))
    h = common.layer_norm(x, bp["ln2_w"], bp["ln2_b"])
    x = x + attention.cross_attention(
        bp["cross_attn"], cfg, h, enc_kv,
        chunk=_whisper_chunk(attn_chunk, enc.shape[1]))
    h = common.layer_norm(x, bp["ln3_w"], bp["ln3_b"])
    return x + _gelu_mlp(bp["mlp"], cfg, h, ft), None


def encode(params, cfg, enc_embed, *, remat: bool = False, attn_chunk=None,
           ft=None):
    """The whisper encoder: the stub frame embeddings (B, Senc, d) cast to
    ``cfg.adtype`` plus the sinusoidal positions (cast before the add),
    the encoder blocks (non-causal self-attention), then its layer norm;
    returns (B, Senc, d) in ``cfg.adtype``. ``ft``: the blocks' MLPs over
    the ft group."""
    enc = enc_embed.to(cfg.adtype)
    enc = enc + common.sinusoidal_positions(
        enc.shape[1], cfg.d_model, enc.device).to(cfg.adtype)
    body = functools.partial(_whisper_enc_block_fwd, cfg=cfg,
                             attn_chunk=attn_chunk, ft=ft)
    for lp in unstack_layers(params["enc_layers"]):
        enc, _ = (checkpoint(body, lp, x=enc, use_reentrant=False) if remat
                  else body(lp, x=enc))
    return common.layer_norm(enc, params["enc_norm_w"], params["enc_norm_b"])


def build_mrope_positions(cfg, batch: int, n_vis: int, n_text: int,
                          device) -> torch.Tensor:
    """Qwen2-VL's M-RoPE position streams (3, B, n_vis + n_text) int32:
    the vision tokens on a (t = 0, h, w) grid of width g = int(sqrt(n_vis))
    (at least 1), the text tokens from g on, all three streams advancing
    together."""
    g = mrope_grid(n_vis)
    i = torch.arange(n_vis, dtype=torch.int32, device=device)
    text = g + torch.arange(n_text, dtype=torch.int32, device=device)
    pos = torch.stack([torch.cat([torch.zeros_like(i), text]),
                       torch.cat([i // g, text]), torch.cat([i % g, text])])
    return pos[:, None, :].expand(3, batch, n_vis + n_text)


def mrope_grid(n_vis: int) -> int:
    """The vision grid's width g, where the text positions start."""
    return int(n_vis ** 0.5) or 1


def embed_inputs(params, cfg, tokens, extras=None, ft=None):
    """(B, S) tokens -> (x (B, S', d) in ``cfg.adtype``, mpos): for a
    ``vlm`` with ``vision_embed`` in ``extras`` the projected vision
    embeddings come first (S' = n_vis + S) and ``mpos`` holds their
    M-RoPE streams; otherwise S' = S and mpos is None. ``ft``:
    ``embed``'s lookup over the ft group (``embed``)."""
    x = embed(params, cfg, tokens, ft)
    vis = (extras or {}).get("vision_embed")
    if cfg.family != "vlm" or vis is None:
        return x, None
    vis = vis.to(cfg.adtype) @ params["vis_proj"].to(cfg.adtype)
    mpos = build_mrope_positions(cfg, x.shape[0], vis.shape[1],
                                 tokens.shape[1], x.device)
    return torch.cat([vis, x], dim=1), mpos


def groups(cfg) -> list:
    """The hybrid stack's groups as layer ranges: the shared attention
    block runs before each (``cfg.attn_every`` layers, the last group the
    remainder); their number is the reference's ``decode._n_app``."""
    per, n = cfg.attn_every, cfg.n_layers
    return [range(g, min(g + per, n)) for g in range(0, n, per)]


def embed(params, cfg, tokens, tp=None):
    """(B, S) int tokens -> (B, S, d) activations in ``cfg.adtype``.

    ``tp`` (the ft group's context) with ``embed`` split by vocab rows
    (the group's rank i of n holds rows ``[i V/n, (i + 1) V/n)``): a
    vocab-parallel lookup, the rank's rows for the ids in its range and
    zero rows for the others, summed over the group (*g*)."""
    table = params["embed"]
    tp = tp_mod.split(tp, table.shape[0], cfg.vocab)
    if tp is None:
        return table[tokens.long()].to(cfg.adtype)
    n = table.shape[0]
    local = tokens.long() - tp.rank * n
    mine = ((local >= 0) & (local < n))[..., None]
    x = torch.where(mine, table[local.clamp(0, n - 1)], 0.0)
    return tp_mod.reduce_from(x.to(cfg.adtype), tp)


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


def forward_hidden(params, cfg, tokens, *, extras=None, window: int = 0,
                   remat: bool = False, ep_axis=None, ep_size: int = 1,
                   attn_chunk=None, wkv_chunked=None, act_spec=None,
                   tp=None, ft=None):
    """Embeds ``tokens`` and runs the stack. Returns (hidden (B, S, d),
    aux_loss): the layers' MoE load-balance losses summed in f32 (a zero
    f32 scalar without MoE). ``extras``: ``enc_embed`` (audio, required)
    and ``vision_embed`` (vlm, optional; its n_vis positions then come
    first in the hidden states, S = n_vis + the tokens).

    ``attn_chunk`` None runs attention through the kernel, an int through
    ``chunked_attention`` with KV chunks of that size; ``wkv_chunked``
    None runs the ``wkv6`` kernel, False / True ``wkv_scan`` /
    ``wkv_chunked`` (module docstring). ``remat`` recomputes each layer
    in the backward (``checkpoint(..., use_reentrant=False)``; the
    checkpointed body returns the pair (x, aux)). ``ep_axis`` set
    (expert parallelism) raises in an MoE block (``moe.moe_ffn``) and is
    ignored elsewhere, as in the reference. ``act_spec`` is the
    reference's activation sharding constraint, the identity on one
    device; only None is accepted.

    ``tp`` and ``ft`` (``models.tp.TPContext``s of a replica's tp and ft
    groups; ``ft`` defaults to ``tp``, the same group at F = 1):
    ``params`` are this rank's tensor blocks (``launch.mesh``) and the
    layers run Megatron's tensor parallelism (``models.tp``; RWKV6:
    ``models.rwkv``), the embedding and the FFN over ``ft``, attention
    over ``tp``: the same hidden states on every rank. A family the
    groups' sizes do not take raises ``NotImplementedError`` (item 10
    (b)); head counts T does not divide raise ``ValueError``
    (``tp.check``)."""
    if act_spec is not None:
        raise NotImplementedError(
            "act_spec (activations sharded over the fsdp x tp axes) is the "
            "tensor plane of ROADMAP.md, 'Modules still to port', item "
            "10 (b)")
    check_family(cfg)
    ft = tp if ft is None else ft
    if ft is not None:
        t = 1 if tp is None else tp.size
        tp_mod.check(cfg, t, ft.size // t)
    x, mpos = embed_inputs(params, cfg, tokens, extras, ft)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "audio":
        enc = encode(params, cfg, extras["enc_embed"], remat=remat,
                     attn_chunk=attn_chunk, ft=ft)
        x = x + params["dec_pos"][:x.shape[1]].to(cfg.adtype)
        body = functools.partial(_whisper_dec_block_fwd, cfg=cfg,
                                 attn_chunk=attn_chunk, ft=ft)
        for lp in unstack_layers(params["layers"]):
            x, _ = (checkpoint(body, lp, x=x, enc=enc, use_reentrant=False)
                    if remat else body(lp, x=x, enc=enc))
        return common.layer_norm(x, params["final_norm"],
                                 params["final_norm_b"]), aux_total
    if cfg.family == "hybrid":
        x = _hybrid_forward(params, cfg, x, remat=remat, window=window,
                            attn_chunk=attn_chunk)
        return common.rms_norm(x, params["final_norm"]), aux_total
    if cfg.family == "ssm":
        body = functools.partial(_rwkv_block_fwd, cfg=cfg,
                                 wkv_chunked=wkv_chunked, tp=tp)
    else:
        body = functools.partial(_dense_block_fwd, cfg=cfg, window=window,
                                 mpos=mpos, chunk=attn_chunk,
                                 ep_axis=ep_axis, ep_size=ep_size, tp=tp,
                                 ft=ft)
    for lp in unstack_layers(_tp_replicated(params["layers"], cfg, tp)):
        if remat:
            x, aux = checkpoint(body, lp, x=x, use_reentrant=False)
        else:
            x, aux = body(lp, x=x)
        if aux is not None:
            aux_total = aux_total + aux
    x = common.rms_norm(x, params["final_norm"])
    return x, aux_total


# the replicated leaves each rank applies to its own heads or channels
# only, per family: (sub-tree, leaves)
_TP_SLICED = {"dense": ("attn", ("q_norm", "k_norm")),
              "ssm": ("tmix", ("decay_w0", "decay_B", "ln_w", "ln_b"))}


def _tp_replicated(layers: dict, cfg, tp) -> dict:
    """``layers`` with the stacked replicated leaves that each rank
    applies to its own heads or channels only (``_TP_SLICED``: a dense
    model's ``q_norm``/``k_norm``, RWKV6's group-norm and decay leaves)
    through *f* under ``tp``: their gradients are summed over the tp
    group (one ``all_reduce`` per stack), which keeps them bitwise
    equal. Ranks of one tp coordinate and other fsdp coordinates hold
    the same heads and compute the same gradients."""
    if tp is None or (cfg.family == "dense" and not cfg.qk_norm):
        return layers
    sub, names = _TP_SLICED[cfg.family]
    part = dict(layers[sub])
    for name in names:
        part[name] = tp_mod.copy_to(part[name], tp)
    return dict(layers, **{sub: part})


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


def logits_from_hidden(params, cfg, h, tp=None):
    """``h @ unembed`` (``embed.T`` when tied) in ``h``'s dtype. Under
    ``tp`` (serving over a serve mesh) with the vocabulary split this
    rank's vocab block of the logits, ``[:, i V/T, (i + 1) V/T)`` at tp
    rank i: each logit is one dot product over d, so the block is bitwise
    those columns of the one-device logits; with the vocabulary whole
    (T does not divide it) the whole logits."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    tp_mod.split(tp, w.shape[1], cfg.vocab)      # whole or 1/T, else raise
    return h @ w.to(h.dtype)
