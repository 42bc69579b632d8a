"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch;
the port of ``repro.models.moe``.

The parameters keep the reference's layout: ``router`` (d, E) f32,
``w_gate``/``w_up`` (E, d, f) and ``w_down`` (E, f, d) in ``cfg.dtype``.

Routing and dispatch are the reference's step for step: f32 router
logits, softmax, top-k, gates renormalised; each (token, choice) pair
takes the next free position of its expert in token-major order over
``(T, k)`` (a cumsum over the one-hot assignments), and pairs past the
expert's capacity are dropped. Drops are part of the function: at a
small batch the capacity is 1 and most assignments are dropped, as in
the reference.

The reference scatters every token copy into an ``(E * C + 1, d)``
buffer whose last row takes all the dropped copies. Here the scatter
writes indices, not activations: each kept pair writes its row number
into the slot it owns (the kept slots are unique; a dropped pair writes
to a junk slot of its own), and the expert inputs are then a gather of
token rows, an empty slot reading a zero row. No two writes meet, so
the result is the same on every run and under
``torch.use_deterministic_algorithms``, and autograd sees plain
indexing. The expert products are ``torch.einsum`` (batched matmuls), as
the reference leaves its einsums to XLA; no hand-written kernel runs
here.

Expert parallelism (``ep_axis``: an ``all_to_all`` over the tp axis of
a mesh) shards a replica and raises ``NotImplementedError`` (the tensor
plane of ROADMAP.md, item 10 (b)); on one device the ``"tensor"`` and
``"expert"`` modes are the same math.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import common

EP_ITEM = "ROADMAP.md, 'Modules still to port', item 10 (b)"
MOE_TOKEN_CHUNK = 8192


def moe_init(gen: torch.Generator, cfg, device, dtype=None) -> dict:
    dtype = dtype or cfg.dtype
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": common.dense_init(gen, (d, e), device, scale=0.02),
        "w_gate": common.dense_init(gen, (e, d, f), device, dtype=dtype),
        "w_up": common.dense_init(gen, (e, d, f), device, dtype=dtype),
        "w_down": common.dense_init(gen, (e, f, d), device, dtype=dtype),
    }


def _route(params, x_flat, n_experts: int, top_k: int):
    """x_flat: (T, d). Returns (gates (T, k) f32, experts (T, k) int64,
    aux): top-k of the f32 softmax, gates divided by ``max(sum, 1e-9)``,
    and the Switch load-balance loss ``E * sum(mean(probs) *
    mean(one_hot(experts[:, 0])))``."""
    logits = x_flat.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, top_k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    me = probs.mean(dim=0)
    ce = F.one_hot(experts[:, 0], n_experts).float().mean(dim=0)
    return gates, experts, n_experts * (me * ce).sum()


def _dispatch_indices(experts, n_experts: int, capacity: int):
    """experts: (T, k). Returns (slot (T, k), keep (T, k)): slot =
    expert * capacity + position in expert, token-major over (T, k);
    dropped pairs get slot = n_experts * capacity (the sentinel)."""
    t, k = experts.shape
    flat = experts.reshape(-1)
    onehot = F.one_hot(flat, n_experts).to(torch.int32)      # (T*k, E)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1
    pos = (pos * onehot).sum(dim=-1, dtype=torch.int32)       # (T*k,)
    keep = pos < capacity
    slot = torch.where(keep, flat.to(torch.int32) * capacity + pos,
                       n_experts * capacity)
    return slot.reshape(t, k), keep.reshape(t, k)


def capacity(n_tokens: int, mc) -> int:
    """Slots per expert for ``n_tokens`` tokens: ``max(1, T k cf // E)``,
    rounded up to a multiple of 128 once it reaches 128."""
    c = int(max(1, (n_tokens * mc.top_k * mc.capacity_factor)
                // mc.n_experts))
    return -(-c // 128) * 128 if c >= 128 else c


def moe_ffn(params, cfg, x, *, ep_axis: Optional[str] = None,
            ep_size: int = 1, token_chunk: int = MOE_TOKEN_CHUNK):
    """x: (B, S, d) -> ((B, S, d) in x's dtype, aux f32 scalar).

    More than ``token_chunk`` tokens, when they divide into chunks of it,
    run chunk by chunk (the reference's scan): capacity is per chunk and
    aux the chunks' mean."""
    if ep_axis is not None:
        raise NotImplementedError(
            f"expert parallelism (ep_axis={ep_axis!r}, ep_size={ep_size}) "
            f"shards the experts over the tp axis, the tensor plane of "
            f"{EP_ITEM}")
    b, s, d = x.shape
    t_all = b * s
    if t_all > token_chunk and t_all % token_chunk == 0:
        xc = x.reshape(t_all // token_chunk, token_chunk, 1, d)
        outs, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
        for chunk in xc.unbind(0):
            out, a = _moe_tokens(params, cfg, chunk)
            outs.append(out)
            aux = aux + a
        return torch.stack(outs).reshape(b, s, d), aux / len(outs)
    return _moe_tokens(params, cfg, x)


def _moe_tokens(params, cfg, x):
    mc = cfg.moe
    b, s, d = x.shape
    t, k, e = b * s, mc.top_k, mc.n_experts
    xf = x.reshape(t, d)
    gates, experts, aux = _route(params, xf, e, k)
    c = capacity(t, mc)
    slot, keep = _dispatch_indices(experts, e, c)
    flat_slot = slot.reshape(-1).long()
    # src[j]: the token whose copy slot j holds, t (a zero row) if empty;
    # a dropped pair i writes to junk slot e * c + i, so no write collides
    pair = torch.arange(t * k, device=x.device)
    target = torch.where(keep.reshape(-1), flat_slot, e * c + pair)
    src = torch.full((e * c + t * k,), t, dtype=torch.long, device=x.device)
    src[target] = pair // k
    xpad = torch.cat([xf, xf.new_zeros((1, d))])
    ex_in = xpad[src[:e * c]].reshape(e, c, d)                    # (E, C, d)
    h = torch.einsum("ecd,edf->ecf", ex_in, params["w_gate"].to(x.dtype))
    u = torch.einsum("ecd,edf->ecf", ex_in, params["w_up"].to(x.dtype))
    ex_out = torch.einsum("ecf,efd->ecd", F.silu(h) * u,
                          params["w_down"].to(x.dtype))
    # gather back (the sentinel reads a zero row), then gate-combine
    flat_out = torch.cat([ex_out.reshape(e * c, d), ex_out.new_zeros((1, d))])
    tok = flat_out[flat_slot].reshape(t, k, d)
    w = (gates * keep.to(gates.dtype)).to(x.dtype)
    gated = torch.einsum("tk,tkd->td", w, tok)
    return gated.reshape(b, s, d), aux
