"""RWKV6 ('Finch') blocks -- attention-free, data-dependent decay
[arXiv:2404.05892]; the port of ``repro.models.rwkv``.

Time-mix: data-dependent token-shift (ddlerp, low-rank) for the r/k/v/g/w
streams, per-channel data-dependent decay ``w``, WKV linear recurrence with
bonus ``u``; per-head group-norm; silu(g) gate. Channel-mix: squared-relu
FFN with receptance gate.

``time_mix_forward(use_chunked=)`` picks the WKV route. ``None`` (the
serving default): a multi-token time-mix from a zero state (prefill, the
full forward) runs the ``wkv6`` kernel (``repro_torch.kernels.ops``),
which computes what the reference's sequential ``wkv_scan`` computes to
f32 rounding and has no backward; a time-mix that carries a state in (the
one-token decode update) runs ``wkv_scan``. ``False`` / ``True`` (set by
``transformer.forward_hidden(wkv_chunked=)``, the training route) run the
reference's plain ``wkv_scan`` / ``wkv_chunked`` in tensor code,
differentiated by autograd; they never reach the kernel.

``tp=`` (a ``models.tp.TPContext``, training only): the blocks are this
rank's tp blocks (``launch.mesh``'s split of the reference's specs). The
token shift and the low-rank lerp run whole on every rank; the time mix
runs its column blocks of ``w_r``/``w_k``/``w_v``/``w_g`` and its
channels of the decay (``decay_B``'s and ``decay_w0``'s, replicated, as
their columns), the WKV and the group norm on its nh/T heads, and ``w_o``
as a row product; the channel mix runs ``w_k``/``w_r`` as column
products, ``w_v`` as a row product and joins the gate's columns
(``tp.gather``). The replicated leaves sliced to a rank's channels
(``ln_w``, ``ln_b``, ``decay_w0``, ``decay_B``) take *f* on their stacks
(``transformer.forward_hidden``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models import tp as tp_mod

LORA_R = 32
STREAMS = ("w", "k", "v", "r", "g")


def rwkv_dims(cfg):
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    return nh, hd


def time_mix_init(gen: torch.Generator, cfg, device, dtype=None) -> dict:
    dtype = dtype or cfg.dtype
    d = cfg.d_model
    nh, hd = rwkv_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)

    def uniform(shape, scale):
        return torch.rand(shape, generator=gen, **f32) * scale

    p = {
        "mu_base": uniform((d,), 0.1),
        "lora_A": common.dense_init(gen, (d, LORA_R * len(STREAMS)), device,
                                    scale=0.01),
        "lora_B": common.dense_init(gen, (len(STREAMS), LORA_R, d), device,
                                    scale=0.01),
        "decay_w0": torch.full((d,), -6.0, **f32),
        "decay_A": common.dense_init(gen, (d, 64), device, scale=0.01),
        "decay_B": common.dense_init(gen, (64, d), device, scale=0.01),
        "bonus_u": torch.randn((nh, hd), generator=gen, **f32) * 0.1,
        "w_r": common.dense_init(gen, (d, d), device, dtype=dtype),
        "w_k": common.dense_init(gen, (d, d), device, dtype=dtype),
        "w_v": common.dense_init(gen, (d, d), device, dtype=dtype),
        "w_g": common.dense_init(gen, (d, d), device, dtype=dtype),
        "w_o": common.dense_init(gen, (d, d), device, dtype=dtype),
        "ln_w": torch.ones((d,), **f32),
        "ln_b": torch.zeros((d,), **f32),
    }
    base = torch.rand((d,), generator=gen, **f32)  # one draw, as the reference
    for i, s_ in enumerate(STREAMS):
        p[f"mu_{s_}"] = base * (i + 1) / len(STREAMS)
    return p


def channel_mix_init(gen: torch.Generator, cfg, device, dtype=None) -> dict:
    dtype = dtype or cfg.dtype
    d, f = cfg.d_model, cfg.d_ff
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "mu_k": torch.rand((d,), generator=gen, **f32) * 0.5,
        "mu_r": torch.rand((d,), generator=gen, **f32) * 0.5,
        "w_k": common.dense_init(gen, (d, f), device, dtype=dtype),
        "w_v": common.dense_init(gen, (f, d), device, dtype=dtype),
        "w_r": common.dense_init(gen, (d, d), device, dtype=dtype),
    }


def _ddlerp(p, x, xx):
    """Data-dependent lerp for all 5 streams. x, xx: (B, S, d). Returns
    dict stream -> mixed (B, S, d) in x's dtype."""
    base = x + xx * p["mu_base"].to(x.dtype)
    lo = torch.tanh(base.float() @ p["lora_A"])
    lo = lo.reshape(lo.shape[:-1] + (len(STREAMS), LORA_R))
    out = {}
    for i, s_ in enumerate(STREAMS):
        delta = lo[..., i, :] @ p["lora_B"][i]
        m = p[f"mu_{s_}"] + delta
        out[s_] = x + xx * m.to(x.dtype)
    return out


def wkv_scan(r, k, v, w, u, state=None):
    """WKV6 recurrence, one token at a time (the reference's
    ``wkv_scan``). r, k, v: (B, S, nh, hd); w: (B, S, nh, hd) decay in
    (0, 1); u: (nh, hd) bonus; state: (B, nh, hd, hd) or None. Returns
    y (B, S, nh, hd) f32 and the final state.

        y_t = r_t . (diag(u) k_t v_t^T + S_{t-1}),
        S_t = diag(w_t) S_{t-1} + k_t v_t^T
    """
    b, s, nh, hd = r.shape
    if state is None:
        state = torch.zeros((b, nh, hd, hd), dtype=torch.float32,
                            device=r.device)
    r, k, v, w = (a.float() for a in (r, k, v, w))
    u = u.float()[None, :, :, None]
    ys = []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # (B,nh,hd,hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], state + u * kv))
        state = state * w[:, t, :, :, None] + kv
    return torch.stack(ys, dim=1), state


def wkv_chunked(r, k, v, w, u, state=None, chunk: int = 64):
    """Chunked WKV6 (the reference's ``wkv_chunked``, its pure-jnp twin
    of the kernel): within a chunk a matmul with the decay products
    inside the contraction (log-space, ``log(max(w, 1e-38))``), across
    chunks the state recurrence. Same arguments and results as
    ``wkv_scan``; S is padded to a whole chunk (w = 1 there).
    Differentiable by autograd."""
    b, s, nh, hd = r.shape
    if state is None:
        state = torch.zeros((b, nh, hd, hd), dtype=torch.float32,
                            device=r.device)
    if s % chunk:
        pad = (0, 0, 0, 0, 0, chunk - s % chunk)
        r, k, v = (F.pad(a, pad) for a in (r, k, v))
        w = F.pad(w, pad, value=1.0)
    nc = r.shape[1] // chunk
    rs, ks, vs, ws = (a.float().reshape(b, nc, chunk, nh, hd)
                      .permute(0, 1, 3, 2, 4) for a in (r, k, v, w))
    logw = torch.log(ws.clamp_min(1e-38))
    logcum = torch.cumsum(logw, dim=3)                      # inclusive
    lprev = logcum - logw
    ti = torch.arange(chunk, device=r.device)
    lower = (ti[:, None] > ti[None, :])[None, None, None, :, :, None]
    diff = lprev[:, :, :, :, None, :] - logcum[:, :, :, None, :, :]
    dd = torch.exp(torch.where(lower, diff, -1e30))         # (B,nc,nh,t,u,hd)
    a = torch.einsum("bchtk,bchuk,bchtuk->bchtu", rs, ks, dd)
    bonus = torch.einsum("bchtk,bchtk->bcht", rs, ks * u.float()[None, None,
                                                                  :, None, :])
    a = a + torch.einsum("bcht,tu->bchtu", bonus,
                         torch.eye(chunk, dtype=torch.float32,
                                   device=r.device))
    y = torch.einsum("bchtu,bchud->bchtd", a, vs)
    rd = rs * torch.exp(lprev)                              # inter-chunk
    dend = torch.exp(logcum[:, :, :, -1:, :] - logcum)
    inc = torch.einsum("bchuk,bchud->bchkd", ks * dend, vs)
    cdecay = torch.exp(logcum[:, :, :, -1, :])              # (B,nc,nh,hd)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * cdecay[:, c, :, :, None] + inc[:, c]
    y = y + torch.einsum("bchtk,bchkd->bchtd", rd, torch.stack(prev, dim=1))
    y = y.permute(0, 1, 3, 2, 4).reshape(b, nc * chunk, nh, hd)
    return y[:, :s], state


def time_mix_forward(p, cfg, x, state=None, return_state: bool = False,
                     use_chunked=None, tp=None):
    """x: (B, S, d). state: (last_x (B, d), S (B, nh, hd, hd)) or None.
    ``use_chunked``: the WKV route (module docstring): None the serving
    route (the ``wkv6`` kernel from a zero state), False ``wkv_scan``,
    True ``wkv_chunked`` (``wkv_scan`` for one token), as the
    reference's ``use_chunked``. ``tp``: this rank's heads (module
    docstring); the output is whole on every rank."""
    b, s, d = x.shape
    nh, hd = rwkv_dims(cfg)
    if state is None:
        last_x = torch.zeros((b, d), dtype=x.dtype, device=x.device)
        wkv_state = None
    else:
        last_x, wkv_state = state
    shifted = torch.cat([last_x[:, None, :], x[:, :-1, :]], dim=1)
    xx = shifted - x
    mix = _ddlerp(p, x, xx)
    w_r, w_k, w_v, w_g, w_o = (p[n].to(x.dtype) for n in (
        "w_r", "w_k", "w_v", "w_g", "w_o"))
    low = torch.tanh(mix["w"].float() @ p["decay_A"])
    if tp is None:
        r, k, v = mix["r"] @ w_r, mix["k"] @ w_k, mix["v"] @ w_v
        g = mix["g"] @ w_g
        dec = p["decay_w0"] + low @ p["decay_B"]
        ln_w, ln_b = p["ln_w"], p["ln_b"]
    else:
        nh //= tp.size
        mine = slice(tp.rank * nh * hd, (tp.rank + 1) * nh * hd)
        r, k, v, g, dd = tp_mod.column_pairs(
            [(mix["r"], w_r), (mix["k"], w_k), (mix["v"], w_v),
             (mix["g"], w_g), (low, p["decay_B"][:, mine])], tp)
        dec = p["decay_w0"][mine] + dd
        ln_w, ln_b = p["ln_w"][mine], p["ln_b"][mine]
    g = F.silu(g)
    w = torch.exp(-torch.exp(dec.float()))                    # (B, S, d)
    rs, ks, vs, ws = (a.reshape(b, s, nh, hd) for a in (r, k, v, w))
    if use_chunked is None and wkv_state is None and s > 1:
        y, wkv_state = ops.wkv6(rs, ks, vs, ws, p["bonus_u"])
    elif use_chunked and s > 1:
        y, wkv_state = wkv_chunked(rs, ks, vs, ws, p["bonus_u"], wkv_state)
    else:
        y, wkv_state = wkv_scan(rs, ks, vs, ws, p["bonus_u"], wkv_state)
    # per-head group norm, in f32
    mu = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, unbiased=False, keepdim=True)
    y = ((y - mu) * torch.rsqrt(var + 64e-5)).reshape(b, s, nh * hd)
    y = (y * ln_w + ln_b).to(x.dtype) * g
    out = y @ w_o if tp is None else tp_mod.row(y, w_o, tp)
    if return_state:
        return out, (x[:, -1, :], wkv_state)
    return out


def channel_mix_forward(p, cfg, x, state=None, return_state: bool = False,
                        tp=None):
    """``tp``: this rank's column blocks of ``w_k`` (where the guard
    splits it) and ``w_r``, its row block of ``w_v`` (module docstring);
    the output is whole on every rank."""
    b, s, d = x.shape
    if state is None:
        last_x = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    else:
        last_x = state
    shifted = torch.cat([last_x[:, None, :], x[:, :-1, :]], dim=1)
    xx = shifted - x
    xk = x + xx * p["mu_k"].to(x.dtype)
    xr = x + xx * p["mu_r"].to(x.dtype)
    w_k, w_v, w_r = (p[n].to(x.dtype) for n in ("w_k", "w_v", "w_r"))
    if tp is None:
        kk = torch.square(F.relu(xk @ w_k))
        out = torch.sigmoid(xr @ w_r) * (kk @ w_v)
    elif tp_mod.split(tp, w_k.shape[-1], cfg.d_ff) is None:
        # the guard keeps w_k and w_v whole: only the gate is split
        kk = torch.square(F.relu(xk @ w_k))
        rr, = tp_mod.column_pairs([(xr, w_r)], tp)
        out = tp_mod.gather(torch.sigmoid(rr), tp) * (kk @ w_v)
    else:
        kk, rr = tp_mod.column_pairs([(xk, w_k), (xr, w_r)], tp)
        vv = tp_mod.row(torch.square(F.relu(kk)), w_v, tp)
        out = tp_mod.gather(torch.sigmoid(rr), tp) * vv
    if return_state:
        return out, x[:, -1, :]
    return out
