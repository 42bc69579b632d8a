"""RWKV6 ('Finch') blocks -- attention-free, data-dependent decay
[arXiv:2404.05892]; the port of ``repro.models.rwkv``.

Time-mix: data-dependent token-shift (ddlerp, low-rank) for the r/k/v/g/w
streams, per-channel data-dependent decay ``w``, WKV linear recurrence with
bonus ``u``; per-head group-norm; silu(g) gate. Channel-mix: squared-relu
FFN with receptance gate.

A multi-token time-mix from a zero state (prefill, the full forward)
runs its WKV through the ``wkv6`` kernel (``repro_torch.kernels.ops``),
which computes what the reference's sequential ``wkv_scan`` computes to
f32 rounding. A time-mix that carries a state in (the one-token decode
update) runs ``wkv_scan`` here, plain tensor code as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import common

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


def time_mix_forward(p, cfg, x, state=None, return_state: bool = False):
    """x: (B, S, d). state: (last_x (B, d), S (B, nh, hd, hd)) or None."""
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
    r = mix["r"] @ p["w_r"].to(x.dtype)
    k = mix["k"] @ p["w_k"].to(x.dtype)
    v = mix["v"] @ p["w_v"].to(x.dtype)
    g = F.silu(mix["g"] @ p["w_g"].to(x.dtype))
    dec = p["decay_w0"] + torch.tanh(mix["w"].float() @ p["decay_A"]) \
        @ p["decay_B"]
    w = torch.exp(-torch.exp(dec.float()))                    # (B, S, d)
    rs, ks, vs, ws = (a.reshape(b, s, nh, hd) for a in (r, k, v, w))
    if wkv_state is None and s > 1:
        y, wkv_state = ops.wkv6(rs, ks, vs, ws, p["bonus_u"])
    else:
        y, wkv_state = wkv_scan(rs, ks, vs, ws, p["bonus_u"], wkv_state)
    # per-head group norm, in f32
    mu = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, unbiased=False, keepdim=True)
    y = ((y - mu) * torch.rsqrt(var + 64e-5)).reshape(b, s, d)
    y = y * p["ln_w"] + p["ln_b"]
    out = (y.to(x.dtype) * g) @ p["w_o"].to(x.dtype)
    if return_state:
        return out, (x[:, -1, :], wkv_state)
    return out


def channel_mix_forward(p, cfg, x, state=None, return_state: bool = False):
    b, s, d = x.shape
    if state is None:
        last_x = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    else:
        last_x = state
    shifted = torch.cat([last_x[:, None, :], x[:, :-1, :]], dim=1)
    xx = shifted - x
    xk = x + xx * p["mu_k"].to(x.dtype)
    xr = x + xx * p["mu_r"].to(x.dtype)
    kk = torch.square(F.relu(xk @ p["w_k"].to(x.dtype)))
    vv = kk @ p["w_v"].to(x.dtype)
    rr = torch.sigmoid(xr @ p["w_r"].to(x.dtype))
    out = rr * vv
    if return_state:
        return out, x[:, -1, :]
    return out
