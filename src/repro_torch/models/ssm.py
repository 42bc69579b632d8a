"""Mamba2 (SSD) block, the zamba2-7b backbone [arXiv:2411.15242 cites
Mamba2, arXiv:2405.21060]; the port of ``repro.models.ssm``.

Scalar-per-head A, shared B/C (ngroups=1), short causal conv on the x/B/C
stream, silu gate, RMSNorm before out-projection. A sequence runs either
``ssd_scan`` (the recurrence one token at a time, the oracle) or
``ssd_chunked`` (Mamba2's matmul form: attention-like products inside
chunks, a scan over chunk states between them; the default for prefill,
the full forward and training); decode is the O(1) one-token recurrence
on the carried state (``mamba2_step``).

The projections are five separate weights (w_z/w_x/w_B/w_C/w_dt), the
reference's layout, so its parameter tree loads leaf for leaf. All of it
is plain tensor math, as in the reference, which has no Pallas kernel
here; ``ssd_chunked`` is differentiable by autograd (``Model.loss``).
The SSD math runs in f32 whatever the activation dtype; the projections,
the conv and the gate run in the activation dtype, in the reference's
order of operations, so bf16 rounds at the same places.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import common

CONV_K = 4


def mamba2_dims(cfg):
    """(inner width din, heads nh, head dim din // nh, state size N)."""
    din = cfg.ssm_expand * cfg.d_model
    headdim = 64
    nheads = cfg.ssm_heads or din // headdim
    return din, nheads, din // nheads, cfg.ssm_state


def mamba2_init(gen: torch.Generator, cfg, device, dtype=None) -> dict:
    """One Mamba2 block's parameters on ``device`` with the reference's
    laws, drawn from ``gen`` in its leaf order: dense weights in
    ``dtype`` (default ``cfg.dtype``), conv weight at scale 0.5, zero
    conv bias; ``A_log`` = log(linspace(1, 16)), ``D`` = 1 and
    ``dt_bias`` = softplus^-1 of a log-uniform dt in [1e-3, 0.1], all
    three in f32."""
    dtype = dtype or cfg.dtype
    d = cfg.d_model
    din, nh, _, n = mamba2_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    dense = lambda shape, **kw: common.dense_init(gen, shape, device,
                                                  dtype=dtype, **kw)
    p = {
        "w_z": dense((d, din)),
        "w_x": dense((d, din)),
        "w_B": dense((d, n)),
        "w_C": dense((d, n)),
        "w_dt": dense((d, nh)),
        "conv_w": dense((CONV_K, din + 2 * n), scale=0.5),
        "conv_b": torch.zeros((din + 2 * n,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "D": torch.ones((nh,), **f32),
    }
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((nh,), generator=gen, **f32) * (hi - lo) + lo
    p["dt_bias"] = torch.log(torch.expm1(torch.exp(u)))
    p["norm"] = torch.ones((din,), dtype=dtype, device=device)
    p["w_out"] = dense((din, d))
    return p


def _project(params, cfg, x):
    """x: (B, S, d) -> z (B, S, din), xbc (B, S, din + 2N), dt (B, S, nh),
    each a product in x's dtype."""
    z = x @ params["w_z"].to(x.dtype)
    xs = x @ params["w_x"].to(x.dtype)
    B = x @ params["w_B"].to(x.dtype)
    C = x @ params["w_C"].to(x.dtype)
    dt = x @ params["w_dt"].to(x.dtype)
    return z, torch.cat([xs, B, C], dim=-1), dt


def _causal_conv(xbc, w, b):
    """xbc: (B, S, C); depthwise causal conv of kernel CONV_K, the taps
    summed in xbc's dtype in the reference's order, then silu."""
    s = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, CONV_K - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(CONV_K):
        out = out + pad[:, i:i + s, :] * w[i]
    return F.silu(out + b)


def ssd_scan(xs, B, C, dt, decay, h0=None):
    """Sequential SSD recurrence (the oracle).

    xs: (B, S, nh, hd) f32; B/C: (B, S, N); dt/decay: (B, S, nh).
    Returns (y (B, S, nh, hd), final h (B, nh, hd, N)):

        h_t = decay_t h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t
    """
    bsz, s, nh, hd = xs.shape
    n = B.shape[-1]
    h = h0 if h0 is not None else torch.zeros(
        (bsz, nh, hd, n), dtype=torch.float32, device=xs.device)
    ys = []
    for t in range(s):
        dbx = (dt[:, t, :, None, None] * B[:, t, None, None, :]
               * xs[:, t, :, :, None])
        h = h * decay[:, t, :, None, None] + dbx
        ys.append(torch.einsum("bhpn,bn->bhp", h, C[:, t]))
    return torch.stack(ys, dim=1), h


def ssd_chunked(xs, B, C, dt, decay, h0=None, chunk: int = 128):
    """Chunked SSD: attention-like products inside chunks of ``chunk``
    tokens plus a scan over the chunk states; the same function as
    ``ssd_scan`` to f32 rounding. A ragged tail is padded with zero
    inputs and decay 1 (the identity, so the final state is kept); the
    log decays are clamped at 1e-38 as in the reference, and the
    exponent of the upper triangle is masked to -1e30 BEFORE ``exp`` (an
    unmasked exponent there overflows and poisons the gradient through
    the mask). Differentiable by autograd."""
    bsz, s, nh, hd = xs.shape
    n = B.shape[-1]
    if h0 is None:
        h0 = torch.zeros((bsz, nh, hd, n), dtype=torch.float32,
                         device=xs.device)
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        zpad = lambda a: F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        xs, B, C, dt = map(zpad, (xs, B, C, dt))
        decay = F.pad(decay, (0, 0, 0, pad), value=1.0)
    ld = torch.log(decay.clamp_min(1e-38)).reshape(bsz, nc, chunk, nh)
    csum = torch.cumsum(ld, dim=2)                         # (B, nc, c, nh)
    total = csum[:, :, -1:, :]                             # (B, nc, 1, nh)
    xs_c = xs.reshape(bsz, nc, chunk, nh, hd)
    B_c = B.reshape(bsz, nc, chunk, n)
    C_c = C.reshape(bsz, nc, chunk, n)
    dt_c = dt.reshape(bsz, nc, chunk, nh)

    # intra-chunk: y[t] = sum_{u <= t} C_t . B_u dt_u decay(u+1..t) x_u,
    # decay(u+1..t) = exp(csum[t] - csum[u])
    scores = torch.einsum("bktn,bkun->bktu", C_c, B_c)    # (B, nc, c, c)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xs.device))
    diff = csum[:, :, :, None, :] - csum[:, :, None, :, :]   # b k t u h
    dd = torch.exp(torch.where(mask[None, None, :, :, None], diff, -1e30))
    w_ = scores[..., None] * dd * dt_c[:, :, None, :, :]     # b k t u h
    y_intra = torch.einsum("bktuh,bkuhp->bkthp", w_, xs_c)

    # each chunk's state increment: sum_u decay(u+1..end) dt_u B_u x_u
    dend = torch.exp(total - csum)                         # (B, nc, c, nh)
    dbx = torch.einsum("bkuh,bkun,bkuhp->bkhpn", dt_c * dend, B_c, xs_c)
    chunk_decay = torch.exp(total[:, :, 0, :])             # (B, nc, nh)
    h, h_prev = h0, []
    for k in range(nc):
        h_prev.append(h)                                   # state BEFORE k
        h = h * chunk_decay[:, k, :, None, None] + dbx[:, k]
    h_prev = torch.stack(h_prev, dim=1)                    # (B, nc, nh, hd, N)

    # inter-chunk: y[t] = C_t . decay(chunk start..t) h_prev
    y_inter = torch.einsum("bktn,bkhpn,bkth->bkthp", C_c, h_prev,
                           torch.exp(csum))
    y = (y_intra + y_inter).reshape(bsz, nc * chunk, nh, hd)
    return y[:, :s], h


def _ssd_inputs(params, cfg, xbc, dt):
    """The conv output split into the SSD's f32 inputs: xs (B, S, nh, hd),
    B and C (B, S, N), dt after softplus and its decay exp(dt * A)."""
    din, nh, hd, n = mamba2_dims(cfg)
    xs = xbc[..., :din].reshape(xbc.shape[:-1] + (nh, hd)).float()
    B = xbc[..., din:din + n].float()
    C = xbc[..., din + n:].float()
    dt = F.softplus(dt.float() + params["dt_bias"])
    decay = torch.exp(dt * -torch.exp(params["A_log"]))
    return xs, B, C, dt, decay


def _out(params, y, xs, z, dtype):
    """The skip ``D x``, the gate, the norm and the out-projection: y
    (..., nh, hd) f32 -> (..., d) in ``dtype``."""
    y = y + params["D"][:, None] * xs
    y = y.reshape(y.shape[:-2] + (-1,)).to(dtype)
    y = common.rms_norm(y * F.silu(z), params["norm"])
    return y @ params["w_out"].to(dtype)


def mamba2_forward(params, cfg, x, return_state: bool = False,
                   use_chunked: bool = True, chunk: int = 128):
    """x: (B, S, d) -> (B, S, d)[, final (state (B, nh, hd, N) f32,
    conv tail (B, CONV_K - 1, din + 2N))]. ``use_chunked`` and S > 1 run
    ``ssd_chunked`` with chunks of min(chunk, S), else ``ssd_scan``. The
    conv tail is the last CONV_K - 1 pre-conv inputs; a prompt shorter
    than that is zero-padded in front (the conv's own padding), where the
    reference returns fewer rows."""
    s = x.shape[1]
    z, xbc, dt = _project(params, cfg, x)
    conv_in = xbc
    xbc = _causal_conv(xbc, params["conv_w"].to(x.dtype),
                       params["conv_b"].to(x.dtype))
    xs, B, C, dt, decay = _ssd_inputs(params, cfg, xbc, dt)
    if use_chunked and s > 1:
        y, h_final = ssd_chunked(xs, B, C, dt, decay, chunk=min(chunk, s))
    else:
        y, h_final = ssd_scan(xs, B, C, dt, decay)
    out = _out(params, y, xs, z, x.dtype)
    if return_state:
        tail = conv_in[:, -(CONV_K - 1):, :]
        if s < CONV_K - 1:
            tail = F.pad(tail, (0, 0, CONV_K - 1 - s, 0))
        return out, (h_final, tail)
    return out


def mamba2_step(params, cfg, x, state):
    """One-token decode. x: (B, 1, d); state: (h (B, nh, hd, N) f32,
    conv tail (B, CONV_K - 1, din + 2N)). Returns (out (B, 1, d), (new h,
    new tail)), new tensors (the state passed in is not written)."""
    h, conv_tail = state
    z, xbc, dt = _project(params, cfg, x)
    window = torch.cat([conv_tail, xbc], dim=1)              # (B, K, chan)
    conv = (torch.einsum("bkc,kc->bc", window, params["conv_w"].to(x.dtype))
            + params["conv_b"].to(x.dtype))
    xs, B, C, dtv, dec = _ssd_inputs(params, cfg, F.silu(conv),
                                     dt[:, 0])
    dbx = dtv[:, :, None, None] * B[:, None, None, :] * xs[:, :, :, None]
    h = h * dec[:, :, None, None] + dbx
    y = torch.einsum("bhpn,bn->bhp", h, C)
    out = _out(params, y[:, None], xs[:, None], z, x.dtype)
    return out, (h, torch.cat([conv_tail[:, 1:], xbc], dim=1))
