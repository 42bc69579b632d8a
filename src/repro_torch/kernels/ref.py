"""Plain PyTorch versions of the port's kernels.

Each function states in tensor operations what a CUDA kernel of
``repro_torch.kernels`` computes. The kernel wrappers use them for
tensors that lie on the CPU, and ``chip_smoke.py`` holds each CUDA
kernel against them on the card. They mirror the oracles of
``repro.kernels.ref`` (``segment_agg_ref``, ``segment_broadcast_ref``,
``hier_agg_ref``, ``flash_attention_ref``, ``wkv6_ref``), and
``segment_agg_sharded_ref`` states the sharded aggregation over a
``torch.distributed`` group;
the async flush's numpy oracles ``staleness_scale_ref``,
``staleness_aggregate_ref`` and ``coverage_aggregate_ref`` are copies
of the reference's;
``flash_attention_split_ref`` states the decode path's split-KV
algorithm for the same function, and ``wkv6_step_ref`` the ``wkv6``
kernel's algorithm (16-token steps, running products of the decay).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30          # the reference's finite mask value


def segment_weight_sums(weights, segment_ids, num_segments: int,
                        dtype=torch.float32):
    """(N,) weights x (N,) ids -> (E,) per-segment weight sums, added and
    returned in ``dtype`` (f32).

    Each sum runs over a masked row of an (E, N) matrix, a plain
    reduction with no atomics, so the result is the same on every run
    on either device (``index_add_`` on CUDA is atomic). With
    ``dtype=torch.float64`` the sums of f32 weights are exact while the
    weights lie within 2^(28 - log2 N) of each other (dataset sizes
    always do), so their rounding to f32 does not depend on the order
    or the grouping of the rows. Ids outside ``[0, E)`` contribute
    nothing."""
    w = weights.to(dtype)
    seg = segment_ids.to(torch.int64)
    ids = torch.arange(int(num_segments), device=w.device)
    hit = seg[None, :] == ids[:, None]
    return torch.where(hit, w[None, :], torch.zeros((), dtype=dtype,
                                                    device=w.device)
                       ).sum(dim=1)


def segment_scaled_sum_ref(bank, weights, segment_ids, scale,
                           num_segments: int):
    """What the ``segment_agg`` kernel computes:

        out[j] = scale[j] * sum_{i: seg_i = j} w_i * bank[i]

    bank (N, P) f32 or bf16, weights (N,) f32, segment ids (N,), scale
    (E,) f32 -> (E, P) f32, accumulated in f32. The scale multiplies
    (the reference normalizes by multiplying with the reciprocal)."""
    e = int(num_segments)
    seg = segment_ids.to(torch.int64)
    keep = (seg >= 0) & (seg < e)           # other ids add a zero row
    w = torch.where(keep, weights.to(torch.float32), 0.0)
    x = bank.to(torch.float32) * w[:, None]
    out = torch.zeros((e, bank.shape[1]), dtype=torch.float32,
                      device=bank.device)
    out.index_add_(0, torch.where(keep, seg, 0), x)
    return out * scale.to(torch.float32)[:, None]


def segment_agg_ref(bank, weights, segment_ids, num_segments: int):
    """(N, P) x (N,) x (N,) -> (E, P) f32 weighted segment means; empty
    segments give 0 through the weight-sum clamp. The division mirrors
    ``repro.kernels.ref.segment_agg_ref``."""
    wsum = segment_weight_sums(weights, segment_ids, num_segments)
    ones = torch.ones_like(wsum)
    s = segment_scaled_sum_ref(bank, weights, segment_ids, ones,
                               num_segments)
    return s / wsum.clamp_min(1e-9)[:, None]


def segment_agg_sharded_ref(bank, weights, segment_ids, num_segments: int,
                            group=None):
    """What ``segment_agg_sharded`` computes on one rank of ``group``:
    this rank's rows' unnormalised sums and weight sums
    (``segment_scaled_sum_ref`` with unit scale, ``segment_weight_sums``),
    each summed over the group's ranks with ``all_reduce``, then the sums
    multiplied by ``1 / max(wsum, 1e-9)`` (the reciprocal, as the
    single-device kernel and the reference do). Segments empty on every
    rank give zeros."""
    import torch.distributed as dist
    wsum = segment_weight_sums(weights, segment_ids, num_segments)
    sums = segment_scaled_sum_ref(bank, weights, segment_ids,
                                  torch.ones_like(wsum), num_segments)
    dist.all_reduce(sums, group=group)
    dist.all_reduce(wsum, group=group)
    return sums * (1.0 / wsum.clamp_min(1e-9))[:, None]


def segment_broadcast_ref(models, segment_ids, out_dtype=None):
    """(E, P) x (N,) -> (N, P): out[i] = models[segment_ids[i]], cast to
    ``out_dtype`` (default: the models' dtype)."""
    out = models[segment_ids.to(torch.int64)]
    return out.to(out_dtype or models.dtype)


def hier_agg_ref(bank, weights):
    """bank (R, N), weights (R,) -> weighted mean (N,) f32."""
    w = weights.to(torch.float32)
    wsum = w.sum().clamp_min(1e-9)
    return (w[:, None] * bank.to(torch.float32)).sum(0) / wsum


def staleness_scale_ref(tau, decay: str = "poly", a: float = 0.5):
    """Numpy staleness decay s(tau): ``none`` -> 1, ``poly`` ->
    (1+tau)^-a (FedBuff), ``exp`` -> a^tau. The oracle twin of
    ``repro_torch.runtime.buffer.staleness_scale`` (a copy of
    ``repro.kernels.ref.staleness_scale_ref``)."""
    tau = np.asarray(tau, np.float32)
    if decay == "none":
        return np.ones_like(tau)
    if decay == "poly":
        return (1.0 + tau) ** (-a)
    if decay == "exp":
        return np.power(np.float32(a), tau)
    raise ValueError(f"unknown staleness decay {decay!r}")


def staleness_aggregate_ref(updates, weights, tau, decay: str = "poly",
                            a: float = 0.5):
    """Numpy oracle for the async cloud flush: ``(K, P)`` buffered
    updates x ``(K,)`` base weights x ``(K,)`` integer staleness ->
    ``(P,)``

        out = sum_j w_j s(tau_j) u_j / max(sum_j w_j s(tau_j), 1e-9)

    The decay folds into the weight vector of the ordinary weighted
    mean, which is why one ``segment_agg`` launch serves the flush
    (``repro_torch.runtime.buffer.StalenessBuffer``)."""
    u = np.asarray(updates, np.float32)
    w = np.asarray(weights, np.float32) * staleness_scale_ref(tau, decay, a)
    return (w[:, None] * u).sum(0) / max(float(w.sum()), 1e-9)


def coverage_aggregate_ref(updates, weights, tau, anchor,
                           anchor_weight: float, decay: str = "poly",
                           a: float = 0.5):
    """Numpy oracle for the *degraded* (coverage-corrected) flush:
    ``(K', P)`` surviving updates x ``(K',)`` base weights x ``(K',)``
    staleness, plus the current global vector ``anchor`` standing in for
    the missing data mass ``anchor_weight``:

        v_j = w_j s(tau_j),  m = anchor_weight
        out = (sum_j v_j u_j + m g) / max(sum_j v_j + m, 1e-9)

    With ``anchor_weight == 0`` this is ``staleness_aggregate_ref``."""
    u = np.asarray(updates, np.float32)
    g = np.asarray(anchor, np.float32)
    v = np.asarray(weights, np.float32) * staleness_scale_ref(tau, decay, a)
    m = np.float32(anchor_weight)
    num = (v[:, None] * u).sum(0) + m * g
    return num / max(float(v.sum() + m), 1e-9)


def flash_attention_ref(q, k, v, *, causal=True, window=0, q_offset=0):
    """What the ``flash_attention`` kernel computes, as one masked
    softmax in f32. q: (B, H, Sq, D); k/v: (B, Hkv, Skv, D) with
    H % Hkv == 0 (query head j reads kv head j // (H / Hkv)). Query row t
    sits at position ``q_offset + t``, kv row u at u; ``causal`` keeps
    u <= qpos, ``window`` > 0 also keeps u > qpos - window. Masked scores
    take the finite -1e30, and the result is ``(e @ v) / max(sum e,
    1e-30)`` in q's dtype, as the kernel finishes."""
    b, h, sq, d = q.shape
    rep = h // k.shape[1]
    skv = k.shape[2]
    qf = q.float() * (1.0 / math.sqrt(d))
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = qf @ kf.transpose(-1, -2)                            # (B,H,Sq,Skv)
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = (e @ vf) / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.to(q.dtype)


def kv_visible_range(sq: int, skv: int, causal: bool, window: int,
                     q_offset: int) -> tuple:
    """[kv_begin, kv_end): the kv rows that some query row at positions
    ``q_offset .. q_offset + sq - 1`` can see (empty: kv_begin ==
    kv_end)."""
    kv_end = min(skv, q_offset + sq) if causal else skv
    kv_begin = max(0, q_offset - window + 1) if window else 0
    return min(kv_begin, kv_end), kv_end


def flash_attention_split_ref(q, k, v, *, causal=True, window=0, q_offset=0,
                              split: int = 64):
    """The split-KV algorithm of the ``flash_attention`` decode path in
    plain PyTorch: the rep = H / Hkv query heads that share a kv head are
    packed into rep * Sq rows, the visible range ``kv_visible_range`` is
    cut into splits of ``split`` keys, each split gives f32 partials
    (m, l, acc) with masked keys weighing exactly zero (a split the mask
    empties has m = NEG_INF, l = 0), and the partials are merged in split
    order: ``sum_s exp(m_s - m) acc_s / max(sum_s exp(m_s - m) l_s,
    1e-30)``. Same function as ``flash_attention_ref``; shapes as there."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep = h // hkv
    lo, hi = kv_visible_range(sq, skv, causal, window, q_offset)
    nsplit = max(1, -(-(hi - lo) // split))
    qp = (q.float() * (1.0 / math.sqrt(d))).reshape(b, hkv, rep * sq, d)
    qpos = q_offset + torch.arange(sq, device=q.device).repeat(rep)[:, None]
    parts = []
    for s in range(nsplit):
        u0, u1 = lo + s * split, min(lo + (s + 1) * split, hi)
        kpos = torch.arange(u0, u1, device=q.device)[None, :]
        vis = torch.ones((rep * sq, u1 - u0), dtype=torch.bool,
                         device=q.device)
        if causal:
            vis &= kpos <= qpos
        if window:
            vis &= kpos > qpos - window
        sc = qp @ k[:, :, u0:u1].float().transpose(-1, -2)  # (B,Hkv,R,U)
        sc = torch.where(vis, sc, NEG_INF)
        m = torch.cat([sc, torch.full_like(sc[..., :1], NEG_INF)],
                      dim=-1).amax(dim=-1)
        p = torch.where(vis, torch.exp(sc - m[..., None]), 0.0)
        parts.append((m, p.sum(dim=-1), p @ v[:, :, u0:u1].float()))
    m = torch.stack([pm for pm, _, _ in parts]).amax(dim=0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for pm, pl, pa in parts:                       # in split order
        w = torch.exp(pm - m)
        l = l + w * pl
        acc = acc + w[..., None] * pa
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, sq, d).to(q.dtype)


def wkv6_ref(r, k, v, w, u, *, chunk: int = 64):
    """What the ``wkv6`` kernel computes: the chunked RWKV6 recurrence
    from a zero state, the torch twin of ``repro.models.rwkv.
    wkv_chunked``. r/k/v/w: (B, S, nh, hd) (w the decay in (0, 1));
    u: (nh, hd). Returns y (B, S, nh, hd) f32 and the final state
    (B, nh, hd, hd) f32. A ragged tail is padded with r = k = v = 0 and
    w = 1, which leaves y and the state unchanged."""
    b, s, nh, hd = r.shape
    pad = (-s) % chunk
    r, k, v, w = (a.float() for a in (r, k, v, w))
    if pad:
        r, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    sp = s + pad
    nc = sp // chunk
    rs, ks, vs, ws = (a.reshape(b, nc, chunk, nh, hd).permute(0, 1, 3, 2, 4)
                      for a in (r, k, v, w))               # (B,nc,nh,C,hd)
    logw = torch.log(ws.clamp_min(1e-38))
    logcum = torch.cumsum(logw, dim=3)                    # inclusive
    lprev = logcum - logw
    lower = torch.ones((chunk, chunk), dtype=torch.bool,
                       device=r.device).tril(-1)          # t > u
    diff = lprev[..., :, None, :] - logcum[..., None, :, :]
    dd = torch.exp(torch.where(lower[:, :, None], diff, NEG_INF))
    a = (rs[..., :, None, :] * ks[..., None, :, :] * dd).sum(-1)
    bonus = (rs * (ks * u.float()[None, None, :, None, :])).sum(-1)
    a = a + torch.diag_embed(bonus)
    y = a @ vs                                            # (B,nc,nh,C,hd)
    rd = rs * torch.exp(lprev)
    dend = torch.exp(logcum[..., -1:, :] - logcum)
    inc = (ks * dend).transpose(-1, -2) @ vs              # (B,nc,nh,hd,hd)
    cdecay = torch.exp(logcum[..., -1, :])                # (B,nc,nh,hd)
    state = torch.zeros((b, nh, hd, hd), dtype=torch.float32,
                        device=r.device)
    s_in = []
    for c in range(nc):
        s_in.append(state)
        state = state * cdecay[:, c, :, :, None] + inc[:, c]
    y = y + rd @ torch.stack(s_in, dim=1)
    y = y.permute(0, 1, 3, 2, 4).reshape(b, sp, nh, hd)[:, :s]
    return y, state


WKV_STEP = 16                  # tokens per step of the wkv6 kernel


def wkv6_step_ref(r, k, v, w, u):
    """The algorithm of the ``wkv6`` kernel in plain PyTorch; the same
    function as ``wkv6_ref``, shapes as there. The sequence is cut into
    steps of ``WKV_STEP`` tokens (a ragged tail padded with r = k = v = 0
    and w = 1), w is clamped to ``max(w, 1e-38)``, and no exponential or
    logarithm is taken: within a step from state S_in,

        A[t, u] = sum_k r_t[k] q_u[k],  q_u = k_u * prod_{m=u+1}^{t-1} w_m
                  (u < t; q_u starts as k_u and is multiplied by w_t
                  after each row t > u, so it ends as k~_u)
        A[t, t] = sum_k r_t[k] u[k] k_t[k]
        y       = A V + (r * prod_{m<t} w_m) S_in
        S_out   = diag(prod_m w_m) S_in + k~^T V"""
    step = WKV_STEP
    b, s, nh, hd = r.shape
    pad = (-s) % step
    r, k, v = (a.float() for a in (r, k, v))
    w = w.float().clamp_min(1e-38)
    if pad:
        r, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    r, k, v, w = (a.permute(0, 2, 1, 3) for a in (r, k, v, w))  # (B,nh,S,hd)
    bonus = u.float()[None, :, :]
    state = torch.zeros((b, nh, hd, hd), dtype=torch.float32,
                        device=r.device)
    ys = []
    for t0 in range(0, s + pad, step):
        rs, ks, vs, ws = (a[:, :, t0:t0 + step] for a in (r, k, v, w))
        pre = torch.ones_like(ws[:, :, 0])
        rt = []
        for t in range(step):                         # prefix products
            rt.append(rs[:, :, t] * pre)
            pre = pre * ws[:, :, t]
        a = torch.zeros((b, nh, step, step), dtype=torch.float32,
                        device=r.device)
        q = ks.clone()
        for t in range(step):                         # running products
            a[:, :, t, t] = (rs[:, :, t] * (ks[:, :, t] * bonus)).sum(-1)
            a[:, :, t, :t] = (rs[:, :, t, None, :] * q[:, :, :t]).sum(-1)
            q[:, :, :t] = q[:, :, :t] * ws[:, :, t, None, :]
        ys.append(a @ vs + torch.stack(rt, dim=2) @ state)
        state = pre[..., None] * state + q.transpose(-1, -2) @ vs
    y = torch.cat(ys, dim=2)[:, :, :s].permute(0, 2, 1, 3)
    return y, state
