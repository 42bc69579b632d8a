"""The port's kernels on the CPU (their plain versions) against the
reference: the aggregation kernels against the Pallas kernels in
interpret mode (``repro.kernels.ops``), on the shapes of
``tests/test_flatbank.py``; ``flash_attention`` and ``wkv6`` against the
pure-jnp oracles (``repro.kernels.ref``, ``repro.models.rwkv``), since
the Pallas versions of those two do not run on the installed jax
(ROADMAP.md, "Reference-side caveats"), on the shapes of
``tests/test_kernels.py`` plus ragged and decode cases. Also: a CUDA
tensor never takes the plain path on a host without a card.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_close, to_torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import rwkv as jrwkv
from repro_torch.configs import get_config
from repro_torch.kernels import _build, flash_attention, hier_agg, ops, ref
from repro_torch.models.model import build_model

# f32 sums of a few O(1) products: the two summation orders differ by a
# few ulp (~1e-7)
F32_ATOL = 1e-6


def _inputs(n, p, e, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    mat = rng.normal(size=(n, p)).astype(np.float32)
    w = rng.uniform(0.1, 3.0, size=(n,)).astype(np.float32)
    seg = rng.integers(0, e, size=(n,)).astype(np.int32)
    jmat = jnp.asarray(mat, dtype)
    return jmat, w, seg


@pytest.mark.parametrize("n,p,e", [(9, 997, 4), (50, 21840, 5), (3, 130, 1)],
                         ids=["9x997x4", "50x21840x5", "3x130x1"])
def test_segment_agg_matches_pallas(n, p, e):
    jmat, w, seg = _inputs(n, p, e, 6)
    want = jops.segment_agg(jmat, jnp.asarray(w), jnp.asarray(seg), e)
    got = ops.segment_agg(to_torch(jmat), to_torch(w), to_torch(seg), e)
    assert got.dtype == torch.float32 and got.shape == (e, p)
    assert_close(got, want, atol=F32_ATOL)


def test_segment_agg_bf16_bank_10x513x3():
    jmat, w, seg = _inputs(10, 513, 3, 8, jnp.bfloat16)
    want = jops.segment_agg(jmat, jnp.asarray(w), jnp.asarray(seg), 3)
    bank = to_torch(jmat)
    assert bank.dtype == torch.bfloat16
    got = ops.segment_agg(bank, to_torch(w), to_torch(seg), 3)
    assert got.dtype == torch.float32                 # f32 accumulate out
    assert_close(got, want, atol=F32_ATOL)


def test_segment_agg_empty_segment_is_zero_9x997x4():
    jmat, w, seg = _inputs(9, 997, 4, 4)
    seg = np.where(seg == 2, 0, seg).astype(np.int32)  # segment 2 empty
    want = jops.segment_agg(jmat, jnp.asarray(w), jnp.asarray(seg), 4)
    got = ops.segment_agg(to_torch(jmat), to_torch(w), to_torch(seg), 4)
    assert_close(got, want, atol=F32_ATOL)
    assert torch.count_nonzero(got[2]) == 0


def test_segment_sum_partial_matches_pallas_9x997x4():
    jmat, w, seg = _inputs(9, 997, 4, 3)
    want_s, want_w = jops.segment_sum_partial(jmat, jnp.asarray(w),
                                              jnp.asarray(seg), 4)
    sums, wsum = ops.segment_sum_partial(to_torch(jmat), to_torch(w),
                                         to_torch(seg), 4)
    # unnormalized sums of ~3 terms of size up to ~3: a few ulp of ~10
    assert_close(sums, want_s, atol=4e-6)
    assert_close(wsum, want_w, atol=F32_ATOL)


def test_hier_agg_matches_pallas_7x300():
    rng = np.random.default_rng(5)
    bank = rng.normal(size=(7, 300)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=(7,)).astype(np.float32)
    want = jops.hier_agg(jnp.asarray(bank), jnp.asarray(w))
    got = ops.hier_agg(to_torch(bank), to_torch(w))
    assert got.shape == (300,)
    assert_close(got, want, atol=F32_ATOL)
    assert_close(ref.hier_agg_ref(to_torch(bank), to_torch(w)), want,
                 atol=F32_ATOL)


def test_plain_versions_agree_with_reference_oracle_50x21840x5():
    """The division form (``segment_agg_ref``) and the kernel's
    multiply-by-reciprocal form agree to rounding."""
    jmat, w, seg = _inputs(50, 21840, 5, 9)
    a = ref.segment_agg_ref(to_torch(jmat), to_torch(w), to_torch(seg), 5)
    b = ops.segment_agg(to_torch(jmat), to_torch(w), to_torch(seg), 5)
    assert_close(a, b, atol=F32_ATOL)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_segment_broadcast_bitwise_4x997_to_13(dtype):
    rng = np.random.default_rng(7)
    models = rng.normal(size=(4, 997)).astype(np.float32)
    seg = rng.integers(0, 4, size=(13,)).astype(np.int32)
    want = jops.segment_broadcast(jnp.asarray(models), jnp.asarray(seg),
                                  out_dtype=dtype)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = ops.segment_broadcast(to_torch(models), to_torch(seg),
                                out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (13, 997)
    assert torch.equal(got, to_torch(np.asarray(want)))    # bitwise
    out = torch.empty((13, 997), dtype=tdt)
    res = ops.segment_broadcast(to_torch(models), to_torch(seg), out=out)
    assert res is out and torch.equal(out, got)


def test_cpu_calls_count_no_kernel_launch():
    hier_agg.reset_launches()
    jmat, w, seg = _inputs(9, 997, 4, 1)
    ops.segment_agg(to_torch(jmat), to_torch(w), to_torch(seg), 4)
    ops.segment_broadcast(torch.zeros(4, 5), to_torch(seg))
    x = torch.zeros(1, 2, 3, 64)
    ops.flash_attention(x, x, x)
    ops.wkv6(x, x, x, x + 0.5, torch.zeros(3, 64))
    assert ops.LAUNCHES == {"segment_agg": 0, "segment_broadcast": 0,
                            "flash_attention": 0, "wkv6": 0}


def test_cuda_tensors_raise_instead_of_running_on_cpu():
    """A CUDA tensor goes to the CUDA kernel or the call raises: on a
    host without nvcc or a card the build (or launch) raises; nothing
    falls back to the plain version. Fake CUDA tensors (no storage)
    reach the wrappers' CUDA branch without a card."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        bank = torch.empty((9, 997), device="cuda")
        w = torch.ones((9,), device="cuda")
        seg = torch.zeros((9,), dtype=torch.int32, device="cuda")
        with pytest.raises(RuntimeError):
            ops.segment_agg(bank, w, seg, 4)
        with pytest.raises(RuntimeError):
            ops.segment_broadcast(torch.empty((4, 997), device="cuda"), seg)
        q = torch.empty((1, 4, 8, 128), device="cuda", dtype=torch.bfloat16)
        kv = torch.empty((1, 2, 8, 128), device="cuda", dtype=torch.bfloat16)
        with pytest.raises(RuntimeError):
            ops.flash_attention(q, kv, kv)
        r = torch.empty((1, 8, 2, 64), device="cuda")
        with pytest.raises(RuntimeError):
            ops.wkv6(r, r, r, r, torch.empty((2, 64), device="cuda"))


def test_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError):
        ops.segment_agg(torch.zeros(4, 5), torch.ones(3), torch.zeros(4,
                        dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        ops.segment_agg(torch.zeros(4, 5, device="meta"),
                        torch.ones(4, device="meta"),
                        torch.zeros(4, dtype=torch.int32, device="meta"), 2)
    with pytest.raises(ValueError, match="H % Hkv"):
        ops.flash_attention(torch.zeros(1, 3, 4, 64), torch.zeros(1, 2, 4, 64),
                            torch.zeros(1, 2, 4, 64))
    with pytest.raises(ValueError, match="u must be"):
        x = torch.zeros(1, 4, 2, 64)
        ops.wkv6(x, x, x, x, torch.zeros(3, 64))
    with pytest.raises(TypeError, match="decay w must be f32"):
        ops.wkv6(x, x, x, x.bfloat16(), torch.zeros(2, 64))
    # every family the reference has builds (zamba2-7b hybrid,
    # whisper-base audio, qwen2-vl-7b vlm among them); one it does not
    # have raises, and so does what the port does not serve instead of
    # computing something else: expert parallelism (an MoE FFN with
    # ep_axis set)
    for arch in ("zamba2-7b", "whisper-base", "qwen2-vl-7b"):
        assert build_model(get_config(arch)).cfg.name == arch
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(get_config("qwen3-1.7b").reduce(),
                                        family="cnn"))
    cfg = get_config("olmoe-1b-7b").reduce()
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP.*10 \\(b\\)"):
        build_model(cfg).loss(params, {"tokens": toks, "labels": toks},
                              ep_axis="tp", ep_size=4)


# ---------------------------------------------------------------------------
# flash_attention and wkv6: the plain versions against the jnp oracles
# ---------------------------------------------------------------------------

def _qkv(seed, b, h, hkv, sq, skv, d, dtype):
    rng = np.random.default_rng(seed)
    return (jnp.asarray(rng.normal(size=(b, h, sq, d)), dtype),
            jnp.asarray(rng.normal(size=(b, hkv, skv, d)), dtype),
            jnp.asarray(rng.normal(size=(b, hkv, skv, d)), dtype))


# f32: both compute one softmax in f32 (the oracle online over 1024-wide
# kv chunks): a few ulp of O(1) outputs. bf16: the oracle scales q and
# rounds p to bf16 before P.V, the plain version does all of it in f32
# (as the kernel does): the tolerance of the reference's own bf16 kernel
# test (tests/test_kernels.py).
FLASH_TOL = {jnp.float32: 5e-6, jnp.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,hkv,sq,skv,d,q_offset", [
    (1, 2, 2, 128, 128, 64, 0),        # MHA
    (2, 4, 2, 256, 256, 64, 0),        # GQA 2:1
    (1, 8, 2, 128, 384, 128, 256),     # GQA 4:1, rectangular (continuation)
    (1, 4, 2, 100, 100, 128, 0),       # ragged: no multiple of a tile
    (2, 4, 2, 1, 33, 128, 32),         # one-token decode, ragged cache
], ids=["mha", "gqa2", "gqa4-rect", "ragged", "decode"])
def test_flash_attention_ref_matches_oracle(b, h, hkv, sq, skv, d, q_offset,
                                            dtype):
    q, k, v = _qkv(0, b, h, hkv, sq, skv, d, dtype)
    want = jref.flash_attention_ref(q, k, v, causal=True, q_offset=q_offset)
    got = ops.flash_attention(to_torch(q), to_torch(k), to_torch(v),
                              causal=True, q_offset=q_offset)
    assert got.dtype == to_torch(q).dtype and got.shape == (b, h, sq, d)
    tol = FLASH_TOL[dtype]
    assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [64, 128])
def test_flash_attention_ref_window(window):
    q, k, v = _qkv(1, 1, 2, 2, 256, 256, 64, jnp.float32)
    want = jref.flash_attention_ref(q, k, v, causal=True, window=window)
    got = ref.flash_attention_ref(to_torch(q), to_torch(k), to_torch(v),
                                  causal=True, window=window)
    assert_close(got, want, atol=5e-6, rtol=5e-6)


def test_flash_attention_ref_q_offset_decode():
    """A 128-row query block at absolute positions 128.. (the reference's
    decode-shape test)."""
    rng = np.random.default_rng(2)
    q = jnp.asarray(rng.normal(size=(2, 2, 128, 64)), jnp.float32)
    k = jnp.asarray(rng.normal(size=(2, 2, 256, 64)), jnp.float32)
    v = jnp.asarray(rng.normal(size=(2, 2, 256, 64)), jnp.float32)
    want = jref.flash_attention_ref(q, k, v, causal=True, q_offset=128)
    got = ref.flash_attention_ref(to_torch(q), to_torch(k), to_torch(v),
                                  causal=True, q_offset=128)
    assert_close(got, want, atol=5e-6, rtol=5e-6)


# The split-KV algorithm of the decode path (per-split partials merged in
# split order) against the jnp oracle, f32: both compute one softmax in
# f32, in other summation orders.
SPLIT_TOL = 1e-5


@pytest.mark.parametrize("b,h,hkv,sq,skv,d,causal,window,q_offset", [
    (2, 4, 4, 1, 1056, 64, True, 0, 1055),     # rep 1, 17 splits
    (2, 4, 2, 1, 63, 64, True, 0, 62),         # rep 2, Skv 63: one split
    (1, 8, 2, 1, 64, 64, True, 0, 63),         # rep 4, Skv 64: one full split
    (1, 16, 2, 2, 65, 64, True, 0, 63),        # rep 8, 16 rows, Skv 65
    (2, 4, 2, 1, 1, 64, True, 0, 0),           # Skv 1
    (1, 4, 2, 1, 1056, 128, True, 0, 1055),    # the qwen3 decode shape's D
    (2, 4, 2, 1, 300, 64, True, 0, 100),       # causal end inside a split
    (1, 4, 2, 2, 65, 64, True, 0, 63),         # row 0 sees split 1 empty
    (1, 4, 2, 3, 300, 64, True, 64, 200),      # window 64, q_offset 200
    (1, 4, 2, 2, 130, 64, False, 0, 0),        # non-causal
], ids=["rep1-skv1056", "rep2-skv63", "rep4-skv64", "rep8-skv65", "skv1",
        "d128-skv1056", "causal-end-mid-split", "split-emptied",
        "window64-offset", "non-causal"])
def test_flash_attention_split_ref_matches_oracle(b, h, hkv, sq, skv, d,
                                                  causal, window, q_offset):
    q, k, v = _qkv(3, b, h, hkv, sq, skv, d, jnp.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if causal:
        want = jref.flash_attention_ref(q, k, v, **kw)
    else:   # the reference's encoder form: every kv position at 0
        tr = lambda a: a.transpose(0, 2, 1, 3)
        want = tr(jattn.chunked_attention(
            tr(q), tr(k), tr(v), causal=False, chunk=skv,
            kv_positions=jnp.zeros((b, skv), jnp.int32)))
    got = ref.flash_attention_split_ref(to_torch(q), to_torch(k),
                                        to_torch(v), **kw)
    assert got.dtype == torch.float32 and got.shape == (b, h, sq, d)
    assert_close(got, want, atol=SPLIT_TOL, rtol=SPLIT_TOL)


@pytest.mark.parametrize("split", [1, 7, 64])
def test_flash_attention_split_ref_is_independent_of_split_size(split):
    """The merge adds splits exactly: any split size gives the oracle's
    result (a split of 1 key makes every masked key its own split)."""
    q, k, v = _qkv(4, 1, 4, 2, 2, 100, 64, jnp.float32)
    kw = dict(causal=True, window=16, q_offset=90)
    want = jref.flash_attention_ref(q, k, v, **kw)
    got = ref.flash_attention_split_ref(to_torch(q), to_torch(k),
                                        to_torch(v), split=split, **kw)
    assert_close(got, want, atol=SPLIT_TOL, rtol=SPLIT_TOL)


# (B, H, Hkv, Sq, Skv, causal, window, q_offset)
PLAN_CASES = [(4, 16, 8, 1, 1056, True, 0, 1055),
              (4, 16, 8, 1024, 1024, True, 0, 0),
              (2, 16, 8, 8, 300, True, 0, 292),
              (2, 16, 8, 40, 1064, True, 0, 1024),
              (1, 32, 4, 1, 500, True, 0, 499),
              (1, 16, 8, 1, 4097, True, 0, 4096),
              (2, 4, 2, 1, 1, True, 0, 0),
              (1, 8, 2, 3, 300, True, 64, 200),
              (1, 4, 2, 2, 130, False, 0, 0),
              (1, 4, 2, 1, 50, True, 8, 100),           # nothing visible
              (4096, 16, 8, 1, 64, True, 0, 63)]
PLAN_IDS = ["qwen3-decode", "qwen3-prefill", "rows-16-edge",
            "continuation-40", "rep8", "skv-4097", "skv-1", "window",
            "non-causal", "empty-range", "batch-4096"]


def _visible_keys(sq, skv, causal, window, q_offset):
    qpos = q_offset + np.arange(sq)[:, None]
    kpos = np.arange(skv)[None, :]
    vis = np.ones((sq, skv), bool)
    if causal:
        vis &= kpos <= qpos
    if window:
        vis &= kpos > qpos - window
    return set(np.nonzero(vis.any(axis=0))[0].tolist())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,hkv,sq,skv,causal,window,q_offset",
                         PLAN_CASES, ids=PLAN_IDS)
def test_flash_attention_plan(b, h, hkv, sq, skv, causal, window, q_offset,
                              dtype):
    """The route follows dtype and packed rows alone; the splits tile the
    visible keys exactly, none lies outside [0, Skv), and the grids stay
    within CUDA's limits (x < 2^31, y <= 65535)."""
    p = flash_attention.plan(b, h, hkv, sq, skv, dtype, causal=causal,
                             window=window, q_offset=q_offset)
    rows = (h // hkv) * sq
    if rows <= flash_attention.MAX_PACKED_ROWS:
        assert p["path"] == "split_kv" and p["rows"] == rows
        lo, hi, n, sp = p["kv_begin"], p["kv_end"], p["n_splits"], p["split"]
        assert 0 <= lo <= hi <= skv and n >= 1 and sp == flash_attention.SPLIT
        splits = [(lo + s * sp, min(lo + (s + 1) * sp, hi)) for s in range(n)]
        assert all(lo <= u0 <= u1 <= hi for u0, u1 in splits)
        assert all(a[1] == c[0] for a, c in zip(splits, splits[1:]))
        assert splits[0][0] == lo and splits[-1][1] == hi
        assert n == 1 or all(u1 > u0 for u0, u1 in splits)   # none empty
        visible = _visible_keys(sq, skv, causal, window, q_offset)
        assert visible <= set(range(lo, hi))
        if visible:
            assert min(visible) == lo and max(visible) == hi - 1
        assert p["grid"] == (n, b * hkv) and p["merge_grid"] == (b * hkv, 1)
    else:
        assert p["path"] == ("wgmma" if dtype == torch.bfloat16
                             else "f32_tile")
        assert p["grid"] == (-(-sq // p["block_rows"]), b * h)
    assert 1 <= p["grid"][0] < 2**31 and 1 <= p["grid"][1] <= 65535


def _wkv_inputs(seed, b, s, nh, hd, wlo=0.3, whi=0.999):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, nh, hd)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(wlo, whi, size=(b, s, nh, hd)).astype(np.float32)
    u = rng.normal(size=(nh, hd)).astype(np.float32)
    return r, k, v, w, u


# the tolerance of the reference's own wkv6 kernel test: chunked and
# sequential sums of O(10) terms differ by f32 rounding
WKV_TOL = 2e-4


_wkv_chunked_jit = jax.jit(jrwkv.wkv_chunked, static_argnames=("chunk",))


@functools.lru_cache(maxsize=None)
def _wkv_scan_oracle(seed, b, s, nh, hd):
    """The sequential oracle's (y, state) as numpy, once per shape."""
    jin = map(jnp.asarray, _wkv_inputs(seed, b, s, nh, hd))
    return tuple(np.asarray(a) for a in jref.wkv6_ref(*jin))


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("b,s,nh,hd", [(1, 128, 2, 64), (2, 192, 3, 64),
                                       (2, 100, 3, 64)],
                         ids=["1x128x2", "2x192x3", "ragged-2x100x3"])
def test_wkv6_ref_matches_scan_and_chunked(b, s, nh, hd, chunk):
    r, k, v, w, u = _wkv_inputs(5, b, s, nh, hd)
    y, st = ops.wkv6(*map(to_torch, (r, k, v, w, u)), chunk=chunk)
    assert y.dtype == torch.float32 and y.shape == (b, s, nh, hd)
    assert st.shape == (b, nh, hd, hd)
    ys, sts = _wkv_scan_oracle(5, b, s, nh, hd)         # sequential scan
    assert_close(y, ys, atol=WKV_TOL, rtol=WKV_TOL)
    assert_close(st, sts, atol=WKV_TOL, rtol=WKV_TOL)
    yc, stc = _wkv_chunked_jit(*map(jnp.asarray, (r, k, v, w, u)),
                               chunk=chunk)             # chunked twin
    assert_close(y, yc, atol=WKV_TOL, rtol=WKV_TOL)
    assert_close(st, stc, atol=WKV_TOL, rtol=WKV_TOL)


def test_wkv6_ref_hard_decay():
    """Strong decays (w in [1e-4, 0.1]) do not overflow the chunked form;
    the tolerance of the reference's hard-decay test."""
    r, k, v, w, u = _wkv_inputs(6, 1, 64, 1, 64, 1e-4, 0.1)
    y, st = ref.wkv6_ref(*map(to_torch, (r, k, v, w, u)), chunk=32)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    ys, _ = jref.wkv6_ref(*map(jnp.asarray, (r, k, v, w, u)))
    assert_close(y, ys, atol=1e-3, rtol=1e-3)


def test_wkv6_ref_bf16_inputs_match_f32():
    """bf16 r/k/v (the model's activations) are converted exactly to f32:
    the result equals the f32 call on the converted values."""
    r, k, v, w, u = _wkv_inputs(7, 1, 70, 2, 64)
    rb, kb, vb = (to_torch(a).to(torch.bfloat16) for a in (r, k, v))
    y1, s1 = ops.wkv6(rb, kb, vb, to_torch(w), to_torch(u))
    y2, s2 = ops.wkv6(rb.float(), kb.float(), vb.float(), to_torch(w),
                      to_torch(u))
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


# The wkv6 kernel's algorithm (16-token steps, running products of the
# decay) against the sequential oracle and the chunked jnp twin at each
# chunk length, at every step edge (S = 1, 15, 16, 17, 33); the
# tolerances as above.
@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("b,s,nh", [(1, 128, 2), (2, 100, 3), (1, 17, 1),
                                    (2, 1, 3), (1, 15, 2), (1, 16, 1),
                                    (2, 33, 1), (1, 64, 2), (3, 47, 1)],
                         ids=["1x128x2", "ragged-2x100x3", "ragged-1x17x1",
                              "s1-2x1x3", "s15-1x15x2", "s16-1x16x1",
                              "s33-2x33x1", "1x64x2", "ragged-3x47x1"])
def test_wkv6_step_ref_matches_scan_and_chunked(b, s, nh, chunk):
    r, k, v, w, u = _wkv_inputs(5, b, s, nh, 64)
    y, st = ref.wkv6_step_ref(*map(to_torch, (r, k, v, w, u)))
    assert y.dtype == torch.float32 and y.shape == (b, s, nh, 64)
    assert st.shape == (b, nh, 64, 64)
    ys, sts = _wkv_scan_oracle(5, b, s, nh, 64)
    assert_close(y, ys, atol=WKV_TOL, rtol=WKV_TOL)
    assert_close(st, sts, atol=WKV_TOL, rtol=WKV_TOL)
    yc, stc = _wkv_chunked_jit(*map(jnp.asarray, (r, k, v, w, u)),
                               chunk=chunk)
    assert_close(y, yc, atol=WKV_TOL, rtol=WKV_TOL)
    assert_close(st, stc, atol=WKV_TOL, rtol=WKV_TOL)


@pytest.mark.parametrize("chunk", [32, 64])
def test_wkv6_step_ref_hard_decay(chunk):
    """w in [1e-4, 0.1]: the running products underflow where the oracles'
    exponentials of summed logarithms do; the reference's hard-decay
    tolerance."""
    r, k, v, w, u = _wkv_inputs(6, 1, 70, 2, 64, 1e-4, 0.1)
    y, st = ref.wkv6_step_ref(*map(to_torch, (r, k, v, w, u)))
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    ys, sts = jref.wkv6_ref(*map(jnp.asarray, (r, k, v, w, u)))
    assert_close(y, ys, atol=1e-3, rtol=1e-3)
    assert_close(st, sts, atol=1e-3, rtol=1e-3)
    yc, stc = _wkv_chunked_jit(*map(jnp.asarray, (r, k, v, w, u)),
                               chunk=chunk)
    assert_close(y, yc, atol=1e-3, rtol=1e-3)
    assert_close(st, stc, atol=1e-3, rtol=1e-3)


def test_wkv6_step_ref_zero_decays():
    """w = 0 exactly in every 5th channel, the rest in [1e-4, 0.1]: the
    1e-38 clamp. Held against the sequential oracle only: the chunked jnp
    twin's clamp value 1e-38 is subnormal in f32, XLA on the CPU flushes
    it to 0, and log(0) gives NaN there (a reference-side caveat); the
    plain chunked ``ref.wkv6_ref`` stays finite but loses precision to
    exponents near -87 per clamped step."""
    r, k, v, w, u = _wkv_inputs(6, 1, 70, 2, 64, 1e-4, 0.1)
    w[..., ::5] = 0.0
    y, st = ref.wkv6_step_ref(*map(to_torch, (r, k, v, w, u)))
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    ys, sts = jref.wkv6_ref(*map(jnp.asarray, (r, k, v, w, u)))
    assert_close(y, ys, atol=1e-3, rtol=1e-3)
    assert_close(st, sts, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("mangled,label", [
    ("_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_c45a2b1818flash_wgmma_"
     "kernelILi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16NS_7StridesEii",
     "flash_wgmma_kernel<128>"),
    ("_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_c45a2b1818flash_split_"
     "kernelI13__nv_bfloat16Li128ELi2EEEvPKT_S4_S4_PfS5_NS_7StridesE",
     "flash_split_kernel<bf16,128,2>"),
    ("_ZN12_GLOBAL__N_116flash_fwd_kernelILi64ELi16EEEvPKfS2_S2_Pf",
     "flash_fwd_kernel<64,16>"),
    ("_ZN12_GLOBAL__N_118flash_merge_kernelIfLi64EEEvPKfS2_PT_",
     "flash_merge_kernel<float,64>"),
    ("_ZN12_GLOBAL__N_111wkv6_kernelILi64EEEvPKfS2_", "wkv6_kernel<64>"),
    ("segment_agg_kernel", "segment_agg_kernel")])
def test_sass_kernel_labels(mangled, label):
    """The SASS check names each kernel instantiation from its mangled
    name (the anonymous namespace's hash holds digits and letters)."""
    assert _build._kernel_label(mangled) == label
