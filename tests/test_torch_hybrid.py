"""The hybrid family (zamba2: Mamba2 blocks and one shared attention
block) of the port against the JAX reference, on the CPU at reduced
sizes: the SSD recurrence in its sequential and chunked forms, a Mamba2
block's forward, state and one-token step, and the whole model's
logits, prefill cache, decode steps, ring-buffer serving and loss with
gradients. The same numpy-seeded inputs go through both packages,
parameters included: numpy draws in the reference's layout (its tree
from ``jax.eval_shape`` of the init), loaded with
``weights.tree_from_numpy``.

The model cases run ``dataclasses.replace(cfg.reduce(), n_layers=5)``:
``attn_every`` 2, so the shared block runs before two groups of two
layers and once more before the last one (3 applications).

Tolerances, as in ``tests/test_torch_llm.py``: f32 1e-4 (summation
order); bf16 0.05 for a module, relative L2 3e-2 for whole-model
results.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    assert_close,
    loss_grads_both,
    numpy_model_params,
    rel_err,
    serve_both,
    to_torch,
)

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models import ssm as jssm
from repro_torch import weights
from repro_torch.configs import get_config
from repro_torch.models import ssm
from repro_torch.models.model import build_model

F32_TOL = 1e-4
BF16_TOL = 0.05
BF16_MODEL_REL = 3e-2
ACTS = ["float32", "bfloat16"]
ARCH = "zamba2-7b"
WINDOW = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs in several worker processes
    at once over the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(act="float32", **kw):
    """(reference cfg, port cfg): reduced zamba2 with 5 layers."""
    return tuple(dataclasses.replace(get(ARCH).reduce(), n_layers=5,
                                     activ_dtype=act, **kw)
                 for get in (j_get_config, get_config))


def _draw(rng, name, shape, dtype):
    """One leaf at the scale of the reference's init: norm scales 1, the
    embedding 0.02, A_log = log(linspace(1, 16)), D around 1, dt_bias
    from the reference's dt law, conv bias small, other weights
    1 / sqrt(fan-in)."""
    if name.startswith("ln") or name.endswith("norm"):
        a = np.ones(shape)
    elif name == "embed":
        a = rng.normal(size=shape) * 0.02
    elif name == "A_log":
        a = np.broadcast_to(np.log(np.linspace(1.0, 16.0, shape[-1])), shape)
    elif name == "D":
        a = 1.0 + 0.1 * rng.normal(size=shape)
    elif name == "dt_bias":
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), size=shape))
        a = np.log(np.expm1(dt))
    elif name == "conv_b":
        a = 0.1 * rng.normal(size=shape)
    else:
        a = rng.normal(size=shape) / np.sqrt(shape[-2])
    return np.asarray(a).astype(dtype)


@functools.lru_cache(maxsize=None)
def _params(seed: int, **kw):
    """A reduced model's parameters in the reference's layout (shapes and
    dtypes from ``jax.eval_shape`` of its init, no compile) drawn with
    numpy; as JAX arrays and as the port's tensors."""
    return numpy_model_params(j_build_model(_cfgs(**kw)[0]), seed, _draw)


def _block(seed: int):
    """Layer 0's Mamba2 parameters of ``_params(seed)``."""
    jp, _ = _params(seed)
    one = jax.tree.map(lambda a: np.asarray(a[0]), jp["layers"]["mamba"])
    return jax.tree.map(jnp.asarray, one), weights.tree_from_numpy(one,
                                                                   "cpu")


def _x(act, shape, seed, scale=1.0):
    x = jnp.asarray(np.random.default_rng(seed).normal(size=shape) * scale,
                    getattr(jnp, act))
    return x, to_torch(x)


def _close(got, want, act):
    tol = F32_TOL if act == "float32" else BF16_TOL
    return assert_close(got, want, atol=tol, rtol=tol)


def _model_close(got, want, act):
    if act == "float32":
        assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        assert rel_err(got, want) <= BF16_MODEL_REL


# ---------------------------------------------------------------------------
# the SSD recurrence
# ---------------------------------------------------------------------------

def _ssd_inputs(b, s, nh, hd, n, lo, hi, seed=7, h0=False):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, s, nh, hd)), rng.normal(size=(b, s, n)),
            rng.normal(size=(b, s, n)), rng.uniform(0.01, 0.2, (b, s, nh)),
            np.exp(rng.uniform(np.log(lo), np.log(hi), (b, s, nh)))]
    if h0:
        arrs.append(rng.normal(size=(b, nh, hd, n)))
    return [a.astype(np.float32) for a in arrs]


# (B, S, nh, hd, N, chunk, nonzero h0): the reference's own chunked-vs-scan
# shapes (S 100 over chunks of 16: a ragged tail), a length of whole
# chunks, and a short ragged one from a nonzero state
SSD_CASES = [(2, 100, 3, 8, 5, 16, False), (2, 64, 3, 8, 5, 16, False),
             (1, 37, 2, 16, 4, 16, True)]


@pytest.mark.parametrize("b,s,nh,hd,n,chunk,h0", SSD_CASES,
                         ids=["reference-shapes", "whole-chunks",
                              "ragged-h0"])
def test_ssd_scan_and_chunked_match_reference(b, s, nh, hd, n, chunk, h0):
    """``ssd_scan`` and ``ssd_chunked`` (decays in [0.7, 0.999], as the
    reference's test draws them): outputs and final states against the
    reference's same functions within 1e-4, and the port's chunked form
    against its scan."""
    arrs = _ssd_inputs(b, s, nh, hd, n, 0.7, 0.999, h0=h0)
    ja = [jnp.asarray(a) for a in arrs]
    ta = [torch.from_numpy(a) for a in arrs]
    jy, jh = jssm.ssd_scan(*ja)
    y, h = ssm.ssd_scan(*ta)
    assert_close(y, jy, atol=F32_TOL, rtol=F32_TOL)
    assert_close(h, jh, atol=F32_TOL, rtol=F32_TOL)
    jy, jh = jssm.ssd_chunked(*ja, chunk=chunk)
    yc, hc = ssm.ssd_chunked(*ta, chunk=chunk)
    assert_close(yc, jy, atol=F32_TOL, rtol=F32_TOL)
    assert_close(hc, jh, atol=F32_TOL, rtol=F32_TOL)
    assert_close(yc, y, atol=F32_TOL, rtol=F32_TOL)
    assert_close(hc, h, atol=F32_TOL, rtol=F32_TOL)


def test_ssd_chunked_matches_scan_with_hard_decays():
    """Decays log-uniform down to 1e-30 (a token can erase the state):
    the port's ``ssd_chunked`` against its own ``ssd_scan``, not against
    the reference's chunked form, whose 1e-38 clamp is subnormal in f32
    and flushed to zero by XLA on the CPU (as with ``wkv_chunked``).
    Finite, and within 1e-4."""
    arrs = [torch.from_numpy(a) for a in
            _ssd_inputs(2, 70, 3, 8, 5, 1e-30, 1.0, seed=8, h0=True)]
    y, h = ssm.ssd_scan(*arrs)
    yc, hc = ssm.ssd_chunked(*arrs, chunk=16)
    assert bool(torch.isfinite(yc).all() and torch.isfinite(hc).all())
    assert_close(yc, y, atol=F32_TOL, rtol=F32_TOL)
    assert_close(hc, h, atol=F32_TOL, rtol=F32_TOL)


# ---------------------------------------------------------------------------
# one Mamba2 block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ACTS)
def test_mamba2_forward_and_step_match_reference(act):
    """``mamba2_forward`` over 24 tokens (chunks of 8: 3 of them) with its
    final state and conv tail, then 3 ``mamba2_step``s from that state,
    against the reference's; f32 1e-4, bf16 0.05."""
    jcfg, cfg = _cfgs(act)
    jp, p = _block(0)
    jx, tx = _x(act, (2, 27, cfg.d_model), seed=1)
    fwd = jax.jit(functools.partial(jssm.mamba2_forward, cfg=jcfg,
                                    return_state=True, chunk=8))
    want, (jh, jtail) = fwd(jp, x=jx[:, :24])
    got, (h, tail) = ssm.mamba2_forward(p, cfg, tx[:, :24],
                                        return_state=True, chunk=8)
    assert got.dtype == tx.dtype and h.dtype == torch.float32
    _close(got, want, act)
    _close(h, jh, act)
    _close(tail, jtail, act)
    step = jax.jit(functools.partial(jssm.mamba2_step, cfg=jcfg))
    jst, st = (jh, jtail), (h, tail)
    for t in range(24, 27):
        want, jst = step(jp, x=jx[:, t:t + 1], state=jst)
        got, st = ssm.mamba2_step(p, cfg, tx[:, t:t + 1], st)
        _close(got, want, act)
        _close(st[0], jst[0], act)
        _close(st[1], jst[1], act)


def test_mamba2_steps_continue_the_forward():
    """The port against itself, f32: the forward over 16 tokens, then 8
    steps from its state, equal the forward over all 24 at those
    positions (chunked and sequential SSD agree) within 1e-4; the scan
    route (``use_chunked=False``) gives the chunked route's output; from
    a 2-token prompt (a conv tail shorter than CONV_K - 1, zero-padded in
    front) the steps continue the forward too."""
    _, cfg = _cfgs()
    _, p = _block(1)
    _, x = _x("float32", (2, 24, cfg.d_model), seed=2)
    full = ssm.mamba2_forward(p, cfg, x, chunk=8)
    assert_close(ssm.mamba2_forward(p, cfg, x, use_chunked=False), full,
                 atol=F32_TOL, rtol=F32_TOL)
    out, st = ssm.mamba2_forward(p, cfg, x[:, :16], return_state=True,
                                 chunk=8)
    assert_close(out, full[:, :16], atol=F32_TOL, rtol=F32_TOL)
    for t in range(16, 24):
        out, st = ssm.mamba2_step(p, cfg, x[:, t:t + 1], st)
        assert_close(out, full[:, t:t + 1], atol=F32_TOL, rtol=F32_TOL)
    _, st = ssm.mamba2_forward(p, cfg, x[:, :2], return_state=True)
    assert st[1].shape == (2, ssm.CONV_K - 1, st[1].shape[-1])
    for t in range(2, 6):
        out, st = ssm.mamba2_step(p, cfg, x[:, t:t + 1], st)
        assert_close(out, full[:, t:t + 1], atol=F32_TOL, rtol=F32_TOL)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def test_init_tree_is_the_references():
    """The port's init has the reference's tree leaf for leaf (shapes and
    dtypes, ``shared_attn`` included), and ``_n_app`` gives 3 groups for
    5 layers at ``attn_every`` 2."""
    from repro_torch.models import decode
    jcfg, cfg = _cfgs()
    jp, _ = _params(3)
    mine = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(jax.tree.leaves(jax.tree.map(lambda t: 0, mine)))
    for path, leaf in flat:
        a = mine
        for key in path:
            a = a[key.key]
        assert tuple(a.shape) == leaf.shape
        assert str(a.dtype).split(".")[-1] == leaf.dtype.name
    assert decode._n_app(cfg) == 3


def _serve_both(act, toks, s, steps, *, seed=3, window=0, **kw):
    """``serve_both`` of reduced zamba2 (5 layers) with ``_params(seed)``:
    logits of the whole sequence (the window's mask with a window),
    prefill of the first ``s`` tokens and ``steps`` decode steps, in
    both packages."""
    jcfg, cfg = _cfgs(act, **kw)
    jp, p = _params(seed, **kw)
    return serve_both(j_build_model(jcfg), jp, build_model(cfg), p, toks, s,
                      steps, window=window)


def _hold(jres, res, act):
    (jfull, jlogits, jcaches), (full, logits, caches) = jres, res
    _model_close(full, jfull, act)
    for lg, jl in zip(logits, jlogits):
        _model_close(lg, jl, act)
    for cache, jc in zip(caches, jcaches):
        assert sorted(cache) == sorted(jc)
        assert cache["t"] == int(jc["t"])
        np.testing.assert_array_equal(cache["apos"].numpy(),
                                      np.asarray(jc["apos"]))
        for k in ("h", "tail", "ak", "av"):
            assert tuple(cache[k].shape) == jc[k].shape
            _model_close(cache[k], jc[k], act)


@pytest.mark.parametrize("act", ACTS)
def test_hybrid_serving_matches_reference(act):
    """Reduced zamba2, 5 layers: ``Model.logits`` over 16 tokens,
    ``prefill`` of 12 (max_new 4) with every cache leaf (Mamba2 states,
    conv tails, the 3 applications' k/v and positions), and 4 decode
    steps with the cache after them, against the reference's; f32 1e-4,
    bf16 relative L2 3e-2 (positions exactly)."""
    toks = np.random.default_rng(4).integers(0, 512, (2, 16)).astype(
        np.int32)
    _hold(*_serve_both(act, toks, 12, 4), act)


def test_hybrid_serving_at_head_dim_112():
    """The same at zamba2-7b's attention head dim 112 (4 heads of 112),
    f32."""
    toks = np.random.default_rng(5).integers(0, 512, (2, 14)).astype(
        np.int32)
    _hold(*_serve_both("float32", toks, 11, 3, seed=4, d_head=112),
          "float32")


def test_hybrid_window_serving_matches_reference():
    """Window 8: a 12-token prompt kept as a ring of 8 slots (position p
    at slot p % 8) in each application's cache, then 4 decode steps that
    wrap it, against the reference's ``prefill(window=8)`` and
    ``decode_step(window=8)``, f32; the full forward under the same
    window mask too."""
    toks = np.random.default_rng(6).integers(0, 512, (2, 16)).astype(
        np.int32)
    jres, res = _serve_both("float32", toks, 12, 4, seed=5, window=WINDOW)
    assert res[2][0]["ak"].shape[2] == WINDOW
    _hold(jres, res, "float32")


def test_hybrid_loss_and_grads_match_reference():
    """``Model.loss`` (attention in KV chunks of 8 over 16 tokens, the
    SSD chunked, remat) and its gradient in every leaf against
    ``jax.value_and_grad`` of the reference's, f32 within 1e-4."""
    jcfg, cfg = _cfgs()
    jp, p = _params(6)
    rng = np.random.default_rng(7)
    batch = {k: rng.integers(0, 512, (2, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    jval, jg, val, g = loss_grads_both(j_build_model(jcfg), jp,
                                       build_model(cfg), p, batch,
                                       attn_chunk=8, remat=True)
    assert_close(val, jval, atol=F32_TOL, rtol=F32_TOL)
    assert sorted(g) == sorted(jg)
    for k in g:
        assert_close(g[k], jg[k], atol=F32_TOL, rtol=F32_TOL)


def test_serve_main_hybrid_on_cpu():
    """``python -m repro_torch.launch.serve --arch zamba2-7b --reduced
    --device cpu``: a 10-token prompt, 3 greedy steps, each fed the
    previous step's argmax; the plain path, no kernel launch."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    ops.reset_launches()
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--prompt-len", "10", "--new-tokens", "3", "--batch",
                      "2"])
    cache = res["cache"]
    assert cache["t"] == 13 and cache["ak"].shape[2] == 13
    assert torch.equal(res["tokens"][:, 1],
                       res["logits"][1].argmax(-1).to(torch.int32))
    assert all(bool(torch.isfinite(lg).all()) for lg in res["logits"])
    assert set(ops.LAUNCHES.values()) == {0}
