"""The LLM serving slice of the port against the JAX reference, on the
CPU at reduced configs (``cfg.reduce()``: 2 layers, d_model 256, head dim
64) and short sequences: configs, token batches, parameter loading, each
module that calls a kernel (attention through ``flash_attention``, RWKV6
time-mix through ``wkv6``), the full forward, and prefill + decode of
qwen3 (dense) and rwkv6 (ssm). Parameters are the reference's
(``Model.init(PRNGKey(0))``) carried over leaf for leaf with
``weights.tree_from_numpy``; inputs come from numpy seeds.

Tolerances. In f32 (``activ_dtype="float32"``) the two packages compute
the same function and differ by summation order: 1e-4. In bf16 (the
configs' activation dtype) each package rounds to bf16 at its own places
(XLA fuses elementwise chains in f32; torch rounds after each op), so a
module differs by a few bf16 ulps of O(1) values: 0.05 absolute, as
``tests/test_arch_smoke.py`` holds decode against forward. Through a
whole model the differences compound, so whole-model bf16 results are
held to a relative L2 error (``rel_err``) of 3e-2 instead.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_close, rel_err, to_numpy, to_torch

from repro.configs import INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs import all_arch_names as j_all_arch_names
from repro.configs import get_config as j_get_config
from repro.data.synthetic import token_batch as j_token_batch
from repro.models import attention as jattn
from repro.models import build_model as j_build_model
from repro.models import rwkv as jrwkv
from repro.models import transformer as jtransformer
from repro_torch import weights
from repro_torch.configs import INPUT_SHAPES, all_arch_names, get_config
from repro_torch.data.synthetic import token_batch
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import attention, rwkv, transformer
from repro_torch.models.model import build_model

F32_TOL = 1e-4
BF16_TOL = 0.05
BF16_MODEL_REL = 3e-2
ACTS = ["float32", "bfloat16"]
ARCHS = ["qwen3-1.7b", "rwkv6-1.6b", "olmoe-1b-7b"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's torch work: the suite runs in
    several worker processes at once over the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params(arch: str):
    """The reference's reduced parameters (``PRNGKey(0)``) and the port's
    copy; the activation dtype does not enter the init."""
    jp = jax.jit(j_build_model(j_get_config(arch).reduce()).init)(
        jax.random.PRNGKey(0))
    return jp, weights.tree_from_numpy(_np_tree(jp), "cpu")


def _models(arch: str, act: str):
    """(reference cfg, model, params; port cfg, model, params), reduced,
    with the activation dtype ``act``; the port's params are the
    reference's."""
    jcfg = dataclasses.replace(j_get_config(arch).reduce(), activ_dtype=act)
    cfg = dataclasses.replace(get_config(arch).reduce(), activ_dtype=act)
    jp, p = _params(arch)
    return jcfg, j_build_model(jcfg), jp, cfg, build_model(cfg), p


def _layer0(tree):
    return jax.tree.map(lambda a: np.asarray(a[0]), tree)


def _x(act, shape=(2, 16, 256), seed=0):
    """The same activations for both packages, rounded once to ``act``."""
    x = jnp.asarray(np.random.default_rng(seed).normal(size=shape),
                    getattr(jnp, act))
    return x, to_torch(x)


def _close(got, want, act):
    tol = F32_TOL if act == "float32" else BF16_TOL
    return assert_close(got, want, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# configs, data, weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", j_all_arch_names())
def test_config_matches_reference(arch):
    jc, c = j_get_config(arch), get_config(arch)
    assert dataclasses.asdict(c) == dataclasses.asdict(jc)
    assert dataclasses.asdict(c.reduce()) == dataclasses.asdict(jc.reduce())
    assert c.n_params() == jc.n_params()
    assert c.reduce().n_params() == jc.reduce().n_params()
    assert (c.head_dim, c.attention_free) == (jc.head_dim, jc.attention_free)
    assert c.dtype == getattr(torch, jc.dtype.name)
    assert c.adtype == getattr(torch, jc.adtype.name)


def test_registry_and_input_shapes_match_reference():
    assert all_arch_names() == j_all_arch_names()
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_INPUT_SHAPES.items()}


def test_token_batch_matches_reference_bitwise():
    want = j_token_batch(3, 4, 37, 512)
    got = token_batch(3, 4, 37, 512, device="cpu")
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_layout_and_loading_match_reference(arch):
    """The port's own init has the reference's tree: same keys, shapes
    and dtypes leaf for leaf; loading the reference's params carries
    every leaf over exactly (bf16 too)."""
    jcfg, _, jp, cfg, m, p = _models(arch, "bfloat16")
    mine = m.init(torch.Generator().manual_seed(0), device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        keys = [k.key for k in path]
        a, b = mine, p
        for key in keys:
            a, b = a[key], b[key]
        assert tuple(a.shape) == leaf.shape and a.dtype == b.dtype
        assert str(a.dtype).split(".")[-1] == leaf.dtype.name
        np.testing.assert_array_equal(to_numpy(b), to_numpy(leaf))
    assert sum(1 for _ in flat_j) == len(jax.tree.leaves(
        jax.tree.map(lambda t: 0, mine)))
    bf = {"w": jnp.asarray([1.0 + 2 ** -7, -3.5], jnp.bfloat16)}
    t = weights.tree_from_numpy(_np_tree({"a": bf}), "cpu")["a"]["w"]
    assert t.dtype == torch.bfloat16
    assert t.float().tolist() == [1.0 + 2 ** -7, -3.5]


# ---------------------------------------------------------------------------
# modules that call a kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ACTS)
def test_project_qkv_matches_reference(act):
    """qk_norm per head, then interleaved RoPE at theta 1e6."""
    jcfg, _, jp, cfg, _, _ = _models("qwen3-1.7b", act)
    pa = _layer0(jp["layers"]["attn"])
    jx, tx = _x(act)
    pos = np.arange(5, 21, dtype=np.int32)[None]
    want = jattn._project_qkv(jax.tree.map(jnp.asarray, pa), jcfg, jx,
                              jnp.asarray(pos))
    got = attention._project_qkv(weights.tree_from_numpy(pa, "cpu"), cfg, tx,
                                 torch.from_numpy(pos))
    for g, w in zip(got, want):
        _close(g, w, act)


@pytest.mark.parametrize("act", ACTS)
def test_prefill_attention_matches_reference(act):
    jcfg, _, jp, cfg, _, _ = _models("qwen3-1.7b", act)
    pa = _layer0(jp["layers"]["attn"])
    jx, tx = _x(act, seed=1)
    want_o, want_c = jattn.prefill_attention(
        jax.tree.map(jnp.asarray, pa), jcfg, jx)
    got_o, got_c = attention.prefill_attention(
        weights.tree_from_numpy(pa, "cpu"), cfg, tx)
    _close(got_o, want_o, act)
    for g, w in zip(got_c, want_c):
        _close(g, w, act)


@pytest.mark.parametrize("act", ACTS)
def test_decode_attention_matches_reference(act):
    """One token at position 16 against a 20-slot cache holding 16
    prefilled positions (kvpos -1 above)."""
    jcfg, _, jp, cfg, _, _ = _models("qwen3-1.7b", act)
    pa = _layer0(jp["layers"]["attn"])
    rng = np.random.default_rng(2)
    kv = rng.normal(size=(2, 2, 20, 2, 64)).astype(np.float32)
    kv[:, :, 16:] = 0.0
    kvpos = np.where(np.arange(20) < 16, np.arange(20), -1).astype(np.int32)
    kvpos = np.broadcast_to(kvpos, (2, 20)).copy()
    jk, jv = (jnp.asarray(a, getattr(jnp, act)) for a in kv)
    jx, tx = _x(act, shape=(2, 1, 256), seed=3)
    want_o, want_c = jattn.decode_attention(
        jax.tree.map(jnp.asarray, pa), jcfg, jx,
        (jk, jv, jnp.asarray(kvpos)), jnp.int32(16))
    cache = (to_torch(jk), to_torch(jv), torch.from_numpy(kvpos))
    got_o, got_c = attention.decode_attention(
        weights.tree_from_numpy(pa, "cpu"), cfg, tx, cache, 16)
    assert got_c[0] is cache[0]                       # updated in place
    _close(got_o, want_o, act)
    for g, w in zip(got_c, want_c):
        _close(g, w, act)


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["from-zero", "carried-state"])
@pytest.mark.parametrize("act", ACTS)
def test_time_mix_forward_matches_reference(act, with_state):
    """From a zero state (the wkv6 kernel's path) the reference runs its
    sequential scan; with a carried state both run the scan."""
    jcfg, _, jp, cfg, _, _ = _models("rwkv6-1.6b", act)
    pt = _layer0(jp["layers"]["tmix"])
    s = 1 if with_state else 16
    jx, tx = _x(act, shape=(2, s, 256), seed=4)
    jstate = tstate = None
    if with_state:
        rng = np.random.default_rng(5)
        ax = jnp.asarray(rng.normal(size=(2, 256)), getattr(jnp, act))
        st = rng.normal(size=(2, 4, 64, 64)).astype(np.float32)
        jstate, tstate = (ax, jnp.asarray(st)), (to_torch(ax), to_torch(st))
    want, (wx, ws) = jrwkv.time_mix_forward(
        jax.tree.map(jnp.asarray, pt), jcfg, jx, state=jstate,
        return_state=True)
    got, (gx, gs) = rwkv.time_mix_forward(
        weights.tree_from_numpy(pt, "cpu"), cfg, tx, state=tstate,
        return_state=True)
    _close(got, want, act)
    _close(gx, wx, act)
    # the f32 state is O(10): the relative part of the tolerance carries
    tol = F32_TOL if act == "float32" else BF16_TOL
    assert rel_err(gs, ws) <= tol


@pytest.mark.parametrize("act", ACTS)
def test_channel_mix_forward_matches_reference(act):
    jcfg, _, jp, cfg, _, _ = _models("rwkv6-1.6b", act)
    pc = _layer0(jp["layers"]["cmix"])
    jx, tx = _x(act, seed=6)
    want, wx = jrwkv.channel_mix_forward(jax.tree.map(jnp.asarray, pc), jcfg,
                                         jx, return_state=True)
    got, gx = rwkv.channel_mix_forward(weights.tree_from_numpy(pc, "cpu"),
                                       cfg, tx, return_state=True)
    _close(got, want, act)
    _close(gx, wx, act)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def _tokens(seed=1, b=2, s=17, vocab=512):
    toks = j_token_batch(seed, b, s, vocab)["tokens"]
    return toks, torch.from_numpy(np.array(toks))


def _model_close(got, want, act):
    if act == "float32":
        assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        assert rel_err(got, want) <= BF16_MODEL_REL


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_matches_reference(arch, act):
    jcfg, _, jp, cfg, _, p = _models(arch, act)
    jt, tt = _tokens(seed=0, s=40)
    want, waux = jtransformer.forward_hidden(jp, jcfg, jt)
    got, aux = transformer.forward_hidden(p, cfg, tt)
    assert aux.dtype == torch.float32
    assert (float(aux) == 0.0) == (cfg.moe is None)
    _model_close(aux, waux, act)
    _model_close(got, want, act)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_reference(arch, act):
    """prefill(16, max_new=4) + decode(1): logits and every cache leaf
    against the reference's ``Model.prefill`` / ``decode_step``."""
    _, jm, jp, _, m, p = _models(arch, act)
    jt, tt = _tokens()
    jl, jc = jm.prefill(jp, jt[:, :16], max_new=4)
    lg, cache = m.prefill(p, tt[:, :16], max_new=4)
    _model_close(lg, jl, act)
    assert cache["t"] == int(jc["t"]) == 16
    for k in jc:
        if k != "t":
            _model_close(cache[k], jc[k], act)
    jl, jc = jm.decode_step(jp, jc, jt[:, 16:17])
    lg, cache = m.decode_step(p, cache, tt[:, 16:17])
    _model_close(lg, jl, act)
    assert cache["t"] == int(jc["t"]) == 17
    for k in jc:
        if k != "t":
            _model_close(cache[k], jc[k], act)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_forward(arch):
    """The port's prefill(16) + decode(1) logits equal its own full
    forward at those positions (the reference's test_decode_matches_
    forward, same tolerance, bf16 activations)."""
    _, _, _, _, m, p = _models(arch, "bfloat16")
    _, tt = _tokens()
    full = m.logits(p, {"tokens": tt})
    lg, cache = m.prefill(p, tt[:, :16], max_new=4)
    assert_close(lg, full[:, 15], atol=0.05, rtol=0.05)
    lg, _ = m.decode_step(p, cache, tt[:, 16:17])
    assert_close(lg, full[:, 16], atol=0.05, rtol=0.05)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_on_cpu(arch):
    """``python -m repro_torch.launch.serve --reduced --device cpu``:
    greedy tokens from the prefill logits on, no kernel launch on the
    CPU, and the cache advanced by every decode step."""
    ops.reset_launches()
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--prompt-len", "12", "--new-tokens", "3",
                      "--batch", "2"])
    assert res["tokens"].shape == (2, 3) and len(res["logits"]) == 4
    assert torch.equal(res["tokens"][:, 0],
                       res["logits"][0].argmax(-1).to(torch.int32))
    assert all(bool(torch.isfinite(lg.float()).all())
               for lg in res["logits"])
    assert res["cache"]["t"] == 15
    assert set(ops.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_defaults_to_the_card(arch):
    """Both cache entry points default to ``device="cuda"`` and take the
    CPU only when asked: without a card the default raises."""
    from repro_torch.models import decode
    cfg = get_config(arch).reduce()
    m = build_model(cfg)
    for cache in (decode.init_cache(cfg, 2, 8, device="cpu"),
                  m.init_cache(2, 8, device="cpu")):
        assert all(t.device.type == "cpu" for k, t in cache.items()
                   if k != "t")
    for make in (lambda: decode.init_cache(cfg, 2, 8),
                 lambda: m.init_cache(2, 8)):
        if torch.cuda.is_available():
            assert all(t.is_cuda for k, t in make().items() if k != "t")
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
