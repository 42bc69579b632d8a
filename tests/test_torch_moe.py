"""The MoE family and ring-buffer (sliding-window) serving of the port
against the JAX reference, on the CPU at reduced sizes: routing, the
dispatch indices, the MoE FFN with drops and in token chunks, reduced
grok-1's forward, ring-buffer prefill and decode of reduced qwen3
(window 8, prompts longer and shorter than the window, and a cache
filled by decode alone), and expert parallelism's refusal. The same
numpy-seeded inputs go through both packages, parameters included:
numpy draws in the reference's layout (its tree from ``jax.eval_shape``
of the init), loaded with ``weights.tree_from_numpy``.

Tolerances, as in ``tests/test_torch_llm.py``: f32 1e-4 (summation
order); bf16 0.05 for a module, relative L2 3e-2 for whole-model
results. Routing is held exactly: the experts chosen, the slots and the
kept pairs are equal, not close.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_close, rel_err, to_torch

from repro.configs import get_config as j_get_config
from repro.models import attention as jattn
from repro.models import build_model as j_build_model
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro_torch import weights
from repro_torch.configs import get_config
from repro_torch.models import attention, moe, transformer
from repro_torch.models.model import build_model

F32_TOL = 1e-4
BF16_TOL = 0.05
BF16_MODEL_REL = 3e-2
ACTS = ["float32", "bfloat16"]
WINDOW = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs in several worker processes
    at once over the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _published_moe(act: str, pkg_get):
    """Reduced olmoe widths (d_model 256) with the published router: 64
    experts, top 8, capacity factor 1.25 (``reduce()`` makes it
    dropless), d_ff cut to 64 to keep the experts small."""
    full = pkg_get("olmoe-1b-7b")
    return dataclasses.replace(full.reduce(), activ_dtype=act, d_ff=64,
                               moe=full.moe)


@functools.lru_cache(maxsize=None)
def _moe_params():
    """MoE parameters for ``_published_moe`` drawn with numpy at the
    scales of the reference's ``moe_init`` (router 0.02; the (E, d, f)
    and (E, f, d) stacks 1 / sqrt(E), its fan-in rule), as JAX arrays
    and as the port's tensors."""
    rng = np.random.default_rng(3)
    e, d, f = 64, 256, 64
    tree = {"router": rng.normal(size=(d, e)) * 0.02,
            "w_gate": rng.normal(size=(e, d, f)) / np.sqrt(e),
            "w_up": rng.normal(size=(e, d, f)) / np.sqrt(e),
            "w_down": rng.normal(size=(e, f, d)) / np.sqrt(e)}
    tree = {k: v.astype(np.float32) for k, v in tree.items()}
    return (jax.tree.map(jnp.asarray, tree),
            weights.tree_from_numpy(tree, "cpu"))


def _drawn_params(jcfg, seed: int):
    """A parameter tree of the reference's layout for ``jcfg`` (shapes
    and dtypes from ``jax.eval_shape`` of its init, no compile), filled
    from numpy: norm scales 1, the embedding and the router at scale
    0.02, other weights 1 / sqrt(fan-in); as JAX arrays and as the
    port's tensors."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(j_build_model(jcfg).init, jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = path[-1].key
        if name.startswith("ln") or name.endswith("norm"):
            a = np.ones(leaf.shape)
        elif name in ("embed", "router"):
            a = rng.normal(size=leaf.shape) * 0.02
        else:
            a = rng.normal(size=leaf.shape) / np.sqrt(leaf.shape[-2])
        return a.astype(leaf.dtype)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return jax.tree.map(jnp.asarray, tree), weights.tree_from_numpy(tree,
                                                                    "cpu")


def _x(act, shape, seed, scale=1.0):
    x = jnp.asarray(np.random.default_rng(seed).normal(size=shape) * scale,
                    getattr(jnp, act))
    return x, to_torch(x)


def _close(got, want, act):
    tol = F32_TOL if act == "float32" else BF16_TOL
    return assert_close(got, want, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# routing and dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ACTS)
def test_route_matches_reference(act):
    """f32 router logits of the same activations: gates within 1e-6,
    the same experts in the same order, the aux loss within 1e-6."""
    jp, p = _moe_params()
    jx, tx = _x(act, (96, 256), seed=0)
    jg, je, ja = jmoe._route(jp, jx, 64, 8)
    g, e, a = moe._route(p, tx, 64, 8)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    assert_close(g, jg, atol=1e-6)
    assert_close(a, ja, atol=1e-6)


def test_dispatch_indices_bitwise():
    """The published olmoe router (64 experts, top 8, capacity factor
    1.25) over 96 tokens whose choices crowd the low experts: capacity
    15, so drops occur. Slots and kept pairs equal the reference's
    bitwise, token-major over (T, k)."""
    rng = np.random.default_rng(1)
    # 8 distinct experts per token, drawn with weights that favour the
    # low ids so some experts get more than their capacity
    w = np.exp(-np.arange(64) / 12.0)
    experts = np.stack([rng.choice(64, 8, replace=False, p=w / w.sum())
                        for _ in range(96)]).astype(np.int32)
    cap = moe.capacity(96, j_get_config("olmoe-1b-7b").moe)
    assert cap == 15
    js, jk = jmoe._dispatch_indices(jnp.asarray(experts), 64, cap)
    s, k = moe._dispatch_indices(torch.from_numpy(experts).long(), 64, cap)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    assert 0 < int((~k).sum()) < k.numel()


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("token_chunk", [moe.MOE_TOKEN_CHUNK, 16],
                         ids=["one-chunk", "chunks-of-16"])
def test_moe_ffn_matches_reference(act, token_chunk):
    """``moe_ffn`` with the published router over (2, 32) tokens: one
    dispatch of 64 tokens (capacity 10) or 4 chunks of 16 (capacity 2,
    aux the chunks' mean), both with drops, against the reference's
    ``moe_ffn(token_chunk=)``. Activations at scale 0.05 keep the output
    O(1) (the reference's fan-in init of the (E, d, f) expert stacks
    takes E as the fan-in)."""
    jcfg = _published_moe(act, j_get_config)
    cfg = _published_moe(act, get_config)
    jp, p = _moe_params()
    jx, tx = _x(act, (2, 32, 256), seed=2, scale=0.05)
    want, waux = jax.jit(functools.partial(
        jmoe.moe_ffn, cfg=jcfg, token_chunk=token_chunk))(jp, x=jx)
    got, aux = moe.moe_ffn(p, cfg, tx, token_chunk=token_chunk)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, act)
    assert_close(aux, waux, atol=1e-6)
    # drops happened: some (token, choice) pair found its expert full
    t = min(64, token_chunk)
    _, e, _ = moe._route(p, tx.reshape(-1, 256)[:t], 64, 8)
    _, keep = moe._dispatch_indices(e, 64, moe.capacity(t, cfg.moe))
    assert not bool(keep.all())


def test_ep_axis_raises():
    """Expert parallelism needs a multi-rank mesh (ROADMAP item 10 (b)):
    ``moe_ffn`` and an MoE model's ``loss`` raise."""
    _, p = _moe_params()
    cfg = _published_moe("float32", get_config)
    x = torch.zeros((1, 4, 256))
    with pytest.raises(NotImplementedError, match="10 \\(b\\)"):
        moe.moe_ffn(p, cfg, x, ep_axis="tp", ep_size=4)
    rcfg = get_config("olmoe-1b-7b").reduce()
    m = build_model(rcfg)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32),
             "labels": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="10 \\(b\\)"):
        m.loss(params, batch, ep_axis="tp", ep_size=4)


def test_grok_reduced_init_and_forward_match_reference():
    """Reduced grok-1-314b (8 -> 4 experts, top 2, 'tensor' experts;
    f32 activations): the port's init has the reference's tree leaf for
    leaf (shapes and dtypes), and ``forward_hidden`` with the same
    numpy-drawn params matches the reference's hidden states within 1e-4
    and its aux loss within 1e-6."""
    jcfg = dataclasses.replace(j_get_config("grok-1-314b").reduce(),
                               activ_dtype="float32")
    cfg = dataclasses.replace(get_config("grok-1-314b").reduce(),
                              activ_dtype="float32")
    jp, p = _drawn_params(jcfg, seed=8)
    mine = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(jax.tree.leaves(jax.tree.map(lambda t: 0, mine)))
    for path, leaf in flat:
        a = mine
        for key in path:
            a = a[key.key]
        assert tuple(a.shape) == leaf.shape
        assert str(a.dtype).split(".")[-1] == leaf.dtype.name
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 24))
    want, waux = jax.jit(functools.partial(
        jtransformer.forward_hidden, cfg=jcfg))(jp,
                                                tokens=jnp.asarray(toks,
                                                                   jnp.int32))
    got, aux = transformer.forward_hidden(p, cfg, torch.from_numpy(toks))
    assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)
    assert_close(aux, waux, atol=1e-6)
    assert float(aux) > 0.0


# ---------------------------------------------------------------------------
# ring-buffer (sliding-window) serving, reduced qwen3, window 8
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _qwen3_params():
    """Reduced qwen3's parameters, numpy draws in the reference's layout
    (the activation dtype does not enter them)."""
    return _drawn_params(j_get_config("qwen3-1.7b").reduce(), seed=9)


def _qwen3(act: str):
    jcfg = dataclasses.replace(j_get_config("qwen3-1.7b").reduce(),
                               activ_dtype=act)
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduce(),
                              activ_dtype=act)
    jp, p = _qwen3_params()
    return jcfg, j_build_model(jcfg), jp, cfg, build_model(cfg), p


def _model_close(got, want, act):
    if act == "float32":
        assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        assert rel_err(got, want) <= BF16_MODEL_REL


@pytest.mark.parametrize("s", [20, 6], ids=["prompt-20", "prompt-6"])
def test_ring_prefill_and_decode_attention_match_reference(s):
    """Layer 0's attention with window 8: prefill of an s-token prompt
    (a ring of the last 8 positions at slot p % 8 when s = 20; the
    prompt's 6 slots when s = 6), then 8 decode steps that wrap the
    ring, each writing in place; outputs and caches against the
    reference's ``prefill_attention`` / ``decode_attention``, in f32
    (``test_ring_serving_matches_reference`` holds bf16 too)."""
    act = "float32"
    jcfg, _, jp, cfg, _, _ = _qwen3(act)
    pa = jax.tree.map(lambda a: np.asarray(a[0]), jp["layers"]["attn"])
    jpa, tpa = jax.tree.map(jnp.asarray, pa), weights.tree_from_numpy(pa,
                                                                     "cpu")
    jx, tx = _x(act, (2, s + 8, 256), seed=5)
    jdecode = jax.jit(functools.partial(jattn.decode_attention, cfg=jcfg,
                                        window=WINDOW))
    want, jc = jax.jit(functools.partial(
        jattn.prefill_attention, cfg=jcfg, window=WINDOW))(jpa, x=jx[:, :s])
    got, cache = attention.prefill_attention(tpa, cfg, tx[:, :s],
                                             window=WINDOW)
    assert cache[0].shape[1] == min(s, WINDOW)
    _close(got, want, act)
    np.testing.assert_array_equal(cache[2].numpy(), np.asarray(jc[2]))
    for g, w in zip(cache[:2], jc[:2]):
        _close(g, w, act)
    for pos in range(s, s + 8):
        want, jc = jdecode(jpa, x=jx[:, pos:pos + 1], cache=jc,
                           pos=jnp.int32(pos))
        got, cache2 = attention.decode_attention(
            tpa, cfg, tx[:, pos:pos + 1], cache, pos, window=WINDOW)
        assert cache2[0] is cache[0]                      # in place
        _close(got, want, act)
        np.testing.assert_array_equal(cache[2].numpy(), np.asarray(jc[2]))
        for g, w in zip(cache[:2], jc[:2]):
            _close(g, w, act)


def test_ring_serving_matches_reference():
    """``Model.prefill(window=8)`` of a 6-token prompt and 4
    ``decode_step(window=8)`` of the whole reduced model, bf16
    activations: logits and every cache leaf against the reference's
    (relative L2 3e-2, positions exactly); the cache has the prompt's 6
    slots, no headroom, and the ring wraps over them. Only the reference
    states this short-prompt ring (a full forward with window 8 sees more
    positions); a prompt past the window is held against the port's own
    windowed forward in f32 in
    ``test_ring_decode_matches_windowed_forward_and_fills_from_empty``."""
    act, s = "bfloat16", 6
    _, jm, jp, _, m, p = _qwen3(act)
    toks = np.random.default_rng(6).integers(0, 512, (2, s + 4)).astype(
        np.int32)
    jdecode = jax.jit(functools.partial(jm.decode_step, window=WINDOW))
    jl, jc = jax.jit(functools.partial(jm.prefill, window=WINDOW,
                                       max_new=4))(jp, jnp.asarray(toks[:, :s]))
    lg, cache = m.prefill(p, torch.from_numpy(toks[:, :s]), window=WINDOW,
                          max_new=4)
    assert cache["k"].shape[2] == jc["k"].shape[2] == min(s, WINDOW)
    for i in range(s, s + 5):
        _model_close(lg, jl, act)
        assert cache["t"] == int(jc["t"]) == i
        for k in ("k", "v"):
            _model_close(cache[k], jc[k], act)
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(jc["pos"]))
        if i < s + 4:
            jl, jc = jdecode(jp, jc, jnp.asarray(toks[:, i:i + 1]))
            lg, cache = m.decode_step(p, cache, torch.from_numpy(
                toks[:, i:i + 1]), window=WINDOW)


def test_ring_decode_matches_windowed_forward_and_fills_from_empty():
    """The port against itself, f32: (a) prefill(20) + 6 ring steps equal
    ``Model.logits(window=8)`` at those positions within 1e-4; (b) a
    cache of 8 empty slots (``init_cache(window=8)``) filled by 12
    decode steps alone (causal with q_offset until the ring is full, then
    wrapped) equals the reference's steps from its own empty cache; (c) a
    wrapped ring longer than its window raises."""
    _, jm, jp, cfg, m, p = _qwen3("float32")
    toks = np.random.default_rng(7).integers(0, 512, (2, 26)).astype(
        np.int32)
    tt = torch.from_numpy(toks)
    full = m.logits(p, {"tokens": tt}, window=WINDOW)
    lg, cache = m.prefill(p, tt[:, :20], window=WINDOW)
    assert_close(lg, full[:, 19], atol=F32_TOL, rtol=F32_TOL)
    for i in range(20, 26):
        lg, cache = m.decode_step(p, cache, tt[:, i:i + 1], window=WINDOW)
        assert_close(lg, full[:, i], atol=F32_TOL, rtol=F32_TOL)
    jdecode = jax.jit(functools.partial(jm.decode_step, window=WINDOW))
    jc = jm.init_cache(2, WINDOW, window=WINDOW)
    cache = m.init_cache(2, WINDOW, window=WINDOW, device="cpu")
    for i in range(12):
        jl, jc = jdecode(jp, jc, jnp.asarray(toks[:, i:i + 1]))
        lg, cache = m.decode_step(p, cache, tt[:, i:i + 1], window=WINDOW)
        assert_close(lg, jl, atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jc["pos"]))
    long = m.init_cache(2, 12, window=WINDOW, device="cpu")
    long["t"] = 12
    with pytest.raises(ValueError, match="longer than the window"):
        m.decode_step(p, long, tt[:, :1], window=WINDOW)


def test_serve_main_with_window_on_cpu():
    """``python -m repro_torch.launch.serve --window 8 --reduced --device
    cpu``: a 12-token prompt served from a ring of 8 slots, 3 greedy
    steps that wrap it, each fed the previous step's argmax, with no
    headroom in the cache."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    ops.reset_launches()
    res = serve.main(["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
                      "--prompt-len", "12", "--new-tokens", "3", "--batch",
                      "2", "--window", str(WINDOW)])
    cache = res["cache"]
    assert cache["t"] == 15 and cache["k"].shape[2] == WINDOW
    assert sorted(cache["pos"][0, 0].tolist()) == list(range(7, 15))
    assert torch.equal(res["tokens"][:, 1],
                       res["logits"][1].argmax(-1).to(torch.int32))
    assert set(ops.LAUNCHES.values()) == {0}
