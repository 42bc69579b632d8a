"""The audio family (whisper: a LayerNorm / GELU encoder-decoder whose
decoder cross-attends to the encoder) of the port against the JAX
reference, on the CPU at ``cfg.reduce()`` (2 encoder + 2 decoder layers,
d_model 256, 4 heads of 64 over 2 kv heads, enc_seq 32, dec_ctx 64):
layer norm, the GELU MLP, the sinusoidal positions, cross-attention and
non-causal self-attention on both routes, and the whole model's init
tree, logits, prefill cache (``ck``/``cv`` included), decode steps, loss
with gradients and ``serve.main``. The same numpy-seeded inputs go
through both packages, parameters included: numpy draws in the
reference's tree (``jax.eval_shape`` of its init), loaded with
``weights.tree_from_numpy``.

Tolerances, as in ``tests/test_torch_llm.py``: f32 1e-4 (summation
order); bf16 0.05 for a module, relative L2 3e-2 for whole-model
results.
"""
import dataclasses

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
from repro.models import attention as jattn
from repro.models import build_model as j_build_model
from repro.models import common as jcommon
from repro_torch.configs import get_config
from repro_torch.models import attention, common, transformer
from repro_torch.models.model import build_model

F32_TOL = 1e-4
BF16_TOL = 0.05
BF16_MODEL_REL = 3e-2
ACTS = ["float32", "bfloat16"]
ARCH = "whisper-base"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs in several worker processes
    at once over the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(act="float32"):
    """(reference cfg, port cfg): reduced whisper-base."""
    return tuple(dataclasses.replace(get(ARCH).reduce(), activ_dtype=act)
                 for get in (j_get_config, get_config))


def _draw(rng, name, shape, dtype):
    """One leaf: norm scales around 1 and biases around 0 (nonzero, so
    each is seen to be applied), the token and position embeddings at the
    init's 0.02, other weights 1 / sqrt(fan-in)."""
    if name.endswith("_w") or name == "final_norm":
        a = 1.0 + 0.1 * rng.normal(size=shape)
    elif name.endswith("_b") or name.startswith("b_"):
        a = 0.1 * rng.normal(size=shape)
    elif name in ("embed", "dec_pos"):
        a = rng.normal(size=shape) * 0.02
    else:
        a = rng.normal(size=shape) / np.sqrt(shape[-2])
    return np.asarray(a).astype(dtype)


_PARAMS = {}


def _params(seed: int):
    if seed not in _PARAMS:
        _PARAMS[seed] = numpy_model_params(j_build_model(_cfgs()[0]), seed,
                                           _draw)
    return _PARAMS[seed]


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


def _enc_embed(b, seed, enc_seq=32):
    return np.random.default_rng(seed).normal(
        size=(b, enc_seq, 256)).astype(np.float32)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ACTS)
def test_layer_norm_and_gelu_mlp_match_reference(act):
    """``layer_norm`` (f32 statistics, the f32 weight and bias applied in
    f32 before the cast back, off-centre inputs) and ``gelu_mlp`` (the
    tanh GELU) on x in the activation dtype, with layer 0's encoder
    parameters, against the reference's; f32 1e-4, bf16 0.05."""
    jp, p = _params(0)
    jx, tx = _x(act, (2, 9, 256), seed=1)
    jx, tx = jx * 3 + 1, tx * 3 + 1
    jl = jax.tree.map(lambda a: a[0], jp["enc_layers"])
    tl = transformer.layer(p["enc_layers"], 0)
    want = jcommon.layer_norm(jx, jl["ln1_w"], jl["ln1_b"])
    got = common.layer_norm(tx, tl["ln1_w"], tl["ln1_b"])
    assert got.dtype == tx.dtype
    _close(got, want, act)
    want = jcommon.gelu_mlp(jl["mlp"], jx)
    got = common.gelu_mlp(tl["mlp"], tx)
    assert got.dtype == tx.dtype
    _close(got, want, act)


@pytest.mark.parametrize("seq,d", [(32, 256), (1500, 512)],
                         ids=["reduced", "whisper-base"])
def test_sinusoidal_positions_match_reference(seq, d):
    """The encoder's (seq, d) sinusoidal positions, at the reduced and the
    published encoder length and width, within 1e-4 (XLA's and torch's
    sin/cos of angles up to 1499 rad)."""
    want = jcommon.sinusoidal_positions(seq, d)
    got = common.sinusoidal_positions(seq, d, "cpu")
    assert got.dtype == torch.float32
    assert_close(got, want, atol=F32_TOL, rtol=0)


def _attn_params(seed, key):
    """Decoder layer 0's ``key`` attention parameters in both packages."""
    jp, p = _params(seed)
    return (jax.tree.map(lambda a: a[0], jp["layers"][key]),
            transformer.layer(p["layers"][key], 0))


@pytest.mark.parametrize("act", ACTS)
def test_cross_attention_matches_reference(act):
    """``encode_cross_kv`` of a 40-row encoder output (no multiple of a
    chunk) and ``cross_attention`` of 12 decoder rows over it, on the
    kernel route (``chunk=None``: the plain version on the CPU) and the
    training route (``chunk=16``: KV chunks of 16, the last ragged),
    against the reference's (KV chunks of min(1024, 40)); f32 1e-4, bf16
    0.05."""
    jcfg, cfg = _cfgs(act)
    jap, ap = _attn_params(1, "cross_attn")
    jenc, tenc = _x(act, (2, 40, 256), seed=2)
    jx, tx = _x(act, (2, 12, 256), seed=3)
    jkv = jattn.encode_cross_kv(jap, jcfg, jenc)
    kv = attention.encode_cross_kv(ap, cfg, tenc)
    for a, b in zip(kv, jkv):
        assert tuple(a.shape) == (2, 40, 2, 64)
        _close(a, b, act)
    want = jattn.cross_attention(jap, jcfg, jx, jkv)
    for chunk in (None, 16):
        got = attention.cross_attention(ap, cfg, tx, kv, chunk=chunk)
        assert got.dtype == tx.dtype
        _close(got, want, act)


@pytest.mark.parametrize("act", ACTS)
def test_non_causal_self_attention_matches_reference(act):
    """The encoder's non-causal ``self_attention`` over 40 rows on the
    kernel route and on the training route (KV chunks of 16, all-zero
    ``kv_positions`` as the reference does it) against the reference's
    (chunks of 40); f32 1e-4, bf16 0.05."""
    jcfg, cfg = _cfgs(act)
    jp, p = _params(1)
    jap = jax.tree.map(lambda a: a[0], jp["enc_layers"]["attn"])
    ap = transformer.layer(p["enc_layers"]["attn"], 0)
    jx, tx = _x(act, (2, 40, 256), seed=4)
    want = jattn.self_attention(jap, jcfg, jx, causal=False, chunk=40)
    for chunk in (None, 16):
        _close(attention.self_attention(ap, cfg, tx, causal=False,
                                        chunk=chunk), want, act)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def test_init_tree_is_the_references():
    """The port's init has the reference's tree leaf for leaf: shapes and
    dtypes of ``enc_layers``, ``enc_norm_w/b``, ``layers`` (self- and
    cross-attention, three layer norms, the GELU MLP), ``final_norm_b``
    and ``dec_pos`` (dec_ctx, d)."""
    jcfg, cfg = _cfgs()
    jp, _ = _params(0)
    mine = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(jax.tree.leaves(jax.tree.map(lambda t: 0, mine)))
    for path, leaf in flat:
        a = mine
        for key in path:
            a = a[key.key]
        assert tuple(a.shape) == leaf.shape
        assert str(a.dtype).split(".")[-1] == leaf.dtype.name
    assert tuple(mine["dec_pos"].shape) == (cfg.dec_ctx, cfg.d_model)
    assert tuple(mine["enc_layers"]["mlp"]["w_up"].shape) == (2, 256, 512)


@pytest.mark.parametrize("act", ACTS)
def test_audio_serving_matches_reference(act):
    """Reduced whisper with a (2, 32, 256) ``enc_embed``: ``Model.logits``
    over 16 decoder tokens, ``prefill`` of 12 (max_new 4) with every
    cache leaf (self-attention k/v and positions, each layer's cross k/v
    ``ck``/``cv``), and 4 decode steps with the cache after them, against
    the reference's; f32 1e-4, bf16 relative L2 3e-2 (positions
    exactly)."""
    jcfg, cfg = _cfgs(act)
    jp, p = _params(2)
    toks = np.random.default_rng(5).integers(0, 512, (2, 16)).astype(
        np.int32)
    (jfull, jlogits, jcaches), (full, logits, caches) = serve_both(
        j_build_model(jcfg), jp, build_model(cfg), p, toks, 12, 4,
        extras={"enc_embed": _enc_embed(2, 6)})
    assert full.shape == (2, 16, 512) and full.dtype == cfg.adtype
    _model_close(full, jfull, act)
    for lg, jl in zip(logits, jlogits):
        _model_close(lg, jl, act)
    for cache, jc in zip(caches, jcaches):
        assert sorted(cache) == sorted(jc)
        assert cache["t"] == int(jc["t"])
        np.testing.assert_array_equal(cache["pos"].numpy(), jc["pos"])
        assert tuple(cache["ck"].shape) == (2, 2, 32, 2, 64)
        for k in ("k", "v", "ck", "cv"):
            assert tuple(cache[k].shape) == jc[k].shape
            _model_close(cache[k], jc[k], act)


def test_audio_loss_and_grads_match_reference():
    """``Model.loss`` with ``enc_embed`` (the whisper blocks in KV chunks
    of min(1024, S) whatever ``attn_chunk``, remat) and its gradient in
    every leaf, encoder included, against ``jax.value_and_grad`` of the
    reference's, f32 within 1e-4."""
    jcfg, cfg = _cfgs()
    jp, p = _params(3)
    rng = np.random.default_rng(7)
    batch = {k: rng.integers(0, 512, (2, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    batch["enc_embed"] = _enc_embed(2, 8)
    jval, jg, val, g = loss_grads_both(j_build_model(jcfg), jp,
                                       build_model(cfg), p, batch,
                                       attn_chunk=8, remat=True)
    assert_close(val, jval, atol=F32_TOL, rtol=F32_TOL)
    assert sorted(g) == sorted(jg)
    assert any(k.startswith("enc_layers/") for k in g)
    for k in g:
        assert_close(g[k], jg[k], atol=F32_TOL, rtol=F32_TOL)


def test_serve_main_audio_on_cpu():
    """``python -m repro_torch.launch.serve --arch whisper-base --reduced
    --device cpu``: ``enc_embed`` drawn as ``examples/serve_decode.py``
    draws it (numpy ``default_rng(seed)``, (B, enc_seq, d) f32), a
    10-token prompt, 3 greedy steps, each fed the previous step's argmax;
    the cross k/v cover the 32 encoder rows; the plain path, no kernel
    launch."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    ops.reset_launches()
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--prompt-len", "10", "--new-tokens", "3", "--batch",
                      "2"])
    cache = res["cache"]
    assert cache["t"] == 13 and cache["k"].shape[2] == 13
    assert cache["ck"].shape == (2, 2, 32, 2, 64)
    assert torch.equal(res["tokens"][:, 1],
                       res["logits"][1].argmax(-1).to(torch.int32))
    assert all(bool(torch.isfinite(lg).all()) for lg in res["logits"])
    assert set(ops.LAUNCHES.values()) == {0}
    _, cfg = _cfgs()
    ex = serve.stub_extras(cfg, 2, 0, "cpu")["enc_embed"]
    want = np.random.default_rng(0).normal(size=(2, 32, 256))
    np.testing.assert_array_equal(ex.numpy(), want.astype(np.float32))
