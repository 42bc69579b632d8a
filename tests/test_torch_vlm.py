"""The vlm family (qwen2-vl: the dense GQA decoder under M-RoPE, with
projected vision embeddings before the text) of the port against the
JAX reference, on the CPU at ``cfg.reduce()`` (2 layers, d_model 256, 4
heads of 64 over 2 kv heads, 16 vision tokens on a 4 x 4 grid): M-RoPE
and its position streams, and the whole model's init tree, logits,
prefill cache (with ``dpos``), decode steps, the model served without a
vision embedding (the standard-RoPE fallback), loss with gradients over
the text positions and ``serve.main``. The same numpy-seeded inputs go
through both packages, parameters included: numpy draws in the
reference's tree (``jax.eval_shape`` of its init), loaded with
``weights.tree_from_numpy``.

Tolerances, as in ``tests/test_torch_llm.py``: f32 1e-4 (summation
order); bf16 0.05 for a module, relative L2 3e-2 for whole-model
results; the position streams exactly.
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
from repro.models import build_model as j_build_model
from repro.models import common as jcommon
from repro.models import transformer as jtransformer
from repro_torch.configs import get_config
from repro_torch.models import common, transformer
from repro_torch.models.model import build_model

F32_TOL = 1e-4
BF16_TOL = 0.05
BF16_MODEL_REL = 3e-2
ACTS = ["float32", "bfloat16"]
ARCH = "qwen2-vl-7b"
N_VIS = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs in several worker processes
    at once over the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(act="float32"):
    """(reference cfg, port cfg): reduced qwen2-vl-7b."""
    return tuple(dataclasses.replace(get(ARCH).reduce(), activ_dtype=act)
                 for get in (j_get_config, get_config))


def _draw(rng, name, shape, dtype):
    """One leaf: norm scales around 1, the embedding at the init's 0.02,
    other weights (the vision projection too) 1 / sqrt(fan-in)."""
    if name.startswith("ln") or name.endswith("norm"):
        a = 1.0 + 0.1 * rng.normal(size=shape)
    elif name == "embed":
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


def _model_close(got, want, act):
    if act == "float32":
        assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        assert rel_err(got, want) <= BF16_MODEL_REL


def _vision(b, seed, n=N_VIS):
    return np.random.default_rng(seed).normal(size=(b, n, 256)).astype(
        np.float32)


def _toks(seed, s=16):
    return np.random.default_rng(seed).integers(0, 512, (2, s)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_vis,n_text", [(16, 8), (256, 4), (10, 3),
                                          (0, 5)],
                         ids=["reduced", "qwen2-vl-7b", "non-square", "text"])
def test_build_mrope_positions_match_reference(n_vis, n_text):
    """The (3, B, n_vis + n_text) position streams exactly: the vision
    grid of width int(sqrt(n_vis)) (4, 16 and 3 here; 1 without vision
    tokens) and the text from the grid's width on; int32."""
    jcfg, cfg = _cfgs()
    want = jtransformer.build_mrope_positions(jcfg, 2, n_vis, n_text)
    got = transformer.build_mrope_positions(cfg, 2, n_vis, n_text, "cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert transformer.mrope_grid(n_vis) == int(want[0, 0, -1]) - n_text + 1


@pytest.mark.parametrize("d", [64, 128], ids=["reduced", "qwen2-vl-7b"])
@pytest.mark.parametrize("act", ACTS)
def test_apply_m_rope_matches_reference(act, d):
    """``apply_m_rope`` of (2, 24, 4, D) q-like inputs over the reduced
    model's position streams (16 vision tokens, 8 text), at the reduced
    and the published head dim, with qwen2-vl's theta 1e6, against the
    reference's; f32 1e-4, bf16 0.05. The sections' bands are (0, 16),
    (16, 24), (24, 32) at D = 64 and (0, 32), (32, 48), (48, 64) at 128;
    with all three streams equal, M-RoPE is standard RoPE."""
    jcfg, cfg = _cfgs(act)
    rng = np.random.default_rng(d)
    jx = jnp.asarray(rng.normal(size=(2, 24, 4, d)), getattr(jnp, act))
    tx = to_torch(jx)
    jpos = jtransformer.build_mrope_positions(jcfg, 2, 16, 8)
    pos = transformer.build_mrope_positions(cfg, 2, 16, 8, "cpu")
    want = jcommon.apply_m_rope(jx, jpos, cfg.rope_theta)
    got = common.apply_m_rope(tx, pos, cfg.rope_theta)
    assert got.dtype == tx.dtype
    tol = F32_TOL if act == "float32" else BF16_TOL
    assert_close(got, want, atol=tol, rtol=tol)
    half = d // 2
    assert common.m_rope_bands(half) == [(0, half // 2),
                                         (half // 2, 3 * half // 4),
                                         (3 * half // 4, half)]
    flat = torch.arange(24, dtype=torch.int32)[None].expand(2, 24)
    same = common.apply_m_rope(tx, flat[None].expand(3, 2, 24),
                               cfg.rope_theta)
    assert torch.equal(same, common.apply_rope(tx, flat, cfg.rope_theta))


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def test_init_tree_is_the_references():
    """The port's init has the reference's tree leaf for leaf (shapes and
    dtypes, ``vis_proj`` (d, d) included)."""
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
    assert tuple(mine["vis_proj"].shape) == (cfg.d_model, cfg.d_model)


def _hold(jres, res, act, s_all):
    (jfull, jlogits, jcaches), (full, logits, caches) = jres, res
    assert full.shape == (2, s_all, 512)
    _model_close(full, jfull, act)
    for lg, jl in zip(logits, jlogits):
        _model_close(lg, jl, act)
    for cache, jc in zip(caches, jcaches):
        assert sorted(cache) == sorted(jc)
        assert cache["t"] == int(jc["t"])
        assert cache["dpos"] == int(jc["dpos"])
        np.testing.assert_array_equal(cache["pos"].numpy(), jc["pos"])
        for k in ("k", "v"):
            assert tuple(cache[k].shape) == jc[k].shape
            _model_close(cache[k], jc[k], act)


@pytest.mark.parametrize("act", ACTS)
def test_vlm_serving_matches_reference(act):
    """Reduced qwen2-vl with a (2, 16, 256) ``vision_embed``:
    ``Model.logits`` over 16 vision + 16 text positions, ``prefill`` of
    12 text tokens (max_new 4: a cache of 32 slots, ``t`` 28 counting the
    vision tokens, ``dpos`` = 4 + 12 - 28 = -12) and 4 decode steps (M-RoPE
    position pos + dpos, cache slot pos) with the cache after them,
    against the reference's; f32 1e-4, bf16 relative L2 3e-2 (positions,
    ``t`` and ``dpos`` exactly). In f32 each decode step also equals the
    port's own full forward at its position within 1e-4."""
    jcfg, cfg = _cfgs(act)
    jp, p = _params(1)
    jres, res = serve_both(j_build_model(jcfg), jp, build_model(cfg), p,
                           _toks(2), 12, 4,
                           extras={"vision_embed": _vision(2, 3)})
    _hold(jres, res, act, N_VIS + 16)
    full, logits, caches = res
    assert caches[0]["t"] == N_VIS + 12 and caches[0]["dpos"] == -12
    assert caches[0]["k"].shape[2] == N_VIS + 16
    if act == "float32":
        for i, lg in enumerate(logits):
            assert_close(lg, full[:, N_VIS + 11 + i], atol=F32_TOL,
                         rtol=F32_TOL)


def test_vlm_serving_without_vision_matches_reference():
    """Reduced qwen2-vl served without ``vision_embed``: standard RoPE at
    the token positions in the forward and the prefill (the reference's
    fallback), ``dpos`` 0, and decode steps whose M-RoPE streams all
    equal the position; against the reference's, f32 1e-4."""
    jcfg, cfg = _cfgs()
    jp, p = _params(2)
    jres, res = serve_both(j_build_model(jcfg), jp, build_model(cfg), p,
                           _toks(4), 12, 4)
    _hold(jres, res, "float32", 16)
    assert res[2][0]["dpos"] == 0 and res[2][0]["t"] == 12


def test_vlm_loss_and_grads_match_reference():
    """``Model.loss`` with ``vision_embed`` (attention in KV chunks of 8
    over 16 + 16 positions, remat; the cross-entropy over the 16 text
    positions only) and its gradient in every leaf, ``vis_proj``
    included, against ``jax.value_and_grad`` of the reference's, f32
    within 1e-4."""
    jcfg, cfg = _cfgs()
    jp, p = _params(3)
    batch = {"tokens": _toks(5), "labels": _toks(6),
             "vision_embed": _vision(2, 7)}
    jval, jg, val, g = loss_grads_both(j_build_model(jcfg), jp,
                                       build_model(cfg), p, batch,
                                       attn_chunk=8, remat=True)
    assert_close(val, jval, atol=F32_TOL, rtol=F32_TOL)
    assert sorted(g) == sorted(jg)
    assert float(g["vis_proj"].abs().max()) > 0
    for k in g:
        assert_close(g[k], jg[k], atol=F32_TOL, rtol=F32_TOL)


def test_serve_main_vlm_on_cpu():
    """``python -m repro_torch.launch.serve --arch qwen2-vl-7b --reduced
    --device cpu``: ``vision_embed`` drawn as ``examples/serve_decode.py``
    draws it (numpy ``default_rng(seed)``, (B, vision_tokens, d) f32), a
    10-token prompt after the 16 vision tokens, 3 greedy steps, each fed
    the previous step's argmax; the plain path, no kernel launch."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    ops.reset_launches()
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--prompt-len", "10", "--new-tokens", "3", "--batch",
                      "2", "--seed", "1"])
    cache = res["cache"]
    assert cache["t"] == N_VIS + 13 and cache["k"].shape[2] == N_VIS + 13
    assert cache["dpos"] == 4 - N_VIS
    assert torch.equal(res["tokens"][:, 1],
                       res["logits"][1].argmax(-1).to(torch.int32))
    assert all(bool(torch.isfinite(lg).all()) for lg in res["logits"])
    assert set(ops.LAUNCHES.values()) == {0}
    _, cfg = _cfgs()
    ex = serve.stub_extras(cfg, 2, 1, "cpu")["vision_embed"]
    np.testing.assert_array_equal(ex.numpy(), _vision(2, 1))
