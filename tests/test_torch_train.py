"""The LLM training slice of the port against the JAX reference, on the CPU
at reduced configs (2 layers, d_model 256): ``chunked_softmax_xent``,
``chunked_attention``, ``wkv_chunked`` and ``Model.loss`` with their
gradients against ``jax.grad`` of the reference, ``remat``, the HFL mesh
and its PartitionSpecs, and the hierarchical train step
``launch.train.make_hfl_train_step`` (static and dynamic, replicas
(1, 2, 2)) against the reference's jitted step.

The reference's step needs a 4-device mesh, so its cases run once in a
child process with 4 forced host devices (``tests/_torch_train_ref.py``),
started by the first test of this file and read by the train-step tests,
which come last; the port gets the same initial parameters through
``weights.tree_from_numpy``.

Tolerances, from ``tests/test_torch_llm.py``: with f32 activations the
two packages compute the same function and differ by summation order:
1e-4. With bf16 activations a module differs by a few bf16 ulps (0.05
absolute for values, relative L2 3e-2 for whole-model results); the
train step, whose gradients are scaled by the learning rate, is held to
5e-3 absolute, the reference's own bound for the same step across
layouts (``tests/test_sharding.py``).
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_train_ref as tref
from _subproc import REPO, child_env
from _torch_parity import assert_close, rel_err, to_torch

from repro import configs as jconfigs
from repro.launch import mesh as jmesh
from repro.models import attention as jattn
from repro.models import build_model as j_build_model
from repro.models import common as jcommon
from repro.models import rwkv as jrwkv
from repro_torch import configs, weights
from repro_torch.data.synthetic import token_batch
from repro_torch.kernels import ops
from repro_torch.launch import mesh, train
from repro_torch.models import attention, common, rwkv, transformer
from repro_torch.models.model import build_model

F32_TOL = 1e-4
BF16_TOL = 0.05
BF16_MODEL_REL = 3e-2
STEP_BF16_TOL = 5e-3
ARCHS = ["qwen3-1.7b", "rwkv6-1.6b", "olmoe-1b-7b"]
ACTS = ["float32", "bfloat16"]
# olmoe's loss is held in f32 only: with bf16 activations the two
# packages' hidden states differ by bf16 roundings, which moves layer 1's
# router logits by up to 3.3e-3 (batch of the loss test), and a token
# whose 2nd and 3rd experts lie 1.0e-4 apart picks another expert in one
# package than in the other: a step of the function, not a fault of
# either (the f32 case holds every leaf at 1e-4)
LOSS_CASES = [(a, act) for a in ARCHS for act in ACTS
              if (a, act) != ("olmoe-1b-7b", "bfloat16")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's torch work: the suite runs in
    several worker processes at once, and a thread pool per process over
    the same cores slows every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _reference_child(tmp_path_factory):
    """Starts the reference's train-step cases in a child process (4 host
    devices) at this file's first test, so they run while the other
    tests do; yields (process, output directory)."""
    out = tmp_path_factory.mktemp("train_ref")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_torch_train_ref.py"),
         str(out)], env=child_env(4, OMP_NUM_THREADS=1),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference(_reference_child):
    """The child's results directory, once it has finished."""
    proc, out = _reference_child
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return out


def _grads(fn, args: list):
    """(value, grads of ``fn(*args)`` in every arg), in torch."""
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    val = fn(*leaves)
    return val, torch.autograd.grad(val, leaves)


# ---------------------------------------------------------------------------
# the modules of the training forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ACTS)
def test_chunked_softmax_xent_value_and_grads(act):
    """S = 40 in chunks of 16: two whole chunks and a remainder of 8, a
    mask with zeros; value and gradients in h and w against ``jax.grad``
    of the reference."""
    rng = np.random.default_rng(0)
    h = rng.normal(size=(2, 40, 32)).astype(np.float32)
    w = (rng.normal(size=(32, 64)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 64, size=(2, 40)).astype(np.int32)
    mask = (rng.random((2, 40)) > 0.3).astype(np.float32)
    jh = jnp.asarray(h, getattr(jnp, act))

    def jloss(a, b):
        return jcommon.chunked_softmax_xent(a, b, jnp.asarray(labels),
                                            jnp.asarray(mask), chunk=16)

    jval, (jgh, jgw) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jh, jnp.asarray(w))
    val, (gh, gw) = _grads(lambda a, b: common.chunked_softmax_xent(
        a, b, torch.from_numpy(labels), torch.from_numpy(mask), chunk=16),
        [to_torch(jh), torch.from_numpy(w)])
    tol = F32_TOL if act == "float32" else BF16_TOL
    assert_close(val, jval, atol=tol, rtol=tol)
    assert_close(gh, jgh, atol=tol, rtol=tol)
    assert_close(gw, jgw, atol=tol, rtol=tol)
    # no mask: the mean over every position
    jv = jcommon.chunked_softmax_xent(jh, jnp.asarray(w),
                                      jnp.asarray(labels), chunk=16)
    v = common.chunked_softmax_xent(to_torch(jh), torch.from_numpy(w),
                                    torch.from_numpy(labels), chunk=16)
    assert_close(v, jv, atol=tol, rtol=tol)


ATTN_CASES = {
    # name: (H, Hkv, Sq, Skv, causal, window, q_offset, kv-positions pad)
    "causal": (4, 4, 24, 24, True, 0, 0, False),
    "gqa-window": (4, 2, 24, 24, True, 7, 0, False),
    "q-offset": (4, 2, 8, 24, True, 0, 16, False),
    "kv-positions-padded": (4, 2, 24, 20, True, 0, 0, True),
    "non-causal": (4, 2, 24, 24, False, 0, 0, False),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_attention_value_and_grads(case):
    """KV chunks of 8 over 20-24 keys (the last chunk padded where 8 does
    not divide); the output and the gradients of ``sum(out * ct)`` in
    q, k, v against ``jax.grad`` of the reference, f32."""
    h, hkv, sq, skv, causal, window, q_off, padded = ATTN_CASES[case]
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(2, s, n, 64)).astype(np.float32)
               for s, n in ((sq, h), (skv, hkv), (skv, hkv)))
    ct = rng.normal(size=(2, sq, h, 64)).astype(np.float32)
    kvp = None
    if padded:           # explicit positions, as a prefilled cache holds
        kvp = np.broadcast_to(np.arange(skv, dtype=np.int32), (2, skv))
    elif not causal:
        kvp = np.zeros((2, skv), np.int32)
    kw = dict(causal=causal, window=window, q_offset=q_off, chunk=8)

    def jf(a, b, c):
        out = jattn.chunked_attention(
            a, b, c, **kw,
            kv_positions=None if kvp is None else jnp.asarray(kvp))
        return jnp.sum(out * ct)

    jval, jgrads = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tkvp = None if kvp is None else torch.from_numpy(kvp.copy())
    val, grads = _grads(lambda a, b, c: (attention.chunked_attention(
        a, b, c, **kw, kv_positions=tkvp) * torch.from_numpy(ct)).sum(),
        [torch.from_numpy(x) for x in (q, k, v)])
    assert_close(val, jval, atol=F32_TOL, rtol=F32_TOL)
    for g, jg in zip(grads, jgrads):
        assert_close(g, jg, atol=F32_TOL, rtol=F32_TOL)


def _wkv_inputs(seed: int, s: int, zero_decay: bool = False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(2, s, 2, 16)).astype(np.float32) * 0.5
               for _ in range(3))
    w = rng.uniform(0.5, 0.999, size=(2, s, 2, 16)).astype(np.float32)
    if zero_decay:
        w[:, 3] = 0.0
        w[:, 17, 1] = 0.0
    u = (rng.normal(size=(2, 16)) * 0.3).astype(np.float32)
    st = rng.normal(size=(2, 2, 16, 16)).astype(np.float32)
    return r, k, v, w, u, st


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zero-state", "carried-state"])
def test_wkv_chunked_matches_reference_and_scan(with_state):
    """S = 40 in chunks of 16 (padded to 48): y and the final state
    against the reference's ``wkv_chunked`` and the port's ``wkv_scan``,
    and the gradients of ``sum(y * ct) + sum(state)`` in r, k, v, w
    against ``jax.grad`` of the reference's; f32."""
    r, k, v, w, u, st = _wkv_inputs(2, 40)
    state = st if with_state else None
    ct = np.random.default_rng(3).normal(size=r.shape).astype(np.float32)

    def jf(a, b, c, d):
        y, s = jrwkv.wkv_chunked(a, b, c, d, jnp.asarray(u),
                                 None if state is None
                                 else jnp.asarray(state), chunk=16)
        return jnp.sum(y * ct) + jnp.sum(s)

    jval, jgrads = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, (r, k, v, w)))
    tst = None if state is None else torch.from_numpy(state)
    tu = torch.from_numpy(u)

    def f(a, b, c, d):
        y, s = rwkv.wkv_chunked(a, b, c, d, tu, tst, chunk=16)
        return (y * torch.from_numpy(ct)).sum() + s.sum()

    val, grads = _grads(f, [torch.from_numpy(x) for x in (r, k, v, w)])
    assert_close(val, jval, atol=F32_TOL, rtol=F32_TOL)
    for g, jg in zip(grads, jgrads):
        assert_close(g, jg, atol=F32_TOL, rtol=F32_TOL)
    args = [torch.from_numpy(x) for x in (r, k, v, w)] + [tu, tst]
    yc, sc = rwkv.wkv_chunked(*args, chunk=16)
    ys, ss = rwkv.wkv_scan(*args)
    jy, js = jrwkv.wkv_chunked(*map(jnp.asarray, (r, k, v, w, u)),
                               None if state is None else jnp.asarray(state),
                               chunk=16)
    assert_close(yc, jy, atol=F32_TOL, rtol=F32_TOL)
    assert_close(sc, js, atol=F32_TOL, rtol=F32_TOL)
    assert_close(yc, ys, atol=F32_TOL, rtol=F32_TOL)
    assert_close(sc, ss, atol=F32_TOL, rtol=F32_TOL)


def test_wkv_chunked_zero_decays_match_scan():
    """w == 0 exactly at some tokens: held against the sequential
    ``wkv_scan`` only (the reference's ``wkv_chunked`` flushes its
    subnormal clamp to 0 on the CPU and gives NaN there; ROADMAP
    reference-side caveats)."""
    r, k, v, w, u, st = _wkv_inputs(4, 40, zero_decay=True)
    args = [torch.from_numpy(x) for x in (r, k, v, w, u, st)]
    yc, sc = rwkv.wkv_chunked(*args, chunk=16)
    ys, ss = rwkv.wkv_scan(*args)
    assert torch.isfinite(yc).all()
    assert_close(yc, ys, atol=F32_TOL, rtol=F32_TOL)
    assert_close(sc, ss, atol=F32_TOL, rtol=F32_TOL)


# ---------------------------------------------------------------------------
# Model.loss
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _params(arch: str):
    """The reference's reduced parameters (vocab 128, PRNGKey(0)) and the
    port's copy; the activation dtype does not enter the init."""
    jp = jax.jit(j_build_model(tref.config(arch, "float32", jconfigs)).init)(
        jax.random.PRNGKey(0))
    return jp, weights.tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _models(arch: str, act: str):
    """(reference cfg, model, params; port cfg, model, params), reduced
    with vocab 128 and activation dtype ``act``; the port's params are
    the reference's."""
    jcfg = tref.config(arch, act, jconfigs)
    cfg = tref.config(arch, act, configs)
    return (jcfg, j_build_model(jcfg), *_params(arch)[:1], cfg,
            build_model(cfg), _params(arch)[1])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _loss_grads(m, p, batch, **kw):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in _flat(p).items()}

    def nest(flat):
        out = {}
        for key, v in flat.items():
            d = out
            *head, last = key.split("/")
            for part in head:
                d = d.setdefault(part, {})
            d[last] = v
        return out

    loss = m.loss(nest(leaves), batch, **kw)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss, dict(zip(leaves, grads))


@pytest.mark.parametrize("arch,act", LOSS_CASES)
def test_model_loss_and_grads_match_reference(arch, act):
    """``Model.loss`` (attention in KV chunks of 16 over 32 tokens; rwkv6
    through ``wkv_scan``) and its gradient in every leaf against
    ``jax.value_and_grad`` of the reference's: f32 within 1e-4. With bf16
    activations the two packages round at other places, so, as
    ``tests/test_torch_llm.py`` holds modules and whole models: the loss
    and each leaf's gradient within 0.05, the whole gradient (every leaf
    at once) within a relative L2 error of 3e-2 (measured 8.1e-3 for
    qwen3, 2.8e-2 for rwkv6, whose small mixing and bonus leaves reach
    up to 7.5e-2 alone)."""
    jcfg, jm, jp, cfg, m, p = _models(arch, act)
    jb = {k: jnp.asarray(v.numpy()) for k, v in token_batch(
        5, 2, 32, cfg.vocab, device="cpu").items()}
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    jval, jg = jax.jit(jax.value_and_grad(
        lambda q: jm.loss(q, jb, attn_chunk=16)))(jp)
    val, g = _loss_grads(m, p, batch, attn_chunk=16)
    jg = _flat(jax.tree.map(np.asarray, jg))
    assert sorted(g) == sorted(jg)
    if act == "float32":
        assert_close(val, jval, atol=F32_TOL, rtol=F32_TOL)
        for k in g:
            assert_close(g[k], jg[k], atol=F32_TOL, rtol=F32_TOL)
    else:
        assert_close(val, jval, atol=BF16_TOL, rtol=BF16_TOL)
        for k in g:
            assert_close(g[k], jg[k], atol=BF16_TOL, rtol=BF16_TOL)
        keys = sorted(g)
        assert rel_err(torch.cat([g[k].reshape(-1) for k in keys]),
                       np.concatenate([jg[k].reshape(-1) for k in keys])) \
            <= BF16_MODEL_REL


def test_model_loss_wkv_chunked_matches_reference():
    """rwkv6 with ``wkv_chunked=True`` (f32): loss and gradients against
    the reference's with the same flag within 1e-4."""
    jcfg, jm, jp, cfg, m, p = _models("rwkv6-1.6b", "float32")
    jb = {k: jnp.asarray(v.numpy()) for k, v in token_batch(
        6, 2, 40, cfg.vocab, device="cpu").items()}
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    jval, jg = jax.jit(jax.value_and_grad(
        lambda q: jm.loss(q, jb, wkv_chunked=True)))(jp)
    val, g = _loss_grads(m, p, batch, wkv_chunked=True)
    assert_close(val, jval, atol=F32_TOL, rtol=F32_TOL)
    jg = _flat(jax.tree.map(np.asarray, jg))
    for k in g:
        assert_close(g[k], jg[k], atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bitwise_no_remat(arch):
    """``remat=True`` recomputes each layer in the backward: the loss and
    every gradient bitwise those without it."""
    _, _, _, cfg, m, p = _models(arch, "bfloat16")
    batch = token_batch(7, 2, 32, cfg.vocab, device="cpu")
    v0, g0 = _loss_grads(m, p, batch, attn_chunk=16)
    v1, g1 = _loss_grads(m, p, batch, attn_chunk=16, remat=True)
    assert torch.equal(v0, v1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


def test_training_reaches_no_kernel(monkeypatch):
    """The training forward and backward of both families never call
    ``flash_attention`` or ``wkv6``: with both replaced by a function
    that raises, ``Model.loss`` and its gradients still run. The serving
    forward (``Model.logits``) does call them."""
    def boom(*a, **k):
        raise AssertionError("a kernel was reached")

    monkeypatch.setattr(ops, "flash_attention", boom)
    monkeypatch.setattr(ops, "wkv6", boom)
    for arch in ARCHS:
        _, _, _, cfg, m, p = _models(arch, "float32")
        batch = token_batch(8, 2, 16, cfg.vocab, device="cpu")
        _loss_grads(m, p, batch, attn_chunk=8)
        with pytest.raises(AssertionError, match="kernel was reached"):
            with torch.no_grad():
                m.logits(p, batch)


def test_kernel_wrappers_refuse_autograd():
    """Every kernel wrapper raises RuntimeError when grad mode is on and
    an input requires a gradient (no kernel has a backward), on the CPU
    as on the card, and runs under ``torch.no_grad()``."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 2, 8, 64), generator=g).requires_grad_(True)
    r = torch.randn((1, 16, 2, 64), generator=g).requires_grad_(True)
    w = torch.rand((1, 16, 2, 64), generator=g)
    u = torch.zeros((2, 64))
    bank = torch.randn((4, 10), generator=g).requires_grad_(True)
    ones, seg = torch.ones(4), torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    models = torch.randn((2, 10), generator=g).requires_grad_(True)
    calls = {
        "flash_attention": lambda: ops.flash_attention(q, q, q),
        "wkv6": lambda: ops.wkv6(r, r, r, w, u),
        "segment_agg": lambda: ops.segment_agg(bank, ones, seg, 2),
        "segment_sum_partial": lambda: ops.segment_sum_partial(
            bank, ones, seg, 2),
        "hier_agg": lambda: ops.hier_agg(bank, ones),
        "segment_broadcast": lambda: ops.segment_broadcast(models, seg),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()


def test_forward_hidden_act_spec_needs_a_mesh():
    _, _, _, cfg, _, p = _models("qwen3-1.7b", "float32")
    toks = token_batch(0, 1, 8, cfg.vocab, device="cpu")["tokens"]
    with pytest.raises(NotImplementedError, match="10 \\(b\\)"):
        transformer.forward_hidden(p, cfg, toks, attn_chunk=8,
                                   act_spec=("fsdp",))


# ---------------------------------------------------------------------------
# the HFL mesh and the PartitionSpecs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.all_arch_names())
def test_param_specs_match_reference(arch):
    """``serve_param_specs`` and ``hfl_param_specs`` (with the config's
    production topology, whose sizes drop what does not divide) leaf for
    leaf against the reference's ``PartitionSpec``s, on the reference's
    abstract parameter tree of the full config."""
    jcfg = jconfigs.get_config(arch)
    cfg = configs.get_config(arch)
    shapes = jax.eval_shape(j_build_model(jcfg).init,
                            jax.random.PRNGKey(0))
    m, d, f, t = jcfg.hfl_topology

    class Sizes:            # all either function reads of a mesh
        shape = {"pod": 1, "edge": m, "fl": d, "fsdp": f, "tp": t}

    pairs = [(jmesh.serve_param_specs(jcfg, shapes),
              mesh.serve_param_specs(cfg, shapes)),
             (jmesh.hfl_param_specs(jcfg, shapes, Sizes),
              mesh.hfl_param_specs(cfg, shapes, Sizes)),
             (jmesh.hfl_param_specs(jcfg, shapes),
              mesh.hfl_param_specs(cfg, shapes))]
    for want, got in pairs:
        flat, _ = jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert len(flat) == len(jax.tree.leaves(shapes))
        for path, spec in flat:
            g = got
            for key in path:
                g = g[getattr(key, "key", getattr(key, "idx", None))]
            assert g == tuple(spec), (path, g, spec)


def test_guard_divisibility_matches_reference():
    sizes = {"fsdp": 2, "tp": 4}
    for spec, shape in [((("fsdp", "tp"), None), (51865, 512)),
                        ((None, ("fsdp", "tp")), (512, 51864)),
                        ((None, "tp"), (6, 10)), (("tp",), (3,))]:
        want = jmesh._guard_divisibility(jax.sharding.PartitionSpec(*spec),
                                         shape, sizes)
        assert mesh._guard_divisibility(spec, shape, sizes) == tuple(want)


def test_hfl_mesh_one_device():
    """``make_hfl_mesh`` with no rank grid puts every replica on one
    device (fsdp = tp = 1; fsdp or tp above 1 needs a process group of
    that many ranks, ValueError without one); ``derive_hfl_mesh`` raises
    ValueError when the topology does not factor the devices, as the
    reference does, and over two devices, replicas, tp or fsdp ranks,
    needs a two-rank process group (``tests/test_torch_sharded.py::
    test_mesh_functions_over_the_ranks`` runs it in one)."""
    hm = mesh.make_hfl_mesh((1, 2, 2), device="cpu")
    assert hm.axis_names == mesh.HFL_AXES == jmesh.HFL_AXES
    assert hm.shape == {"pod": 1, "edge": 2, "fl": 2, "fsdp": 1, "tp": 1}
    assert mesh.n_replicas(hm) == (1, 2, 2)
    assert (hm.grid, hm.n_ranks, hm.coords, hm.block) == \
        ((1, 1, 1), 1, (0, 0, 0), (1, 2, 2))
    assert (mesh.REPLICA_AXES, mesh.TENSOR_AXES, mesh.SERVE_AXES) == \
        (jmesh.REPLICA_AXES, jmesh.TENSOR_AXES, jmesh.SERVE_AXES)
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        mesh.make_hfl_mesh((1, 2, 2), fsdp=2, device="cpu")
    with pytest.raises(ValueError, match="process group of 4 ranks"):
        mesh.make_hfl_mesh((1, 2, 2), tp=4, device="cpu")
    with pytest.raises(ValueError, match="does not factor"):
        mesh.derive_hfl_mesh(["cpu"], (2, 1, 1, 1))
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        mesh.derive_hfl_mesh(["cpu", "cpu"], (2, 1, 1, 1))
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        mesh.derive_hfl_mesh(["cpu", "cpu"], (1, 1, 1, 2))
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        mesh.derive_hfl_mesh(["cpu", "cpu"], (1, 1, 2, 1))
    assert mesh.derive_hfl_mesh(["cpu"], (1, 1, 1, 1)).shape["edge"] == 1
    if not torch.cuda.is_available():         # the default is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_hfl_mesh((1, 2, 2))


def test_production_layouts_match_reference():
    """``make_production_mesh`` and ``derive_serve_mesh`` give the shapes
    of the reference's ``tests/test_sharding.py::
    test_make_production_mesh_shapes`` with the ranks in row-major
    order; below 256 (512) ranks they raise ValueError, as
    ``jax.make_mesh`` does. The reference's ``derive_hfl_mesh(m2, (4, 4,
    1, 16))`` shards each replica over tp = 16 (``{"pod": 2, "edge": 4,
    "fl": 4, "fsdp": 1, "tp": 16}``): the port needs a process group of
    512 ranks for it (ValueError without one), and so does a topology
    with fsdp above 1 (qwen2-72b's (4, 2, 2, 16)); ``shardings`` of a
    tp-sharded spec over the serve layout (mesh serving) raises
    NotImplementedError (the tensor plane of item 10 (b))."""
    m1 = mesh.make_production_mesh(n_ranks=512)
    assert m1.shape == {"data": 16, "model": 16}
    assert np.array_equal(m1.ranks, np.arange(256).reshape(16, 16))
    m2 = mesh.make_production_mesh(multi_pod=True, n_ranks=512)
    assert m2.shape == {"pod": 2, "data": 16, "model": 16}
    assert np.array_equal(m2.ranks, np.arange(512).reshape(2, 16, 16))
    s = mesh.derive_serve_mesh(m1, 8)
    assert s.shape == {"pod": 1, "batch": 32, "tp": 8}
    assert np.array_equal(s.ranks, np.arange(256).reshape(1, 32, 8))
    assert mesh.derive_serve_mesh(m2, 16).shape == {"pod": 2, "batch": 16,
                                                    "tp": 16}
    with pytest.raises(ValueError, match="needs 512 ranks"):
        mesh.make_production_mesh(multi_pod=True, n_ranks=256)
    with pytest.raises(ValueError, match="needs 256 ranks, have 1"):
        mesh.make_production_mesh()
    with pytest.raises(ValueError, match="does not divide"):
        mesh.derive_serve_mesh(m1, 7)
    with pytest.raises(ValueError, match="process group of 512 ranks"):
        mesh.derive_hfl_mesh(["cpu"] * 512, (4, 4, 1, 16), n_pods=2)
    with pytest.raises(ValueError, match="process group of 512 ranks"):
        mesh.derive_hfl_mesh(["cpu"] * 512, (4, 2, 2, 16), n_pods=2)
    with pytest.raises(NotImplementedError, match="10 \\(b\\)"):
        mesh.shardings(s, {"w": (None, "tp")})
    assert mesh.rank_grid((1, 2, 2), 2) == (1, 1, 2)
    assert mesh.rank_grid((2, 4, 2), 8) == (1, 4, 2)
    with pytest.raises(ValueError, match="do not divide"):
        mesh.rank_grid((1, 2, 2), 3)


# ---------------------------------------------------------------------------
# the hierarchical train step
# ---------------------------------------------------------------------------

def _port_step(arch, act, dynamic, chunked, coll, reference):
    """The port's step on the reference's initial params; returns the
    lifted params after one round."""
    cfg = tref.config(arch, act, configs)
    init = np.load(os.path.join(reference, f"init-{arch}-{act}.npz"))
    p0 = {}
    for key in init.files:
        d = p0
        *head, last = key.split("/")
        for part in head:
            d = d.setdefault(part, {})
        d[last] = init[key]
    hm = mesh.make_hfl_mesh((1, 2, 2), device="cpu")
    kw = dict(tref.STEP, mb_per_epoch=tref.MB_PER_EPOCH[arch],
              wkv_chunked=chunked, collective_dtype=coll)
    kw.update(dict(dynamic=True, **tref.DYNAMIC) if dynamic else tref.STATIC)
    step, specs, bspec = train.make_hfl_train_step(cfg, hm, **kw)
    assert bspec == (("pod", "edge", "fl"),)
    assert specs["embed"][:3] == ("pod", "edge", "fl")
    params = train.lift_params(weights.tree_from_numpy(p0, "cpu"), 1, 2, 2)
    batch = token_batch(0, tref.BATCH, tref.SEQ, cfg.vocab, device="cpu")
    batch.update({k: torch.from_numpy(v) for k, v in tref.extras(cfg).items()})
    args = (tref.G1E, tref.G2E) if dynamic else ()
    return step(params, batch, *args)


@pytest.mark.parametrize("case", tref.CASES, ids=[c[0] for c in tref.CASES])
def test_train_step_matches_reference(reference, case):
    """One cloud round at (g1, g2) = (2, 2), or dynamic with per-edge
    g1e (1, 2), g2e (2, 1) under (3, 3) bounds, of reduced qwen3 / rwkv6
    / whisper-base / qwen2-vl on replicas (1, 2, 2): batch 8 x seq 32,
    two sequences per replica in 2 minibatches per epoch (qwen3,
    whisper, qwen2-vl) or 1 (rwkv6; ``tests/_torch_train_ref.py`` says
    why), lr 3e-3, KV chunks of 16; whisper's batch carries ``enc_embed``
    (8, 32, 256) and qwen2-vl's ``vision_embed`` (8, 16, 256), sliced
    into the minibatches as the tokens are. Every leaf against the
    reference's jitted step within 1e-4 (f32 activations) or 5e-3 (bf16),
    the four replicas bitwise equal after the round in both packages."""
    name, arch, act, dynamic, chunked, coll = case
    out = _port_step(arch, act, dynamic, chunked, coll, reference)
    want = np.load(os.path.join(reference, f"{name}.npz"))
    assert bool(want["__replicas_equal__"])
    got = _flat(out)
    assert sorted(got) == sorted(k for k in want.files
                                 if k != "__replicas_equal__")
    tol = F32_TOL if act == "float32" else STEP_BF16_TOL
    for k, leaf in got.items():
        rows = leaf.reshape((4,) + leaf.shape[3:])
        assert all(torch.equal(rows[r], rows[0]) for r in range(1, 4)), k
        assert_close(leaf[0, 0, 0], want[k], atol=tol, rtol=tol)


def test_dynamic_with_constant_gammas_is_bitwise_static():
    """A dynamic round with g1e = g2e = 2 on every edge under (3, 3)
    bounds is bitwise the static (2, 2) round, reduced qwen3, f32."""
    _, _, jp, cfg, m, p = _models("qwen3-1.7b", "float32")
    hm = mesh.make_hfl_mesh((1, 2, 2), device="cpu")
    batch = token_batch(1, tref.BATCH, 16, cfg.vocab, device="cpu")
    kw = dict(tref.STEP, attn_chunk=8, mb_per_epoch=2)
    static, _, _ = train.make_hfl_train_step(cfg, hm, **kw, **tref.STATIC)
    dyn, _, _ = train.make_hfl_train_step(cfg, hm, **kw, dynamic=True,
                                          **tref.DYNAMIC)
    a = static(train.lift_params(p, 1, 2, 2), batch)
    b = dyn(train.lift_params(p, 1, 2, 2), batch, np.full(2, 2),
            np.full(2, 2))
    fa, fb = _flat(a), _flat(b)
    assert all(torch.equal(fa[k], fb[k]) for k in fa)


def test_main_runs_on_the_cpu(capsys):
    """``main(["--device", "cpu", ...])``: reduced qwen3 at replicas
    (1, 2, 2), one static round and one dynamic, a finite loss each;
    ``--mesh single`` in a world smaller than its 256 ranks raises
    ValueError."""
    train.main(["--device", "cpu", "--rounds", "1", "--seq", "16",
                "--batch", "4", "--g1", "1", "--g2", "1"])
    train.main(["--device", "cpu", "--rounds", "1", "--seq", "16",
                "--batch", "4", "--g1", "1", "--g2", "1", "--dynamic",
                "--arch", "rwkv6-1.6b"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("round 0 loss=")]
    assert len(lines) == 2
    assert all(np.isfinite(float(ln.split("loss=")[1].split()[0]))
               for ln in lines)
    with pytest.raises(ValueError, match="256"):
        train.main(["--device", "cpu", "--mesh", "single"])


def test_main_trains_whisper_with_its_stub_input(capsys):
    """``main(["--arch", "whisper-base", "--device", "cpu", ...])``: the
    reduced whisper round with the batch's ``enc_embed``
    (``serve.stub_extras``), a finite loss; its full config's ``--mesh
    single`` (the published (8, 16, 2, 1), fsdp 2) in a world smaller
    than 256 ranks raises ValueError."""
    train.main(["--device", "cpu", "--rounds", "1", "--seq", "16",
                "--batch", "4", "--g1", "1", "--g2", "1", "--arch",
                "whisper-base"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("round 0 loss=")]
    assert len(lines) == 1
    assert np.isfinite(float(lines[0].split("loss=")[1].split()[0]))
    with pytest.raises(ValueError, match="256"):
        train.main(["--device", "cpu", "--mesh", "single", "--arch",
                    "whisper-base"])
