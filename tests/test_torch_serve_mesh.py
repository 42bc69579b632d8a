"""The port's serve layout against the reference's: ``_batch_axes``,
``serve_specs_for_params`` and ``cache_specs`` of ``launch/serve.py``
for every registered config, at the serve meshes the reference's dry run
lowers its steps on (``src/repro/launch/dryrun.py``): decode at ``tp =
hfl_topology[3]`` (2 for whisper-base), prefill at ``max(T, 256 // B)``
for the request batches 1, 8 and 32, each over a pod and over two
(``derive_serve_mesh`` of the production mesh), each with the cache of
batches 1, 8 and 32. Both packages' functions read only ``mesh.shape``,
so the reference gets a stand-in with the same ``.shape``; specs must
agree entry for entry (a ``PartitionSpec`` is a tuple of its entries).
Also the serve mesh's index of a leaf against ``np.split`` and the
refusals that need no process group. The gloo worlds that serve over a
mesh are in ``tests/test_torch_sharded.py`` (``test_serve_mesh_*``).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch import serve as jserve
from repro_torch.configs import all_arch_names, get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve
from repro_torch.models import tp as tp_mod

BATCHES = (1, 8, 32)
LAYOUTS = ["decode"] + [f"prefill-{b}" for b in BATCHES]


def _tp(arch: str, layout: str) -> int:
    """The dry run's tp of ``layout`` for ``arch``."""
    t = get_config(arch).hfl_topology[3]
    if layout == "decode":
        return 2 if arch == "whisper-base" else t
    return max(t, 256 // int(layout.split("-")[1]))


class _Stand:
    """All the reference's spec functions read of a mesh."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)


@functools.lru_cache(maxsize=None)
def _jspecs(arch: str, shape: tuple) -> tuple:
    """The reference's serve specs of ``arch`` at a serve mesh of
    ``shape`` ((pod, batch, tp)), as {path: entries}."""
    specs = jserve.serve_specs_for_params(
        j_get_config(arch), _Stand(zip(mesh_lib.SERVE_AXES, shape)))
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in flat}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _serve_mesh(tp: int, pods: int):
    return mesh_lib.derive_serve_mesh(
        mesh_lib.make_production_mesh(multi_pod=pods == 2,
                                      n_ranks=256 * pods), tp)


@pytest.mark.parametrize("pods", [1, 2], ids=["pod", "multi-pod"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", all_arch_names())
def test_serve_specs_match_reference(arch, layout, pods):
    """``serve_specs_for_params`` (shapes from the port's init on the
    meta device) and ``cache_specs`` at batches 1, 8 and 32 equal the
    reference's entry for entry, with ``_batch_axes`` of each batch;
    ``derive_serve_mesh`` lays the production mesh's ranks out as the
    reference does."""
    tp = _tp(arch, layout)
    mesh = _serve_mesh(tp, pods)
    assert isinstance(mesh, mesh_lib.RankMesh)
    shape = (pods, 256 // tp, tp)
    assert mesh.shape == dict(zip(mesh_lib.SERVE_AXES, shape))
    got = _flat(serve.serve_specs_for_params(get_config(arch), mesh))
    want = _jspecs(arch, shape)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k
    stand = _Stand(mesh.shape)
    for b in BATCHES:
        assert serve._batch_axes(mesh, b) == jserve._batch_axes(stand, b)
        jc = jserve.cache_specs(j_get_config(arch), stand, b)
        tc = serve.cache_specs(get_config(arch), mesh, b)
        assert sorted(tc) == sorted(jc)
        for k in jc:
            assert tc[k] == tuple(jc[k]), (b, k)


def test_fsdp_serve_reaches_the_merged_and_swapped_specs():
    """The specs above cover the reference's ``fsdp_serve`` branch:
    qwen2-72b at decode (T = 16, 72.7 B f32 parameters, 18 GB a rank)
    merges its vocabulary over ('batch', 'tp') (152,064 = 594 x 256) and,
    its d_ff of 29,568 not dividing 256, swaps the FFN's split onto the
    d_model rows, as it swaps attention's tp; qwen3-1.7b (2.0 GB a rank
    at T = 4) keeps plain tp."""
    big = _flat(serve.serve_specs_for_params(get_config("qwen2-72b"),
                                             _serve_mesh(16, 1)))
    assert big["embed"] == (("batch", "tp"), None)
    assert big["layers/mlp/w_up"] == (None, ("batch", "tp"), None)
    assert big["layers/attn/wq"] == (None, ("batch", "tp"), None)
    small = _flat(serve.serve_specs_for_params(get_config("qwen3-1.7b"),
                                               _serve_mesh(4, 1)))
    assert small["layers/mlp/w_up"] == (None, None, "tp")
    assert small["layers/attn/wq"] == (None, None, "tp")
    assert small["embed"] == ("tp", None)


@pytest.mark.parametrize("dims", [(1, 1, 4), (1, 2, 2), (2, 2, 2)])
def test_serve_index_is_np_split(dims):
    """Each rank's ``ServeMesh.index`` of a (pod, batch, tp) layout: a
    ``("pod", "batch")`` dimension in p B blocks, pod-major, a ``"batch"``
    one in B blocks (the same on every pod), a ``"tp"`` one in T blocks,
    ``None`` whole, as ``np.split`` cuts them; ranks row-major over the
    axes, tp the fastest."""
    p, b, t = dims
    a = np.arange(8 * 4 * 8 * 3).reshape(8, 4, 8, 3)
    for rank in range(p * b * t):
        m = mesh_lib.ServeMesh(dims=dims, device=torch.device("cpu"),
                               rank=rank)
        cp, cb, ct = np.unravel_index(rank, dims)
        assert m.coords == (cp, cb, ct) and m.tp_rank == ct
        idx = m.index((("pod", "batch"), "batch", "tp", None), a.shape)
        want = np.split(a, p * b, 0)[cp * b + cb]
        want = np.split(want, b, 1)[cb]
        want = np.split(want, t, 2)[ct]
        assert np.array_equal(a[idx], want)


def test_serve_index_refusals():
    """An entry over both 'batch' (of more than one rank) and 'tp' (the
    reference's ``fsdp_serve`` weights) raises ``NotImplementedError``
    naming item 10 (b); at one batch rank it is plain tp; a block that
    does not divide raises ``ValueError``."""
    m = mesh_lib.ServeMesh(dims=(1, 2, 2), device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="item 10 \\(b\\)"):
        m.index((None, ("batch", "tp")), (4, 8))
    one = mesh_lib.ServeMesh(dims=(1, 1, 2), device=torch.device("cpu"),
                             rank=1)
    assert one.index((None, ("batch", "tp")), (4, 8)) == (
        slice(None), slice(4, 8))
    with pytest.raises(ValueError):
        m.index(("tp",), (3,))


def test_one_device_serve_mesh_steps_match_the_plain_steps():
    """``make_serve_mesh(1, device="cpu")`` without a process group is
    one device: every index whole, no tp context, and the mesh steps'
    prefill and decode of reduced qwen3 (f32) equal the plain steps
    bitwise."""
    import dataclasses
    from repro_torch.data.synthetic import token_batch
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduce(),
                              activ_dtype="float32")
    m = mesh_lib.make_serve_mesh(1, device="cpu")
    assert m.shape == {"pod": 1, "batch": 1, "tp": 1}
    assert m.tp_context is None
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    toks = token_batch(1, 2, 12, cfg.vocab, "cpu")["tokens"]
    step, param_sh, batch_sh, (logits_sh, cache_sh) = \
        serve.make_prefill_step(cfg, m, batch=2, seq=8, max_new=4)
    assert all(all(s == slice(None) for s in idx)
               for idx in _flat(param_sh).values())
    assert batch_sh == (slice(None),) and logits_sh == (slice(None),) * 2
    dec, _, _, token_sh = serve.make_decode_step(cfg, m, batch=2,
                                                 cache_len=12)
    plain_pre = serve.make_prefill_step(cfg, max_new=4)
    plain_dec = serve.make_decode_step(cfg)
    with torch.no_grad():
        a, ca = step(params, {"tokens": toks[:, :8]})
        b, cb = plain_pre(params, {"tokens": toks[:, :8]})
        assert torch.equal(a, b)
        for i in range(8, 12):
            a, ca = dec(params, ca, toks[token_sh][:, i:i + 1])
            b, cb = plain_dec(params, cb, toks[:, i:i + 1])
            assert torch.equal(a, b)
    assert all(torch.equal(ca[k], cb[k]) for k in ("k", "v", "pos"))


@pytest.mark.parametrize("arch,exc", [
    ("rwkv6-1.6b", NotImplementedError), ("olmoe-1b-7b", NotImplementedError),
    ("qwen2-vl-7b", NotImplementedError), ("zamba2-7b", NotImplementedError),
    ("whisper-base", NotImplementedError)])
def test_check_serve_refuses_other_families(arch, exc):
    """Mesh serving of a family other than dense raises naming item 10
    (b), at any T."""
    for t in (1, 2):
        with pytest.raises(exc, match="item 10 \\(b\\)"):
            tp_mod.check_serve(get_config(arch).reduce(), t)


def test_check_serve_takes_dividing_heads_only():
    """Reduced qwen3 (4 heads over 2 kv heads) serves at T = 1 and 2; at
    T = 4 the kv heads do not divide (the reference would split the
    cache length): ``ValueError``."""
    cfg = get_config("qwen3-1.7b").reduce()
    tp_mod.check_serve(cfg, 1)
    tp_mod.check_serve(cfg, 2)
    with pytest.raises(ValueError, match="n_kv_heads=2"):
        tp_mod.check_serve(cfg, 4)
    tp_mod.check_serve(get_config("qwen3-1.7b"), 4)
