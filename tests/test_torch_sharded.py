"""The port's row-sharded bank over ``torch.distributed``: gloo process
groups of 1, 2 and 4 ranks on the CPU, case for case what
``tests/test_sharded_bank.py`` holds for the reference's mesh path.

Each world size is spawned once (``tests/_torch_dist_driver.py``, one
intra-op thread per rank) and runs every case; the module fixture
gathers every rank's results. Each case is held against the same
computation on one device (no context) -- bitwise where every edge's
rows lie on one rank, within 1e-5 where an edge spans ranks -- and
against the JAX package's single-device result on the same numpy
inputs, at the tolerance of the existing single-device parity test of
that function. Banks come back as each rank's rows; no rank may hold
more than ``N/k`` of them.
"""
import functools
import json
import os
import pickle
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_dist_driver as drv
import _torch_train_ref as tref
from _subproc import REPO, child_env
from _torch_parity import (jax_async_perm_sources, jax_env_perm_source,
                           jax_fedavg_perms, jax_round_perms)

from repro import configs as jconfigs
from repro.core import hfl as jhfl
from repro.launch import mesh as jmesh
from repro.launch import serve as jserve
from repro.core import sync as jsync
from repro.kernels import ref as jref
from repro.models import build_model as j_build_model
from repro.models import model as jmodel
from repro.runtime import AsyncConfig as JAsyncConfig
from repro.runtime import ChurnEvent as JChurnEvent
from repro.runtime import FaultSpec as JFaultSpec
from repro.runtime import StalenessBuffer as JStalenessBuffer
from repro.sim import env as jenv
from repro_torch import configs as tconfigs
from repro_torch.core import hfl
from repro_torch.kernels import ops, ref
from repro_torch.models import tp as tp_mod

WORLDS = (1, 2, 4)
MESH_CASES = [(w, s) for w in WORLDS for s in drv.MESHES[w]]
MESH_IDS = [f"{s[0]}x{s[1]}" for _, s in MESH_CASES]
F32_TOL = 1e-4                   # tests/test_torch_train.py's step bound
SEED = drv.TRAJ_CFG["seed"]
G = drv.TRAJ_CFG["gamma_max"]
N = drv.TRAJ_CFG["n_devices"]
N_LOCAL = drv.TRAJ_CFG["n_local"]
VERSIONS = 8                     # edge-round shuffles for versions 0..7
# the reference's train-step cases the multi-rank step is held against
TRAIN_CASES = {False: "qwen3-f32-static", True: "qwen3-f32-dynamic"}
RWKV_CASE = "rwkv6-f32-static"          # and the rwkv6 tp step


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat_tree(v, key) if isinstance(v, dict)
                   else {key: np.asarray(v)})
    return out


@functools.lru_cache(maxsize=None)
def _tp_params(arch=drv.TRAIN_ARCH, vocab=None):
    """The tensor plane's numpy parameters of ``drv.tp_config(arch,
    vocab)`` in the reference's tree (shapes from ``jax.eval_shape`` of
    its init, seed 7): norm scales 1 + 0.1 z (so that ``q_norm``'s and
    ``k_norm``'s gradients differ by head; RWKV6's ``ln_w``/``ln_b``
    likewise), the embedding 0.02 z, other vectors (whisper's biases and
    encoder norm) 0.1 z, other weights z / sqrt(fan-in); as (the JAX
    tree, the flat numpy leaves)."""
    jcfg = drv.tp_config(jconfigs, arch, vocab)
    rng = np.random.default_rng(7)
    shapes = jax.eval_shape(j_build_model(jcfg).init, jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = path[-1].key
        if name.startswith("ln") or name.endswith("norm"):
            a = 1.0 + 0.1 * rng.normal(size=leaf.shape)
        elif name == "embed":
            a = rng.normal(size=leaf.shape) * 0.02
        elif leaf.ndim == 1:
            a = rng.normal(size=leaf.shape) * 0.1
        else:
            a = rng.normal(size=leaf.shape) / np.sqrt(leaf.shape[-2])
        return a.astype(leaf.dtype)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return jax.tree.map(jnp.asarray, tree), _flat_tree(tree)


def _inputs() -> dict:
    """The reference's draws for the rounds and the envs, as numpy."""
    perm_source, edge_perm_source = jax_async_perm_sources(
        SEED, G, G, N, N_LOCAL)
    env_source = jax_env_perm_source(SEED, G, G, N, N_LOCAL)
    w0 = jmodel.mnist_cnn_init(jax.random.PRNGKey(SEED + 1000))
    return {
        "cloud_perms": jax_round_perms(jax.random.PRNGKey(0), 2, 3, 16, 8),
        "fedavg_perms": jax_fedavg_perms(jax.random.PRNGKey(1), 2, 16, 8),
        "edge_perms": jax_round_perms(jax.random.PRNGKey(3), 3, 3, 16, 8),
        "w0": {k: np.asarray(v) for k, v in w0.items()},
        "warm_perms": perm_source().numpy(),
        "async_perms": [edge_perm_source(v).numpy()
                        for v in range(VERSIONS)],
        "env_perms": [env_source().numpy()
                      for _ in range(drv.ENV_ROUNDS + 1)],
        # the reference's initial parameters of the reduced train step,
        # as its child process draws them
        "train_init": _train_init(drv.TRAIN_ARCH),
        "train_init_rwkv": _train_init(drv.RWKV_ARCH),
        "tp_params": {drv._fsdp_key(arch, vocab): _tp_params(arch, vocab)[1]
                      for arch, vocab in (
                          (drv.TRAIN_ARCH, None), (drv.RWKV_ARCH, None),
                          (drv.AUDIO_ARCH, None), (drv.AUDIO_ARCH, 515))},
    }


def _train_init(arch: str) -> dict:
    """The reference's initial parameters of ``arch``'s reduced train
    step, as ``tests/_torch_train_ref.py`` draws them."""
    return _flat_tree(jax.jit(j_build_model(tref.config(
        arch, "float32", jconfigs)).init)(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Torch on one intra-op thread in this process: a thread pool per
    xdist worker over the same cores slows the CPU cases many times."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: [rank 0's results, rank 1's, ...]}, and under "dirs" each
    world's directory and the reference's train-step results: the three
    worlds run at once, one driver process each, beside the reference's
    reduced qwen3 and rwkv6 train steps in a child process with 4 host devices
    (``tests/_torch_train_ref.py``), while this process computes the
    reference's env runs."""
    root = tmp_path_factory.mktemp("dist")
    inputs = root / "inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump(_inputs(), f)
    driver = os.path.join(REPO, "tests", "_torch_dist_driver.py")
    procs = {}
    for w in WORLDS:
        (root / f"w{w}").mkdir()
        procs[w] = subprocess.Popen(
            [sys.executable, driver, str(w), str(inputs),
             str(root / f"w{w}")], env=child_env(OMP_NUM_THREADS=1),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    (root / "train_ref").mkdir()
    ref_proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_torch_train_ref.py"),
         str(root / "train_ref"), *TRAIN_CASES.values(), RWKV_CASE],
        env=child_env(4, OMP_NUM_THREADS=1), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    _jtraj_all()
    _jenv_accs()
    out = {"dirs": {w: root / f"w{w}" for w in WORLDS}}
    _, err = ref_proc.communicate(timeout=900)
    assert ref_proc.returncode == 0, err[-4000:]
    out["dirs"]["train_ref"] = root / "train_ref"
    for w, p in procs.items():
        _, err = p.communicate(timeout=900)
        assert p.returncode == 0, err[-4000:]
        out[w] = []
        for r in range(w):
            with open(root / f"w{w}" / f"rank{r}.pkl", "rb") as f:
                out[w].append(pickle.load(f))
    return out


def _same(a, b) -> bool:
    """Bitwise (as torch.equal: -0 equals +0) for arrays, dicts, lists."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and bool(np.all(a == b))
    return a == b


def _rows(parts: list):
    """The ranks' row parts (arrays or dicts of arrays) joined in rank
    order: the whole bank, for comparison only."""
    if isinstance(parts[0], dict):
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    return np.concatenate(parts)


def _close(got, want, atol, rtol=0.0):
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for k in got:
            _close(got[k], want[k], atol, rtol)
        return
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol)


def _replicated(results: list, case: str, *key):
    """The value every rank returned for ``case`` (asserting they agree
    bitwise: the sharded results are replicated)."""
    vals = []
    for res in results:
        v = res[case]
        for k in key:
            v = v[k]
        vals.append(v)
    for v in vals[1:]:
        assert _same(v, vals[0])
    return vals[0]


def _nest(flat: dict) -> dict:
    """The driver's flat mixed-bank keys as the reference's nested tree."""
    return {"conv": {"w": flat["conv/w"], "b": flat["conv/b"]},
            "head": [flat["head/0"], flat["head/1"]]}


def _flat(tree) -> dict:
    return {"conv/w": tree["conv"]["w"], "conv/b": tree["conv"]["b"],
            "head/0": tree["head"][0], "head/1": tree["head"][1]}


def _jbank(leaves, bf16=()):
    return {k: jnp.asarray(v, jnp.bfloat16 if k in bf16 else jnp.float32)
            for k, v in leaves.items()}


def _f32(tree):
    return {k: np.asarray(v, np.float32) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# mesh construction, the context, the shims
# ---------------------------------------------------------------------------

def test_agg_context_construction_and_validation(runs):
    c = runs[1][0]["context"]
    assert c["single"] and c["for_mesh_none"] and c["for_mesh_str"]
    assert c["ctx1"] == (True, ("edge", "fl"), 1, 8)
    assert c["mesh1"] == (("edge", "fl"), {"edge": 1, "fl": 1}, 1, 0, "cpu")


def test_make_bank_mesh_needs_a_group_of_its_size(runs):
    assert runs[1][0]["context"]["mesh_2"]
    assert all(r["indivisible"]["mesh_5"] for r in runs[4])


def test_flatbank_placement_plumbing(runs):
    """``flatbank``'s row layout: rows per shard, this rank's slice, a
    placed bank's rows, replicated trees keeping their container type;
    on one device the context's placement is the identity."""
    c = runs[1][0]["context"]
    assert c["spec"] == (8, True, [4])
    assert c["replicated"] == [0.0, 1.0, 2.0, "list", True, True, True]
    for r in runs[4]:
        assert r["indivisible"]["local_rows_8"] == 2
        assert r["indivisible"]["local_rows_7"]


def test_entry_points_take_a_context_only(runs):
    """A one-rank context gives the one-device result; every entry point
    (weighted/edge/cloud aggregate, both round factories, the buffer,
    the env) raises TypeError for a ctx that is not an ``AggContext``
    (a bare ``BankMesh`` included); the buffer keeps the context it was
    given."""
    c = runs[1][0]["context"]
    assert c["ctx_equal"] and c["buffer_ctx"]
    assert c["bad_ctx"] == [True] * 7


def test_ledger_mesh_and_sharded_snapshot(runs):
    """The ledger's mesh description; ``save_runtime`` of an analytic env
    under a one-rank mesh no longer raises and writes the one-device
    env's snapshot: every array and the JSON equal."""
    c = runs[1][0]["context"]
    assert c["mesh_desc"] == {"axes": ["edge", "fl"],
                              "shape": {"edge": 1, "fl": 1}}
    assert c["single_desc"] == "single-chip"
    assert c["snapshot"] == (True, True)


# ---------------------------------------------------------------------------
# aggregation: sharded vs one device vs the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,shape", MESH_CASES, ids=MESH_IDS)
def test_weighted_aggregate_sharded_matches_oracle(runs, world, shape):
    """Mixed f32 + bf16 bank, P = 140, 5 edges on random rows: within the
    reference's 1e-5 (bf16 2e-2) of its tree oracle and of the one-device
    port; the one-device port within the parity test's 1e-6 of the
    reference's ``weighted_aggregate``; the same bits on every rank."""
    leaves, bf16, w, seg, m = drv.mixed_bank_inputs()
    got = _replicated(runs[world], "agg_mixed", shape)
    single = runs[world][0]["agg_mixed"]["single"]
    jb = _nest(_jbank(leaves, bf16))
    oracle = _flat(jref.weighted_aggregate_ref(jb, jnp.asarray(w),
                                               jnp.asarray(seg), m))
    want = _flat(jhfl.weighted_aggregate(jb, jnp.asarray(w),
                                         jnp.asarray(seg), m))
    for k in got:
        tol = 2e-2 if k in bf16 else 1e-5
        _close(got[k], np.asarray(oracle[k], np.float32), tol, tol)
        _close(got[k], single[k], tol, tol)
        _close(single[k], np.asarray(want[k], np.float32),
               2e-2 if k in bf16 else 1e-6)
    if world == 1:
        assert _same(got, single)


def test_uneven_edge_to_shard_split(runs):
    """Edge 0 spans ranks 0-2, edge 1 straddles ranks 2/3, edge 2 lies on
    rank 3 and edge 3 is empty: within 1e-5 of the oracle, the empty
    segment exactly zero, the one-rank edge bitwise the one-device one."""
    bank, w, seg, m = drv.uneven_inputs()
    got = _replicated(runs[4], "uneven", "got")["w"]
    single = runs[4][0]["uneven"]["single"]["w"]
    oracle = np.asarray(jref.weighted_aggregate_ref(
        {"w": jnp.asarray(bank["w"])}, jnp.asarray(w), jnp.asarray(seg),
        m)["w"])
    _close(got, oracle, 1e-5, 1e-5)
    _close(got, single, 1e-5, 1e-5)
    assert np.abs(got[3]).max() == 0.0
    assert _same(got[2], single[2])
    want = np.asarray(jhfl.weighted_aggregate(
        {"w": jnp.asarray(bank["w"])}, jnp.asarray(w), jnp.asarray(seg),
        m)["w"])
    _close(single, want, 1e-6)


@pytest.mark.parametrize("world", [2, 4], ids=["2x1", "2x2"])
def test_sharded_bf16_bank(runs, world):
    """A bf16 bank stays bf16 through the sharded path (f32 only inside
    the kernel and the collective)."""
    bank, w, seg, m = drv.bf16_inputs()
    shape = drv.MESHES[world][-1]
    res = _replicated(runs[world], "bf16", shape)
    assert runs[world][0]["bf16"]["dtype"] == "torch.bfloat16"
    assert res["dtypes"] == ["torch.bfloat16"] * 2
    jb = _jbank(bank, ("a", "b"))
    oracle = jref.weighted_aggregate_ref(jb, jnp.asarray(w),
                                         jnp.asarray(seg), m)
    _close(res["got"], _f32(oracle), 4e-2, 4e-2)
    _close(res["got"], runs[world][0]["bf16"]["single"], 4e-2, 4e-2)


@pytest.mark.parametrize("world", [2, 4])
def test_shard_local_broadcast_matches_ref(runs, world):
    """The shard-local resync: replicated (E, P) models onto each rank's
    rows only, bitwise the gather oracle."""
    models, seg = drv.broadcast_inputs()
    parts = [r["broadcast"]["rows"] for r in runs[world]]
    assert {r["broadcast"]["shape"] for r in runs[world]} \
        == {(16 // world, 137)}
    want = np.asarray(jref.segment_broadcast_ref(jnp.asarray(models),
                                                 jnp.asarray(seg)))
    assert _same(_rows(parts), want)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_cloud_aggregate_replicated_bitwise(runs, k):
    """Eq. 2 under a mesh is the plain launch on every rank: bitwise the
    one-device result for any shard count, 3 (a subgroup of the 4-rank
    world, E = 4 not divisible) included; within the parity test's 1e-6
    of the reference."""
    ranks = runs[2] if k == 2 else runs[4][:k] if k == 3 else runs[4]
    for r in ranks:
        assert r["cloud_agg"][f"equal-{k}"]
        assert _same(r["cloud_agg"][k], r["cloud_agg"]["single"])
    em, esz = drv.cloud_agg_inputs()
    want = jhfl.cloud_aggregate({"w": jnp.asarray(em)}, jnp.asarray(esz))
    _close(ranks[0]["cloud_agg"]["single"]["w"], np.asarray(want["w"]), 1e-6)


@pytest.mark.parametrize("n,k,m", [(16, 2, 4), (16, 4, 4), (50, 5, 5),
                                   (40, 4, 4)])
def test_plain_sums_of_aligned_shards_are_the_whole_banks_bits(n, k, m):
    """The CPU path of ``segment_agg_sharded`` on edge-aligned shards,
    its ``all_reduce`` done by hand: the ranks' plain partial sums and
    weight sums added (one non-zero term per segment, so any order) and
    multiplied by the reciprocal are bitwise the one-device
    ``segment_agg``, for 20 random banks and weights each. It rests on
    the CPU path adding the weights in f64, where the sums are exact
    over any subset of rows, as the kernel's one chain per segment is
    over a shard's rows; f32 sums of a shard's rows and of all rows
    associate differently."""
    for seed in range(20):
        rng = np.random.default_rng(seed)
        bank = torch.from_numpy(rng.normal(size=(n, 33)).astype(np.float32))
        w = torch.from_numpy(rng.uniform(0.1, 3.0, n).astype(np.float32))
        seg = torch.from_numpy(np.repeat(np.arange(m), n // m).astype(
            np.int32))
        per = n // k
        parts = [ops.segment_sum_partial(bank[r * per:(r + 1) * per],
                                         w[r * per:(r + 1) * per],
                                         seg[r * per:(r + 1) * per], m)
                 for r in range(k)]
        sums, wsum = parts[0]
        for s, ws in parts[1:]:
            sums, wsum = sums + s, wsum + ws
        got = sums * (1.0 / wsum.clamp_min(1e-9))[:, None]
        assert torch.equal(got, ops.segment_agg(bank, w, seg, m)), seed


# ---------------------------------------------------------------------------
# staleness-weighted flushes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_flush(kind):
    vecs, w, tau, anchor, m_w = drv.flush_inputs(kind)
    k = len(vecs) + (anchor is not None)
    buf = JStalenessBuffer(k, decay="poly", decay_a=0.5)
    for j in range(len(vecs)):
        buf.push(j, jnp.asarray(vecs[j]), float(w[j]),
                 version=10 - int(tau[j]))
    kw = {} if anchor is None else dict(anchor=jnp.asarray(anchor),
                                        anchor_weight=m_w)
    return np.asarray(buf.flush(version=10, **kw)[0])


@pytest.mark.parametrize("kind", ["stale", "degraded"])
@pytest.mark.parametrize("world,shape", MESH_CASES, ids=MESH_IDS)
def test_flush_sharded_matches_oracle_and_is_bitwise(runs, world, shape,
                                                    kind):
    """The async flush (staleness folded into the weights; degraded: 7
    survivors plus the anchor row) runs replicated under a mesh: bitwise
    the one-device flush at any shard count, within 1e-5 of the numpy
    oracle and of the reference's flush."""
    vecs, w, tau, anchor, m_w = drv.flush_inputs(kind)
    res = _replicated(runs[world], "flushes", kind, shape)
    assert res["equal"] and res["staleness"] == tau.tolist()
    if kind == "stale":
        want = ref.staleness_aggregate_ref(vecs, w, tau, decay="poly", a=0.5)
    else:
        assert 0.0 < res["coverage"] < 1.0
        want = ref.coverage_aggregate_ref(vecs, w, tau, anchor, m_w,
                                          decay="poly", a=0.5)
    _close(res["got"], want, 1e-5, 1e-5)
    _close(res["got"], _reference_flush(kind), 1e-5, 1e-5)


def test_staleness_flush_indivisible_k_is_bitwise(runs):
    """K = 5 on 4 ranks: the flush is the plain launch on every rank, so
    bitwise the one-device ``segment_agg``."""
    res = _replicated(runs[4], "flushes", "indivisible")
    assert res["equal"]
    vecs, w, *_ = drv.flush_inputs("indivisible")
    want = jref.segment_agg_ref(jnp.asarray(vecs), jnp.asarray(w),
                                jnp.zeros((5,), jnp.int32), 1)[0]
    _close(res["got"], np.asarray(want), 1e-6)


# ---------------------------------------------------------------------------
# rounds (training on)
# ---------------------------------------------------------------------------

def _jloss(p, batch):
    return jnp.mean((batch["x"] @ p["w"][..., 0] - batch["y"]) ** 2)


@functools.lru_cache(maxsize=None)
def _jcloud_round(aligned):
    bank, x, y, sizes, seg, m, g1, g2 = drv.cloud_round_inputs(aligned)
    rnd = jhfl.make_cloud_round(_jloss, 0.05, 4, m, 3, 2)
    b, g, e = rnd({k: jnp.asarray(v) for k, v in bank.items()},
                  jnp.asarray(x), jnp.asarray(y), jnp.asarray(sizes),
                  jnp.asarray(seg), jnp.asarray(g1), jnp.asarray(g2),
                  jax.random.PRNGKey(0))
    return _f32(b), _f32(g), _f32(e)


@pytest.mark.parametrize("aligned", [False, True],
                         ids=["spanning", "aligned"])
@pytest.mark.parametrize("world,shape", MESH_CASES, ids=MESH_IDS)
def test_cloud_round_sharded_matches_single_chip(runs, world, shape,
                                                 aligned):
    """A cloud round of the linear fixture with local SGD on, the
    reference's shuffles: bank rows, global and edge models bitwise the
    one-device round when every edge lies on one rank, within 1e-5 when
    edges span ranks; the one-device round within the parity test's
    rtol 1e-4 / atol 1e-5 of the reference's."""
    res = [r["cloud_round"][aligned] for r in runs[world]]
    single = res[0]["single"]
    bank = _rows([r[shape][0] for r in res])
    glob = _replicated(runs[world], "cloud_round", aligned, shape, 1)
    edges = _replicated(runs[world], "cloud_round", aligned, shape, 2)
    got = (bank, glob, edges)
    if aligned:
        assert _same(got, single)
    else:
        for a, b in zip(got, single):
            _close(a, b, 1e-5, 1e-5)
    for a, b in zip(single, _jcloud_round(aligned)):
        _close(a, b, 1e-5, 1e-4)


def test_fedavg_round_sharded_matches_single_chip(runs):
    """FedAvg's one segment spans all 4 ranks: bank and global model
    within 1e-5 of the one-device round, which is within the parity
    test's 1e-5 of the reference's."""
    res = [r["fedavg"] for r in runs[4]]
    bank = _rows([r["sharded"][0] for r in res])
    glob = res[0]["sharded"][1]
    _close(bank, res[0]["single"][0], 1e-5, 1e-5)
    _close(glob, res[0]["single"][1], 1e-5, 1e-5)
    bank0, x, y, sizes, part = drv.fedavg_inputs()
    rnd = jhfl.make_fedavg_round(_jloss, 0.05, 4, max_g1=2)
    jb, jg = rnd({k: jnp.asarray(v) for k, v in bank0.items()},
                 jnp.asarray(x), jnp.asarray(y), jnp.asarray(sizes),
                 jnp.asarray(part), jnp.asarray(2), jax.random.PRNGKey(1))
    _close(res[0]["single"][0], _f32(jb), 1e-5)
    _close(res[0]["single"][1], _f32(jg), 1e-5)


def test_sharded_round_never_materializes_full_bank(runs):
    """Each of 4 ranks holds N/4 = 4 rows of the placed bank and of the
    cloud and edge rounds' output banks; global and edge models and the
    edge vector come back whole; the round updates the rank's rows in
    place, and a clone passed in instead leaves them untouched and gives
    the same result."""
    for r in runs[4]:
        p = r["placement"]
        assert p["placed_rows"] == p["out_rows"] == p["edge_out_rows"] \
            == [4]
        assert p["bank_mat_rows"] == 4
        assert p["glob_shapes"] == [(3,), (4, 3)]
        assert p["edge_shapes"] == [(4, 3), (4, 4, 3)]
        assert p["evec_shape"] == (15,)
        assert p["in_place"] and p["copy_untouched"] and p["copy_equal"]


def test_round_rejects_indivisible_rows(runs):
    """10 rows on 4 ranks: placing them raises, and so does a sharded
    round handed a bank that is not a rank's N/k rows."""
    for r in runs[4]:
        i = r["indivisible"]
        assert i["place_bank"] and i["place_rows"] and i["round"]


@functools.lru_cache(maxsize=None)
def _jedge_rounds():
    bank, x, y, sizes, seg, gvec = drv.edge_round_inputs()
    rnd = jhfl.make_edge_round(_jloss, 0.05, 4, 4, 3, 3)
    out = []
    for j in range(4):
        b, e = rnd({k: jnp.asarray(v) for k, v in bank.items()},
                   jnp.asarray(x), jnp.asarray(y), jnp.asarray(sizes),
                   jnp.asarray(seg), jnp.int32(j), jnp.int32(2),
                   jnp.int32(2), jnp.asarray(gvec), jax.random.PRNGKey(3))
        out.append((_f32(b), np.asarray(e)))
    return out


@pytest.mark.parametrize("world,shape", MESH_CASES, ids=MESH_IDS)
def test_edge_round_sharded_bitwise(runs, world, shape):
    """The async edge round of each of 4 edge-aligned edges: the edge
    vector (the same on every rank) and the bank bitwise the one-device
    round's; the one-device round within the parity test's 1e-5 of the
    reference's."""
    res = [r["edge_round"] for r in runs[world]]
    single = res[0]["single"]
    for j in range(4):
        bank = _rows([r[shape][j][0] for r in res])
        evec = _replicated(runs[world], "edge_round", shape, j, 1)
        assert _same(evec, single[j][1]) and _same(bank, single[j][0])
    for (b, e), (jb, je) in zip(single, _jedge_rounds()):
        _close(e, je, 1e-5)
        _close(b, jb, 1e-5)


@pytest.mark.parametrize("world,shape", MESH_CASES[1:], ids=MESH_IDS[1:])
def test_masked_resync_sharded_churn_join_bitwise(runs, world, shape):
    """Churn-join: edge 1's rows take its edge model, each rank writing
    its own rows; bitwise the one-device resync and the reference's."""
    bank_mat, edge_mat, seg = drv.resync_inputs()
    res = [r["resync"] for r in runs[world]]
    got = _rows([r[shape] for r in res])
    assert {r[shape].shape[0] for r in res} == {16 // world}
    assert _same(got, res[0]["single"])
    alive = np.arange(4) == 1
    want = jhfl.masked_resync(jnp.asarray(edge_mat), jnp.asarray(bank_mat),
                              jnp.asarray(seg), jnp.asarray(alive))
    assert _same(got, np.asarray(want))


# ---------------------------------------------------------------------------
# the envs end to end
# ---------------------------------------------------------------------------

def _jtraj(kind):
    """The reference's single-device trajectory of ``kind`` (its own key
    chain, which ``_inputs`` replays for the port)."""
    if kind == "clean":
        acfg, spec = JAsyncConfig(buffer_k=2, decay="none"), JFaultSpec(
            seed=3)
    else:
        acfg = JAsyncConfig(buffer_k=3, flush_deadline=20.0)
        spec = JFaultSpec(drop_prob=0.6,
                          churn=(JChurnEvent(30.0, 1, "leave"),
                                 JChurnEvent(60.0, 1, "join")), seed=5)
    env = jenv.AsyncHFLEnv(jenv.EnvConfig(**drv.TRAJ_CFG), acfg, faults=spec)
    env.set_topology(drv.TRAJ_ASSIGN)
    env.reset()
    traj = []
    for _ in range(drv.TRAJ_RUNS[kind]):
        _, _, done, info = env.step(np.array([2.0, 2.0]))
        traj.append((info["acc"], info["edge"], info["flushed"],
                     info["dropped"]))
        if done:
            break
    return traj, np.asarray(env._global_vec)


@functools.lru_cache(maxsize=None)
def _jtraj_all():
    return {kind: _jtraj(kind) for kind in drv.TRAJ_RUNS}


@pytest.fixture(scope="module")
def jtraj():
    return _jtraj_all()


@pytest.mark.parametrize("kind", ["clean", "faults"])
@pytest.mark.parametrize("world", WORLDS)
def test_async_env_trajectory_sharded_bitwise(runs, jtraj, world, kind):
    """MNIST ``AsyncHFLEnv`` (``TRAJ_CFG``, edge-aligned, deterministic
    mode) with an all-zeros spec (4 events) or with drops, deadline
    flushes and a leave + join of edge 1 (6 events): every event, the
    global vector and the bank bitwise the one-rank run, no rank ever
    holding more than N/k bank rows; the one-rank run against the
    reference's: acc within 0.002 at every event, the same edges,
    flushes and drops, the global vector within 1e-5."""
    single = runs[1][0]["traj"][(kind, "single")]
    res = [r["traj"][(kind, "sharded")] for r in runs[world]]
    for r in res:
        assert r["traj"] == single["traj"] and r["reset_acc"] \
            == single["reset_acc"] and r["degraded"] == single["degraded"]
        assert _same(r["gvec"], single["gvec"])
        assert all(rows == [N // world] for rows in r["rows"])
    assert _same(_rows([r["bank"] for r in res]), single["bank"])
    if kind == "faults":
        assert single["degraded"] >= 1 and any(t[4] for t in single["traj"])
    jt, jvec = jtraj[kind]
    assert len(jt) == len(single["traj"])
    for (_, acc, edge, flushed, dropped), (jacc, jedge, jfl, jdr) in zip(
            single["traj"], jt):
        assert abs(acc - jacc) <= 0.002
        assert (edge, flushed, dropped) == (jedge, jfl, jdr)
    _close(single["gvec"], jvec, 1e-5)


def test_async_env_telemetry_on_equals_off_sharded(runs):
    """2 ranks, the faulty trajectory with telemetry on: every event, the
    global vector and the bank bitwise the telemetry-off run's."""
    for r in runs[2]:
        on, off = r["traj"][("faults", "telemetry")], \
            r["traj"][("faults", "sharded")]
        assert on["trace"] > 0 and off["trace"] == 0
        assert on["traj"] == off["traj"]
        assert _same(on["gvec"], off["gvec"]) and _same(on["bank"],
                                                        off["bank"])


@pytest.mark.parametrize("world", [1, 2])
def test_hflenv_sharded_matches_one_rank(runs, world):
    """The synchronous ``HFLEnv`` (``TRAJ_CFG``, deterministic) on a
    mesh: reset plus two (2, 2) rounds, accuracies, global model and bank
    bitwise the one-rank env's, N/k rows per rank; the one-rank env's
    accuracies within 0.002 of the reference's."""
    single = runs[1][0]["hflenv"]["single"]
    res = [r["hflenv"]["sharded"] for r in runs[world]]
    for r in res:
        assert r["accs"] == single["accs"] and _same(r["gvec"],
                                                     single["gvec"])
        assert r["rows"] == [N // world] and r["device"] == "cpu"
    assert _same(_rows([r["bank"] for r in res]), single["bank"])
    jaccs = _jenv_accs()
    assert max(abs(a - b) for a, b in zip(single["accs"], jaccs)) <= 0.002


@functools.lru_cache(maxsize=None)
def _jenv_accs():
    je = jenv.HFLEnv(jenv.EnvConfig(**drv.TRAJ_CFG))
    je.set_topology(drv.TRAJ_ASSIGN)
    je.reset()
    return [je.acc] + [je.step_raw(np.full(4, 2), np.full(4, 2))[3]["acc"]
                       for _ in range(drv.ENV_ROUNDS)]


def _fault3_bitwise(runs, world: int, case: str) -> None:
    res = [r[case] for r in runs[world]]
    single = res[0]["single"]
    gvec = _replicated(runs[world], case, "sharded", "gvec")
    assert _same(gvec, single["gvec"])
    assert _same(_rows([r["sharded"]["bank"] for r in res]), single["bank"])
    assert all(r["sharded"]["acc"] == single["acc"] for r in res)
    n = single["bank"].shape[0]
    assert all(r["sharded"]["rows"] == [n // world] for r in res)


def test_one_row_per_rank_cnn_round_bitwise(runs):
    """Fault 3 closed (ROADMAP section 3), the one-row case: 4 MNIST
    devices on 4 ranks, one bank row and one edge each; the deterministic
    trainer's calls are each edge's rows (``hfl.train_calls``), one row
    on one device as on the ranks, so the reset plus one (2, 2) round
    gives the global model, the bank and the accuracy bitwise, the same
    on every rank."""
    _fault3_bitwise(runs, 4, "one_row")


def test_spanning_edge_cnn_round_bitwise(runs):
    """Fault 3 closed, the non-aligned case: 10 MNIST devices on 2 ranks
    of 5 rows, edge 1 (rows 3-6) spanning them and so its 4-row training
    call. Each rank pads its half of the call; Eq. 1 of
    the deterministic round chains the ranks' sums in row order
    (``ops.segment_agg_ordered``). Global model, bank and accuracy
    bitwise the one-device round."""
    _fault3_bitwise(runs, 2, "spanning")


@pytest.mark.parametrize("groups,sizes", [
    (np.zeros(47, np.int64), [16, 16, 15]),      # prime N: no 1-row calls
    (np.zeros(50, np.int64), [13, 13, 12, 12]),
    (np.arange(50) % 5, [10] * 5),               # edges scattered over rows
    (np.repeat([2, 0, 1], [3, 20, 3]), [20 // 2] * 2 + [3, 3]),
], ids=["prime", "one-group", "round-robin", "uneven"])
def test_train_calls_chunk_each_edge(groups, sizes):
    """The deterministic trainer's calls: each edge's global rows in
    ascending order, in chunks of at most ``TRAIN_CALL_ROWS`` of
    near-equal size, every row in exactly one call."""
    calls = hfl.train_calls(groups)
    assert [c.size for c in calls] == sizes
    assert np.array_equal(np.sort(np.concatenate(calls)),
                          np.arange(groups.size))
    for c in calls:
        assert np.all(np.diff(c) > 0) and np.unique(groups[c]).size == 1
        assert c.size <= hfl.TRAIN_CALL_ROWS


def test_deterministic_edge_round_trains_its_edge_chunks_only():
    """A deterministic edge round on scattered edges (40 rows, edge =
    row % 2) makes one ``vmap(grad)`` call per chunk of its edge per
    step, two here, where the cloud round makes four; and it returns
    the edge's row of the cloud round's edge matrix bitwise."""
    n, m, n_local, bs = 40, 2, 8, 4
    calls = []

    def loss(p, batch):
        calls.append(1)
        return torch.mean((batch["x"] @ p["w"][..., 0] - batch["y"]) ** 2)

    g = torch.Generator().manual_seed(0)
    bank = {"w": torch.randn(n, 3, 1, generator=g)}
    x = torch.randn(n, n_local, 3, generator=g)
    y = torch.randn(n, n_local, generator=g)
    sizes = torch.full((n,), float(n_local))
    ea = torch.as_tensor(np.arange(n) % m, dtype=torch.int32)
    perms = torch.rand((1, 1, n, n_local), generator=g).argsort(-1)
    steps = n_local // bs
    cloud = hfl.make_cloud_round(loss, 0.05, bs, m, 1, 1, deterministic=True)
    _, _, edges = cloud({"w": bank["w"].clone()}, x, y, sizes, ea,
                        np.ones(m), np.ones(m), perms)
    assert len(calls) == 4 * steps
    calls.clear()
    edge = hfl.make_edge_round(loss, 0.05, bs, m, 1, 1, deterministic=True)
    _, vec = edge({"w": bank["w"].clone()}, x, y, sizes, ea, 1, 1, 1,
                  bank["w"][1].reshape(-1).clone(), perms)
    assert len(calls) == 2 * steps
    # the edge starts from row 1's model, the cloud round from each row's
    start = {"w": bank["w"].clone()}
    start["w"][ea == 1] = bank["w"][1]
    _, _, edges = cloud(start, x, y, sizes, ea, np.ones(m), np.ones(m),
                        perms)
    assert torch.equal(vec, edges["w"][1].reshape(-1))


# ---------------------------------------------------------------------------
# sharded snapshots, share on a sharded env, the multi-rank train step and
# the mesh functions
# ---------------------------------------------------------------------------

SNAP_LAYOUTS = [(2, (2, 1)), (4, (4, 1)), (4, (2, 2))]
SNAP_IDS = [f"{s[0]}x{s[1]}" for _, s in SNAP_LAYOUTS]


def _npz(path) -> dict:
    with np.load(f"{path}.npz") as d:
        return {k: d[k] for k in d.files}


@pytest.mark.parametrize("world,shape", SNAP_LAYOUTS, ids=SNAP_IDS)
def test_sharded_snapshot_resume_is_uninterrupted_bitwise(runs, world,
                                                          shape):
    """``TRAJ_CFG``'s faulty trajectory in deterministic mode on k ranks,
    saved after 3 of its 6 events: a fresh sharded env that loads the
    snapshot runs the other 3 with every event, the global vector and
    every rank's bank rows bitwise the uninterrupted run's, N/k rows on
    each rank; the uninterrupted run is the one-device run's, bitwise."""
    res = [r["snapshot"][shape] for r in runs[world]]
    for r in res:
        assert r["resumed"]["traj"] == r["whole"]["traj"]
        assert _same(r["resumed"]["gvec"], r["whole"]["gvec"])
        assert _same(r["resumed"]["bank"], r["whole"]["bank"])
        assert r["resumed"]["rows"] == r["whole"]["rows"] == [N // world]
    single = runs[1][0]["snapshot"]["single"]
    assert single["resumed"]["traj"] == single["whole"]["traj"]
    for r in res:
        assert r["head"] == single["head"]
        assert r["whole"]["traj"] == single["whole"]["traj"]
        assert _same(r["whole"]["gvec"], single["whole"]["gvec"])
    assert _same(_rows([r["whole"]["bank"] for r in res]),
                 single["whole"]["bank"])


@pytest.mark.parametrize("world,shape", [(1, (1, 1))] + SNAP_LAYOUTS,
                         ids=["1x1"] + SNAP_IDS)
def test_sharded_snapshot_is_the_one_device_snapshot(runs, world, shape):
    """The files a sharded env writes at event 3 are the one-device env's
    at the same event: the npz's keys, shapes, dtypes and values bitwise
    (the bank gathered in row order), and the JSON equal. So the
    one-device loaders, the port's and the reference's, read it as a
    one-device snapshot."""
    one = _npz(runs["dirs"][1] / "snap-single")
    got = _npz(runs["dirs"][world] / f"snap-{shape[0]}x{shape[1]}")
    assert sorted(got) == sorted(one)
    assert any(k.startswith("bank/") for k in one)
    for k in one:
        assert got[k].dtype == one[k].dtype and _same(got[k], one[k]), k
    with open(runs["dirs"][1] / "snap-single.json") as f:
        want = json.load(f)
    with open(runs["dirs"][world] / f"snap-{shape[0]}x{shape[1]}.json") as f:
        assert json.load(f) == want


def test_sharded_snapshot_loads_across_layouts(runs):
    """2 ranks: the one-device snapshot of event 3 loads into a sharded
    env and the sharded snapshot into a one-device env; each runs the
    last 3 events bitwise the uninterrupted sharded run (the one-device
    bank is its ranks' rows joined)."""
    whole = [r["snapshot"][(2, 1)]["whole"] for r in runs[2]]
    for r, w in zip(runs[2], whole):
        into_sharded = r["snapshot"]["cross"]["into_sharded"]
        into_single = r["snapshot"]["cross"]["into_single"]
        assert into_sharded["traj"] == into_single["traj"] == w["traj"]
        assert _same(into_sharded["gvec"], w["gvec"])
        assert _same(into_single["gvec"], w["gvec"])
        assert _same(into_sharded["bank"], w["bank"])
        assert into_sharded["rows"] == [N // 2] and into_single["rows"] == [N]
        assert _same(into_single["bank"], _rows([x["bank"] for x in whole]))


@pytest.mark.parametrize("world", [4])
def test_share_topology_sharded_matches_reference(runs, world):
    """``share_topology`` on a sharded ``TRAJ_CFG`` env gathers the ranks'
    labels (the one-device env's, bitwise) and returns, on every rank,
    the reference's ``repro.core.sync.share_topology`` assignment on
    them (called on a stub holding the labels and the config, all it
    reads) and the one-device env's; the deterministic (2, 2) round after
    it is bitwise the one-device round, N/k rows per rank."""
    single = runs[world][0]["share"]["single"]
    stub = types.SimpleNamespace(
        fed=types.SimpleNamespace(y=single["y"]),
        cfg=types.SimpleNamespace(n_devices=N,
                                  n_edges=drv.TRAJ_CFG["n_edges"]))
    want = jsync.share_topology(stub)
    assert np.array_equal(single["assign"], want)
    for r in runs[world]:
        sh = r["share"]["sharded"]
        assert _same(sh["y"], single["y"])
        assert np.array_equal(sh["assign"], want)
        assert sh["acc"] == single["acc"] and _same(sh["gvec"],
                                                    single["gvec"])
        assert sh["rows"] == [N // world]
    assert _same(_rows([r["share"]["sharded"]["bank"] for r in runs[world]]),
                 single["bank"])


TRAIN_LAYOUTS = [(1, (1, 1, 1)), (2, (1, 1, 2)), (2, (1, 2, 1)),
                 (4, (1, 2, 2))]
TRAIN_IDS = ["one-device"] + [f"{w}ranks-{g[0]}{g[1]}{g[2]}"
                              for w, g in TRAIN_LAYOUTS[1:]]


def _train_launches(block, coords, dynamic: bool, n_leaves: int) -> dict:
    """One rank's launches of each kernel in a round: an Eq. 1 per edge
    period in which one of its edges is active (one broadcast, or one per
    active (pod, edge) when not all are), and Eq. 2."""
    agg = bcast = 1 + (tref.STATIC["g2"] if not dynamic else 0)
    if dynamic:
        be, e0 = block[1], coords[1] * block[1]
        for t2 in range(tref.DYNAMIC["max_g2"]):
            act = (t2 < tref.G2E)[e0:e0 + be]
            if act.any():
                agg += 1
                bcast += 1 if act.all() else int(act.sum()) * block[0]
    return {"segment_agg": agg * n_leaves,
            "segment_broadcast": bcast * n_leaves}


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
@pytest.mark.parametrize("world,grid", TRAIN_LAYOUTS, ids=TRAIN_IDS)
def test_multi_rank_train_step_matches_reference(runs, world, grid,
                                                  dynamic):
    """Reduced qwen3 (f32 activations, ``tests/_torch_train_ref.py``'s
    settings) on replicas (1, 2, 2) spread over the rank grid, one
    static (2, 2) round or the dynamic one: every leaf of replica (0, 0,
    0) within 1e-4 of the reference's jitted step, plain and in
    deterministic mode; in deterministic mode bitwise the one-device port
    step; all four replicas bitwise equal on every rank after the round;
    each rank's block, and its ``segment_agg`` (partial) and
    ``segment_broadcast`` launches as its edges imply: (g2 + 1) per leaf
    of each in the static round."""
    want = np.load(runs["dirs"]["train_ref"] / f"{TRAIN_CASES[dynamic]}.npz")
    keys = sorted(k for k in want.files if k != "__replicas_equal__")
    one = runs[1][0]["train"][((1, 1, 1), dynamic, True)]["replica0"]
    block = tuple(d // g for d, g in zip(drv.TRAIN_REPS, grid))
    for det in (False, True):
        res = [r["train"][(grid, dynamic, det)] for r in runs[world]]
        got = res[0]["replica0"]
        assert sorted(got) == keys
        for k in keys:
            _close(got[k], want[k], F32_TOL, F32_TOL)
        for rank, r in enumerate(res):
            coords = tuple(int(c) for c in np.unravel_index(rank, grid))
            assert r["replicas_equal"] and r["block"] == block
            assert r["coords"] == coords
            assert r["launches"] == _train_launches(block, coords, dynamic,
                                                    len(keys))
        if det:
            assert _same(got, one)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_functions_over_the_ranks(runs, world):
    """``rank_grid`` fills the fl axis first; the HFL mesh's replicas,
    rank grid, rank order (row-major), coordinates, blocks and fl group;
    ``derive_bank_mesh`` (pod 0's ``(edge, fl)`` plane) placing and
    gathering bank rows; ``derive_hfl_mesh`` over the world's devices,
    its replicas, its tp ranks or its fsdp x tp ranks ((1, 1, 2, world /
    2)), and its
    ``ValueError``s (a topology that does not factor the world, a rank
    grid that does not divide the replicas, fsdp of more ranks than the
    world has);
    ``shardings`` of replica specs, ``place_params`` and
    ``gather_params``; a tp-sharded spec raising; the production mesh
    raising below 256 ranks."""
    grid = {1: (1, 1, 1), 2: (1, 1, 2), 4: (1, 2, 2)}[world]
    block = tuple(d // g for d, g in zip(drv.TRAIN_REPS, grid))
    bank = np.arange(48, dtype=np.float32).reshape(16, 3)
    whole = np.arange(24, dtype=np.float32).reshape(1, 2, 2, 6)
    for rank, r in enumerate(runs[world]):
        m = r["mesh"]
        coords = tuple(int(c) for c in np.unravel_index(rank, grid))
        idx = tuple(slice(c * b, (c + 1) * b) for c, b in zip(coords, block))
        assert m["grid"] == grid
        assert m["hfl"] == ({"pod": 1, "edge": 2, "fl": 2, "fsdp": 1,
                             "tp": 1}, grid, rank, coords, block, grid[2] > 1)
        assert m["bank"] == ({"edge": grid[1], "fl": grid[2]}, world, rank)
        per = 16 // world
        assert _same(m["bank_rows"], bank[rank * per:(rank + 1) * per])
        assert _same(m["bank_gathered"], bank)
        assert all(m["derive_errors"])
        if world > 1:
            assert m["derived"] == {"pod": 1, "edge": world, "fl": 1,
                                    "fsdp": 1, "tp": 1}
            assert m["derive_tp"] == {"pod": 1, "edge": 1, "fl": 1,
                                      "fsdp": 1, "tp": world}
            assert m["derive_fsdp"] == {"pod": 1, "edge": 1, "fl": 1,
                                        "fsdp": 2, "tp": world // 2}
        assert m["shardings"] == {"a": {"w": idx + (slice(None),)},
                                  "b": idx}
        assert _same(m["place"][0], whole[idx]) and m["place"][1]
        assert m["gather"] and m["shardings_tp"] and m["production"]


# ---------------------------------------------------------------------------
# the tensor plane: each replica over tp = 2 ranks (case "tp" of the driver)
# ---------------------------------------------------------------------------

def _tp_axes(jcfg, lifted: bool, reps=(1, 1, 1), tp=drv.TP) -> dict:
    """{leaf path: the dimension the reference's ``hfl_param_specs``
    splits over "tp" at ``tp`` ranks (None: whole)}, counted in the
    lifted leaf (``lifted``) or in the replica's own."""
    shapes = jax.eval_shape(j_build_model(jcfg).init, jax.random.PRNGKey(0))

    class Sizes:             # all the reference's guard reads of a mesh
        shape = dict(zip(jmesh.HFL_AXES, reps + (1, tp)))

    flat, _ = jax.tree_util.tree_flatten_with_path(
        jmesh.hfl_param_specs(jcfg, shapes, Sizes),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = {}
    for path, spec in flat:
        axis = next((i for i, e in enumerate(spec) if e is not None and "tp"
                     in (e if isinstance(e, tuple) else (e,))), None)
        out["/".join(k.key for k in path)] = (
            axis if axis is None or lifted else axis - 3)
    return out


def _tp_ranks(world):
    """(rank, replica coordinates, tp coordinate) of every rank: tp the
    fastest axis of the rank grid."""
    grid = drv.TP_GRIDS[world] + (1, drv.TP)
    return [(r, tuple(int(c) for c in np.unravel_index(r, grid)[:3]),
             r % drv.TP) for r in range(world)]


def _check_tp_placement(runs, world, arch, case):
    """``drv._tp_placement`` of ``arch``'s parameters on every rank
    (``case`` the rank's result) against the reference's specs."""
    jcfg = drv.tp_config(jconfigs, arch)
    reps = drv.TP_PLACE_REPS[world]
    axes = _tp_axes(jcfg, True, reps)
    one = _tp_params(arch)[1]
    whole = {k: np.stack([v * (r + 1) for r in range(reps[2])]).reshape(
        reps + v.shape) for k, v in one.items()}
    assert sorted(axes) == sorted(one)
    for rank, coords, t in _tp_ranks(world):
        res = case(runs[world][rank])
        m = res["mesh"]
        block = tuple(d // g for d, g in zip(reps, drv.TP_GRIDS[world]))
        assert (m["shape"], m["grid"], m["rank"], m["coords"],
                m["tp_rank"], m["block"]) == (
            dict(zip(jmesh.HFL_AXES, reps + (1, drv.TP))),
            drv.TP_GRIDS[world], rank, coords, t, block)
        assert m["groups"] == (True, drv.TP_GRIDS[world][2] > 1, world > 2)
        idx = tuple(slice(c * b, (c + 1) * b) for c, b in zip(coords, block))
        for k, v in whole.items():
            want = v[idx]
            if axes[k] is not None:
                want = np.split(want, drv.TP, axes[k])[t]
            assert _same(res["place"][k], want), k
            assert _same(res["place"][k], v[res["shardings"][k]]), k
        assert res["gather"] and res["blocks"] and res["replica"]


@pytest.mark.parametrize("world", (2, 4))
def test_tp_placement_matches_reference_specs(runs, world):
    """At tp = 2 over rank grid ``drv.TP_GRIDS[world]`` (tp the fastest
    rank axis): every rank's coordinates and groups; ``place_params`` of
    the whole lifted tree (replica r scaled by r + 1) is each leaf's
    replica block and, on the dimension the reference's
    ``hfl_param_specs`` splits over "tp", ``np.split(leaf, 2,
    axis)[t]``; ``shardings`` gives the same index; ``gather_params``
    and ``gather_replica`` invert the placement bitwise and
    ``tp_blocks`` of one replica is its placed block."""
    _check_tp_placement(runs, world, drv.TRAIN_ARCH, lambda r: r["tp"])


@pytest.mark.parametrize("world", (2, 4))
def test_tp_loss_and_grads_match_reference(runs, world):
    """``Model.loss(tp=)`` of reduced qwen3 (4 heads over 2 kv heads,
    d_ff 512, vocab 512, f32 activations) at tp = 2, KV chunks of 16
    over 32 tokens (remat at world 4), on every rank against
    ``jax.value_and_grad`` of the reference's ``Model.loss`` on the same
    numpy parameters and batch: the loss, and each rank's gradient of
    every leaf against its block (``np.split`` on the split dimension,
    the whole gradient of a replicated leaf), within 1e-4 (summation
    order: the split products and the vocab-parallel loss sum in
    another order)."""
    jcfg = drv.tp_config(jconfigs)
    jp = _tp_params()[0]
    jb = {k: jnp.asarray(v) for k, v in drv.tp_loss_batch(jcfg).items()}
    jval, jg = jax.jit(jax.value_and_grad(
        lambda q: j_build_model(jcfg).loss(q, jb, attn_chunk=16)))(jp)
    jg = _flat_tree(jax.tree.map(np.asarray, jg))
    axes = _tp_axes(jcfg, False)
    for rank, _, t in _tp_ranks(world):
        res = runs[world][rank]["tp"]
        _close(res["loss"], float(jval), F32_TOL, F32_TOL)
        assert sorted(res["grads"]) == sorted(jg)
        for k, g in jg.items():
            want = g if axes[k] is None else np.split(g, drv.TP, axes[k])[t]
            _close(res["grads"][k], want, F32_TOL, F32_TOL)


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
@pytest.mark.parametrize("world", (2, 4))
def test_tp_train_step_matches_reference(runs, world, dynamic):
    """Reduced qwen3 (``case_train``'s f32 settings and start) on
    replicas (1, 2, 2) over rank grid ``drv.TP_GRIDS[world]``, each
    replica over tp = 2 ranks (world 4: Eq. 1 and Eq. 2 cross ranks at a
    fixed tp coordinate): replica (0, 0, 0) of a static round (plain and
    deterministic) and of the dynamic round (deterministic), gathered
    whole, within 1e-4 of the reference's one-device jitted step; the
    four replicas bitwise equal; the replicated leaves (norms,
    ``q_norm``, ``k_norm``) bitwise equal across the ranks of each tp
    group; the deterministic static round bitwise run to run; each
    rank's launches as its edges imply (its tp block's leaves, one
    launch each)."""
    want = np.load(runs["dirs"]["train_ref"] / f"{TRAIN_CASES[dynamic]}.npz")
    keys = sorted(k for k in want.files if k != "__replicas_equal__")
    grid = drv.TP_GRIDS[world]
    block = tuple(d // g for d, g in zip(drv.TRAIN_REPS, grid))
    runs_ = [(True, True, 0)] if dynamic else [(False, False, 0),
                                               (False, True, 0)]
    for key in runs_:
        res = [r["tp"]["rounds"][key] for r in runs[world]]
        got = res[0]["replica0"]
        assert sorted(got) == keys
        for k in keys:
            _close(got[k], want[k], F32_TOL, F32_TOL)
        for rank, coords, t in _tp_ranks(world):
            r = res[rank]
            assert r["replicas_equal"] and r["block"] == block
            assert (r["coords"], r["tp_rank"]) == (coords, t)
            assert r["launches"] == _train_launches(block, coords, dynamic,
                                                    len(keys))
            peer = res[rank - t]             # tp coordinate 0 of the group
            assert _same(r["replicated"], peer["replicated"])
    if not dynamic:
        for r in runs[world]:
            a, b = (r["tp"]["rounds"][(False, True, i)] for i in (0, 1))
            assert _same(a["replicated"], b["replicated"])
            assert a.get("replica0") is None or _same(a["replica0"],
                                                      b["replica0"])


@pytest.mark.parametrize("world", (2, 4))
def test_tp_refusals(runs, world):
    """fsdp over more ranks than the world holds raises ``ValueError``
    (fsdp above 1 is taken since the fsdp axis came: ``test_fsdp_*``); a
    family still refused (reduced zamba2-7b, the hybrid family) at tp =
    2 raises ``NotImplementedError`` (the tensor plane of item 10 (b));
    tp = 4 on reduced qwen3 (2 kv heads) raises ``ValueError``, where
    reduced rwkv6 (also 2 kv heads, but 4 wkv heads, the only ones it
    splits) is taken."""
    for r in runs[world]:
        errs = r["tp"]["errors"]
        assert errs["fsdp"] and errs["family"]
        if world == 4:
            assert errs["heads"] and not errs["rwkv_heads"]


@pytest.mark.parametrize("arch,size,ok", [
    ("rwkv6-1.6b", 4, True), ("rwkv6-1.6b", 8, False),
    ("qwen3-1.7b", 4, False), ("zamba2-7b", 2, None)],
    ids=["rwkv6-tp4", "rwkv6-tp8", "qwen3-tp4", "zamba2-tp2"])
def test_tp_check_counts_the_heads_each_family_splits(arch, size, ok):
    """``tp.check`` on the reduced configs: an ssm model is split by its
    wkv heads alone (rwkv6: 4 heads, 2 kv heads, so T = 4 is taken and T
    = 8 raises ``ValueError``), a dense one by its query and kv heads
    (qwen3: T = 4 does not divide 2 kv heads), and the hybrid family
    raises ``NotImplementedError``."""
    cfg = tconfigs.get_config(arch).reduce()
    if ok is None:
        with pytest.raises(NotImplementedError, match="item 10"):
            tp_mod.check(cfg, size)
    elif ok:
        tp_mod.check(cfg, size)
    else:
        with pytest.raises(ValueError, match="whole heads"):
            tp_mod.check(cfg, size)


# ---------------------------------------------------------------------------
# the ssm family's tensor plane: reduced rwkv6 (case "tp_rwkv"), and the
# gather operator (case "tp_gather")
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", (2, 4))
def test_tp_rwkv6_placement_matches_reference_specs(runs, world):
    """Reduced rwkv6 at tp = 2 (``test_tp_placement_matches_reference_
    specs``'s checks): time-mix ``w_r``/``w_k``/``w_v``/``w_g`` by
    columns, ``w_o`` by rows, ``bonus_u`` by heads, channel-mix
    ``w_k``/``w_r`` by columns and ``w_v`` by rows, the rest whole, each
    ``np.split`` of the reference's ``hfl_param_specs``; the gathers
    invert the placement bitwise."""
    _check_tp_placement(runs, world, drv.RWKV_ARCH,
                        lambda r: r["tp_rwkv"]["place"])


@functools.lru_cache(maxsize=None)
def _jrwkv_loss(chunked: bool):
    """The reference's loss and flat gradients of reduced rwkv6 on the
    tensor plane's parameters and batch, through ``wkv_chunked`` or
    ``wkv_scan``."""
    jcfg = drv.tp_config(jconfigs, drv.RWKV_ARCH)
    jb = {k: jnp.asarray(v) for k, v in drv.tp_loss_batch(jcfg).items()}
    jval, jg = jax.jit(jax.value_and_grad(
        lambda q: j_build_model(jcfg).loss(q, jb, wkv_chunked=chunked)))(
            _tp_params(drv.RWKV_ARCH)[0])
    return float(jval), _flat_tree(jax.tree.map(np.asarray, jg))


@pytest.mark.parametrize("route", list(drv.WKV_ROUTES))
@pytest.mark.parametrize("world", (2, 4))
def test_tp_rwkv6_loss_and_grads_match_reference(runs, world, route):
    """``Model.loss(tp=)`` of reduced rwkv6 (4 wkv heads, d_ff 512, vocab
    512, f32 activations) over tp = 2 ranks (world 2) or 4 (world 4, one
    head a rank), 32 tokens through ``wkv_chunked`` or ``wkv_scan``, on
    every rank against ``jax.value_and_grad`` of the reference's
    ``Model.loss`` on the same numpy parameters and batch: the loss, and
    each rank's gradient of every leaf against its block (``np.split``
    on the split dimension, the whole gradient of a replicated leaf:
    the decay and group-norm leaves each rank slices are summed over the
    group), within 1e-4."""
    jval, jg = _jrwkv_loss(drv.WKV_ROUTES[route])
    size = drv.RWKV_TP[world]
    axes = _tp_axes(drv.tp_config(jconfigs, drv.RWKV_ARCH), False, tp=size)
    for rank in range(world):
        res = runs[world][rank]["tp_rwkv"]["loss"][route]
        _close(res["loss"], jval, F32_TOL, F32_TOL)
        assert sorted(res["grads"]) == sorted(jg)
        for k, g in jg.items():
            want = g if axes[k] is None else \
                np.split(g, size, axes[k])[rank % size]
            _close(res["grads"][k], want, F32_TOL, F32_TOL)


def test_tp_rwkv6_guarded_channel_mix(runs):
    """Reduced rwkv6 with d_ff = 511 at tp = 2 (world 2): the guard keeps
    the channel mix's ``w_k`` whole on every rank, and ``Model.loss(tp=)``
    and its gradient blocks hold 1e-4 against the one-device port's."""
    for rank in range(2):
        res = runs[2][rank]["tp_rwkv"]["guarded"]
        assert res["w_k"] == (2, 256, 511)
        assert res["loss"] <= F32_TOL and res["grads"] <= F32_TOL


@pytest.mark.parametrize("world", (2, 4))
def test_tp_rwkv6_train_step_matches_reference(runs, world):
    """Reduced rwkv6 (``tests/_torch_train_ref.py``'s f32 settings: one
    minibatch per epoch, ``wkv_scan``) on replicas (1, 2, 2) over rank
    grid ``drv.TP_GRIDS[world]``, each replica over tp = 2 ranks: replica
    (0, 0, 0) of a static (2, 2) round, plain and in deterministic mode,
    gathered whole, within 1e-4 of the reference's one-device jitted
    step (``rwkv6-f32-static``); the four replicas bitwise equal; every
    leaf no spec splits bitwise equal across the ranks of each tp group;
    the deterministic round bitwise run to run; each rank's launches as
    its edges imply."""
    want = np.load(runs["dirs"]["train_ref"] / f"{RWKV_CASE}.npz")
    keys = sorted(k for k in want.files if k != "__replicas_equal__")
    grid = drv.TP_GRIDS[world]
    block = tuple(d // g for d, g in zip(drv.TRAIN_REPS, grid))
    rounds = [r["tp_rwkv"]["rounds"] for r in runs[world]]
    for key in ((False, 0), (True, 0)):
        res = [r[key] for r in rounds]
        got = res[0]["replica0"]
        assert sorted(got) == keys
        for k in keys:
            _close(got[k], want[k], F32_TOL, F32_TOL)
        for rank, coords, t in _tp_ranks(world):
            r = res[rank]
            assert r["replicas_equal"] and r["block"] == block
            assert (r["coords"], r["tp_rank"]) == (coords, t)
            assert r["launches"] == _train_launches(block, coords, False,
                                                    len(keys))
            assert "layers/tmix/decay_B" in r["replicated"]
            assert _same(r["replicated"], res[rank - t]["replicated"])
    for r in rounds:
        a, b = r[(True, 0)], r[(True, 1)]
        assert _same(a["replicated"], b["replicated"])
        assert a.get("replica0") is None or _same(a["replica0"],
                                                  b["replica0"])


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("world", (2, 4))
def test_tp_gather_forward_and_backward(runs, world, dtype):
    """``tp.gather`` over the world: forward bitwise ``torch.cat`` of the
    ranks' blocks along the last dimension, in its dtype; backward this
    rank's slice of the gradient, bitwise the plain ``cat``'s."""
    for r in runs[world]:
        got, want = r["tp_gather"][dtype]["gather"], \
            r["tp_gather"][dtype]["plain"]
        assert got[2:] == want[2:] == (dtype, dtype)
        assert _same(got[0], want[0]) and _same(got[1], want[1])


# ---------------------------------------------------------------------------
# the fsdp axis: each replica over F = 2 fsdp x T tp ranks (case "fsdp")
# ---------------------------------------------------------------------------

def _ft_axes(jcfg, fsdp: int, tp: int, reps=(1, 1, 1)) -> dict:
    """{leaf path: (dimension, blocks, "ft" or "tp")} of the dimension
    the reference's guarded ``hfl_param_specs`` at (fsdp, tp) splits over
    tensor axes, in the lifted leaf (None: whole): an ``("fsdp", "tp")``
    entry into fsdp x tp blocks, a ``"tp"`` entry into tp."""
    shapes = jax.eval_shape(j_build_model(jcfg).init, jax.random.PRNGKey(0))
    sizes = {"fsdp": fsdp, "tp": tp}

    class Sizes:             # all the reference's guard reads of a mesh
        shape = dict(zip(jmesh.HFL_AXES, reps + (fsdp, tp)))

    flat, _ = jax.tree_util.tree_flatten_with_path(
        jmesh.hfl_param_specs(jcfg, shapes, Sizes),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = {}
    for path, spec in flat:
        cut = None
        for i, e in enumerate(spec):
            axes = [a for a in (e if isinstance(e, tuple) else (e,))
                    if sizes.get(a, 1) > 1]
            if axes:
                cut = (i, int(np.prod([sizes[a] for a in axes])),
                       "ft" if "fsdp" in axes else "tp")
        out["/".join(k.key for k in path)] = cut
    return out


def _ft_block(a, cut, f: int, t: int, tp: int, lead: int = 0):
    """``a``'s block at tensor coordinate (f, t) under ``cut``
    (``_ft_axes``; ``lead`` fewer leading axes than the lifted leaf):
    fsdp-major, block f T + t of an ft split, block t of a tp split."""
    if cut is None:
        return a
    axis, n, kind = cut
    return np.split(a, n, axis - lead)[f * tp + t if kind == "ft" else t]


def _ft_ranks(world, grid=(1, 1, 1), tp=None):
    """(rank, replica coordinates, f, t) of every rank over ``grid +
    (FSDP, tp)``, row-major, tp fastest."""
    tp = drv.FSDP_TP[world] if tp is None else tp
    out = []
    for r in range(world):
        c = [int(x) for x in np.unravel_index(r, grid + (drv.FSDP, tp))]
        out.append((r, tuple(c[:3]), c[3], c[4]))
    return out


@pytest.mark.parametrize("arch", [drv.TRAIN_ARCH, drv.AUDIO_ARCH])
@pytest.mark.parametrize("world", (2, 4))
def test_fsdp_placement_matches_reference_specs(runs, world, arch):
    """Replicas (1, 1, 2) on every rank of (1, 1, 2, T), T =
    ``drv.FSDP_TP[world]`` (tp the fastest rank axis): every rank's
    coordinates and groups; ``place_params`` of the whole lifted tree
    (replica r scaled by r + 1) cut as the reference's guarded
    ``hfl_param_specs`` read fsdp-major (a ``("fsdp", "tp")`` dimension
    into 2 T blocks, rank (f, t) holding block f T + t, a ``"tp"``
    dimension into T, the same on both fsdp ranks); ``shardings`` gives
    the same index; ``gather_params`` and ``gather_replica`` invert the
    placement bitwise and ``tp_blocks`` of one replica is its placed
    block."""
    tp = drv.FSDP_TP[world]
    reps = drv.FSDP_PLACE_REPS
    jcfg = drv.tp_config(jconfigs, arch)
    axes = _ft_axes(jcfg, drv.FSDP, tp, reps)
    one = _tp_params(arch)[1]
    whole = {k: np.stack([v * (r + 1) for r in range(reps[2])]).reshape(
        reps + v.shape) for k, v in one.items()}
    assert sorted(axes) == sorted(one)
    if arch == drv.AUDIO_ARCH:     # the MLP and the vocabulary split
        assert axes["layers/mlp/b_up"][2] == axes["embed"][2] == "ft"
    for rank, coords, f, t in _ft_ranks(world):
        res = runs[world][rank]["fsdp"]["place"][arch]
        m = res["mesh"]
        assert (m["shape"], m["grid"], m["rank"], m["coords"],
                m["fsdp_rank"], m["tp_rank"], m["block"]) == (
            dict(zip(jmesh.HFL_AXES, reps + (drv.FSDP, tp))), (1, 1, 1),
            rank, coords, f, t, reps)
        assert m["groups"] == (tp > 1, False, False) and m["ft_group"]
        for k, v in whole.items():
            want = _ft_block(v, axes[k], f, t, tp)
            assert _same(res["place"][k], want), k
            assert _same(res["place"][k], v[res["shardings"][k]]), k
        assert res["gather"] and res["blocks"] and res["replica"]


@functools.lru_cache(maxsize=None)
def _jft_loss(arch: str, vocab=None):
    """The reference's loss and flat gradients of ``drv.tp_config(arch,
    vocab)`` on the tensor plane's parameters and ``drv.tp_loss_batch``,
    KV chunks of 16."""
    jcfg = drv.tp_config(jconfigs, arch, vocab)
    jb = {k: jnp.asarray(v) for k, v in drv.tp_loss_batch(jcfg).items()}
    jval, jg = jax.jit(jax.value_and_grad(
        lambda q: j_build_model(jcfg).loss(q, jb, attn_chunk=16)))(
            _tp_params(arch, vocab)[0])
    return float(jval), _flat_tree(jax.tree.map(np.asarray, jg))


FSDP_LOSS_CASES = [(w, c) for w in (2, 4) for c in drv.FSDP_LOSSES[w]]


@pytest.mark.parametrize("world,case", FSDP_LOSS_CASES, ids=[
    f"{w}ranks-{a}-f{f}t{t}" + (f"-vocab{v}" if v else "")
    for w, (a, f, t, v) in FSDP_LOSS_CASES])
def test_fsdp_loss_and_grads_match_reference(runs, world, case):
    """``Model.loss(tp=, ft=)`` of reduced qwen3 at (1, 1, 2, 1) and (1, 1,
    2, 2), and of reduced whisper-base (its batch with ``enc_embed`` (2,
    32, 256)) at F = 2 and 4, also with an odd vocabulary (515, which the
    guard keeps whole: the embedding and unembedding whole on every
    rank, the MLP split), on every rank against ``jax.value_and_grad`` of
    the reference's ``Model.loss`` on the same numpy parameters and
    batch, f32: the loss, and each rank's gradient of every leaf against
    its block (fsdp-major), within 1e-4."""
    arch, fsdp, tp, vocab = case
    jval, jg = _jft_loss(arch, vocab)
    axes = _ft_axes(drv.tp_config(jconfigs, arch, vocab), fsdp, tp)
    if vocab is not None:
        assert axes["embed"] is None and axes["unembed"] is None
        assert axes["layers/mlp/w_up"] is not None
    for rank in range(world):
        f, t = divmod(rank, tp)
        res = runs[world][rank]["fsdp"]["loss"][(arch, vocab)]
        _close(res["loss"], jval, F32_TOL, F32_TOL)
        assert sorted(res["grads"]) == sorted(jg)
        for k, g in jg.items():
            _close(res["grads"][k], _ft_block(g, axes[k], f, t, tp, 3),
                   F32_TOL, F32_TOL)


@pytest.mark.parametrize("world", (2, 4))
def test_fsdp_train_step_matches_reference(runs, world):
    """Reduced qwen3 (``case_train``'s f32 settings and start) on replicas
    (1, 2, 2), each replica over F = 2 fsdp ranks (T = 1), rank grid
    ``drv.FSDP_GRIDS[world]`` (world 4: Eq. 1 and Eq. 2 cross ranks at
    each fsdp coordinate): replica (0, 0, 0) of a static (2, 2) round
    gathered whole within 1e-4 of the reference's one-device jitted step
    (``qwen3-f32-static``); the four replicas bitwise equal; every leaf
    no spec splits (attention, the norms) bitwise equal across the ranks
    of each ft group; each rank's launches as its edges imply;
    ``derive_bank_mesh`` on the ranks at tensor coordinates (0, 0)
    only."""
    want = np.load(runs["dirs"]["train_ref"] / f"{TRAIN_CASES[False]}.npz")
    keys = sorted(k for k in want.files if k != "__replicas_equal__")
    grid = drv.FSDP_GRIDS[world]
    block = tuple(d // g for d, g in zip(drv.TRAIN_REPS, grid))
    res = [r["fsdp"]["round"] for r in runs[world]]
    got = res[0]["replica0"]
    assert sorted(got) == keys
    for k in keys:
        _close(got[k], want[k], F32_TOL, F32_TOL)
    for rank, coords, f, _ in _ft_ranks(world, grid, tp=1):
        r = res[rank]
        assert r["replicas_equal"] and r["block"] == block
        assert (r["coords"], r["fsdp_rank"]) == (coords, f)
        assert r["launches"] == _train_launches(block, coords, False,
                                                len(keys))
        assert "layers/attn/wq" in r["replicated"]
        assert _same(r["replicated"], res[rank - f]["replicated"])
        bank = runs[world][rank]["fsdp"]["bank"]
        assert bank == (None if f else ({"edge": grid[1], "fl": grid[2]},
                                        rank // drv.FSDP))


@pytest.mark.parametrize("world", (2, 4))
def test_fsdp_refusals(runs, world):
    """At F = 2 the ssm (rwkv6), hybrid (zamba2), vlm (qwen2-vl) and moe
    (olmoe) families raise ``NotImplementedError`` from the train step
    (the tensor plane of item 10 (b)), and at world 4, (1, 1, 2, 2), so
    does the audio family (whisper) at T = 2."""
    for r in runs[world]:
        errs = r["fsdp"]["errors"]
        assert sorted(errs) == sorted(drv.FSDP_REFUSED + (
            ("audio_tp",) if world == 4 else ()))
        assert all(errs.values())


@pytest.mark.parametrize("arch,tp,fsdp,ok", [
    ("qwen3-1.7b", 1, 2, True), ("qwen3-1.7b", 2, 2, True),
    ("whisper-base", 1, 2, True), ("whisper-base", 2, 1, False),
    ("rwkv6-1.6b", 1, 2, False), ("zamba2-7b", 1, 2, False),
    ("qwen2-vl-7b", 1, 2, False), ("olmoe-1b-7b", 1, 2, False)],
    ids=["qwen3-f2", "qwen3-f2t2", "whisper-f2", "whisper-t2", "rwkv6-f2",
         "zamba2-f2", "qwen2vl-f2", "olmoe-f2"])
def test_tp_check_takes_fsdp_for_dense_and_audio(arch, tp, fsdp, ok):
    """``tp.check(cfg, T, F)`` on the reduced configs: fsdp above 1 is
    taken for the dense and audio families and raises
    ``NotImplementedError`` naming item 10 (b) for the others; tp above
    1 raises it for audio."""
    cfg = tconfigs.get_config(arch).reduce()
    if ok:
        tp_mod.check(cfg, tp, fsdp)
    else:
        with pytest.raises(NotImplementedError, match="item 10 \\(b\\)"):
            tp_mod.check(cfg, tp, fsdp)


# ---------------------------------------------------------------------------
# mesh serving: reduced qwen3 over a (pod, batch, tp) serve mesh (case
# "serve_mesh" of `_torch_dist_driver.py`)
# ---------------------------------------------------------------------------

SERVE_CASES = [(w, dims, b, win) for w in (2, 4)
               for dims, b in drv.SERVE_LAYOUTS[w]
               for win in drv.SERVE_WINDOWS]


class _ServeShape:
    """All the reference's serve spec functions read of a mesh."""

    def __init__(self, dims):
        self.shape = dict(zip(jmesh.SERVE_AXES, dims))


def _serve_block(a, spec, dims, coords):
    """The block of ``a`` that ``spec`` (a ``PartitionSpec``) gives the
    serve-mesh rank at ``coords`` of ``dims``: each named dimension
    ``np.split`` into as many blocks as its axes have ranks, the rank's
    block row-major over them."""
    sizes = dict(zip(jmesh.SERVE_AXES, dims))
    at = dict(zip(jmesh.SERVE_AXES, coords))
    for i, entry in enumerate(spec):
        axes = () if entry is None else \
            entry if isinstance(entry, tuple) else (entry,)
        n, k = 1, 0
        for ax in axes:
            n, k = n * sizes[ax], k * sizes[ax] + at[ax]
        a = np.split(a, n, i)[k]
    return a


@functools.lru_cache(maxsize=None)
def _jserve(batch: int, window: int):
    """The reference's ``Model.prefill`` of ``drv.SERVE_PROMPT`` tokens
    of ``drv.serve_tokens(batch)`` and ``drv.SERVE_STEPS`` teacher-forced
    ``decode_step``s of reduced qwen3 (f32 activations) on
    ``_tp_params()``: (prefill logits, its cache, [step logits], the
    cache after the last step), numpy."""
    jm = j_build_model(drv.tp_config(jconfigs))
    jp = _tp_params()[0]
    toks = jnp.asarray(drv.serve_tokens(batch))
    p = drv.SERVE_PROMPT
    jl, jc = jax.jit(functools.partial(
        jm.prefill, window=window,
        max_new=0 if window else drv.SERVE_STEPS))(jp, toks[:, :p])
    kv = lambda c: {k: np.asarray(c[k]) for k in ("k", "v", "pos")}
    pre = (np.asarray(jl), kv(jc))
    dec = jax.jit(functools.partial(jm.decode_step, window=window))
    steps = []
    for i in range(p, p + drv.SERVE_STEPS):
        jl, jc = dec(jp, jc, toks[:, i:i + 1])
        steps.append(np.asarray(jl))
    return pre[0], pre[1], steps, kv(jc)


@pytest.mark.parametrize("world,dims,batch,window", SERVE_CASES, ids=[
    f"w{w}-{'x'.join(map(str, d))}-b{b}-win{win}"
    for w, d, b, win in SERVE_CASES])
def test_serve_mesh_matches_reference(runs, world, dims, batch, window):
    """Reduced qwen3 (4 heads over 2 kv heads, vocab 512, f32
    activations) served over a serve mesh of this world (``(1, 1, 2)``;
    ``(1, 2, 2)`` with batch 2 split over the batch groups and batch 3
    replicated by ``_batch_axes``), with and without a window of 8 (the
    ring wraps): on every rank, the prefill logits and the cache blocks
    after the prefill and after 4 teacher-forced decode steps are the
    blocks the reference's out shardings give it (its ``cache_specs``;
    the logits over (batch axes, 'tp')) of the reference's
    ``Model.prefill``/``decode_step`` on the same numpy parameters,
    within 1e-4 (the positions exactly); every decode step's logits are
    whole on every rank (the reference's ``P()``), within 1e-4 of the
    reference's and bitwise equal across the ranks."""
    jl, jc, jsteps, jlast = _jserve(batch, window)
    shape = _ServeShape(dims)
    jcfg = drv.tp_config(jconfigs)
    cspecs = jserve.cache_specs(jcfg, shape, batch)
    lspec = (jserve._batch_axes(shape, batch), "tp")
    steps0 = None
    for rank, r in enumerate(runs[world]):
        coords = tuple(int(c) for c in np.unravel_index(rank, dims))
        res = r["serve_mesh"]["runs"][(dims, batch, window)]
        _close(res["prefill"], _serve_block(jl, lspec, dims, coords),
               F32_TOL, F32_TOL)
        for got, want in ((res["prefill_cache"], jc), (res["cache"], jlast)):
            for k in ("k", "v"):
                _close(got[k], _serve_block(want[k], cspecs[k], dims, coords),
                       F32_TOL, F32_TOL)
            assert _same(got["pos"], _serve_block(
                want["pos"], cspecs["pos"], dims, coords))
        assert res["t"] == list(range(drv.SERVE_PROMPT, drv.SERVE_PROMPT
                                      + drv.SERVE_STEPS + 1))
        assert len(res["steps"]) == len(jsteps)
        for got, want in zip(res["steps"], jsteps):
            _close(got, want, F32_TOL, F32_TOL)
        steps0 = steps0 or res["steps"]
        assert _same(res["steps"], steps0)


@pytest.mark.parametrize("world", (2, 4))
def test_serve_mesh_places_the_reference_specs(runs, world):
    """Each rank of the serve mesh (ranks row-major over (pod, batch,
    tp), the tp group of its batch coordinate) holds of every parameter
    the block the reference's ``serve_specs_for_params`` gives it
    (``np.split``), bitwise; ``derive_serve_mesh`` of the world's ranks
    at tp = 2 builds a runnable ``ServeMesh`` (1, world / 2, 2)."""
    dims, batch = drv.SERVE_LAYOUTS[world][0]
    jcfg = drv.tp_config(jconfigs)
    specs = _flat_tree(jax.tree.map(
        tuple, jserve.serve_specs_for_params(jcfg, _ServeShape(dims)),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    one = _tp_params()[1]
    assert sorted(specs) == sorted(one)
    for rank, r in enumerate(runs[world]):
        coords = tuple(int(c) for c in np.unravel_index(rank, dims))
        res = r["serve_mesh"]
        assert res["mesh"] == (dict(zip(jmesh.SERVE_AXES, dims)), coords,
                               coords[2], True)
        two = (1, world // 2, 2)
        assert res["derived"] == (
            "ServeMesh", dict(zip(jmesh.SERVE_AXES, two)),
            tuple(int(c) for c in np.unravel_index(rank, two)))
        assert sorted(res["blocks"]) == sorted(one)
        for k, a in one.items():
            assert _same(res["blocks"][k],
                         _serve_block(a, specs[k], dims, coords)), k


@pytest.mark.parametrize("world", (2, 4))
def test_serve_mesh_refusals(runs, world):
    """Mesh serving refuses what it does not run, naming item 10 (b):
    a non-dense family (reduced rwkv6) raises ``NotImplementedError``; at
    world 4 reduced qwen3 at T = 4 (2 kv heads, where the reference
    splits the cache length) raises ``ValueError``, and phi3-medium-14b
    at (1, 2, 2) (over 4 GiB of parameters a rank: the reference's
    ``fsdp_serve`` merge over ('batch', 'tp')) ``NotImplementedError``."""
    want = {"family"} | ({"heads", "fsdp_serve"} if world == 4 else set())
    for r in runs[world]:
        errs = r["serve_mesh"]["errors"]
        assert set(errs) == want and all(errs.values())
