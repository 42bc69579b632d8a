"""Rank driver of the port's sharded-bank tests (not a pytest file);
imports only the port.

    python tests/_torch_dist_driver.py WORLD INPUTS OUTDIR

spawns WORLD ranks (``torch.multiprocessing``) on the CPU, joined by a
gloo process group through a file store in OUTDIR; each rank runs torch
on one intra-op thread, runs every case of ``CASES`` whose worlds include
WORLD, in order (their collectives line up across ranks), and pickles
``{case: result}`` to ``OUTDIR/rank<r>.pkl``. ``INPUTS`` is a pickle the
test process wrote: the reference's draws for the rounds and the envs
(``inputs`` below lists its keys). Results are numpy arrays, lists and
flags: this rank's rows of a bank, the replicated (E, P) results, and
the same computation on one device (no context) in the same process.

The numpy data of each case comes from the ``*_inputs`` functions here,
which ``tests/test_torch_sharded.py`` also calls to build the JAX
reference's inputs, so both sides see the same arrays. They mirror
``tests/test_sharded_bank.py`` case for case, with its seeds.
"""
import contextlib
import dataclasses
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import _torch_train_ref as tref
from repro_torch import configs, weights
from repro_torch.checkpoint import store
from repro_torch.core import flatbank, hfl, sync
from repro_torch.data.synthetic import token_batch
from repro_torch.device import deterministic_algorithms
from repro_torch.kernels import hier_agg, ops, ref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve
from repro_torch.models import tp as tp_mod
from repro_torch.models import transformer
from repro_torch.models.model import build_model
from repro_torch.runtime import (AsyncConfig, ChurnEvent, FaultSpec,
                                 StalenessBuffer)
from repro_torch.sim import AsyncHFLEnv, EnvConfig, HFLEnv
from repro_torch.telemetry import ledger
from repro_torch.launch import train

# the mesh shapes each world runs (rows shard over all ranks either way)
MESHES = {1: [(1, 1)], 2: [(2, 1)], 4: [(4, 1), (2, 2)]}
# the reference's async trajectory config (tests/test_sharded_bank.py)
TRAJ_CFG = dict(task="mnist", mode="real", n_devices=8, n_edges=4,
                n_local=32, batch_size=16, threshold_time=300.0,
                gamma_max=2, seed=0)
TRAJ_ASSIGN = np.repeat(np.arange(4), 2)        # edge-aligned shards
TRAJ_RUNS = {"clean": 4, "faults": 6}           # events per trajectory
ENV_ROUNDS = 2                                  # HFLEnv step_raw calls
SNAP_AT = 3               # events of the faulty trajectory before a snapshot
# the rank grids of the train step's replicas (1, 2, 2) at each world
TRAIN_REPS = (1, 2, 2)
TRAIN_GRIDS = {1: [(1, 1, 1)], 2: [(1, 1, 2), (1, 2, 1)], 4: [(1, 2, 2)]}
TRAIN_ARCH = "qwen3-1.7b"
# the tensor plane: each replica over TP ranks; the rank grid of the
# replicas at each world (world 4: Eq. 1 and Eq. 2 cross ranks at a
# fixed tp coordinate), and the replicas of the placement case
TP = 2
TP_GRIDS = {2: (1, 1, 1), 4: (1, 1, 2)}
TP_PLACE_REPS = {2: (1, 1, 1), 4: (1, 1, 2)}
# the replicated leaves of a dense replica (no spec splits them)
TP_REPLICATED = ("final_norm", "layers/ln1", "layers/ln2",
                 "layers/attn/q_norm", "layers/attn/k_norm")
# the ssm family's tensor plane (RWKV6): its loss case's tp size at each
# world (world 4: one of the reduced model's 4 wkv heads a rank, which
# reduced qwen3's 2 kv heads cannot take), and its WKV routes
RWKV_ARCH = "rwkv6-1.6b"
RWKV_TP = {2: 2, 4: 4}
WKV_ROUTES = {"chunked": True, "scan": False}
# the fsdp axis: each replica over FSDP fsdp x FSDP_TP[world] tp ranks
# (world 2: (1, 1, 2, 1), world 4: (1, 1, 2, 2)), the replicas of the
# placement case on every rank; the train step at F = 2, T = 1 over rank
# grid FSDP_GRIDS[world] (world 4: Eq. 1 and Eq. 2 cross ranks at each
# tensor coordinate); the loss cases of each world: (arch, fsdp, tp,
# vocab), whisper's vocab 515 (odd) kept whole by the guard
FSDP = 2
FSDP_TP = {2: 1, 4: 2}
FSDP_PLACE_REPS = (1, 1, 2)
FSDP_GRIDS = {2: (1, 1, 1), 4: (1, 1, 2)}
AUDIO_ARCH = "whisper-base"
FSDP_LOSSES = {2: [(TRAIN_ARCH, 2, 1, None), (AUDIO_ARCH, 2, 1, None),
                   (AUDIO_ARCH, 2, 1, 515)],
               4: [(TRAIN_ARCH, 2, 2, None), (AUDIO_ARCH, 4, 1, None)]}
# families fsdp above 1 still refuses (item 10 (b))
FSDP_REFUSED = (RWKV_ARCH, "zamba2-7b", "qwen2-vl-7b", "olmoe-1b-7b")
# mesh serving: tp_config's reduced qwen3 over the serve mesh (pod,
# batch, tp) of each world, at each request batch (world 4: batch 2 split
# over the two batch groups, batch 3 replicated by _batch_axes), prefill
# of SERVE_PROMPT tokens, SERVE_STEPS teacher-forced decode steps, with
# and without a window (8 < the prompt: a ring that wraps)
SERVE_LAYOUTS = {2: [((1, 1, 2), 2)], 4: [((1, 2, 2), 2), ((1, 2, 2), 3)]}
SERVE_PROMPT, SERVE_STEPS = 16, 4
SERVE_WINDOWS = (0, 8)
# a dense model over 4 GiB of f32 parameters a rank at T = 2: the
# reference's fsdp_serve, which mesh serving refuses
SERVE_FSDP_ARCH = "phi3-medium-14b"


# ---------------------------------------------------------------------------
# numpy inputs, shared with the test process
# ---------------------------------------------------------------------------

def mixed_bank_inputs():
    """A nested-bank stand-in, f32 + bf16 leaves, P = 140, 16 rows on 5
    segments (seed 2): (leaves, bf16 keys, weights, segment ids)."""
    rng = np.random.default_rng(2)
    n, m = 16, 5
    leaves = {"conv/w": rng.normal(size=(n, 2, 3, 5)),
              "conv/b": rng.normal(size=(n, 74)),
              "head/0": rng.normal(size=(n, 5, 7)),
              "head/1": rng.normal(size=(n,))}
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    w = rng.uniform(0.1, 3.0, size=(n,)).astype(np.float32)
    seg = rng.integers(0, m, size=(n,)).astype(np.int32)
    return leaves, ("conv/b", "head/0"), w, seg, m


def uneven_inputs():
    """Edge 0 spans ranks 0-2, edge 1 straddles ranks 2/3, edge 2 lies on
    rank 3, edge 3 is empty (seed 3)."""
    rng = np.random.default_rng(3)
    seg = np.asarray([0] * 9 + [1] * 3 + [2] * 4, np.int32)
    bank = {"w": rng.normal(size=(16, 130)).astype(np.float32)}
    w = rng.uniform(0.5, 2.0, size=(16,)).astype(np.float32)
    return bank, w, seg, 4


def bf16_inputs():
    rng = np.random.default_rng(4)
    n, m = 8, 3
    bank = {"a": rng.normal(size=(n, 9)).astype(np.float32),
            "b": rng.normal(size=(n, 3, 2)).astype(np.float32)}
    w = rng.uniform(0.5, 2.0, size=(n,)).astype(np.float32)
    seg = rng.integers(0, m, size=(n,)).astype(np.int32)
    return bank, w, seg, m


def broadcast_inputs():
    rng = np.random.default_rng(5)
    models = rng.normal(size=(4, 137)).astype(np.float32)
    seg = rng.integers(0, 4, size=(16,)).astype(np.int32)
    return models, seg


def cloud_agg_inputs():
    rng = np.random.default_rng(6)
    return (rng.normal(size=(4, 33)).astype(np.float32),
            rng.uniform(1, 3, size=(4,)).astype(np.float32))


def flush_inputs(kind: str):
    """(vecs (K, P), weights, staleness, anchor or None, anchor weight):
    ``stale`` K = 8 (seed 11), ``degraded`` 7 + an anchor (seed 13),
    ``indivisible`` K = 5 (seed 12)."""
    if kind == "indivisible":
        rng = np.random.default_rng(12)
        vecs = rng.normal(size=(5, 140)).astype(np.float32)
        return vecs, np.arange(5, dtype=np.float32) + 1.0, \
            np.zeros(5, np.int64), None, 0.0
    rng = np.random.default_rng(11 if kind == "stale" else 13)
    k = 8 if kind == "stale" else 7
    vecs = np.stack([rng.normal(size=(130,)) for _ in range(k)]
                    ).astype(np.float32)
    anchor = None
    if kind == "degraded":
        anchor = rng.normal(size=(130,)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=k).astype(np.float32)
    tau = rng.integers(0, 4, size=k)
    return vecs, w, tau, anchor, 2.5 if kind == "degraded" else 0.0


def round_inputs(seed: int, n: int = 16):
    """The reference's ``_round_fixtures``: a linear model's bank, data
    and sizes (``loss_quad`` is its loss)."""
    rng = np.random.default_rng(seed)
    bank = {"w": rng.normal(size=(n, 4, 3)).astype(np.float32),
            "b": rng.normal(size=(n, 3)).astype(np.float32)}
    x = rng.normal(size=(n, 8, 4)).astype(np.float32)
    y = rng.normal(size=(n, 8)).astype(np.float32)
    sizes = rng.uniform(1, 3, size=(n,)).astype(np.float32)
    return bank, x, y, sizes, rng


def loss_quad(p, batch):
    return torch.mean((batch["x"] @ p["w"][..., 0] - batch["y"]) ** 2)


def cloud_round_inputs(aligned: bool):
    """Seed 7, 16 rows: 5 edges on random rows (edges span ranks), or 4
    edges of 4 contiguous rows (edge-aligned at 1, 2 and 4 ranks)."""
    bank, x, y, sizes, rng = round_inputs(7)
    if aligned:
        m, seg = 4, np.repeat(np.arange(4), 4).astype(np.int32)
        g1, g2 = np.array([2, 1, 3, 2]), np.array([1, 2, 1, 2])
    else:
        m = 5
        seg = rng.integers(0, m, size=(16,)).astype(np.int32)
        g1, g2 = np.array([2, 1, 3, 2, 1]), np.array([1, 2, 1, 2, 1])
    return bank, x, y, sizes, seg, m, g1, g2


def fedavg_inputs():
    bank, x, y, sizes, rng = round_inputs(8)
    return bank, x, y, sizes, rng.random(16) < 0.7


def edge_round_inputs():
    bank, x, y, sizes, rng = round_inputs(20)
    seg = np.repeat(np.arange(4), 4).astype(np.int32)
    gvec = rng.normal(size=(15,)).astype(np.float32)
    return bank, x, y, sizes, seg, gvec


def tp_config(pkg, arch=TRAIN_ARCH, vocab=None):
    """Reduced ``arch`` with f32 activations (and ``vocab``, if given),
    for either package's ``configs``: qwen3 (4 heads, 2 kv heads, d_ff
    512, vocab 512), rwkv6 (4 wkv heads, d_ff 512, vocab 512) or
    whisper-base (2 + 2 layers, d_ff 512, vocab 512, enc_seq 32)."""
    kw = {} if vocab is None else {"vocab": vocab}
    return dataclasses.replace(pkg.get_config(arch).reduce(),
                               activ_dtype="float32", **kw)


def tp_loss_batch(cfg) -> dict:
    """The loss case's batch: 2 sequences of 32 tokens (seed 5) and, for
    an audio model, ``enc_embed`` (2, enc_seq, d) normal from
    ``default_rng(6)``, numpy."""
    out = {k: v.numpy() for k, v in token_batch(5, 2, 32, cfg.vocab,
                                                device="cpu").items()}
    if cfg.family == "audio":
        out["enc_embed"] = np.random.default_rng(6).normal(
            size=(2, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def serve_tokens(batch: int):
    """The mesh serve's tokens: ``batch`` sequences of the prompt and the
    fed tokens (seed 11), numpy."""
    return token_batch(11, batch, SERVE_PROMPT + SERVE_STEPS, 512,
                       device="cpu")["tokens"].numpy()


def resync_inputs():
    rng = np.random.default_rng(23)
    bank_mat = rng.normal(size=(16, 37)).astype(np.float32)
    edge_mat = rng.normal(size=(4, 37)).astype(np.float32)
    return bank_mat, edge_mat, np.repeat(np.arange(4), 4).astype(np.int32)


def traj_runtime(kind: str):
    """(AsyncConfig, FaultSpec) of the reference's clean (all-zeros
    spec) and faulty (drops, deadline flushes, a leave and a join of
    edge 1) trajectories."""
    if kind == "clean":
        return AsyncConfig(buffer_k=2, decay="none"), FaultSpec(seed=3)
    return (AsyncConfig(buffer_k=3, flush_deadline=20.0),
            FaultSpec(drop_prob=0.6, churn=(ChurnEvent(30.0, 1, "leave"),
                                            ChurnEvent(60.0, 1, "join")),
                      seed=5))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _t(a, bf16=False):
    t = torch.from_numpy(np.array(a))
    return t.to(torch.bfloat16) if bf16 else t


def _np(t):
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _ctx(shape, **kw):
    return mesh_lib.make_bank_context(*shape, device="cpu", **kw)


def _raises(exc, fn) -> bool:
    try:
        fn()
    except exc:
        return True
    return False


def _bank(leaves, bf16=()):
    return {k: _t(v, k in bf16) for k, v in leaves.items()}


def _leaf_rows(bank: dict) -> list:
    return sorted({int(v.shape[0]) for v in bank.values()})


# ---------------------------------------------------------------------------
# cases: each returns {mesh label: result} (or one result)
# ---------------------------------------------------------------------------

def case_agg_mixed(world, inp):
    leaves, bf16, w, seg, m = mixed_bank_inputs()
    full = _bank(leaves, bf16)
    out = {"single": _np(hfl.weighted_aggregate(full, _t(w), _t(seg), m))}
    for shape in MESHES[world]:
        ctx = _ctx(shape)
        got = hfl.weighted_aggregate(ctx.place_bank(full), ctx.place_rows(
            _t(w)), ctx.place_rows(_t(seg)), m, ctx=ctx)
        out[shape] = _np(got)
    return out


def case_uneven(world, inp):
    bank, w, seg, m = uneven_inputs()
    ctx = _ctx((4, 1))
    full = _bank(bank)
    return {"single": _np(hfl.weighted_aggregate(full, _t(w), _t(seg), m)),
            "got": _np(hfl.weighted_aggregate(
                ctx.place_bank(full), ctx.place_rows(_t(w)),
                ctx.place_rows(_t(seg)), m, ctx=ctx))}


def case_bf16(world, inp):
    bank, w, seg, m = bf16_inputs()
    full = _bank(bank, ("a", "b"))
    out = {"single": _np(hfl.weighted_aggregate(full, _t(w), _t(seg), m)),
           "dtype": str(flatbank.bank_spec(full).dtype)}
    for shape in MESHES[world][-1:]:
        ctx = _ctx(shape)
        part = ctx.place_bank(full)
        got = hfl.weighted_aggregate(part, ctx.place_rows(_t(w)),
                                     ctx.place_rows(_t(seg)), m, ctx=ctx)
        out[shape] = {"got": _np(got), "dtypes": sorted(
            str(v.dtype) for v in got.values())}
    return out


def case_broadcast(world, inp):
    models, seg = broadcast_inputs()
    ctx = _ctx(MESHES[world][0])
    out = ops.segment_broadcast(_t(models), ctx.place_rows(_t(seg)))
    return {"rows": _np(out), "shape": tuple(out.shape)}


def case_cloud_agg(world, inp):
    em, esz = cloud_agg_inputs()
    want = hfl.cloud_aggregate({"w": _t(em)}, _t(esz))
    out = {"single": _np(want)}
    ctxs = [(world, _ctx((world, 1)))]
    group3 = dist.new_group([0, 1, 2]) if world == 4 else None
    if world == 4 and dist.get_rank() < 3:
        ctxs.append((3, hfl.AggContext.for_mesh(
            mesh_lib.make_bank_mesh(3, group=group3, device="cpu"))))
    for k, ctx in ctxs:
        got = hfl.cloud_aggregate({"w": _t(em)}, _t(esz), ctx=ctx)
        out[k] = _np(got)
        out[f"equal-{k}"] = torch.equal(got["w"], want["w"])
    return out


def _flush(kind, ctx):
    vecs, w, tau, anchor, m_w = flush_inputs(kind)
    k = len(vecs) + (anchor is not None)
    decay = "none" if kind == "indivisible" else "poly"
    buf = StalenessBuffer(k, decay=decay, decay_a=0.5, ctx=ctx,
                          device="cpu")
    for j in range(len(vecs)):
        buf.push(j, _t(vecs[j]), float(w[j]), version=10 - int(tau[j]))
    kw = {} if anchor is None else dict(anchor=_t(anchor), anchor_weight=m_w)
    glob, info = buf.flush(version=10, **kw)
    return glob, info


def case_flushes(world, inp):
    out = {}
    for kind in ("stale", "degraded"):
        single, _ = _flush(kind, None)
        out[kind] = {"single": _np(single)}
        for shape in MESHES[world]:
            glob, info = _flush(kind, _ctx(shape))
            out[kind][shape] = {"got": _np(glob), "equal": torch.equal(
                glob, single), "staleness": info["staleness"],
                "coverage": info.get("coverage")}
    if world == 4:
        vecs, w, *_ = flush_inputs("indivisible")
        glob, _ = _flush("indivisible", _ctx((4, 1)))
        want = ops.segment_agg(_t(vecs), _t(w), torch.zeros(
            5, dtype=torch.int32), 1)[0]
        out["indivisible"] = {"got": _np(glob),
                              "equal": torch.equal(glob, want)}
    return out


def _cloud_round(ctx, aligned, perms):
    bank, x, y, sizes, seg, m, g1, g2 = cloud_round_inputs(aligned)
    rnd = hfl.make_cloud_round(loss_quad, 0.05, 4, m, 3, 2, ctx=ctx)
    full = _bank(bank)
    if ctx is None:
        return rnd(full, _t(x), _t(y), _t(sizes), _t(seg), g1, g2, perms)
    return rnd(ctx.place_bank(full), ctx.place_rows(_t(x)),
               ctx.place_rows(_t(y)), ctx.place_rows(_t(sizes)),
               ctx.place_rows(_t(seg)), g1, g2, perms)


def case_cloud_round(world, inp):
    out = {}
    for aligned in (False, True):
        perms = _t(inp["cloud_perms"])
        b, g, e = _cloud_round(None, aligned, perms)
        res = {"single": (_np(b), _np(g), _np(e))}
        for shape in MESHES[world]:
            b1, g1_, e1 = _cloud_round(_ctx(shape), aligned, perms)
            res[shape] = (_np(b1), _np(g1_), _np(e1))
        out[aligned] = res
    return out


def case_fedavg(world, inp):
    bank, x, y, sizes, part = fedavg_inputs()
    perms = _t(inp["fedavg_perms"])
    out = {}
    for label, ctx in (("single", None), ("sharded", _ctx((world, 1)))):
        rnd = hfl.make_fedavg_round(loss_quad, 0.05, 4, 2, ctx=ctx)
        place = (lambda a: a) if ctx is None else ctx.place_rows
        full = _bank(bank)
        b, g = rnd(full if ctx is None else ctx.place_bank(full),
                   place(_t(x)), place(_t(y)), place(_t(sizes)),
                   place(_t(part)), 2, perms)
        out[label] = (_np(b), _np(g))
    return out


def case_placement(world, inp):
    """No rank holds the full bank: the placed bank and the rounds'
    output banks, which reuse the placed rows' storage; a clone passed in
    stays as it was."""
    ctx = _ctx((4, 1))
    bank, x, y, sizes, seg, m, g1, g2 = cloud_round_inputs(True)
    part = ctx.place_bank(_bank(bank))
    before = {k: v.clone() for k, v in part.items()}
    perms = _t(inp["cloud_perms"])
    rnd = hfl.make_cloud_round(loss_quad, 0.05, 4, m, 2, 2, ctx=ctx)
    args = (ctx.place_rows(_t(x)), ctx.place_rows(_t(y)),
            ctx.place_rows(_t(sizes)), ctx.place_rows(_t(seg)),
            np.full(m, 2), np.full(m, 2), perms)
    kept = {k: v.clone() for k, v in part.items()}
    kb, _, _ = rnd(kept, *args)
    untouched = all(torch.equal(part[k], before[k]) for k in part)
    ob, glob, edges = rnd(part, *args)
    ebank, ex, ey, esz, eseg, gvec = edge_round_inputs()
    epart = ctx.place_bank(_bank(ebank))
    er = hfl.make_edge_round(loss_quad, 0.05, 4, 4, 2, 2, ctx=ctx)
    eb, evec = er(epart, ctx.place_rows(_t(ex)), ctx.place_rows(_t(ey)),
                  ctx.place_rows(_t(esz)), ctx.place_rows(_t(eseg)), 1, 2, 2,
                  torch.zeros(15), _t(inp["edge_perms"]))
    return {"placed_rows": _leaf_rows(part), "out_rows": _leaf_rows(ob),
            "edge_out_rows": _leaf_rows(eb),
            "glob_shapes": sorted(tuple(v.shape) for v in glob.values()),
            "edge_shapes": sorted(tuple(v.shape) for v in edges.values()),
            "evec_shape": tuple(evec.shape),
            "in_place": all(ob[k].data_ptr() == part[k].data_ptr()
                           for k in part)
            and eb["w"].data_ptr() == epart["w"].data_ptr(),
            "copy_untouched": untouched,
            "copy_equal": all(torch.equal(kb[k], ob[k]) for k in kb),
            "bank_mat_rows": int(flatbank.bank_spec(ob).flatten(ob).shape[0])}


def case_indivisible(world, inp):
    ctx = _ctx((4, 1))
    bank, x, y, sizes, _ = round_inputs(10, n=10)
    rnd = hfl.make_cloud_round(loss_quad, 0.05, 4, 2, 2, 2, ctx=ctx)
    full = _bank(bank)
    return {
        "local_rows_8": flatbank.local_rows(8, ctx.mesh),
        "local_rows_7": _raises(ValueError,
                                lambda: flatbank.local_rows(7, ctx.mesh)),
        "place_bank": _raises(ValueError, lambda: ctx.place_bank(full)),
        "place_rows": _raises(ValueError, lambda: ctx.place_rows(_t(x))),
        "round": _raises(ValueError, lambda: rnd(
            full, _t(x), _t(y), _t(sizes), torch.zeros(10, dtype=torch.int32),
            np.ones(2, np.int64), np.ones(2, np.int64),
            torch.zeros((2, 2, 10, 8), dtype=torch.int64))),
        "mesh_5": _raises(ValueError, lambda: mesh_lib.make_bank_mesh(5)),
    }


def case_context(world, inp):
    """Construction and validation (one rank); the entry points take the
    context only (the reference's deprecated ``mesh=`` kwargs have no
    counterpart)."""
    sc = hfl.AggContext.single_chip()
    m1 = mesh_lib.make_bank_mesh(1, device="cpu")
    ctx1 = hfl.AggContext.for_mesh(m1)
    bank = {"w": torch.from_numpy(
        np.random.default_rng(21).normal(size=(4, 9)).astype(np.float32))}
    w, seg = torch.ones(4), torch.zeros(4, dtype=torch.int32)
    want = hfl.weighted_aggregate(bank, w, seg, 1)["w"]
    env = AsyncHFLEnv(EnvConfig(task="mnist", mode="analytic", n_devices=8,
                                n_edges=4, threshold_time=300.0, seed=0,
                                device="cpu", agg=ctx1))
    env.reset()
    return {
        "single": (not sc.sharded and sc.mesh is None and sc.n_shards == 1
                   and sc.axes == ()),
        "for_mesh_none": _raises(ValueError,
                                 lambda: hfl.AggContext.for_mesh(None)),
        "for_mesh_str": _raises(TypeError,
                                lambda: hfl.AggContext.for_mesh("mesh")),
        "ctx1": (ctx1.sharded, ctx1.axes, ctx1.n_shards, ctx1.check_rows(8)),
        "mesh1": (m1.axis_names, m1.shape, m1.size, m1.rank, str(m1.device)),
        "mesh_2": _raises(ValueError, lambda: mesh_lib.make_bank_mesh(2)),
        "spec": (flatbank.local_rows(8, m1),
                 flatbank.row_slice(8, m1) == slice(0, 8),
                 _leaf_rows(flatbank.place_bank(bank, m1))),
        "replicated": _np(ctx1.place_replicated(
            {"a": np.arange(3.0), "b": [torch.ones(2)]})["a"]).tolist()
        + [type(flatbank.place_replicated([torch.ones(1)], m1)).__name__,
           ctx1.place_replicated(bank) is not bank,
           sc.place_replicated(bank) is bank, sc.place_rows(w) is w],
        "ctx_equal": torch.equal(hfl.weighted_aggregate(
            ctx1.place_bank(bank), w, seg, 1, ctx=ctx1)["w"], want),
        "bad_ctx": [_raises(TypeError, f) for f in (
            lambda: hfl.weighted_aggregate(bank, w, seg, 1, ctx="nope"),
            lambda: hfl.edge_aggregate(bank, w, seg, 1, ctx=m1),
            lambda: hfl.cloud_aggregate(bank, w, ctx=m1),
            lambda: hfl.make_cloud_round(loss_quad, 0.1, 4, 1, 1, 1, ctx=m1),
            lambda: hfl.make_fedavg_round(loss_quad, 0.1, 4, 1, ctx=m1),
            lambda: StalenessBuffer(2, ctx=m1, device="cpu"),
            lambda: AsyncHFLEnv(EnvConfig(task="mnist", mode="analytic",
                                          device="cpu", agg=m1)))],
        "buffer_ctx": StalenessBuffer(2, ctx=ctx1, device="cpu").ctx is ctx1,
        "mesh_desc": ledger.mesh_desc(ctx1),
        "single_desc": ledger.mesh_desc(sc),
        "snapshot": _analytic_snapshots(env, inp["outdir"]),
    }


def _analytic_snapshots(env, outdir: str) -> tuple:
    """``env`` (analytic, a one-rank mesh) and the same env on one device,
    each reset and saved: (every array equal, the JSON equal)."""
    one = AsyncHFLEnv(dataclasses.replace(env.cfg, agg=None))
    one.reset()
    paths = [os.path.join(outdir, f"ctx-snap-{i}") for i in range(2)]
    for e, path in zip((env, one), paths):
        store.save_runtime(e, path)
    arrays = [np.load(p + ".npz") for p in paths]
    metas = []
    for p in paths:
        with open(p + ".json") as f:
            metas.append(f.read())
    return (arrays[0].files == arrays[1].files and all(
        np.array_equal(arrays[0][k], arrays[1][k]) for k in arrays[0].files),
        metas[0] == metas[1])


def case_edge_round(world, inp):
    bank, x, y, sizes, seg, gvec = edge_round_inputs()
    perms = _t(inp["edge_perms"])

    def run(ctx, j):
        rnd = hfl.make_edge_round(loss_quad, 0.05, 4, 4, 3, 3, ctx=ctx)
        full = _bank(bank)
        place = (lambda a: a) if ctx is None else ctx.place_rows
        b, e = rnd(full if ctx is None else ctx.place_bank(full),
                   place(_t(x)), place(_t(y)), place(_t(sizes)),
                   place(_t(seg)), j, 2, 2, _t(gvec), perms)
        return _np(b), _np(e)

    out = {"single": [run(None, j) for j in range(4)]}
    for shape in MESHES[world]:
        ctx = _ctx(shape)
        out[shape] = [run(ctx, j) for j in range(4)]
    return out


def case_resync(world, inp):
    bank_mat, edge_mat, seg = resync_inputs()
    alive = np.arange(4) == 1                      # edge 1 rejoins
    out = {"single": _np(hfl.masked_resync(_t(edge_mat), _t(bank_mat),
                                           _t(seg), alive))}
    for shape in MESHES[world]:
        ctx = _ctx(shape)
        out[shape] = _np(hfl.masked_resync(
            _t(edge_mat), ctx.place_rows(_t(bank_mat)),
            ctx.place_rows(_t(seg)), alive, ctx=ctx))
    return out


def _sources(inp):
    """The reference's w(0), warmup shuffles and per-version edge-round
    shuffles, as the env hooks take them."""
    w0 = {k: torch.from_numpy(v) for k, v in inp["w0"].items()}
    return dict(init_params=w0,
                perm_source=lambda: _t(inp["warm_perms"]),
                edge_perm_source=lambda v: _t(inp["async_perms"][int(v)]))


def _traj(inp, ctx, kind, telemetry=False):
    acfg, spec = traj_runtime(kind)
    cfg = EnvConfig(**TRAJ_CFG, device="cpu", deterministic=True, agg=ctx,
                    telemetry=telemetry)
    env = AsyncHFLEnv(cfg, acfg, faults=spec, **_sources(inp))
    env.set_topology(TRAJ_ASSIGN)
    env.reset()
    reset_acc = env.acc
    traj, degraded, rows = [], 0, []
    for _ in range(TRAJ_RUNS[kind]):
        _, r, done, info = env.step(np.array([2.0, 2.0]))
        traj.append((float(r), info["acc"], info["edge"], info["flushed"],
                     info["dropped"]))
        degraded += bool(info["flushed"] and env._flush_info.get("degraded"))
        rows.append(_leaf_rows(env.bank))
        if done:
            break
    return {"traj": traj, "degraded": degraded, "reset_acc": reset_acc,
            "gvec": _np(env._global_vec),
            "bank": _np(env._spec.flatten(env.bank)), "rows": rows,
            "trace": len(env.telemetry.recorder) if telemetry else 0}


def case_traj(world, inp):
    out = {}
    for kind in TRAJ_RUNS:
        if world == 1:
            out[(kind, "single")] = _traj(inp, None, kind)
        out[(kind, "sharded")] = _traj(inp, _ctx((world, 1)), kind)
    if world == 2:
        out[("faults", "telemetry")] = _traj(inp, _ctx((2, 1)), "faults",
                                             telemetry=True)
    return out


def _hflenv(inp, ctx):
    perms = iter(inp["env_perms"])
    w0 = {k: torch.from_numpy(v) for k, v in inp["w0"].items()}
    cfg = EnvConfig(**TRAJ_CFG, device="cpu", deterministic=True, agg=ctx)
    env = HFLEnv(cfg, init_params=w0, perm_source=lambda: _t(next(perms)))
    env.set_topology(TRAJ_ASSIGN)
    env.reset()
    accs = [env.acc]
    for _ in range(ENV_ROUNDS):
        _, r, _, info = env.step_raw(np.full(4, 2), np.full(4, 2))
        accs.append(info["acc"])
    spec = flatbank.model_spec(env.global_model)
    return {"accs": accs,
            "gvec": _np(spec.flatten_model(env.global_model)),
            "bank": _np(flatbank.bank_spec(env.bank).flatten(env.bank)),
            "rows": _leaf_rows(env.bank), "device": str(env.device)}


def _fault3_run(cfg: dict, assign, ctx) -> dict:
    """A deterministic MNIST ``HFLEnv`` under ``ctx`` (None: one device):
    reset and one (2, 2) round."""
    env = HFLEnv(EnvConfig(**cfg, agg=ctx))
    env.set_topology(assign)
    env.reset()
    env.step_raw(np.full(cfg["n_edges"], 2), np.full(cfg["n_edges"], 2))
    spec = flatbank.model_spec(env.global_model)
    return {"acc": env.acc, "gvec": _np(spec.flatten_model(
        env.global_model)), "bank": _np(flatbank.bank_spec(
            env.bank).flatten(env.bank)), "rows": _leaf_rows(env.bank)}


def case_one_row(world, inp):
    """ROADMAP fault 3 on the CPU: 4 devices on 4 ranks, one bank row per
    rank, one edge per device, so every training call is its edge's one
    row on both layouts. Sharded and on one device in this process."""
    cfg = dict(TRAJ_CFG, n_devices=4, device="cpu", deterministic=True)
    return {label: _fault3_run(cfg, np.arange(4), ctx)
            for label, ctx in (("single", None), ("sharded", _ctx((4, 1))))}


# 10 devices on 3 edges of 3, 4 and 3 rows: on 2 ranks of 5 rows edge 1
# (rows 3-6) spans them, and so does its 4-row training call
SPAN_ASSIGN = np.array([0, 0, 0, 1, 1, 1, 1, 2, 2, 2])


def case_spanning(world, inp):
    """The non-aligned layout: ``SPAN_ASSIGN`` on 2 ranks, sharded and on
    one device in this process."""
    cfg = dict(TRAJ_CFG, n_devices=10, n_edges=3, device="cpu",
               deterministic=True)
    return {label: _fault3_run(cfg, SPAN_ASSIGN, ctx)
            for label, ctx in (("single", None), ("sharded", _ctx((2, 1))))}


def case_hflenv(world, inp):
    out = {"sharded": _hflenv(inp, _ctx((world, 1)))}
    if world == 1:
        out["single"] = _hflenv(inp, None)
    return out


def _traj_env(inp, ctx, kind="faults"):
    """The deterministic ``TRAJ_CFG`` ``AsyncHFLEnv`` of ``kind`` under
    ``ctx`` (None: one device), with the reference's draws."""
    acfg, spec = traj_runtime(kind)
    cfg = EnvConfig(**TRAJ_CFG, device="cpu", deterministic=True, agg=ctx)
    env = AsyncHFLEnv(cfg, acfg, faults=spec, **_sources(inp))
    env.set_topology(TRAJ_ASSIGN)
    return env


def _events(env, n: int) -> dict:
    """``n`` events at action (2, 2): their (reward, acc, edge, flushed,
    dropped), then the global vector and this rank's bank rows."""
    traj = []
    for _ in range(n):
        _, r, _, info = env.step(np.array([2.0, 2.0]))
        traj.append((float(r), info["acc"], info["edge"], info["flushed"],
                     info["dropped"]))
    return {"traj": traj, "gvec": _np(env._global_vec),
            "bank": _np(env._spec.flatten(env.bank)),
            "rows": _leaf_rows(env.bank)}


def _resume(inp, ctx, path: str) -> dict:
    """A fresh env under ``ctx`` loads ``path`` and runs the rest of the
    faulty trajectory."""
    env = _traj_env(inp, ctx)
    store.load_runtime(env, path)
    return _events(env, TRAJ_RUNS["faults"] - SNAP_AT)


def _label(layout) -> str:
    return layout if isinstance(layout, str) else f"{layout[0]}x{layout[1]}"


def case_snapshot(world, inp):
    """The faulty trajectory under each layout of this world (and on one
    device at world 1): ``SNAP_AT`` events, ``save_runtime`` to
    ``snap-<layout>`` in the world's directory, the rest uninterrupted,
    then a fresh env that loads the snapshot and runs the rest. At
    world 2 the layouts cross: a one-device snapshot at the same event
    (each rank writes its own) loads into a sharded env, and the sharded
    snapshot into a one-device env."""
    layouts = [("single", None)] if world == 1 else []
    layouts += [(shape, _ctx(shape)) for shape in MESHES[world]]
    out = {}
    for layout, ctx in layouts:
        path = os.path.join(inp["outdir"], f"snap-{_label(layout)}")
        env = _traj_env(inp, ctx)
        env.reset()
        head = _events(env, SNAP_AT)
        store.save_runtime(env, path)
        out[layout] = {"head": head["traj"], "path": path,
                       "whole": _events(env, TRAJ_RUNS["faults"] - SNAP_AT),
                       "resumed": _resume(inp, ctx, path)}
    if world == 2:
        single = os.path.join(inp["outdir"], f"snap-one-r{dist.get_rank()}")
        env = _traj_env(inp, None)
        env.reset()
        _events(env, SNAP_AT)
        store.save_runtime(env, single)
        out["cross"] = {"into_sharded": _resume(inp, _ctx((2, 1)), single),
                        "into_single": _resume(inp, None,
                                               out[(2, 1)]["path"])}
    return out


def _share_run(ctx) -> dict:
    """The deterministic ``TRAJ_CFG`` ``HFLEnv`` under ``ctx``:
    ``share_topology``, that topology, reset and one (2, 2) round; the
    labels it read are gathered for the test."""
    env = HFLEnv(EnvConfig(**TRAJ_CFG, device="cpu", deterministic=True,
                           agg=ctx))
    assign = sync.share_topology(env)
    env.set_topology(assign)
    env.reset()
    env.step_raw(np.full(4, 2), np.full(4, 2))
    spec = flatbank.model_spec(env.global_model)
    return {"assign": assign, "acc": env.acc,
            "y": _np(env.agg_ctx.gather_rows(env.fed.y)),
            "gvec": _np(spec.flatten_model(env.global_model)),
            "bank": _np(flatbank.bank_spec(env.bank).flatten(env.bank)),
            "rows": _leaf_rows(env.bank)}


def case_share(world, inp):
    return {"single": _share_run(None), "sharded": _share_run(
        _ctx((world, 1)))}


def _flat(tree, prefix="") -> dict:
    """A nested dict's leaves under their '/'-joined key paths."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _nest(flat: dict) -> dict:
    out = {}
    for key, v in flat.items():
        d = out
        *head, last = key.split("/")
        for part in head:
            d = d.setdefault(part, {})
        d[last] = v
    return out


@contextlib.contextmanager
def _kernel_calls():
    """Counts the calls of the aggregation wrappers (CPU tensors launch no
    kernel, so ``ops.LAUNCHES`` stays 0 here): ``segment_agg`` (one
    launch on the card) and ``segment_sum_partial`` (a rank's partial
    launch) under "segment_agg", as ``LAUNCHES`` counts them, and
    ``segment_broadcast``."""
    counts = {"segment_agg": 0, "segment_broadcast": 0}
    saved = {n: getattr(hier_agg, n) for n in (
        "segment_agg", "segment_sum_partial", "segment_broadcast")}

    def counted(fn, key):
        def call(*args, **kw):
            counts[key] += 1
            return fn(*args, **kw)
        return call

    for name, fn in saved.items():
        setattr(hier_agg, name, counted(fn, "segment_broadcast"
                                        if name == "segment_broadcast"
                                        else "segment_agg"))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(hier_agg, name, fn)


def case_train(world, inp):
    """The reduced qwen3 train step (f32, ``tests/_torch_train_ref.py``'s
    settings) from the reference's initial parameters on replicas (1, 2,
    2) over each rank grid of this world, static and dynamic, plain and
    in deterministic mode: rank 0 returns replica (0, 0, 0) of the round
    (``mesh.gather_params``), every rank its launches, its block and
    whether every replica of the gathered round equals replica (0, 0,
    0) bitwise. The launches are the wrappers' calls
    (``_kernel_calls``)."""
    cfg = tref.config(TRAIN_ARCH, "float32", configs)
    p0 = weights.tree_from_numpy(_nest(inp["train_init"]), "cpu")
    batch = token_batch(0, tref.BATCH, tref.SEQ, cfg.vocab, device="cpu")
    out = {}
    for grid in TRAIN_GRIDS[world]:
        hm = mesh_lib.make_hfl_mesh(TRAIN_REPS, ranks=grid, device="cpu")
        for dynamic in (False, True):
            kw = dict(tref.STEP, mb_per_epoch=tref.MB_PER_EPOCH[TRAIN_ARCH])
            kw.update(dict(dynamic=True, **tref.DYNAMIC) if dynamic
                      else tref.STATIC)
            step, _, _ = train.make_hfl_train_step(cfg, hm, **kw)
            args = (tref.G1E, tref.G2E) if dynamic else ()
            for det in (False, True):
                params = train.lift_params(p0, *hm.block)
                mode = deterministic_algorithms() if det else \
                    contextlib.nullcontext()
                with mode, _kernel_calls() as launches:
                    params = step(params, batch, *args)
                whole = _flat(mesh_lib.gather_params(params, hm))
                res = {"launches": launches, "block": hm.block,
                       "coords": hm.coords, "replicas_equal": all(
                           torch.equal(r, a[0, 0, 0]) for a in whole.values()
                           for r in a.reshape((4,) + a.shape[3:]))}
                if hm.rank == 0:
                    res["replica0"] = {k: _np(a[0, 0, 0])
                                       for k, a in whole.items()}
                out[(grid, dynamic, det)] = res
    return out


def _tp_mesh(world, reps=TRAIN_REPS):
    return mesh_lib.make_hfl_mesh(reps, ranks=TP_GRIDS[world], tp=TP,
                                  device="cpu")


def _tp_placement(world, cfg, params: dict) -> dict:
    """``_placement`` at tp = 2 over this world (rank grid
    ``TP_GRIDS``), replicas ``TP_PLACE_REPS``."""
    reps = TP_PLACE_REPS[world]
    return _placement(_tp_mesh(world, reps), reps, cfg, params)


def _placement(hm, reps, cfg, params: dict) -> dict:
    """``shardings``, ``place_params``, ``tp_blocks``, ``gather_params``
    and ``gather_replica`` on ``hm`` of ``cfg``'s flat numpy ``params``,
    replica r scaled by r + 1, lifted to replicas ``reps``."""
    specs = mesh_lib.hfl_param_specs(cfg, transformer.meta_params(cfg), hm)
    one = weights.tree_from_numpy(_nest(params), "cpu")
    whole = train._map(lambda a: torch.stack([a * (r + 1) for r in range(
        reps[2])]).reshape(reps + tuple(a.shape)), one)
    placed = mesh_lib.place_params(whole, hm)
    back = mesh_lib.gather_params(placed, hm, specs)
    blocks = mesh_lib.tp_blocks(one, hm)
    return {"mesh": {"shape": hm.shape, "grid": hm.grid, "rank": hm.rank,
                     "coords": hm.coords, "tp_rank": hm.tp_rank,
                     "block": hm.block, "groups": (
                         hm.tp_group is not None, hm.fl_group is not None,
                         hm.replica_group is not None),
                     "fsdp_rank": hm.fsdp_rank,
                     "ft_group": hm.ft_group is not None},
            "place": _np(_flat(placed)),
            "shardings": _flat(mesh_lib.shardings(hm, specs, whole)),
            "gather": all(torch.equal(a, b) for a, b in zip(
                train._leaves(back), train._leaves(whole))),
            "blocks": all(torch.equal(a, b[(0,) * 3] / (hm.coords[2] + 1))
                          for a, b in zip(train._leaves(blocks),
                                          train._leaves(placed))),
            "replica": all(torch.equal(a, b) for a, b in zip(
                train._leaves(mesh_lib.gather_replica(blocks, hm, specs)),
                train._leaves(one)))}


def _tp_loss(cfg, params: dict, hm, **kw) -> dict:
    """``Model.loss(tp=)`` of this rank's blocks of ``cfg``'s flat numpy
    ``params`` on ``tp_loss_batch`` and each leaf's gradient block."""
    leaves = {k: v.requires_grad_(True) for k, v in _flat(mesh_lib.tp_blocks(
        weights.tree_from_numpy(_nest(params), "cpu"), hm)).items()}
    batch = {k: torch.from_numpy(v) for k, v in tp_loss_batch(cfg).items()}
    with torch.enable_grad():
        loss = build_model(cfg).loss(_nest(leaves), batch, tp=hm.tp_context,
                                     ft=hm.ft_context, **kw)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return {"loss": float(loss.detach()),
            "grads": {k: _np(g) for k, g in zip(leaves, grads)}}


def _whole_leaves(specs, hm) -> list:
    """The paths of the leaves no spec of ``specs`` splits over more
    than one of ``hm``'s tensor ranks."""
    return [k for k, spec in _flat(specs).items()
            if mesh_lib.tensor_cut(spec, hm) is None]


def _tp_round(cfg, hm, p0, kw, det, args=(), replicated=None) -> dict:
    """One round of ``train.make_hfl_train_step(cfg, hm, **kw)`` from
    this rank's blocks ``p0`` (plain, or in deterministic mode): its
    launches (the wrappers' calls), block, coordinates, the replicated
    leaves (``replicated``, default: every leaf no spec splits), whether
    every replica equals replica (0, 0, 0) bitwise, and on rank 0 that
    replica gathered whole."""
    step, specs, _ = train.make_hfl_train_step(cfg, hm, **kw)
    batch = token_batch(0, tref.BATCH, tref.SEQ, cfg.vocab, device="cpu")
    params = train.lift_params(p0, *hm.block)
    mode = deterministic_algorithms() if det else contextlib.nullcontext()
    with mode, _kernel_calls() as launches:
        params = step(params, batch, *args)
    whole = _flat(mesh_lib.gather_params(params, hm, specs))
    flat = _flat(params)
    res = {"launches": launches, "block": hm.block, "coords": hm.coords,
           "tp_rank": hm.tp_rank,
           "replicated": {k: _np(flat[k]) for k in (
               replicated or _whole_leaves(specs, hm))},
           "replicas_equal": all(
               torch.equal(r, a[0, 0, 0]) for a in whole.values()
               for r in a.reshape((4,) + a.shape[3:]))}
    if hm.rank == 0:
        res["replica0"] = {k: _np(a[0, 0, 0]) for k, a in whole.items()}
    return res


def case_tp(world, inp):
    """The tensor plane at tp = 2 over this world (rank grid
    ``TP_GRIDS``): (a) ``_tp_placement`` of ``tp_config``'s numpy
    parameters (``inp["tp_params"][TRAIN_ARCH]``); (b) ``Model.loss(tp=)``
    (remat at world 4) and each rank's gradient blocks on
    ``tp_loss_batch``; (c) the reduced train step (``case_train``'s
    config, settings and start) on replicas (1, 2, 2): static plain,
    static deterministic twice, dynamic deterministic, rank 0 returning
    replica (0, 0, 0) gathered whole, every rank its launches (the
    wrappers' calls) and (d) its replicated leaves; (e) the refusals,
    and reduced rwkv6 (2 kv heads, 4 wkv heads) taken at tp = 4 (fsdp
    of 2 x world ranks in this world: ``ValueError``)."""
    # (a)
    cfg = tp_config(configs)
    out = _tp_placement(world, cfg, inp["tp_params"][TRAIN_ARCH])
    # (b)
    out.update(_tp_loss(cfg, inp["tp_params"][TRAIN_ARCH], _tp_mesh(
        world, TP_PLACE_REPS[world]), attn_chunk=16, remat=world == 4))
    # (c), (d)
    cfg = tref.config(TRAIN_ARCH, "float32", configs)
    hm = _tp_mesh(world)
    p0 = mesh_lib.tp_blocks(weights.tree_from_numpy(
        _nest(inp["train_init"]), "cpu"), hm)
    out["rounds"] = {}
    for dynamic, det, run in ((False, False, 0), (False, True, 0),
                              (False, True, 1), (True, True, 0)):
        kw = dict(tref.STEP, mb_per_epoch=tref.MB_PER_EPOCH[TRAIN_ARCH])
        kw.update(dict(dynamic=True, **tref.DYNAMIC) if dynamic
                  else tref.STATIC)
        out["rounds"][(dynamic, det, run)] = _tp_round(
            cfg, hm, p0, kw, det, (tref.G1E, tref.G2E) if dynamic else (),
            TP_REPLICATED)
    # (e)
    hybrid = tp_config(configs, "zamba2-7b")
    out["errors"] = {
        "fsdp": _raises(ValueError, lambda: mesh_lib.make_hfl_mesh(
            TRAIN_REPS, fsdp=2 * world, device="cpu")),
        "family": _raises(NotImplementedError, lambda: (
            train.make_hfl_train_step(hybrid, hm)))}
    if world == 4:
        hm4 = mesh_lib.make_hfl_mesh(TRAIN_REPS, tp=4, device="cpu")
        out["errors"]["heads"] = _raises(ValueError, lambda: (
            train.make_hfl_train_step(tp_config(configs), hm4)))
        out["errors"]["rwkv_heads"] = _raises(ValueError, lambda: (
            train.make_hfl_train_step(tp_config(configs, RWKV_ARCH), hm4)))
    return out


def case_tp_rwkv(world, inp):
    """The tensor plane of the ssm family, reduced rwkv6: (a)
    ``_tp_placement`` of its numpy parameters
    (``inp["tp_params"][RWKV_ARCH]``); (b) ``Model.loss(tp=)`` and each
    rank's gradient blocks on ``tp_loss_batch`` over tp = ``RWKV_TP
    [world]`` ranks (replicas (1, 1, 1)), through each WKV route; (c) the
    reduced static train step (``tests/_torch_train_ref.py``'s rwkv6
    settings, the reference's start ``inp["train_init_rwkv"]``) on
    replicas (1, 2, 2) at tp = 2 over ``TP_GRIDS[world]``, plain and
    twice in deterministic mode; at world 2 also (d) ``_tp_guarded``."""
    cfg = tp_config(configs, RWKV_ARCH)
    out = {"place": _tp_placement(world, cfg, inp["tp_params"][RWKV_ARCH])}
    hm = mesh_lib.make_hfl_mesh((1, 1, 1), tp=RWKV_TP[world], device="cpu")
    out["loss"] = {route: _tp_loss(cfg, inp["tp_params"][RWKV_ARCH], hm,
                                   wkv_chunked=chunked)
                   for route, chunked in WKV_ROUTES.items()}
    if world == 2:
        out["guarded"] = _tp_guarded(cfg, hm)
    cfg = tref.config(RWKV_ARCH, "float32", configs)
    hm = _tp_mesh(world)
    p0 = mesh_lib.tp_blocks(weights.tree_from_numpy(
        _nest(inp["train_init_rwkv"]), "cpu"), hm)
    kw = dict(tref.STEP, mb_per_epoch=tref.MB_PER_EPOCH[RWKV_ARCH],
              **tref.STATIC)
    out["rounds"] = {(det, run): _tp_round(cfg, hm, p0, kw, det)
                     for det, run in ((False, 0), (True, 0), (True, 1))}
    return out


def _tp_guarded(cfg, hm) -> dict:
    """``cfg`` with d_ff = 511, which tp = 2 does not divide, so the
    guard keeps the channel mix's ``w_k`` and ``w_v`` whole (only its
    gate splits): ``Model.loss(tp=)`` and the gradient blocks against
    the one-device loss and the same blocks of its gradients, from
    seed-0 weights; the largest difference of each and ``w_k``'s block
    shape."""
    cfg = dataclasses.replace(cfg, d_ff=511)
    model = build_model(cfg)
    p0 = _flat(model.init(torch.Generator().manual_seed(0), "cpu"))
    batch = {k: torch.from_numpy(v) for k, v in tp_loss_batch(cfg).items()}
    res = {}
    for label, tp in (("one", None), ("tp", hm.tp_context)):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        if tp is not None:
            leaves = {k: v.detach().requires_grad_(True) for k, v in _flat(
                mesh_lib.tp_blocks(_nest(leaves), hm)).items()}
        with torch.enable_grad():
            loss = model.loss(_nest(leaves), batch, tp=tp, wkv_chunked=True)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
        if tp is None:
            grads = _flat(mesh_lib.tp_blocks(_nest(grads), hm))
        res[label] = (float(loss.detach()), grads,
                      tuple(leaves["layers/cmix/w_k"].shape))
    (l1, g1, _), (l2, g2, shape) = res["one"], res["tp"]
    return {"loss": abs(l1 - l2), "w_k": shape,
            "grads": max(float((g1[k] - g2[k]).abs().max()) for k in g1)}


def case_tp_gather(world, inp):
    """``tp.gather`` over the world (one tp group of every rank), f32 and
    bf16: its result and the gradient of ``(y.float() * c).sum()`` at
    this rank's block, and the same through a plain ``torch.cat`` of
    every rank's block (drawn from seed 11 + rank)."""
    rank = dist.get_rank()
    ctx = tp_mod.TPContext(None, world, rank)
    c = torch.from_numpy(np.random.default_rng(10).normal(
        size=(2, 3, 5 * world)).astype(np.float32))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        xs = [torch.from_numpy(np.random.default_rng(11 + r).normal(
            size=(2, 3, 5)).astype(np.float32)).to(dtype)
            for r in range(world)]
        res = {}
        for how in ("gather", "plain"):
            x = xs[rank].clone().requires_grad_(True)
            with torch.enable_grad():
                y = tp_mod.gather(x, ctx) if how == "gather" else \
                    torch.cat(xs[:rank] + [x] + xs[rank + 1:], dim=-1)
                gx, = torch.autograd.grad((y.float() * c).sum(), x)
            res[how] = (_np(y), _np(gx), str(y.dtype), str(gx.dtype))
        out[str(dtype)] = res
    return out


def _fsdp_key(arch: str, vocab=None) -> str:
    """The key of ``inp["tp_params"]`` for ``tp_config(arch, vocab)``."""
    return arch if vocab is None else f"{arch}/{vocab}"


def case_fsdp(world, inp):
    """The fsdp axis over this world: (a) ``_placement`` of reduced
    qwen3's and whisper-base's numpy parameters at (1, 1, 2, T), T =
    ``FSDP_TP[world]``, replicas ``FSDP_PLACE_REPS`` on every rank; (b)
    ``Model.loss(tp=, ft=)`` and each rank's gradient blocks of every
    case of ``FSDP_LOSSES[world]`` on ``tp_loss_batch`` (replicas (1, 1,
    1)); (c) the reduced qwen3 static train step (``case_train``'s f32
    settings and start) on replicas (1, 2, 2) at F = 2, T = 1 over rank
    grid ``FSDP_GRIDS[world]``, its launches (the wrappers' calls) and
    the leaves no spec splits; (d) ``derive_bank_mesh`` of that mesh
    (tensor coordinates (0, 0), ``ValueError`` elsewhere) and the
    refusals: every family of ``FSDP_REFUSED`` at F = 2 and, at world 4,
    audio at T = 2 (``NotImplementedError``)."""
    tp = FSDP_TP[world]
    hm = mesh_lib.make_hfl_mesh((1, 1, 1), fsdp=FSDP, tp=tp, device="cpu")
    place = mesh_lib.make_hfl_mesh(FSDP_PLACE_REPS, fsdp=FSDP, tp=tp,
                                   device="cpu")
    out = {"place": {arch: _placement(place, FSDP_PLACE_REPS, tp_config(
        configs, arch), inp["tp_params"][arch])
        for arch in (TRAIN_ARCH, AUDIO_ARCH)}, "loss": {}}
    for arch, f, t, vocab in FSDP_LOSSES[world]:
        cfg = tp_config(configs, arch, vocab)
        lm = hm if (f, t) == (FSDP, tp) else mesh_lib.make_hfl_mesh(
            (1, 1, 1), fsdp=f, tp=t, device="cpu")
        out["loss"][(arch, vocab)] = _tp_loss(
            cfg, inp["tp_params"][_fsdp_key(arch, vocab)], lm, attn_chunk=16)
    cfg = tref.config(TRAIN_ARCH, "float32", configs)
    tm = mesh_lib.make_hfl_mesh(TRAIN_REPS, ranks=FSDP_GRIDS[world],
                                fsdp=FSDP, device="cpu")
    p0 = mesh_lib.tp_blocks(weights.tree_from_numpy(
        _nest(inp["train_init"]), "cpu"), tm)
    kw = dict(tref.STEP, mb_per_epoch=tref.MB_PER_EPOCH[TRAIN_ARCH],
              **tref.STATIC)
    out["round"] = _tp_round(cfg, tm, p0, kw, False)
    out["round"]["fsdp_rank"] = tm.fsdp_rank
    try:
        bm = mesh_lib.derive_bank_mesh(tm)
        out["bank"] = (bm.shape, bm.rank)
    except ValueError:
        out["bank"] = None
    out["errors"] = {arch: _raises(NotImplementedError, lambda: (
        train.make_hfl_train_step(tp_config(configs, arch), hm)))
        for arch in FSDP_REFUSED}
    if world == 4:
        out["errors"]["audio_tp"] = _raises(NotImplementedError, lambda: (
            train.make_hfl_train_step(tp_config(configs, AUDIO_ARCH), hm)))
    return out


def case_mesh(world, inp):
    """The mesh functions in this world: ``derive_hfl_mesh`` over the
    world's devices, ``rank_grid``, ``derive_bank_mesh``, ``shardings``
    of the train step's specs, ``place_params``/``gather_params``, and the
    layouts (``make_production_mesh``, ``derive_serve_mesh``)."""
    from repro_torch.launch import mesh as m
    out = {"grid": m.rank_grid(TRAIN_REPS, world)}
    hm = m.make_hfl_mesh(TRAIN_REPS, ranks=out["grid"], device="cpu")
    out["hfl"] = (hm.shape, hm.grid, hm.rank, hm.coords, hm.block,
                  hm.fl_group is not None)
    bm = m.derive_bank_mesh(hm)
    out["bank"] = (bm.shape, bm.size, bm.rank)
    bank = {"w": torch.arange(16 * 3, dtype=torch.float32).reshape(16, 3)}
    ctx = hfl.AggContext.for_mesh(bm)
    out["bank_rows"] = _np(ctx.place_bank(bank)["w"])
    out["bank_gathered"] = _np(ctx.gather_rows(ctx.place_rows(bank["w"])))
    out["derive_errors"] = (
        _raises(ValueError, lambda: m.derive_hfl_mesh(["cpu"] * world,
                                                      (3, 1, 1, 1))),
        _raises(ValueError, lambda: m.make_hfl_mesh(TRAIN_REPS,
                                                    ranks=(1, 1, 4))),
        _raises(ValueError, lambda: m.make_hfl_mesh(
            TRAIN_REPS, fsdp=2 * world, device="cpu")))
    if world > 1:
        out["derived"] = m.derive_hfl_mesh(["cpu"] * world,
                                           (world, 1, 1, 1)).shape
        out["derive_tp"] = m.derive_hfl_mesh(["cpu"] * world,
                                             (1, 1, 1, world)).shape
        out["derive_fsdp"] = m.derive_hfl_mesh(["cpu"] * world,
                                               (1, 1, 2, world // 2)).shape
    full = {"a": {"w": torch.arange(4 * 6, dtype=torch.float32).reshape(
        1, 2, 2, 6)}, "b": torch.arange(4.0).reshape(1, 2, 2)}
    mine = m.place_params(full, hm)
    specs = {"a": {"w": m.REPLICA_AXES + (None,)},
             "b": m.REPLICA_AXES}
    idx = m.shardings(hm, specs)
    out["shardings"] = idx
    out["place"] = (_np(mine["a"]["w"]), torch.equal(
        full["a"]["w"][idx["a"]["w"]], mine["a"]["w"]))
    back = m.gather_params(mine, hm)
    out["gather"] = torch.equal(back["a"]["w"], full["a"]["w"]) and \
        torch.equal(back["b"], full["b"])
    serve = m.derive_serve_mesh(m.make_production_mesh(n_ranks=256), 8)
    out["shardings_tp"] = _raises(NotImplementedError, lambda: m.shardings(
        serve, {"w": (None, "tp")}))
    out["production"] = _raises(ValueError, m.make_production_mesh)
    return out


def _serve_run(cfg, params, mesh, batch: int, window: int) -> dict:
    """``serve``'s steps over ``mesh`` from the whole ``params``: the
    prefill of ``SERVE_PROMPT`` tokens (``max_new`` ``SERVE_STEPS``)
    and ``SERVE_STEPS`` decode steps fed ``serve_tokens(batch)``, each
    on this rank's blocks and rows (``serve.take`` of the factories'
    shardings). Returns the rank's prefill logits and cache blocks, the
    decode steps' logits and the cache blocks after the last step."""
    toks = torch.from_numpy(serve_tokens(batch))
    pre, param_sh, batch_sh, _ = serve.make_prefill_step(
        cfg, mesh, batch=batch, seq=SERVE_PROMPT, window=window,
        max_new=SERVE_STEPS)
    blocks = serve.take(params, param_sh)
    c = min(SERVE_PROMPT, window) if window else SERVE_PROMPT + SERVE_STEPS
    dec, _, _, token_sh = serve.make_decode_step(
        cfg, mesh, batch=batch, cache_len=c, window=window)
    with torch.no_grad():
        logits, cache = pre(blocks,
                            {"tokens": toks[batch_sh][:, :SERVE_PROMPT]})
        # copies: the decode steps write the cache in place
        out = {"prefill": _np(logits), "prefill_cache": _np({
            k: cache[k].clone() for k in ("k", "v", "pos")}),
            "t": [cache["t"]]}
        steps = []
        for i in range(SERVE_PROMPT, SERVE_PROMPT + SERVE_STEPS):
            lg, cache = dec(blocks, cache, toks[:, i:i + 1][token_sh])
            steps.append(_np(lg))
            out["t"].append(cache["t"])
    out["steps"] = steps
    out["cache"] = _np({k: cache[k] for k in ("k", "v", "pos")})
    return out


def case_serve_mesh(world, inp):
    """Mesh serving over this world: for each layout and batch of
    ``SERVE_LAYOUTS[world]`` and each window of ``SERVE_WINDOWS``,
    ``_serve_run`` of ``tp_config``'s reduced qwen3 (f32 activations) on
    ``inp["tp_params"]``; the mesh's shape, coordinates and group; this
    rank's parameter blocks at the first layout; ``derive_serve_mesh``
    of the world's ranks at tp = 2; and the refusals:
    reduced rwkv6 (a non-dense family: ``NotImplementedError``), at world
    4 reduced qwen3 at T = 4 (2 kv heads: ``ValueError``) and
    ``SERVE_FSDP_ARCH`` at (1, 2, 2) (``fsdp_serve`` with batch 2:
    ``NotImplementedError``)."""
    cfg = tp_config(configs)
    params = weights.tree_from_numpy(_nest(inp["tp_params"][TRAIN_ARCH]),
                                     "cpu")
    out = {"runs": {}}
    for dims, batch in SERVE_LAYOUTS[world]:
        mesh = mesh_lib.make_serve_mesh(dims[2], ranks=dims[:2],
                                        device="cpu")
        out["mesh"] = (mesh.shape, mesh.coords, mesh.tp_rank,
                       mesh.tp_group is not None)
        if "blocks" not in out:
            param_sh = serve.make_prefill_step(cfg, mesh, batch=batch,
                                               seq=SERVE_PROMPT)[1]
            out["blocks"] = _np(_flat(serve.take(params, param_sh)))
        for window in SERVE_WINDOWS:
            out["runs"][(dims, batch, window)] = _serve_run(
                cfg, params, mesh, batch, window)
    # the world's ranks as a one-pod ("data", "model") layout: a process
    # group spans them, so derive_serve_mesh builds a runnable mesh
    layout = mesh_lib.RankMesh(np.arange(world).reshape(1, world),
                               ("data", "model"))
    derived = mesh_lib.derive_serve_mesh(layout, 2, device="cpu")
    out["derived"] = (type(derived).__name__, derived.shape,
                      derived.coords)
    errors = {"family": _raises(NotImplementedError, lambda: (
        serve.make_decode_step(tp_config(configs, RWKV_ARCH), mesh,
                               batch=2, cache_len=20)))}
    if world == 4:
        m4 = mesh_lib.make_serve_mesh(4, device="cpu")
        errors["heads"] = _raises(ValueError, lambda: (
            serve.make_prefill_step(cfg, m4, batch=2, seq=16)))
        errors["fsdp_serve"] = _raises(NotImplementedError, lambda: (
            serve.make_decode_step(configs.get_config(SERVE_FSDP_ARCH), mesh,
                                   batch=2, cache_len=20)))
    out["errors"] = errors
    return out


CASES = [("context", (1,), case_context),
         ("agg_mixed", (1, 2, 4), case_agg_mixed),
         ("uneven", (4,), case_uneven),
         ("bf16", (2, 4), case_bf16),
         ("broadcast", (2, 4), case_broadcast),
         ("cloud_agg", (2, 4), case_cloud_agg),
         ("flushes", (1, 2, 4), case_flushes),
         ("cloud_round", (1, 2, 4), case_cloud_round),
         ("fedavg", (4,), case_fedavg),
         ("placement", (4,), case_placement),
         ("indivisible", (4,), case_indivisible),
         ("edge_round", (1, 2, 4), case_edge_round),
         ("resync", (2, 4), case_resync),
         ("hflenv", (1, 2), case_hflenv),
         ("one_row", (4,), case_one_row),
         ("spanning", (2,), case_spanning),
         ("traj", (1, 2, 4), case_traj),
         ("snapshot", (1, 2, 4), case_snapshot),
         ("share", (4,), case_share),
         ("train", (1, 2, 4), case_train),
         ("mesh", (1, 2, 4), case_mesh),
         ("tp", (2, 4), case_tp),
         ("tp_rwkv", (2, 4), case_tp_rwkv),
         ("tp_gather", (2, 4), case_tp_gather),
         ("fsdp", (2, 4), case_fsdp),
         ("serve_mesh", (2, 4), case_serve_mesh)]


def card_aggregation(rank: int, world: int, port: int, outdir: str) -> None:
    """One rank of a gloo group on the card (a ``torch.multiprocessing.
    spawn`` target of ``tests/test_torch_cuda.py``): MNIST-width Eq. 1
    (50 x 21,840, 5 contiguous edges of 10 rows, random weights) through
    ``segment_agg_sharded`` on this rank's rows against the single launch
    on the whole bank and the plain version, and the shard-local resync
    of edge 2 against the one-device resync and the plain gather; writes
    its findings to ``outdir/rank<r>.pt``."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        ctx = mesh_lib.make_bank_context(world)
        dev, e = ctx.mesh.device, 5
        gen = torch.Generator(device=dev).manual_seed(3)
        bank = torch.randn((50, 21840), generator=gen, device=dev)
        w = torch.rand((50,), generator=gen, device=dev) + 0.5
        seg = torch.repeat_interleave(torch.arange(e, device=dev),
                                      10).to(torch.int32)
        single = ops.segment_agg(bank, w, seg, e)
        lb, lw, ls = (ctx.place_rows(bank), ctx.place_rows(w),
                      ctx.place_rows(seg))
        ops.reset_launches()
        got = ops.segment_agg_sharded(lb, lw, ls, e, ctx.mesh.group)
        launches = dict(ops.LAUNCHES)
        plain = ref.segment_agg_sharded_ref(lb, lw, ls, e, ctx.mesh.group)
        one = [j for j in range(e) if j * 10 // 25 == (j * 10 + 9) // 25]
        span = [j for j in range(e) if j not in one]
        edge_mat = torch.randn((e, 21840), generator=gen, device=dev)
        alive = np.arange(e) == 2
        rows = flatbank.row_slice(50, ctx.mesh)
        resync = hfl.masked_resync(edge_mat, lb, ls, alive, ctx=ctx)
        keep = torch.as_tensor(alive, device=dev)[ls.long()]
        res = {"launches": launches, "device": str(got.device),
               "one_rank_edges": one,
               "bitwise": torch.equal(got[one], single[one]),
               "span": bool(torch.allclose(got[span], single[span],
                                           atol=1e-5, rtol=1e-5)),
               "plain": bool(torch.allclose(got, plain, atol=1e-5,
                                            rtol=1e-5)),
               "resync": torch.equal(
                   resync, hfl.masked_resync(edge_mat, bank, seg,
                                             alive)[rows]),
               "resync_plain": torch.equal(resync, torch.where(
                   keep[:, None], ref.segment_broadcast_ref(
                       edge_mat, ls, lb.dtype), lb))}
        torch.save(res, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# the deterministic MNIST env of the card's fault-3 test
# (tests/test_torch_cuda.py), SPAN_ASSIGN's edges on 2 ranks of 5 rows
CARD_ROUND_CFG = dict(task="mnist", mode="real", n_devices=10, n_edges=3,
                      n_local=64, gamma_max=2, deterministic=True)


def card_round(rank: int, world: int, port: int, outdir: str) -> None:
    """One rank of a gloo group on the card (a ``torch.multiprocessing.
    spawn`` target of ``tests/test_torch_cuda.py``): the
    ``CARD_ROUND_CFG`` env under a ``world``-rank context, reset and one
    (2, 2) round; writes its accuracy, global vector and bank rows to
    ``outdir/rank<r>.pt``."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        ctx = mesh_lib.make_bank_context(world)
        env = HFLEnv(EnvConfig(**CARD_ROUND_CFG, agg=ctx))
        env.set_topology(SPAN_ASSIGN)
        env.reset()
        env.step_raw(np.full(3, 2), np.full(3, 2))
        spec = flatbank.model_spec(env.global_model)
        torch.save({"acc": env.acc, "device": str(ctx.mesh.device),
                    "gvec": spec.flatten_model(env.global_model).cpu(),
                    "bank": flatbank.bank_spec(env.bank).flatten(
                        env.bank).cpu()},
                   os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# the deterministic faulty MNIST trajectory of the card's snapshot test
# (tests/test_torch_cuda.py): 8 devices on 2 ranks, TRAJ_ASSIGN's edges
CARD_SNAP_CFG = dict(task="mnist", mode="real", n_devices=8, n_edges=4,
                     n_local=64, gamma_max=2, threshold_time=300.0,
                     deterministic=True)


def card_snapshot_env(ctx):
    """The ``CARD_SNAP_CFG`` ``AsyncHFLEnv`` with the faulty trajectory's
    runtime under ``ctx`` (None: one device), on the card."""
    acfg, spec = traj_runtime("faults")
    env = AsyncHFLEnv(EnvConfig(**CARD_SNAP_CFG, agg=ctx), acfg, faults=spec)
    env.set_topology(TRAJ_ASSIGN)
    return env


def card_snapshot(rank: int, world: int, port: int, outdir: str) -> None:
    """One rank of a gloo group on the card (a ``torch.multiprocessing.
    spawn`` target of ``tests/test_torch_cuda.py``): the
    ``card_snapshot_env`` trajectory, saved after ``SNAP_AT`` events to
    ``outdir/snap``, the rest uninterrupted, then a fresh env that loads
    it and runs the rest; writes both ends to ``outdir/rank<r>.pt``."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        ctx = mesh_lib.make_bank_context(world)
        env = card_snapshot_env(ctx)
        env.reset()
        _events(env, SNAP_AT)
        path = os.path.join(outdir, "snap")
        store.save_runtime(env, path)
        whole = _events(env, TRAJ_RUNS["faults"] - SNAP_AT)
        env = card_snapshot_env(ctx)
        store.load_runtime(env, path)
        torch.save({"whole": whole, "device": str(env.device),
                    "resumed": _events(env, TRAJ_RUNS["faults"] - SNAP_AT)},
                   os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def card_train_setup(dev):
    """The card's reduced train step: qwen3 with ``tests/
    _torch_train_ref.py``'s config and settings, seed-0 weights drawn on
    ``dev``, its batch; returns (cfg, params, batch, step kwargs)."""
    cfg = tref.config(TRAIN_ARCH, "float32", configs)
    p0 = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                               dev)
    batch = token_batch(0, tref.BATCH, tref.SEQ, cfg.vocab, device=dev)
    kw = dict(tref.STEP, mb_per_epoch=tref.MB_PER_EPOCH[TRAIN_ARCH],
              **tref.STATIC)
    return cfg, p0, batch, kw


def card_train(rank: int, world: int, port: int, outdir: str) -> None:
    """One rank of a gloo group on the card (a spawn target of
    ``tests/test_torch_cuda.py``): the reduced static (2, 2) round on
    replicas (1, 2, 2) over rank grid ``mesh.rank_grid`` of ``world``
    ranks in deterministic mode, with the launch counts set to 0 just
    before; writes the gathered round (on the CPU) and the launches to
    ``outdir/rank<r>.pt``."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        grid = mesh_lib.rank_grid(TRAIN_REPS, world)
        hm = mesh_lib.make_hfl_mesh(TRAIN_REPS, ranks=grid)
        cfg, p0, batch, kw = card_train_setup(hm.device)
        step, _, _ = train.make_hfl_train_step(cfg, hm, **kw)
        params = train.lift_params(p0, *hm.block)
        ops.reset_launches()
        with deterministic_algorithms():
            params = step(params, batch)
        launches = dict(ops.LAUNCHES)
        whole = _flat(mesh_lib.gather_params(params, hm))
        torch.save({"launches": launches, "device": str(hm.device),
                    "grid": grid, "round": {k: v.cpu()
                                            for k, v in whole.items()}},
                   os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def card_tp_train(rank: int, world: int, port: int, outdir: str,
                  fsdp: int = 1) -> None:
    """One rank of a gloo group on the card (a spawn target of
    ``tests/test_torch_cuda.py``): the reduced static (2, 2) round
    (``card_train_setup``) on replicas (1, 2, 2), each replica over
    ``world`` tensor ranks, ``fsdp`` x ``world / fsdp`` tp: twice on the
    card in deterministic mode, the launch counts set to 0 just before
    the first, then once on the CPU from the same weights; writes
    replica (0, 0, 0) of each, gathered whole (on the CPU), the leaves
    no spec splits and the launches to ``outdir/rank<r>.pt``."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        out = {"rounds": [], "replicated": []}
        for dev in ("cuda", "cuda", "cpu"):
            hm = mesh_lib.make_hfl_mesh(TRAIN_REPS, fsdp=fsdp,
                                        tp=world // fsdp, device=dev)
            cfg, p0, batch, kw = card_train_setup(torch.device("cuda"))
            step, specs, _ = train.make_hfl_train_step(cfg, hm, **kw)
            params = train.lift_params(mesh_lib.tp_blocks(p0, hm),
                                       *hm.block)
            batch = {k: v.to(hm.device) for k, v in batch.items()}
            if not out["rounds"]:
                ops.reset_launches()
            mode = deterministic_algorithms() if dev == "cuda" else \
                contextlib.nullcontext()
            with mode:
                params = step(params, batch)
            if "launches" not in out:
                out["launches"] = dict(ops.LAUNCHES)
                out["device"] = str(hm.device)
            whole = _flat(mesh_lib.gather_params(params, hm, specs))
            flat = _flat(params)
            out["rounds"].append({k: a[0, 0, 0].cpu()
                                  for k, a in whole.items()})
            out["replicated"].append({k: flat[k].cpu()
                                      for k in _whole_leaves(specs, hm)})
        torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def card_tp_rwkv(rank: int, world: int, port: int, outdir: str) -> None:
    """One rank of a gloo group on the card (a spawn target of
    ``tests/test_torch_cuda.py``): reduced rwkv6 (``tp_config``, f32
    activations) from seed-0 weights drawn on the card, split over
    ``world`` tp ranks (replicas (1, 1, 1)): ``Model.loss(tp=)`` and this
    rank's gradient blocks on ``tp_loss_batch`` through each WKV route,
    beside the one-device loss and the same blocks of its gradients, all
    on the card; writes them (on the CPU) to ``outdir/rank<r>.pt``."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        hm = mesh_lib.make_hfl_mesh((1, 1, 1), tp=world)
        cfg = tp_config(configs, RWKV_ARCH)
        model = build_model(cfg)
        p0 = _flat(model.init(torch.Generator(device=hm.device).manual_seed(
            0), hm.device))
        batch = {k: torch.from_numpy(v).to(hm.device)
                 for k, v in tp_loss_batch(cfg).items()}
        out = {"device": str(hm.device)}
        for route, chunked in WKV_ROUTES.items():
            res = {}
            for label, tp in (("one", None), ("tp", hm.tp_context)):
                leaves = {k: v.detach().clone().requires_grad_(True)
                          for k, v in p0.items()}
                if tp is not None:
                    leaves = {k: v.detach().requires_grad_(True)
                              for k, v in _flat(mesh_lib.tp_blocks(
                                  _nest(leaves), hm)).items()}
                with torch.enable_grad():
                    loss = model.loss(_nest(leaves), batch, tp=tp,
                                      wkv_chunked=chunked)
                    grads = torch.autograd.grad(loss, list(leaves.values()))
                grads = dict(zip(leaves, grads))
                if tp is None:      # this rank's blocks of the whole grads
                    grads = _flat(mesh_lib.tp_blocks(_nest(grads), hm))
                res[label] = {"loss": float(loss.detach()),
                              "grads": {k: g.cpu() for k, g in
                                        grads.items()}}
            out[route] = res
        torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def card_fsdp_loss(rank: int, world: int, port: int, outdir: str) -> None:
    """One rank of a gloo group on the card (a spawn target of
    ``tests/test_torch_cuda.py``): reduced whisper-base (``tp_config``,
    f32 activations; vocab 512, split, and 515, whole) from seed-0
    weights drawn on the card, split over ``world`` fsdp ranks (T = 1,
    replicas (1, 1, 1)): ``Model.loss(ft=)`` and this rank's gradient
    blocks on ``tp_loss_batch``, beside the one-device loss and the same
    blocks of its gradients, all on the card; writes them (on the CPU)
    to ``outdir/rank<r>.pt``."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        hm = mesh_lib.make_hfl_mesh((1, 1, 1), fsdp=world)
        out = {"device": str(hm.device)}
        for vocab in (None, 515):
            cfg = tp_config(configs, AUDIO_ARCH, vocab)
            model = build_model(cfg)
            p0 = _flat(model.init(torch.Generator(
                device=hm.device).manual_seed(0), hm.device))
            batch = {k: torch.from_numpy(v).to(hm.device)
                     for k, v in tp_loss_batch(cfg).items()}
            res = {}
            for label, ft in (("one", None), ("ft", hm.ft_context)):
                leaves = {k: v.detach().clone().requires_grad_(True)
                          for k, v in p0.items()}
                if ft is not None:
                    leaves = {k: v.detach().requires_grad_(True)
                              for k, v in _flat(mesh_lib.tp_blocks(
                                  _nest(leaves), hm)).items()}
                with torch.enable_grad():
                    loss = model.loss(_nest(leaves), batch, ft=ft)
                    grads = torch.autograd.grad(loss, list(leaves.values()))
                grads = dict(zip(leaves, grads))
                if ft is None:      # this rank's blocks of the whole grads
                    grads = _flat(mesh_lib.tp_blocks(_nest(grads), hm))
                res[label] = {"loss": float(loss.detach()),
                              "grads": {k: g.cpu() for k, g in
                                        grads.items()}}
            out[vocab] = res
        torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def card_serve_mesh(rank: int, world: int, port: int, outdir: str) -> None:
    """One rank of a gloo group on the card (a spawn target of
    ``tests/test_torch_cuda.py``): reduced qwen3 (seed-3 weights drawn on
    the card) served over the serve mesh ``(1, 1, world)``, prefill of 16
    tokens and 4 decode steps fed the one-device serve's greedy tokens,
    in bf16 and in f32 activations, beside the one-device serve of the
    same weights in this process; the launch counts and flash paths set
    to 0 just before each mesh serve. Writes every step's logits of both
    serves (on the CPU), the launches and the paths to
    ``outdir/rank<r>.pt``."""
    import dataclasses
    from repro_torch.kernels import flash_attention as fa
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = mesh_lib.make_serve_mesh(world, device="cuda")
        dev = mesh.device
        out = {"device": str(dev)}
        for act in ("bfloat16", "float32"):
            cfg = dataclasses.replace(configs.get_config(TRAIN_ARCH).reduce(),
                                      activ_dtype=act)
            params = build_model(cfg).init(
                torch.Generator(device=dev).manual_seed(3), dev)
            toks = token_batch(4, 2, 16, cfg.vocab, device=dev)["tokens"]
            one = serve.greedy_serve(cfg, params, toks, 4)
            _, param_sh, _, _ = serve.make_prefill_step(
                cfg, mesh, batch=2, seq=16, max_new=4)
            blocks = serve.take(params, param_sh)
            ops.reset_launches()
            fa.reset_paths()
            split = serve.greedy_serve(cfg, blocks, toks, 4, mesh=mesh,
                                       forced=one["tokens"])
            out[act] = {"launches": dict(ops.LAUNCHES),
                        "paths": dict(fa.PATH_CALLS),
                        "one": [lg.cpu() for lg in one["logits"]],
                        "mesh": [lg.cpu() for lg in split["logits"]],
                        "fed": split["tokens"].cpu(),
                        "greedy": one["tokens"].cpu()}
        torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _rank(rank: int, world: int, inputs: str, outdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(outdir, "store"),
        rank=rank, world_size=world)
    try:
        with open(inputs, "rb") as f:
            inp = pickle.load(f)
        inp["outdir"] = outdir
        res = {name: fn(world, inp) for name, worlds, fn in CASES
               if world in worlds}
        with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def main() -> None:
    world, inputs, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    mp.spawn(_rank, args=(world, inputs, outdir), nprocs=world, join=True)


if __name__ == "__main__":
    main()
