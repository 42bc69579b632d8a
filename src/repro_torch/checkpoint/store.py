"""Minimal npz-based pytree checkpointing plus full async-runtime crash
recovery (``save_runtime`` / ``load_runtime``); the port of
``repro.checkpoint.store``.

Leaves of a nested dict/list/tuple of tensors are stored under their
key paths (``"a/0/b"``, dict keys in sorted order as JAX flattens them)
in ``<path>.npz``, with the structure beside it in ``<path>.tree.json``.
bfloat16 has no numpy dtype and is stored as f32 (exact); a load casts
each leaf back to its template's dtype and device.

The runtime snapshot keeps the reference's layout and field names:
arrays in ``<path>.npz``, scalars and structure in ``<path>.json``
(Python's JSON float repr round-trips IEEE doubles exactly). It holds
everything ``AsyncHFLEnv`` needs to resume mid-stream bit for bit: the
pending event queue (times, seq counter, payloads with their round costs
and model snapshots), the staleness buffer, the staleness counters, the
flat model bank, the env's numpy generator, the fault injector's state,
telemetry, health and the ledger run id.

Where the reference saves its ``jax.random`` key chain (``key``,
``abase``), the port saves the state of its own draws in fields of its
own: the round generator's state (``perm_gen_state``, npz) and the
episode's edge-shuffle base (``edge_perm_base``, JSON). An injected
``perm_source`` / ``edge_perm_source`` keeps its own state. A reference
snapshot loads into the port's env (counters, queue, buffer, bank, PCA,
injector, numpy generator); in real mode its key chain cannot seed a
``torch.Generator``, so the load refuses it unless the env was built
with injected sources (which then replay the chain); in analytic mode
no draw uses it and it is ignored.

A sharded env (``EnvConfig.agg`` with a mesh) writes the one-device
snapshot: the bank is its only row-sharded state, so every rank
gathers the bank's rows (``AggContext.gather_rows``) and rank 0 writes
the files, taking the replicated state (queue payloads, buffer slots,
edge matrix, global vector, PCA state, draws, telemetry, health) from
its own copy. A load keeps each rank's rows of the saved bank
(``AggContext.place_rows``), so either layout loads the other's
snapshot.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.runtime.buffer import _Slot
from repro_torch.runtime.clock import Event, RoundCost

# the reference's ``save_runtime`` checks these EnvConfig fields on load
_CFG_KEYS = ("task", "mode", "n_devices", "n_edges", "seed",
             "threshold_time")


def _key_str(path) -> str:
    return "/".join(str(p) for p in path)


def _flatten_with_path(tree, path=()):
    """``(path, leaf)`` pairs of a nested dict/list/tuple, dict keys in
    sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_path(v, path + (i,))
    else:
        yield path, tree


def _treedef(tree) -> str:
    """The structure of ``tree`` with ``*`` for each leaf, as JAX prints
    a treedef."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        return "(" + ", ".join(_treedef(v) for v in tree) + ")"
    return "*"


def _rebuild(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaves) for v in template)
    return next(leaves)


def _to_np(v) -> np.ndarray:
    """Tensor or array -> numpy on the host; bfloat16 as f32 (exact)."""
    if torch.is_tensor(v):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


def _like(arr: np.ndarray, template) -> torch.Tensor:
    """``arr`` as a tensor with ``template``'s dtype and device."""
    return torch.from_numpy(np.array(arr)).to(device=template.device,
                                              dtype=template.dtype)


def save_pytree(tree: Any, path: str) -> None:
    arrays = {_key_str(p): _to_np(v) for p, v in _flatten_with_path(tree)}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path + ".npz", **arrays)
    with open(path + ".tree.json", "w") as f:
        json.dump({"treedef": f"PyTreeDef({_treedef(tree)})",
                   "keys": list(arrays.keys())}, f)


def load_pytree(template: Any, path: str) -> Any:
    """The tree saved at ``path``, in ``template``'s structure, each leaf
    in its template leaf's dtype and on its device."""
    data = np.load(path + ".npz")
    leaves = [_like(data[_key_str(p)], v)
              for p, v in _flatten_with_path(template)]
    return _rebuild(template, iter(leaves))


# ---------------------------------------------------------------------------
# full async-runtime crash recovery (AsyncHFLEnv)
# ---------------------------------------------------------------------------

def _enc_val(v, arrays: dict, key: str):
    """JSON-encode one event-payload / slot-meta value; tensors spill to
    the npz side under ``key`` and leave a reference behind."""
    if isinstance(v, RoundCost):
        return {"__cost__": {k: float(x) for k, x in
                             dataclasses.asdict(v).items()}}
    if v is None or isinstance(v, (bool, str)):
        return v
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    if hasattr(v, "shape"):
        arrays[key] = _to_np(v)
        return {"__arr__": key}
    raise TypeError(f"cannot checkpoint payload value of type {type(v)!r}")


def _dec_val(v, data, device: torch.device):
    if isinstance(v, dict) and "__cost__" in v:
        return RoundCost(**v["__cost__"])
    if isinstance(v, dict) and "__arr__" in v:
        return torch.from_numpy(np.array(data[v["__arr__"]])).to(device)
    return v


def _enc_map(d: dict, arrays: dict, prefix: str) -> dict:
    return {k: _enc_val(v, arrays, f"{prefix}/{k}") for k, v in d.items()}


def _dec_map(d: dict, data, device: torch.device) -> dict:
    return {k: _dec_val(v, data, device) for k, v in d.items()}


def save_runtime(env, path: str) -> None:
    """Snapshot the complete state of a running ``AsyncHFLEnv`` so a
    killed process can resume mid-stream (``load_runtime``) and reach
    the same final model as an uninterrupted run.

    Captured: the pending event queue (clock, seq counter, every payload
    with its round cost and model snapshot), the staleness buffer's
    slots, the model bank, edge matrix, global vector and PCA state (real
    mode), the analytic accuracy state, all histories and counters, the
    env's numpy generator, the round generator's state and edge-shuffle
    base (real mode), the fault injector's full state, and telemetry,
    health and the ledger run id.

    On a sharded env every rank of the mesh calls it: the bank's rows
    are gathered, rank 0 writes the files, the one-device env's files at
    the same event, and a barrier holds every rank until they exist.
    """
    cfg = env.cfg
    ctx = env.agg_ctx
    arrays: dict = {}
    meta: dict = {
        "cfg": {k: getattr(cfg, k) for k in _CFG_KEYS},
        "version": int(env.version), "k": int(env.k),
        "t_re": float(env.t_re), "acc": float(env.acc),
        "total_energy": float(env.total_energy),
        "episode": int(env.episode), "n_flushes": int(env.n_flushes),
        "deciding": -1 if env._deciding is None else int(env._deciding),
        "last_time": float(env._last_time),
        "last_flush_time": float(env._last_flush_time),
        "last_upload_lost": bool(env._last_upload_lost),
        "flushed": bool(getattr(env, "_flushed", False)),
        "energy_hist": [float(x) for x in env.energy_hist],
        "acc_hist": [float(x) for x in env.acc_hist],
        "time_hist": [float(x) for x in env.time_hist],
        "last_action": [[int(g1), int(g2)]
                        for g1, g2 in env._last_action],
        "incarnation": [int(x) for x in env._incarnation],
        "rng": env.rng.bit_generator.state,
        "injector": env._injector.state(),
        "queue": {"now": float(env.queue.now), "seq": int(env.queue._seq),
                  "events": [
                      {"time": float(ev.time), "seq": int(ev.seq),
                       "edge": int(ev.edge), "kind": ev.kind,
                       "payload": _enc_map(ev.payload, arrays, f"q/{i}")}
                      for i, ev in enumerate(env.queue.events())]},
        # trace events, open spans and metric state are plain Python, so
        # a resumed traced run emits the same merged trace
        "telemetry": (env.telemetry.state()
                      if env.telemetry.enabled else None),
        # a resumed run keeps its health arming state and appends to the
        # same ledger stream
        "health": (env.health.state() if env.health is not None
                   else None),
        "ledger_run_id": getattr(env, "_ledger_run_id", None),
        "buffer": {"arrivals": int(env.buffer._arrivals),
                   "slots": [
                       {"edge": int(s.edge), "weight": float(s.weight),
                        "version": int(s.version),
                        "arrival": int(s.arrival),
                        "has_vec": s.vec is not None,
                        "meta": _enc_map(s.meta, arrays, f"buf/{i}/meta")}
                       for i, s in enumerate(env.buffer._slots)]},
    }
    for i, s in enumerate(env.buffer._slots):
        if s.vec is not None:
            arrays[f"buf/{i}/vec"] = _to_np(s.vec)
    arrays["h_edges"] = np.asarray(env._h_edges)
    arrays["edge_version"] = np.asarray(env._edge_version)
    arrays["staleness"] = np.asarray(env._staleness)
    arrays["in_flight"] = np.asarray(env._in_flight, np.uint8)
    arrays["edge_assign"] = np.asarray(env.edge_assign)
    arrays["edge_sizes"] = np.asarray(env._edge_sizes)
    arrays["edge_w"] = np.asarray(env._edge_w)
    # device profiles: cpu_usage mutates under device mobility
    arrays["cpu_usage"] = np.asarray(env.profiles.cpu_usage)
    arrays["freq"] = np.asarray(env.profiles.freq)
    if cfg.mode == "real":
        # the port's draws, in place of the reference's key chain
        arrays["perm_gen_state"] = env._perm_gen.get_state().numpy()
        meta["edge_perm_base"] = int(env._edge_perm_base)
        arrays["global_vec"] = _to_np(env._global_vec)
        arrays["edge_mat"] = _to_np(env._edge_mat)
        for p, v in _flatten_with_path(env.bank):
            arrays[f"bank/{_key_str(p)}"] = _to_np(ctx.gather_rows(v))
    else:
        arrays["edge_acc"] = np.asarray(env._edge_acc)
    for p, v in _flatten_with_path(env.pca_state):
        arrays[f"pca/{_key_str(p)}"] = _to_np(v)
    if not ctx.sharded or ctx.mesh.rank == 0:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path + ".npz", **arrays)
        with open(path + ".json", "w") as f:
            json.dump(meta, f)
    if ctx.sharded:
        import torch.distributed as dist
        dist.barrier(group=ctx.mesh.group)


def load_runtime(env, path: str) -> None:
    """Restore a ``save_runtime`` snapshot (the port's or the
    reference's) into a *fresh* ``AsyncHFLEnv`` built with the same
    config and fault spec. Calls ``env.reset()`` first (data, rounds,
    placeholders), then overwrites every piece of mutable runtime state,
    every tensor on ``env.device``, so the next ``step`` continues the
    interrupted trajectory exactly.

    Raises ``ValueError`` on a config mismatch, and for a real-mode
    reference snapshot (a ``jax.random`` key chain in place of the
    port's generator state) unless the env was built with injected
    ``perm_source`` / ``edge_perm_source``.

    On a sharded env every rank reads the files and keeps its rows of
    the bank and of the edge assignment (``AggContext.place_rows``), so
    a sharded env loads a one-device snapshot and the other way round;
    a bank whose N does not split over the mesh raises ``ValueError``."""
    ctx = env.agg_ctx
    with open(path + ".json") as f:
        meta = json.load(f)
    data = np.load(path + ".npz")
    cfg = env.cfg
    for k, v in meta["cfg"].items():
        if getattr(cfg, k) != v:
            raise ValueError(
                f"checkpoint/config mismatch on {k!r}: saved {v!r}, "
                f"env has {getattr(cfg, k)!r}")
    key_chain = "perm_gen_state" not in data.files
    if cfg.mode == "real" and key_chain and not env._injected_perms:
        raise ValueError(
            f"{path}: a reference snapshot; its jax.random key chain "
            f"(key, abase) cannot seed the port's torch.Generator. Build "
            f"the env with perm_source= and edge_perm_source= that replay "
            f"the chain from the saved key and abase")
    dev = env.device
    env.reset()
    # --- counters / histories ------------------------------------------
    env.version = meta["version"]
    env.k = meta["k"]
    env.t_re = meta["t_re"]
    env.acc = meta["acc"]
    env.total_energy = meta["total_energy"]
    env.episode = meta["episode"]
    env.n_flushes = meta["n_flushes"]
    env._deciding = None if meta["deciding"] < 0 else meta["deciding"]
    env._last_time = meta["last_time"]
    env._last_flush_time = meta["last_flush_time"]
    env._last_upload_lost = meta["last_upload_lost"]
    env._flushed = meta["flushed"]
    env.energy_hist = list(meta["energy_hist"])
    env.acc_hist = list(meta["acc_hist"])
    env.time_hist = list(meta["time_hist"])
    env._last_action = [(g1, g2) for g1, g2 in meta["last_action"]]
    env._incarnation = np.asarray(meta["incarnation"], np.int64)
    # --- draws (numpy generator, fault injector, round generator) ------
    env.rng.bit_generator.state = meta["rng"]
    env._injector.set_state(meta["injector"])
    if cfg.mode == "real" and not key_chain:
        env._perm_gen.set_state(torch.from_numpy(
            np.array(data["perm_gen_state"])))
        env._edge_perm_base = int(meta["edge_perm_base"])
    # --- telemetry (when the snapshot carries it and the env records) --
    if meta.get("telemetry") is not None and env.telemetry.enabled:
        env.telemetry.set_state(meta["telemetry"])
    # --- health monitor + ledger identity ------------------------------
    if meta.get("health") is not None and env.health is not None:
        env.health.set_state(meta["health"])
    if meta.get("ledger_run_id"):
        env._ledger_run_id = meta["ledger_run_id"]
    # --- topology / hardware -------------------------------------------
    env.edge_assign = np.asarray(data["edge_assign"], np.int64)
    env._edge_assign_t = ctx.place_rows(torch.as_tensor(
        env.edge_assign.astype(np.int32), device=dev))
    env._edge_sizes = np.asarray(data["edge_sizes"])
    env._edge_w = np.asarray(data["edge_w"])
    env.profiles.cpu_usage = np.asarray(data["cpu_usage"])
    env.profiles.freq = np.asarray(data["freq"])
    # --- per-edge runtime arrays ---------------------------------------
    env._h_edges = np.asarray(data["h_edges"])
    env._edge_version = np.asarray(data["edge_version"])
    env._staleness = np.asarray(data["staleness"])
    env._in_flight = np.asarray(data["in_flight"]).astype(bool)
    # --- models ---------------------------------------------------------
    if cfg.mode == "real":
        env._global_vec = _like(data["global_vec"], env._global_vec)
        env._edge_mat = _like(data["edge_mat"], env._edge_mat)
        env.global_model = env._spec.unflatten_model(env._global_vec)
        env.edge_models = env._spec.unflatten(env._edge_mat)
        for p, v in _flatten_with_path(env.bank):       # in place
            v.copy_(ctx.place_rows(torch.from_numpy(
                np.array(data[f"bank/{_key_str(p)}"]))))
    else:
        env._edge_acc = np.asarray(data["edge_acc"])
    env.pca_state = _rebuild(env.pca_state, iter(
        [_like(data[f"pca/{_key_str(p)}"], v)
         for p, v in _flatten_with_path(env.pca_state)]))
    # --- staleness buffer ----------------------------------------------
    env.buffer._arrivals = meta["buffer"]["arrivals"]
    env.buffer._slots = [
        _Slot(edge=sl["edge"],
              vec=(torch.from_numpy(np.array(data[f"buf/{i}/vec"])).to(dev)
                   if sl["has_vec"] else None),
              weight=sl["weight"], version=sl["version"],
              arrival=sl["arrival"], meta=_dec_map(sl["meta"], data, dev))
        for i, sl in enumerate(meta["buffer"]["slots"])]
    # --- event queue ----------------------------------------------------
    q = meta["queue"]
    env.queue.load(q["now"], q["seq"], [
        Event(time=e["time"], seq=e["seq"], edge=e["edge"], kind=e["kind"],
              payload=_dec_map(e["payload"], data, dev))
        for e in q["events"]])
