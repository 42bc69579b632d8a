"""Hierarchical FL aggregation and the cloud round (paper 2.1, Eqs. 1, 2, 5).

The single-device port of ``repro.core.hfl``. The *model bank* holds
every device's parameters as a dict of tensors with a leading
``N_devices`` axis. It lives as one contiguous ``(N, P)`` matrix with the
leaves as views into it (``flatbank.BankSpec``), so

* local SGD updates the leaves, and thereby the matrix, in place;
* Eq. 1 (edge aggregation) and Eq. 2 (cloud aggregation) read the
  matrix with one ``segment_agg`` kernel launch each;
* the edge->device resync writes the matrix in place with one
  ``segment_broadcast`` launch;
* the FedAvg round (``make_fedavg_round``, the Vanilla-FL baseline)
  aggregates the participating devices with one ``segment_agg`` launch;
* the edge round (``make_edge_round``, the async runtime's unit of work)
  is the cloud round restricted to one edge: masked weights in each
  ``segment_agg`` launch and a resync of that edge's rows only.

The reference donates the bank buffer to its jit'd round; here the
round reuses the bank's storage in place. Per-edge frequencies (gamma1_j,
gamma2_j) are host integers: an epoch in which no device is active and
a t2 step past ``max(gamma2)`` are skipped, where the reference computes
them under masks and throws the results away, so no number changes.

The reference draws each epoch's shuffles from a ``jax.random`` key
chain inside the round. The port takes them as an input instead: a
``perms`` tensor of shape ``(max_g2, max_g1, N, n_local)``, indexed by
(t2, epoch) so a skipped step never shifts them (``(max_g1, N,
n_local)`` for the FedAvg round). ``repro_torch.sim.env`` draws them from its
``torch.Generator``; the parity tests inject the reference's.

Every factory takes ``deterministic`` (default False): with it, each
call of the round runs inside ``repro_torch.device.
deterministic_algorithms``, so the same inputs give the same bank bits
on every run on the card too (cuDNN and the gathers otherwise sum in
run-dependent orders), and every epoch trains all N rows as the
reference does (``make_local_trainer(all_rows=True)``), so an edge
round is bitwise its row of the cloud round.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import flatbank
from repro_torch.device import (deterministic_algorithms, disable_tf32,
                                 set_cublas_workspace)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import segment_weight_sums


# ---------------------------------------------------------------------------
# model bank
# ---------------------------------------------------------------------------

def broadcast_model(model: dict, n: int) -> dict:
    """``n`` copies of ``model`` as a bank: views into one new contiguous
    ``(n, P)`` matrix."""
    spec = flatbank.model_spec(model)
    vec = spec.flatten_model(model)
    return spec.unflatten(vec.expand(n, spec.width).contiguous())


def init_bank(init_fn: Callable, gen: torch.Generator, n_devices: int, *,
              device="cuda") -> dict:
    """Replicates one init across devices (all start from w(0)).
    ``init_fn(gen, device)`` draws the model from ``gen``."""
    return broadcast_model(init_fn(gen, device), n_devices)


def bank_select(bank: dict, i: int) -> dict:
    return {k: v[i] for k, v in bank.items()}


# ---------------------------------------------------------------------------
# AggContext -- the aggregation contract (single device in this port)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AggContext:
    """The aggregation contract every entry point runs under. Only the
    single-device context exists so far."""

    @classmethod
    def single_chip(cls) -> "AggContext":
        return cls()

    @classmethod
    def for_mesh(cls, mesh) -> "AggContext":
        raise NotImplementedError(
            "AggContext.for_mesh: the multi-GPU bank is not ported yet "
            "(ROADMAP.md, modules still to port, item 10)")


def _resolve_ctx(ctx, where: str) -> AggContext:
    if ctx is None:
        return AggContext.single_chip()
    if not isinstance(ctx, AggContext):
        raise TypeError(f"{where}: ctx must be a repro_torch AggContext, "
                        f"got {type(ctx).__name__}")
    return ctx


# ---------------------------------------------------------------------------
# aggregation (Eqs. 1 and 2) on the flat bank
# ---------------------------------------------------------------------------

def weighted_aggregate(bank: dict, weights, segment_ids, num_segments: int,
                       *, ctx: Optional[AggContext] = None) -> dict:
    """Dataset-size-weighted aggregation on the flat bank:

        out_j = sum_{i in j} w_i x_i / sum_{i in j} w_i          (Eq. 1)

    One ``segment_agg`` launch over the ``(N, P)`` bank; returns a dict
    with leading ``num_segments`` axis, leaf dtypes restored."""
    _resolve_ctx(ctx, "weighted_aggregate")
    spec = flatbank.bank_spec(bank)
    out = ops.segment_agg(spec.flatten(bank), weights, segment_ids,
                          num_segments)
    return spec.unflatten(out)


def edge_aggregate(bank: dict, device_sizes, edge_assign, n_edges: int,
                   *, ctx: Optional[AggContext] = None) -> dict:
    """Eq. 1: w_j^e = sum_i |D_i| w_i / sum_i |D_i| over edge j's devices."""
    return weighted_aggregate(bank, device_sizes, edge_assign, n_edges,
                              ctx=ctx)


def cloud_aggregate(edge_models: dict, edge_sizes, *,
                    ctx: Optional[AggContext] = None) -> dict:
    """Eq. 2: w = sum_j |D_j| w_j^e / sum_j |D_j| (one segment)."""
    _resolve_ctx(ctx, "cloud_aggregate")
    spec = flatbank.bank_spec(edge_models)
    seg = torch.zeros((edge_sizes.shape[0],), dtype=torch.int32,
                      device=edge_sizes.device)
    out = ops.segment_agg(spec.flatten(edge_models), edge_sizes, seg, 1)
    return spec.unflatten_model(out[0])


def masked_resync(edge_mat, bank_mat, edge_assign, alive, *,
                  ctx: Optional[AggContext] = None):
    """Edge->device resync onto the rows of *alive* edges only: the
    ``(E, P)`` edge matrix is broadcast to ``(N, P)`` through
    ``segment_broadcast``, and rows of edges with ``alive[j]`` false come
    back bit-identical. With ``alive`` all true this is the plain
    resync."""
    _resolve_ctx(ctx, "masked_resync")
    out = ops.segment_broadcast(edge_mat, edge_assign,
                                out_dtype=bank_mat.dtype)
    alive = torch.as_tensor(alive, dtype=torch.bool, device=bank_mat.device)
    keep = alive[edge_assign.to(torch.int64)]
    return torch.where(keep[:, None], out, bank_mat)


# ---------------------------------------------------------------------------
# device-local training (per-device SGD epochs)
# ---------------------------------------------------------------------------

def _host_ints(v) -> np.ndarray:
    if torch.is_tensor(v):
        v = v.cpu()
    return np.asarray(v, dtype=np.int64).reshape(-1)


def make_local_trainer(loss_fn: Callable, lr: float, batch_size: int,
                       all_rows: bool = False):
    """Returns ``local_train(bank, x, y, gamma1_dev, max_g1, perms)``.

    ``loss_fn(params, batch) -> scalar`` for one device. One epoch is one
    pass over the device's shard in minibatches of ``batch_size`` taken
    in the order ``perms[e]`` gives (``perms``: ``(max_g1, N, n_local)``).
    ``gamma1_dev`` (``(N,)`` host ints): device i runs its first
    ``gamma1_dev[i]`` of the ``max_g1`` epochs; an epoch updates only the
    devices active in it, which is the reference's per-epoch
    ``where(active, new, old)``. Each step is ``a - lr * g`` in f32 per
    device, with per-device gradients from ``torch.func.vmap`` of
    ``torch.func.grad``. The bank's leaves are updated in place and the
    bank is returned.

    An epoch in which only some devices are active takes ``vmap(grad)``
    over those rows only, unless ``all_rows``: then, as the reference
    does, every epoch trains all N rows and writes back only the active
    ones (the inactive rows come back bit-identical). The vmapped
    convolutions pick their algorithm by the number of rows in the call,
    so only with ``all_rows`` does a row's result depend on nothing but
    its own parameters and batch, and an edge round equal its row of the
    cloud round bit for bit. The round factories set it when built with
    ``deterministic=True``.
    """
    grad_fn = torch.func.vmap(torch.func.grad(loss_fn))

    def run_epoch(params: dict, x, y, rows, perm) -> None:
        nb = x.shape[1] // batch_size
        r = rows[:, None]
        for s in range(nb):
            b = perm[:, s * batch_size:(s + 1) * batch_size]
            g = grad_fn(params, {"x": x[r, b], "y": y[r, b]})
            for k, p in params.items():
                p.copy_(p.to(torch.float32)
                        - lr * g[k].to(torch.float32))

    def local_train(bank: dict, x, y, gamma1_dev, max_g1: int, perms):
        g1 = _host_ints(gamma1_dev)
        n_epochs = min(int(max_g1), int(g1.max(initial=0)))
        for e in range(n_epochs):
            active = e < g1
            perm = perms[e].to(device=x.device, dtype=torch.int64)
            if active.all():
                rows = torch.arange(x.shape[0], device=x.device)
                run_epoch(bank, x, y, rows, perm)
                continue
            if all_rows:
                rows = torch.arange(x.shape[0], device=x.device)
                idle = torch.as_tensor(np.flatnonzero(~active),
                                       device=x.device)
                old = {k: v[idle] for k, v in bank.items()}
                run_epoch(bank, x, y, rows, perm)
                for k, v in bank.items():
                    v[idle] = old[k]
                continue
            rows = torch.as_tensor(np.flatnonzero(active), device=x.device)
            params = {k: v[rows] for k, v in bank.items()}
            run_epoch(params, x, y, rows, perm[rows])
            for k, v in bank.items():
                v[rows] = params[k]
        return bank

    return local_train


def _check_one_dtype(spec, where: str) -> None:
    """A round updates the bank in place through its (N, P) matrix, which
    needs every leaf in the matrix's dtype."""
    if any(d != spec.dtype for d in spec.dtypes) or spec.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"{where}: the bank needs one dtype, f32 or bf16; "
                        f"got {spec.dtypes}")


def _round_mode(round_fn: Callable, deterministic: bool) -> Callable:
    """``round_fn`` without gradients, TF32 off, and inside
    ``deterministic_algorithms`` on each call when ``deterministic``."""
    disable_tf32()
    if deterministic:
        set_cublas_workspace()        # before the process's first cuBLAS call

    @functools.wraps(round_fn)
    def run(*args):
        mode = (deterministic_algorithms() if deterministic
                else contextlib.nullcontext())
        with mode, torch.no_grad():
            return round_fn(*args)

    return run


# ---------------------------------------------------------------------------
# one cloud round (Eq. 5 composition)
# ---------------------------------------------------------------------------

def make_cloud_round(loss_fn: Callable, lr: float, batch_size: int,
                     n_edges: int, max_g1: int, max_g2: int,
                     ctx: Optional[AggContext] = None,
                     deterministic: bool = False):
    """Builds ``cloud_round``:

    cloud_round(bank, x, y, sizes, edge_assign, g1 (M,), g2 (M,), perms)
      -> (bank synced to the new global model, global model, edge models)

    Composition per Eq. 5: for t2 < gamma2_j, devices of edge j run
    gamma1_j local epochs and then edge-aggregate; edges past their
    gamma2_j freeze; finally the cloud aggregates the edge models and
    every device resumes from the global model.

    Per round: one ``segment_agg`` launch for the starting edge models,
    one ``segment_agg`` and one ``segment_broadcast`` per executed t2
    step, and one ``segment_agg`` for Eq. 2. ``bank`` must have one
    dtype (f32 or bf16); its storage is reused, so use the returned
    bank. Turns TF32 off (``repro_torch.device.disable_tf32``).
    """
    _resolve_ctx(ctx, "make_cloud_round")
    local_train = make_local_trainer(loss_fn, lr, batch_size,
                                     all_rows=deterministic)

    def cloud_round(bank, x, y, sizes, edge_assign, g1, g2, perms):
        spec = flatbank.bank_spec(bank)
        _check_one_dtype(spec, "cloud_round")
        mat = spec.flatten(bank)
        bank = spec.unflatten(mat)           # views: updates land in mat
        dev = mat.device
        sizes = torch.as_tensor(sizes, dtype=torch.float32, device=dev)
        ea = _host_ints(edge_assign)
        g1h, g2h = _host_ints(g1), _host_ints(g2)
        g1_dev, g2_dev = g1h[ea], g2h[ea]
        seg = torch.as_tensor(ea.astype(np.int32), device=dev)

        edge_mat = ops.segment_agg(mat, sizes, seg, n_edges)
        for t2 in range(min(int(max_g2), int(g2h.max(initial=0)))):
            g1_eff = np.where(t2 < g2_dev, g1_dev, 0)
            local_train(bank, x, y, g1_eff, max_g1, perms[t2])
            a = ops.segment_agg(mat, sizes, seg, n_edges)
            active_edge = t2 < g2h
            if active_edge.all():
                edge_mat = a
            else:
                keep = torch.as_tensor(active_edge, device=dev)[:, None]
                edge_mat = torch.where(keep, a, edge_mat)
            # devices resume from their edge's current model
            ops.segment_broadcast(edge_mat, seg, out=mat)

        edge_sizes = segment_weight_sums(sizes, seg, n_edges)
        zeros = torch.zeros((n_edges,), dtype=torch.int32, device=dev)
        glob = ops.segment_agg(edge_mat, edge_sizes, zeros, 1)[0]
        mat.copy_(glob.expand_as(mat))       # every device resumes from w
        return bank, spec.unflatten_model(glob), spec.unflatten(edge_mat)

    return _round_mode(cloud_round, deterministic)


# ---------------------------------------------------------------------------
# one edge-local round -- the async runtime's unit of work
# ---------------------------------------------------------------------------

def make_edge_round(loss_fn: Callable, lr: float, batch_size: int,
                    n_edges: int, max_g1: int, max_g2: int,
                    ctx: Optional[AggContext] = None,
                    deterministic: bool = False):
    """Builds ``edge_round``:

    edge_round(bank, x, y, sizes, edge_assign, edge_id, g1, g2,
               global_vec (P,), perms) -> (bank, edge_vec (P,) f32)

    The async runtime's unit of work (``repro_torch.runtime``): edge
    ``edge_id``'s devices start from the flat global snapshot
    ``global_vec`` (the version the edge downloaded), run gamma2 edge
    syncs of gamma1 local epochs, and return their edge aggregate for the
    cloud's staleness buffer. ``g1``/``g2`` are this edge's host ints;
    ``perms`` is ``(max_g2, max_g1, N, n_local)`` as in
    ``make_cloud_round``.

    It is the cloud round restricted to one edge: one ``segment_agg``
    launch for the starting edge models, then per t2 < gamma2 local
    epochs updating the edge's rows only, one ``segment_agg`` (E =
    n_edges, weights ``sizes * (edge_assign == edge_id)``) and one
    ``masked_resync`` of the edge's rows (one ``segment_broadcast`` and a
    ``where``). Rows of other edges come back bitwise untouched: the bank
    is the scratch buffer of every in-flight edge round. Given the
    shuffles the cloud round got, the returned vector is row
    ``edge_id`` of its edge matrix: bitwise with ``deterministic`` (each
    epoch then trains all N rows and keeps the edge's), within the
    grouped convolutions' last bits without it (they train the edge's
    rows alone). ``bank`` must have one dtype; its storage is reused.
    Turns TF32 off.
    """
    _resolve_ctx(ctx, "make_edge_round")
    local_train = make_local_trainer(loss_fn, lr, batch_size,
                                     all_rows=deterministic)

    def edge_round(bank, x, y, sizes, edge_assign, edge_id, g1, g2,
                   global_vec, perms):
        spec = flatbank.bank_spec(bank)
        _check_one_dtype(spec, "edge_round")
        mat = spec.flatten(bank)
        bank = spec.unflatten(mat)           # views: updates land in mat
        dev = mat.device
        ea = _host_ints(edge_assign)
        j, g1, g2 = int(edge_id), int(g1), int(g2)
        row_active = ea == j
        rows = torch.as_tensor(row_active, device=dev)
        w = torch.as_tensor(sizes, dtype=torch.float32, device=dev) * rows
        seg = torch.as_tensor(ea.astype(np.int32), device=dev)
        alive = np.arange(n_edges) == j

        # the edge's devices resume from the snapshot it downloaded
        mat.copy_(torch.where(rows[:, None], global_vec.to(mat.dtype), mat))
        edge_mat = ops.segment_agg(mat, w, seg, n_edges)
        g1_dev = np.where(row_active, g1, 0)
        for t2 in range(min(int(max_g2), g2)):
            local_train(bank, x, y, g1_dev, max_g1, perms[t2])
            edge_mat = ops.segment_agg(mat, w, seg, n_edges)
            # resync only this edge's rows
            mat.copy_(masked_resync(edge_mat, mat, seg, alive))
        return bank, edge_mat[j].clone()

    return _round_mode(edge_round, deterministic)


# ---------------------------------------------------------------------------
# Vanilla-FL (FedAvg) round -- the paper's two-layer baseline
# ---------------------------------------------------------------------------

def make_fedavg_round(loss_fn: Callable, lr: float, batch_size: int,
                      max_g1: int, ctx: Optional[AggContext] = None,
                      deterministic: bool = False):
    """FedAvg with random participation: selected devices run gamma1
    local epochs, the cloud aggregates them directly (gamma2 = 1).

    fedavg_round(bank, x, y, sizes, participate (N,) bool, g1, perms)
      -> (bank synced to the global model, global model)

    ``perms`` (``(max_g1, N, n_local)``) replaces the reference's key, as
    in ``make_cloud_round``. One ``segment_agg`` launch (E = 1, weights
    ``sizes * participate``) and no ``segment_broadcast``: like the
    reference's ``broadcast_model``, the global model is copied to every
    row, here into the bank's own storage. ``g1`` is a scalar or one
    value per device. Turns TF32 off.
    """
    _resolve_ctx(ctx, "make_fedavg_round")
    local_train = make_local_trainer(loss_fn, lr, batch_size,
                                     all_rows=deterministic)

    def fedavg_round(bank, x, y, sizes, participate, g1, perms):
        spec = flatbank.bank_spec(bank)
        _check_one_dtype(spec, "fedavg_round")
        mat = spec.flatten(bank)
        bank = spec.unflatten(mat)           # views: updates land in mat
        dev = mat.device
        part = _host_ints(participate).astype(bool)
        g1_dev = np.where(part, _host_ints(g1), 0)   # scalar or (N,)
        local_train(bank, x, y, g1_dev, max_g1, perms)
        w = torch.as_tensor(sizes, dtype=torch.float32, device=dev) \
            * torch.as_tensor(part, device=dev)
        seg = torch.zeros((mat.shape[0],), dtype=torch.int32, device=dev)
        glob = ops.segment_agg(mat, w, seg, 1)[0]
        mat.copy_(glob.to(mat.dtype).expand_as(mat))
        return bank, spec.unflatten_model(glob)

    return _round_mode(fedavg_round, deterministic)
