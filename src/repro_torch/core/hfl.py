"""Hierarchical FL aggregation and the cloud round (paper 2.1, Eqs. 1, 2, 5).

The port of ``repro.core.hfl``. The *model bank* holds
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
round reuses the bank's storage in place (a caller that wants its bank
kept passes a clone). Per-edge frequencies (gamma1_j,
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
run-dependent orders); local SGD trains fixed chunks of each edge's
global rows (``make_local_trainer(all_rows=True)``), so a row's result
depends on nothing but its own parameters and batch; and under a mesh
Eq. 1 chains the ranks' sums in row order (``ops.segment_agg_ordered``).
An edge round is then bitwise its row of the cloud round, and a sharded
round bitwise the one-device round on any row layout.

Multi-GPU banks -- the **AggContext contract**: every aggregation entry
point and round factory takes an optional ``ctx: AggContext``, which
carries the bank mesh (``repro_torch.launch.mesh.BankMesh``, the ranks
of a ``torch.distributed`` group) and with it the row layout
(``flatbank.place_bank``); the reference's per-call ``mesh=`` kwargs
have no counterpart. Under a mesh each rank holds and
passes its ``N/k`` rows of the bank and of every row-aligned input;
the round body is the one-device body on those rows: local SGD trains
them, Eq. 1 is one ``segment_agg`` launch on them whose partial sums
meet in ``all_reduce`` (``ops.segment_agg_sharded``), the resync is a
``segment_broadcast`` onto them, and Eq. 2 and the flushes run the
plain launch on the replicated (E, P) matrices on every rank
(``AggContext.segment_agg_small``). No rank holds the full bank.

Bitwise contract of the sharded paths: the kernel splits no row across
threads or blocks and zero partials add nothing, so when every edge's
rows lie on one rank (the ``flatbank.place_bank`` layout with
edge-aligned shards) the aggregations reproduce the one-device
accumulation exactly, as the reference's do. In plain mode an edge
spanning ranks splits its chain at the ``all_reduce`` and differs in the
last bits, and local SGD differs where a rank's ``vmap(grad)`` calls
hold other rows than one device's; deterministic mode closes both
(ROADMAP section 3, fault 3).
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
from repro_torch.launch.mesh import BankMesh


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
# AggContext -- the one aggregation/placement contract
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AggContext:
    """The aggregation contract every ``hfl`` entry point runs under.

    It carries the bank mesh (``repro_torch.launch.mesh.BankMesh``, or
    ``None`` for one device) and with it the row layout
    (``flatbank.place_bank``). Build it once
    -- :meth:`for_mesh` / :meth:`single_chip` -- and pass it to
    ``weighted_aggregate`` / ``cloud_aggregate`` / ``masked_resync`` /
    the round factories, to ``runtime.buffer.StalenessBuffer(ctx=)`` and
    to ``sim.EnvConfig(agg=)``.

    Under a mesh every row-aligned input of an entry point (the bank,
    data shards, sizes, edge assignment, participation) is this rank's
    rows (``place_rows``/``place_bank``), while small (E, P) inputs
    (edge and global models, flush stacks) are replicated: every rank
    holds them whole and passes the same values."""
    mesh: Optional[BankMesh] = None

    # -- constructors -------------------------------------------------
    @classmethod
    def single_chip(cls) -> "AggContext":
        """No mesh: every entry point takes the one-device path and the
        placement helpers are identities."""
        return cls(mesh=None)

    @classmethod
    def for_mesh(cls, mesh) -> "AggContext":
        """Sharded context over ``mesh`` (``launch.mesh.make_bank_mesh``):
        bank rows shard over all its axes."""
        if mesh is None:
            raise ValueError("AggContext.for_mesh needs a mesh; use "
                             "AggContext.single_chip() for one device")
        if not isinstance(mesh, BankMesh):
            raise TypeError(f"AggContext.for_mesh expects a repro_torch."
                            f"launch.mesh.BankMesh, got "
                            f"{type(mesh).__name__}")
        return cls(mesh=mesh)

    # -- introspection ------------------------------------------------
    @property
    def sharded(self) -> bool:
        return self.mesh is not None

    @property
    def axes(self) -> tuple:
        """Mesh axis names the bank rows shard over (() on one device)."""
        return () if self.mesh is None else tuple(self.mesh.axis_names)

    @property
    def n_shards(self) -> int:
        return 1 if self.mesh is None else int(self.mesh.size)

    def check_rows(self, n: int) -> int:
        """Raise ValueError unless ``n`` rows divide over the shards;
        returns the rows per shard (``n`` itself on one device)."""
        if self.mesh is None:
            return int(n)
        return flatbank.local_rows(n, self.mesh)

    # -- placement (flatbank's row layout) ----------------------------
    def place_rows(self, arr):
        """This rank's rows of an array with a leading device-row axis
        (identity on one device)."""
        if self.mesh is None:
            return arr
        return flatbank.place_rows(arr, self.mesh)

    def gather_rows(self, arr):
        """Every rank's rows of a row-aligned tensor joined in rank
        order, the whole ``(N, ...)`` tensor on every rank
        (``flatbank.gather_rows``, a collective over the mesh's group;
        identity on one device)."""
        if self.mesh is None:
            return arr
        return flatbank.gather_rows(arr, self.mesh)

    def place_replicated(self, tree):
        """A tensor or a dict/list/tuple of them on this rank's device
        (identity on one device)."""
        if self.mesh is None:
            return tree
        return flatbank.place_replicated(tree, self.mesh)

    def place_bank(self, bank: dict) -> dict:
        """This rank's rows of a full bank as a new contiguous matrix
        (identity on one device); validates the layout contract."""
        if self.mesh is None:
            return bank
        return flatbank.place_bank(bank, self.mesh)

    def local_perms(self, perms, rows: int):
        """This rank's rows of a round's shuffles (rows on axis -2) for a
        bank part of ``rows`` rows: ``perms[..., r0:r1, :]``, so every
        row trains on the shuffles of the one-device round."""
        if self.mesh is None:
            return perms
        n = perms.shape[-2]
        if self.check_rows(n) != rows:
            raise ValueError(
                f"the round got {rows} bank rows and shuffles for {n}: "
                f"under a {self.n_shards}-shard mesh a rank passes its "
                f"N/{self.n_shards} rows (AggContext.place_bank) and the "
                f"shuffles of all N")
        return perms[..., flatbank.row_slice(n, self.mesh), :]

    # -- kernel routing -----------------------------------------------
    def segment_agg_rows(self, mat, weights, segment_ids,
                         num_segments: int, ordered: bool = False):
        """Aggregate the bank's rows (Eq. 1, FedAvg): one ``segment_agg``
        launch on one device; under a mesh one launch on this rank's
        rows plus ``all_reduce`` (``ops.segment_agg_sharded``), or, when
        ``ordered``, the ranks' launches chained in rank order
        (``ops.segment_agg_ordered``: the one-device bits even where an
        edge spans ranks; the deterministic rounds set it)."""
        if self.mesh is None:
            return ops.segment_agg(mat, weights, segment_ids, num_segments)
        agg = ops.segment_agg_ordered if ordered else ops.segment_agg_sharded
        return agg(mat, weights, segment_ids, num_segments, self.mesh.group)

    def row_offset(self, rows: int) -> int:
        """The global index of this rank's first bank row, for a part of
        ``rows`` rows (0 on one device)."""
        if self.mesh is None:
            return 0
        return flatbank.row_slice(rows * self.n_shards, self.mesh).start

    def gather_row_ids(self, ids) -> np.ndarray:
        """The global (N,) host ints whose rows this rank holds as
        ``ids`` (its (N/k,) part, e.g. its edge assignment): ``ids``
        itself on one device, else one ``all_reduce`` of N int64 on the
        mesh's device, the same on every rank."""
        ids = _host_ints(ids)
        if self.mesh is None:
            return ids
        import torch.distributed as dist
        n = ids.size * self.n_shards
        full = torch.zeros((n,), dtype=torch.int64, device=self.mesh.device)
        full[flatbank.row_slice(n, self.mesh)] = torch.as_tensor(
            ids, device=self.mesh.device)
        dist.all_reduce(full, group=self.mesh.group)
        return full.cpu().numpy()

    def segment_agg_small(self, mat, weights, segment_ids,
                          num_segments: int):
        """Aggregate a *small* replicated (K, P) stack (edge matrices,
        staleness flushes): the plain single launch, computed on every
        rank from the same inputs, so bitwise the one-device launch for
        any K (no collective, no divisibility condition)."""
        return ops.segment_agg(mat, weights, segment_ids, num_segments)

    def segment_weight_sums(self, weights, segment_ids, num_segments: int):
        """Per-segment sums of the rows' weights, over every rank's rows
        under a mesh: added in f64 (``ref.segment_weight_sums``), where
        they are exact, summed over the ranks with ``all_reduce`` and
        rounded once to f32, so any row layout gives the one-device
        bits."""
        out = segment_weight_sums(weights, segment_ids, num_segments,
                                  dtype=torch.float64)
        if self.mesh is not None:
            import torch.distributed as dist
            dist.all_reduce(out, group=self.mesh.group)
        return out.to(torch.float32)


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
    with leading ``num_segments`` axis, leaf dtypes restored. Under a
    sharded ``ctx`` the bank, weights and ids are this rank's rows, the
    launch runs on them and the partial sums meet in ``all_reduce``; the
    result is the same on every rank."""
    ctx = _resolve_ctx(ctx, "weighted_aggregate")
    spec = flatbank.bank_spec(bank)
    out = ctx.segment_agg_rows(spec.flatten(bank), weights, segment_ids,
                               num_segments)
    return spec.unflatten(out)


def edge_aggregate(bank: dict, device_sizes, edge_assign, n_edges: int,
                   *, ctx: Optional[AggContext] = None) -> dict:
    """Eq. 1: w_j^e = sum_i |D_i| w_i / sum_i |D_i| over edge j's devices."""
    return weighted_aggregate(bank, device_sizes, edge_assign, n_edges,
                              ctx=ctx)


def cloud_aggregate(edge_models: dict, edge_sizes, *,
                    ctx: Optional[AggContext] = None) -> dict:
    """Eq. 2: w = sum_j |D_j| w_j^e / sum_j |D_j| (one segment). The edge
    matrix is small and replicated, so under a mesh every rank computes
    the plain launch (``AggContext.segment_agg_small``): bitwise the
    one-device result for any number of edges."""
    ctx = _resolve_ctx(ctx, "cloud_aggregate")
    spec = flatbank.bank_spec(edge_models)
    seg = torch.zeros((edge_sizes.shape[0],), dtype=torch.int32,
                      device=edge_sizes.device)
    out = ctx.segment_agg_small(spec.flatten(edge_models), edge_sizes, seg,
                                1)
    return spec.unflatten_model(out[0])


def masked_resync(edge_mat, bank_mat, edge_assign, alive, *,
                  ctx: Optional[AggContext] = None):
    """Edge->device resync onto the rows of *alive* edges only: the
    ``(E, P)`` edge matrix is broadcast to ``(N, P)`` through
    ``segment_broadcast``, and rows of edges with ``alive[j]`` false come
    back bit-identical. With ``alive`` all true this is the plain
    resync. Under a sharded ``ctx`` ``bank_mat`` and ``edge_assign`` are
    this rank's rows and the broadcast writes those only: a gather copies
    one edge row per device row, so the result is bitwise the one-device
    one and no rank touches another's rows."""
    _resolve_ctx(ctx, "masked_resync")
    if edge_assign.shape[0] != bank_mat.shape[0]:
        raise ValueError(f"masked_resync: {bank_mat.shape[0]} bank rows "
                         f"and {edge_assign.shape[0]} edge ids")
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


TRAIN_CALL_ROWS = 16               # most rows in one deterministic call


def train_calls(groups) -> list:
    """The ``vmap(grad)`` calls of the deterministic trainer for a bank
    whose global rows carry the group ids ``groups`` ((N,) ints: the edge
    assignment, or all one group): each group's rows in ascending order,
    cut into ``ceil(size / TRAIN_CALL_ROWS)`` consecutive chunks of
    near-equal size.
    Returns one array of global row indices per call. It depends on the
    global groups only, never on the shard count or on which rows are
    active."""
    groups = np.asarray(groups).reshape(-1)
    calls = []
    for gid in np.unique(groups):
        rows = np.flatnonzero(groups == gid)
        calls.extend(np.array_split(rows,
                                    -(-rows.size // TRAIN_CALL_ROWS)))
    return calls


def make_local_trainer(loss_fn: Callable, lr: float, batch_size: int,
                       all_rows: bool = False,
                       ctx: Optional[AggContext] = None):
    """Returns ``local_train(bank, x, y, gamma1_dev, max_g1, perms,
    groups=None)``.

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

    Plain mode (``all_rows`` False) takes ``vmap(grad)`` over all rows
    when every device is active, else over the active rows only. The
    vmapped convolutions pick their algorithm by the number of rows in
    the call, so a row's bits then depend on which rows share its call.

    With ``all_rows`` (the round factories set it when built with
    ``deterministic=True``) every call holds one fixed chunk of
    ``train_calls(groups)``: ``groups`` is the *global* (N,) edge
    assignment (``None``: all rows one group), each edge's rows cut into
    chunks of at most ``TRAIN_CALL_ROWS``, each row at its own position
    in its chunk. On a rank of a sharded ``ctx`` that holds only part of
    a chunk, the call is padded to the chunk's size with copies of one of
    the rank's real rows, whose results are dropped. So the call that
    trains a row has the same shape and the row the same position in it
    on one device, on any shard count and whichever rows are active: a
    row's result depends on nothing but its own parameters and batch, an
    edge round is bitwise its row of the cloud round, and a sharded round
    bitwise the one-device round. An epoch trains only the chunks that
    hold an active row and writes back only the active rows. Design
    choice: chunks follow the edges (rather than fixed blocks of
    consecutive global rows) because the profiling module clusters
    devices by capability, which scatters an edge's rows over the whole
    bank; blocks of consecutive rows would make an edge round train
    nearly every block. An edge round trains its edge's chunks only.
    Cost: a cloud round makes one call per chunk where plain mode makes
    one N-row call (PERF.md section 5).
    """
    grad_fn = torch.func.vmap(torch.func.grad(loss_fn))
    ctx = _resolve_ctx(ctx, "make_local_trainer")

    def run_epoch(params: dict, x, y, rows, perm) -> None:
        nb = x.shape[1] // batch_size
        r = rows[:, None]
        for s in range(nb):
            b = perm[:, s * batch_size:(s + 1) * batch_size]
            g = grad_fn(params, {"x": x[r, b], "y": y[r, b]})
            for k, p in params.items():
                p.copy_(p.to(torch.float32)
                        - lr * g[k].to(torch.float32))

    def run_calls(bank: dict, x, y, active, perm, calls) -> None:
        n = x.shape[0]
        off = ctx.row_offset(n)
        for call in calls:
            local = call - off
            real = (local >= 0) & (local < n)
            keep = real & active[np.clip(local, 0, n - 1)]
            if not keep.any():
                continue
            idx = np.where(real, local, local[real][0])
            rows = torch.as_tensor(idx, device=x.device)
            params = {k: v[rows] for k, v in bank.items()}
            run_epoch(params, x, y, rows, perm[rows])
            pos = torch.as_tensor(np.flatnonzero(keep), device=x.device)
            dst = rows[pos]
            for k, v in bank.items():
                v[dst] = params[k][pos]

    def local_train(bank: dict, x, y, gamma1_dev, max_g1: int, perms,
                    groups=None):
        g1 = _host_ints(gamma1_dev)
        n_epochs = min(int(max_g1), int(g1.max(initial=0)))
        if all_rows:
            calls = train_calls(np.zeros(x.shape[0] * ctx.n_shards, np.int64)
                                if groups is None else groups)
        for e in range(n_epochs):
            active = e < g1
            perm = perms[e].to(device=x.device, dtype=torch.int64)
            if all_rows:
                run_calls(bank, x, y, active, perm, calls)
            elif active.all():
                rows = torch.arange(x.shape[0], device=x.device)
                run_epoch(bank, x, y, rows, perm)
            else:
                rows = torch.as_tensor(np.flatnonzero(active),
                                       device=x.device)
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
    bank. Turns TF32 off
    (``repro_torch.device.disable_tf32``).

    Under a sharded ``ctx`` each rank passes its rows of ``bank``,
    ``x``, ``y``, ``sizes`` and ``edge_assign`` (``AggContext.
    place_bank`` / ``place_rows``) and the shuffles of all N rows; it
    trains its rows on their shuffles (``perms[..., r0:r1, :]``, so each
    row sees the one-device round's), Eq. 1 is one launch on its rows
    plus ``all_reduce`` (``ops.segment_agg_sharded``), the resync writes
    its rows only and Eq. 2 runs replicated on the (E, P) edge matrix. It
    returns its rows of the bank and the global and edge models, the
    same on every rank. No rank holds the full bank. When every edge's
    rows lie on one rank the aggregations are bitwise the one-device
    round's (zero partials add nothing); an edge spanning ranks differs
    in the last bits, except with ``deterministic``, whose Eq. 1 chains
    the ranks in row order (``ops.segment_agg_ordered``): the round is
    then bitwise the one-device round on any row layout.
    """
    ctx = _resolve_ctx(ctx, "make_cloud_round")
    local_train = make_local_trainer(loss_fn, lr, batch_size,
                                     all_rows=deterministic, ctx=ctx)

    def cloud_round(bank, x, y, sizes, edge_assign, g1, g2, perms):
        spec = flatbank.bank_spec(bank)
        _check_one_dtype(spec, "cloud_round")
        mat = spec.flatten(bank)
        bank = spec.unflatten(mat)           # views: updates land in mat
        perms = ctx.local_perms(perms, mat.shape[0])
        dev = mat.device
        sizes = torch.as_tensor(sizes, dtype=torch.float32, device=dev)
        ea = _host_ints(edge_assign)
        g1h, g2h = _host_ints(g1), _host_ints(g2)
        g1_dev, g2_dev = g1h[ea], g2h[ea]
        seg = torch.as_tensor(ea.astype(np.int32), device=dev)

        edge_mat = ctx.segment_agg_rows(mat, sizes, seg, n_edges,
                                        deterministic)
        groups = ctx.gather_row_ids(ea) if deterministic else None
        for t2 in range(min(int(max_g2), int(g2h.max(initial=0)))):
            g1_eff = np.where(t2 < g2_dev, g1_dev, 0)
            local_train(bank, x, y, g1_eff, max_g1, perms[t2], groups)
            a = ctx.segment_agg_rows(mat, sizes, seg, n_edges,
                                     deterministic)
            active_edge = t2 < g2h
            if active_edge.all():
                edge_mat = a
            else:
                keep = torch.as_tensor(active_edge, device=dev)[:, None]
                edge_mat = torch.where(keep, a, edge_mat)
            # devices resume from their edge's current model
            ops.segment_broadcast(edge_mat, seg, out=mat)

        edge_sizes = ctx.segment_weight_sums(sizes, seg, n_edges)
        zeros = torch.zeros((n_edges,), dtype=torch.int32, device=dev)
        glob = ctx.segment_agg_small(edge_mat, edge_sizes, zeros, 1)[0]
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
    epoch then trains the edge's fixed chunks, the calls the cloud round
    makes for them), within the grouped convolutions' last bits without
    it (they train the edge's rows alone). ``bank`` must have one dtype;
    its storage is reused. Turns TF32 off.

    Under a sharded ``ctx`` it takes and returns this rank's rows as
    ``make_cloud_round`` does; the masked Eq. 1 is one launch on them
    plus ``all_reduce``, the resync touches this rank's rows of the edge
    only, and ``edge_vec`` is the same on every rank. When the edge's
    rows lie on one rank the round is bitwise the one-device round.
    """
    ctx = _resolve_ctx(ctx, "make_edge_round")
    local_train = make_local_trainer(loss_fn, lr, batch_size,
                                     all_rows=deterministic, ctx=ctx)

    def edge_round(bank, x, y, sizes, edge_assign, edge_id, g1, g2,
                   global_vec, perms):
        spec = flatbank.bank_spec(bank)
        _check_one_dtype(spec, "edge_round")
        mat = spec.flatten(bank)
        bank = spec.unflatten(mat)           # views: updates land in mat
        perms = ctx.local_perms(perms, mat.shape[0])
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
        edge_mat = ctx.segment_agg_rows(mat, w, seg, n_edges, deterministic)
        g1_dev = np.where(row_active, g1, 0)
        groups = ctx.gather_row_ids(ea) if deterministic else None
        for t2 in range(min(int(max_g2), g2)):
            local_train(bank, x, y, g1_dev, max_g1, perms[t2], groups)
            edge_mat = ctx.segment_agg_rows(mat, w, seg, n_edges,
                                            deterministic)
            # resync only this edge's rows
            mat.copy_(masked_resync(edge_mat, mat, seg, alive, ctx=ctx))
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
    value per device. Turns TF32 off. Under a sharded ``ctx`` it takes
    and returns this rank's rows (``participate`` too) as
    ``make_cloud_round`` does, and the aggregation is one launch on them
    plus ``all_reduce``.
    """
    ctx = _resolve_ctx(ctx, "make_fedavg_round")
    local_train = make_local_trainer(loss_fn, lr, batch_size,
                                     all_rows=deterministic, ctx=ctx)

    def fedavg_round(bank, x, y, sizes, participate, g1, perms):
        spec = flatbank.bank_spec(bank)
        _check_one_dtype(spec, "fedavg_round")
        mat = spec.flatten(bank)
        bank = spec.unflatten(mat)           # views: updates land in mat
        perms = ctx.local_perms(perms, mat.shape[0])
        dev = mat.device
        part = _host_ints(participate).astype(bool)
        g1_dev = np.where(part, _host_ints(g1), 0)   # scalar or (N,)
        local_train(bank, x, y, g1_dev, max_g1, perms)
        w = torch.as_tensor(sizes, dtype=torch.float32, device=dev) \
            * torch.as_tensor(part, device=dev)
        seg = torch.zeros((mat.shape[0],), dtype=torch.int32, device=dev)
        glob = ctx.segment_agg_rows(mat, w, seg, 1, deterministic)[0]
        mat.copy_(glob.to(mat.dtype).expand_as(mat))
        return bank, spec.unflatten_model(glob)

    return _round_mode(fedavg_round, deterministic)
