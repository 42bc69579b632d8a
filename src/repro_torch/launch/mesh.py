"""Meshes: the HFL mesh of the LLM train step, the bank mesh of the
sharded ``(N, P)`` model bank and the production layouts; the port of
``repro.launch.mesh``.

**HFL mesh.** The reference factors a TPU pod into the five axes
``("pod", "edge", "fl", "fsdp", "tp")``: ``pod`` x ``edge`` x ``fl``
index the diverging model replicas (Arena's edges and their devices),
``fsdp`` x ``tp`` shard each replica. Here an :class:`HFLMesh` lays the
replicas of the ``(pod, edge, fl)`` axes over a *rank grid* ``(p_r,
e_r, f_r)`` that divides them: the ranks of an initialised
``torch.distributed`` process group (the world), and each replica over
``F`` x ``T`` tensor ranks: the ranks lie in row-major order over
``(p_r, e_r, f_r, F, T)``, tp the fastest axis, as the reference
reshapes its device array. Rank ``r`` holds, at its grid coordinates,
the block of ``(pod/p_r, edge/e_r, fl/f_r)`` replicas as the leading
axes of each parameter leaf (one device holds them all, grid ``(1, 1,
1)``, ``launch.train.lift_params``), and of each leaf that the
reference's specs split over tensor axes its block at its tensor
coordinate ``(f, t)`` (``place_params``, ``tp_blocks``): a dimension
split over ``("fsdp", "tp")`` (the FFN, the vocabulary) is cut into F x
T equal contiguous blocks, fsdp-major, rank (f, t) holding block f T +
t, as a JAX ``NamedSharding`` lays one dimension over two mesh axes; a
dimension split over ``"tp"`` alone (attention) into T blocks, the same
on every fsdp rank. So the reference's fsdp is a wider tensor split of
the FFN and the vocabulary, not ZeRO, and the layers run it by hand as
Megatron-style tensor parallelism (``models.tp``). fsdp above 1 outside
the dense and audio families, and tp above 1 outside the dense and ssm
families, is the rest of the tensor plane of ROADMAP item 10 (b) and
raises ``NotImplementedError`` (``models.tp.check``). The mesh owns the
process groups its collectives cross: the tp group (the T consecutive
ranks of a replica block at one fsdp coordinate), the ft group (the F x
T ranks of a replica block), and at each tensor coordinate the fl group
of each ``(pod, edge)`` block of ranks (Eq. 1; none when f_r = 1) and
the replica group of all of them (Eq. 2; the world when F = T = 1). The
parameter PartitionSpecs (``serve_param_specs``, ``hfl_param_specs``)
are pure functions: a spec is a tuple with one entry per dimension,
``None``, an axis name or a tuple of axis names, as the reference's
``PartitionSpec`` reads entry for entry; ``shardings`` turns one into
this rank's index of a leaf.

**Production layouts.** ``make_production_mesh`` returns a
:class:`RankMesh`, the port's stand-in for a ``jax.sharding.Mesh``: the
ranks laid out over named axes, a layout only. ``derive_serve_mesh``
returns one too, unless a process group spans its ranks.

**Serve mesh.** Serving has no replicas: the reference refactors the
devices into ``("pod", "batch", "tp")``, the request batch split over
``("pod", "batch")`` and each model's tensors over ``tp``. A
:class:`ServeMesh` lays those axes over the ranks of an initialised
process group, row-major over ``(pod, batch, tp)`` with tp the fastest,
as the reference reshapes its devices (``make_serve_mesh``; and
``derive_serve_mesh`` where a process group spans its ranks). It owns
the tp group of each ``(pod, batch)`` coordinate; ``shardings`` gives
each rank its index into a leaf under the reference's serve specs
(``launch.serve``), and ``gather_serve`` joins the ranks' blocks whole.

**Bank mesh.** The reference's bank mesh is a ``jax.sharding.Mesh``
with axes ``("edge", "fl")``, the HFL mesh's replica plane. Here a
:class:`BankMesh` names the same two axes over the ranks of a process
group, one rank per shard, ranks in ``edge``-major order: rank ``r``
holds bank rows ``[r N/k, (r + 1) N/k)`` of ``k = edge * fl`` shards
(``repro_torch.core.flatbank.place_bank``); ``derive_bank_mesh`` takes
it from an HFL mesh's pod 0.

Importing this module touches neither ``torch.distributed`` nor the
card: everything happens inside the functions.
"""
from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import tp as tp_mod

HFL_AXES = ("pod", "edge", "fl", "fsdp", "tp")
REPLICA_AXES = ("pod", "edge", "fl")
TENSOR_AXES = ("fsdp", "tp")
SERVE_AXES = ("pod", "batch", "tp")
BANK_AXES = ("edge", "fl")      # flat-bank row shards (replica plane)
MESH_ITEM = tp_mod.TP_ITEM


def _world():
    """``torch.distributed``, or None when no process group is up."""
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def torchrun_world() -> bool:
    """Under ``torchrun`` (``WORLD_SIZE`` in the environment) and with no
    process group up yet: initialise the world from the environment on
    gloo (which runs CPU and CUDA tensors) and return True; else
    False."""
    import torch.distributed as dist
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return False
    dist.init_process_group("gloo")
    return True


def _rank_device(device) -> torch.device:
    """This rank's device: ``"cuda"`` gives ``cuda:{r % cards}``, r the
    process's global rank, and makes it the current card; ``"cpu"`` the
    CPU (the gloo backend runs both)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.device(device).index is None:
        dev = torch.device("cuda", _world().get_rank()
                           % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


# ---------------------------------------------------------------------------
# the HFL mesh: replicas over the ranks of a process group
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HFLMesh:
    """``dims`` over ``HFL_AXES``; the ``(pod, edge, fl)`` replicas over
    the rank grid ``grid`` and each replica over ``dims[3]`` = F fsdp x
    ``dims[4]`` = T tp ranks, rank ``rank`` holding the ``block`` at its
    grid coordinates and its tensor blocks at ``(fsdp_rank, tp_rank)``,
    on ``device``. ``tp_group`` is the process group of the T ranks of
    its replica block at its fsdp coordinate (None when T = 1),
    ``ft_group`` that of the F x T ranks of its replica block (None when
    F x T = 1; the tp group when F = 1), ``fl_group`` that of its ``(pod,
    edge)`` block of ranks at its tensor coordinate (None when f_r = 1)
    and ``replica_group`` that of every replica block at its tensor
    coordinate (Eq. 2; None: the world, when F x T = 1). One device:
    grid (1, 1, 1), F = T = 1, rank 0, no groups."""
    dims: tuple
    device: torch.device
    grid: tuple = (1, 1, 1)
    rank: int = 0
    fl_group: object = dataclasses.field(default=None, compare=False)
    replica_group: object = dataclasses.field(default=None, compare=False)
    tp_group: object = dataclasses.field(default=None, compare=False)
    ft_group: object = dataclasses.field(default=None, compare=False)

    @property
    def axis_names(self) -> tuple:
        return HFL_AXES

    @property
    def shape(self) -> dict:
        """``{"pod": p, "edge": e, "fl": f, "fsdp": F, "tp": T}``, as a
        JAX mesh's ``shape`` reads (replicas and tensor ranks)."""
        return dict(zip(HFL_AXES, self.dims))

    @property
    def fsdp(self) -> int:
        return int(self.dims[3])

    @property
    def tp(self) -> int:
        return int(self.dims[4])

    @property
    def ft(self) -> int:
        """The tensor ranks of one replica, F x T."""
        return self.fsdp * self.tp

    @property
    def replica_ranks(self) -> int:
        """The ranks of one tensor coordinate: one per replica block."""
        return math.prod(self.grid)

    @property
    def n_ranks(self) -> int:
        return self.replica_ranks * self.ft

    @property
    def coords(self) -> tuple:
        """This rank's ``(pod, edge, fl)`` coordinates in the rank grid."""
        return tuple(int(c) for c in np.unravel_index(self.rank // self.ft,
                                                      self.grid))

    @property
    def ft_rank(self) -> int:
        """This rank's place in its ft group, f T + t: its block of every
        leaf split over ``("fsdp", "tp")``."""
        return self.rank % self.ft

    @property
    def fsdp_rank(self) -> int:
        return self.ft_rank // self.tp

    @property
    def tp_rank(self) -> int:
        """This rank's tp coordinate: its block of every leaf split over
        ``"tp"`` alone."""
        return self.rank % self.tp

    @property
    def tp_context(self):
        """The ``models.tp.TPContext`` of this rank's tp group
        (``Model.loss(tp=)``: attention), None when T = 1."""
        if self.tp == 1:
            return None
        return tp_mod.TPContext(self.tp_group, self.tp, self.tp_rank)

    @property
    def ft_context(self):
        """The ``models.tp.TPContext`` of this rank's ft group
        (``Model.loss(ft=)``: the FFN and the vocabulary), None when F x
        T = 1; the tp context when F = 1."""
        if self.fsdp == 1:
            return self.tp_context
        return tp_mod.TPContext(self.ft_group, self.ft, self.ft_rank)

    @property
    def block(self) -> tuple:
        """The ``(pod, edge, fl)`` replicas each rank holds."""
        return tuple(d // g for d, g in zip(self.dims[:3], self.grid))

    def block_slice(self, axis: str) -> slice:
        """This rank's replicas along the replica axis ``axis``."""
        i = REPLICA_AXES.index(axis)
        b, c = self.block[i], self.coords[i]
        return slice(c * b, (c + 1) * b)


def rank_grid(replicas: tuple, n_ranks: int) -> tuple:
    """A rank grid ``(p_r, e_r, f_r)`` of ``n_ranks`` ranks that divides
    ``replicas``, filled from the fl axis outwards (so Eq. 1 crosses
    ranks first); ``ValueError`` where none does."""
    n = int(n_ranks)
    f = math.gcd(int(replicas[2]), n)
    e = math.gcd(int(replicas[1]), n // f)
    p = n // (f * e)
    if int(replicas[0]) % p:
        raise ValueError(f"{n} ranks do not divide the replicas "
                         f"{tuple(replicas)}")
    return (p, e, f)


def make_hfl_mesh(replicas: tuple, *, ranks=None, fsdp: int = 1,
                  tp: int = 1, device="cuda") -> HFLMesh:
    """An HFL mesh of ``replicas = (pod, edge, fl)`` model replicas over
    the rank grid ``ranks`` (default ``(1, 1, 1)``: every replica on one
    device), each replica split over ``fsdp`` x ``tp`` ranks. A mesh of
    k = prod(ranks) x fsdp x tp > 1 ranks needs an initialised process
    group of exactly k ranks, the ranks in row-major order over ``ranks
    + (fsdp, tp)``, and builds its groups with ``dist.new_group``, so
    every rank calls this, with the same arguments; ``device="cuda"``
    puts this rank's blocks on ``cuda:{r % cards}``. ``ValueError`` where
    the grid does not divide the replicas or the group does not fit the
    mesh. Whether a model splits over F x T ranks is the train step's
    check (``models.tp.check``)."""
    pod, edge, fl = (int(a) for a in replicas)
    if min(pod, edge, fl) < 1:
        raise ValueError(f"HFL mesh replicas {replicas} must be >= 1")
    fsdp, tp = int(fsdp), int(tp)
    if min(fsdp, tp) < 1:
        raise ValueError(f"fsdp={fsdp} and tp={tp} must be >= 1")
    grid = (1, 1, 1) if ranks is None else tuple(int(a) for a in ranks)
    if len(grid) != 3 or min(grid) < 1 or any(
            d % g for d, g in zip((pod, edge, fl), grid)):
        raise ValueError(f"rank grid {grid} does not divide the replicas "
                         f"{(pod, edge, fl)}")
    dims = (pod, edge, fl, fsdp, tp)
    n_blocks, ft = math.prod(grid), fsdp * tp
    k = n_blocks * ft
    if k == 1:
        return HFLMesh(dims=dims, device=resolve_device(device))
    dist = _world()
    if dist is None or dist.get_world_size() != k:
        raise ValueError(f"rank grid {grid + (fsdp, tp)} needs an "
                         f"initialised torch.distributed process group of "
                         f"{k} ranks")
    rank = dist.get_rank()
    dev = _rank_device(device)
    ids = np.arange(k).reshape((n_blocks, fsdp, tp))  # (block, fsdp, tp)
    groups = {}

    def build(kind, members):
        # every rank creates every group, in the same order
        group = dist.new_group(members.tolist())
        if rank in members:
            groups[kind] = group

    if tp > 1:
        for members in ids.reshape(-1, tp):
            build("tp_group", members)
    if fsdp > 1:
        for members in ids.reshape(n_blocks, ft):
            build("ft_group", members)
    elif tp > 1:
        groups["ft_group"] = groups["tp_group"]
    at_coord = ids.reshape(n_blocks, ft)      # (block, tensor coordinate)
    if grid[2] > 1:
        for c in range(ft):
            for members in at_coord[:, c].reshape(-1, grid[2]):
                build("fl_group", members)
    if ft > 1 and n_blocks > 1:
        for c in range(ft):
            build("replica_group", at_coord[:, c])
    return HFLMesh(dims=dims, device=dev, grid=grid, rank=rank, **groups)


def derive_hfl_mesh(devices, topology: tuple, n_pods: int = 1) -> HFLMesh:
    """The reference's ``derive_hfl_mesh``: ``topology`` = (M edges, D
    fl-devices, F fsdp, T tp) must factor the devices of a pod
    (``len(devices) / n_pods``), else ``ValueError``, as in the
    reference. ``devices`` holds one device per rank of the world, in
    rank order; each replica block of F x T ranks holds one replica, so
    the mesh is replicas ``(n_pods, M, D)`` over the same rank grid, each
    split over F x T tensor ranks (one device: every replica there)."""
    devices = list(devices)
    m, d, f, t = (int(a) for a in topology)
    per_pod = len(devices) // max(int(n_pods), 1)
    if m * d * f * t != per_pod or per_pod * n_pods != len(devices):
        raise ValueError(
            f"topology {tuple(topology)} does not factor {per_pod} "
            f"devices/pod")
    if len(devices) == 1:
        return make_hfl_mesh((1, m, d), device=devices[0])
    dist = _world()
    reps = (int(n_pods), m, d)
    return make_hfl_mesh(reps, ranks=reps, fsdp=f, tp=t, device=devices[
        dist.get_rank() if dist is not None else 0])


def n_replicas(hfl_mesh) -> tuple:
    s = hfl_mesh.shape
    return s["pod"], s["edge"], s["fl"]


def _leaf_spec(path: str, shape, hfl_mesh) -> tuple:
    """One unlifted leaf's tensor spec (``_spec_for``, no expert
    parallelism), guarded by the mesh's sizes."""
    return _guard_divisibility(_spec_for(path, len(shape), False),
                               tuple(shape), hfl_mesh.shape)


def tensor_cut(spec: tuple, hfl_mesh):
    """How ``spec`` splits a replica's leaf over the mesh's tensor ranks:
    ``(dim, n, i, ctx)``, the dimension cut into ``n`` equal contiguous
    blocks, this rank's block ``i`` (fsdp-major over a ``("fsdp",
    "tp")`` entry, as a ``NamedSharding`` reads two axes) and the
    ``models.tp.TPContext`` of the ranks that hold the other blocks (the
    tp group for ``"tp"``, the ft group where fsdp takes part); None
    where it splits no dimension over more than one rank."""
    sizes = {"fsdp": hfl_mesh.fsdp, "tp": hfl_mesh.tp}
    at = {"fsdp": hfl_mesh.fsdp_rank, "tp": hfl_mesh.tp_rank}
    for dim, entry in enumerate(spec):
        axes = [a for a in (() if entry is None else entry if isinstance(
            entry, tuple) else (entry,)) if sizes.get(a, 1) > 1]
        if not axes:
            continue
        n, i = 1, 0
        for a in axes:
            n, i = n * sizes[a], i * sizes[a] + at[a]
        ctx = hfl_mesh.ft_context if "fsdp" in axes else \
            hfl_mesh.tp_context
        return dim, n, i, ctx
    return None


def _place(params, hfl_mesh, lead: tuple) -> dict:
    """Each leaf indexed by ``lead`` on its leading axes, then cut to this
    rank's tensor block where the reference's specs (and the guard)
    split it (``tensor_cut``), a new contiguous tensor on the mesh's
    device."""
    def place(path, a):
        a = torch.as_tensor(a)[lead]
        n = len(lead)
        cut = tensor_cut(_leaf_spec(path, a.shape[n:], hfl_mesh), hfl_mesh)
        if cut is not None:
            dim, k, i, _ = cut
            size = a.shape[n + dim] // k
            a = a.narrow(n + dim, i * size, size)
        return a.to(hfl_mesh.device, copy=True).contiguous()

    return _map_paths(place, params)


def tp_blocks(params, hfl_mesh) -> dict:
    """This rank's tensor blocks of one whole replica's (unlifted)
    parameter tree: each leaf split over ``("fsdp", "tp")`` cut to its
    block f T + t of F x T, each split over ``"tp"`` to its t-th of T.
    Lift the result to the rank's replica block with
    ``launch.train.lift_params``."""
    return _place(params, hfl_mesh, ())


def place_params(params, hfl_mesh) -> dict:
    """This rank's block of a whole lifted parameter tree (every leaf
    ``(pod, edge, fl, ...)``, ``launch.train.lift_params``): each leaf's
    block of the replica axes and, of a leaf split over tensor axes, its
    tensor block (``tp_blocks``)."""
    return _place(params, hfl_mesh, tuple(hfl_mesh.block_slice(a)
                                          for a in REPLICA_AXES))


def gather_replicas(block, hfl_mesh):
    """One leaf's blocks ``(pod/p_r, edge/e_r, fl/f_r, ...)`` from every
    replica block laid out whole, ``(pod, edge, fl, ...)`` on every rank:
    one ``all_gather`` over the replica group of this rank's tensor
    coordinate (the world when F = T = 1), which every rank calls (the
    block itself on one replica block)."""
    k = hfl_mesh.replica_ranks
    if k == 1:
        return block
    rest = tuple(block.shape[3:])
    parts = torch.empty((k,) + tuple(block.shape), dtype=block.dtype,
                        device=block.device)
    _world().all_gather(list(parts.unbind(0)), block.contiguous(),
                        group=hfl_mesh.replica_group)
    tail = tuple(range(6, 6 + len(rest)))
    whole = parts.view(hfl_mesh.grid + hfl_mesh.block + rest).permute(
        (0, 3, 1, 4, 2, 5) + tail)
    return whole.reshape(tuple(hfl_mesh.dims[:3]) + rest).contiguous()


def gather_blocks(block, axis, ctx):
    """One leaf's tensor blocks joined along ``axis`` on every rank of
    the group of ``ctx`` (a ``models.tp.TPContext``), in its rank order:
    one ``all_gather`` over it, which each of them calls; the block
    itself when ``axis`` is None."""
    if axis is None or ctx is None:
        return block
    parts = torch.empty((ctx.size,) + tuple(block.shape), dtype=block.dtype,
                        device=block.device)
    _world().all_gather(list(parts.unbind(0)), block.contiguous(),
                        group=ctx.group)
    return torch.cat(parts.unbind(0), dim=axis)


def _specs_at(specs, path: str):
    for key in path.split("/"):
        specs = specs[int(key) if isinstance(specs, list) else key]
    return specs


def _join(params, hfl_mesh, specs, n_lead: int, first=None) -> dict:
    """``first`` (default: nothing) on each leaf, then its tensor blocks
    joined (``gather_blocks``) on the dimension its spec (lifted; a leaf
    with ``n_lead`` leading replica axes) splits, over the group that
    holds them. With F x T > 1 the specs are needed: a block does not
    say whether its leaf was split (the guard keeps a leaf F x T or T
    does not divide whole)."""
    if hfl_mesh.ft > 1 and specs is None:
        raise ValueError("joining tensor blocks needs the tree's specs "
                         "(hfl_param_specs with the mesh)")

    def join(path, a):
        a = a if first is None else first(a)
        if hfl_mesh.ft == 1:
            return a
        cut = tensor_cut(_specs_at(specs, path)[3 - n_lead:], hfl_mesh)
        return a if cut is None else gather_blocks(a, cut[0], cut[3])

    return _map_paths(join, params)


def gather_params(params, hfl_mesh, specs=None) -> dict:
    """The inverse of ``place_params``: every rank's blocks joined into
    the whole lifted tree on every rank (``gather_replicas`` and
    ``gather_blocks`` per leaf; for tests and checks). With F x T > 1 it
    needs the tree's ``specs`` (``hfl_param_specs(cfg, shapes,
    hfl_mesh)``, the train step's ``param_specs``)."""
    return _join(params, hfl_mesh, specs, 3,
                 lambda a: gather_replicas(a, hfl_mesh))


def gather_replica(params, hfl_mesh, specs=None) -> dict:
    """One replica's tensor blocks (an unlifted tree, ``tp_blocks``)
    joined whole on every rank of its ft group, leaf by leaf; ``specs``
    as for ``gather_params``."""
    return _join(params, hfl_mesh, specs, 0)


# ---------------------------------------------------------------------------
# production layouts
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RankMesh:
    """Global ranks laid out over ``axis_names``: ``ranks`` is an int
    array of the axes' shape, as a ``jax.sharding.Mesh`` lays out its
    devices. A layout only."""
    ranks: np.ndarray = dataclasses.field(compare=False)
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)


def make_production_mesh(*, multi_pod: bool = False,
                         n_ranks=None) -> RankMesh:
    """The reference's production mesh: ``("data", "model")`` = (16, 16)
    over 256 ranks, or ``("pod", "data", "model")`` = (2, 16, 16) over
    512. ``n_ranks`` (default: the world's size, 1 without a process
    group) below that raises ``ValueError``, as ``jax.make_mesh`` does
    with too few devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    if n_ranks is None:
        dist = _world()
        n_ranks = dist.get_world_size() if dist is not None else 1
    if n_ranks < need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks, "
                         f"have {n_ranks}")
    return RankMesh(np.arange(need).reshape(shape), axes)


def derive_serve_mesh(mesh: RankMesh, tp: int, *, device="cuda"):
    """Serving has no replicas: ``("pod", "batch", "tp")`` over the same
    ranks, as the reference derives it (``ValueError`` where ``tp`` does
    not divide a pod's ranks). Where an initialised process group spans
    exactly those ranks a runnable :class:`ServeMesh` on ``device``
    (``make_serve_mesh``, which every rank calls), else a
    :class:`RankMesh`, a layout only."""
    ranks = mesh.ranks
    n_pods = ranks.shape[0] if ranks.ndim == 3 else 1
    per_pod = ranks.size // n_pods
    if per_pod % tp:
        raise ValueError(f"tp={tp} does not divide {per_pod}")
    dist = _world()
    if (dist.get_world_size() if dist is not None else 1) == ranks.size:
        return make_serve_mesh(tp, ranks=(n_pods, per_pod // tp),
                               device=device)
    return RankMesh(ranks.reshape(n_pods, per_pod // tp, tp), SERVE_AXES)


@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """``dims`` = (pod, batch, tp) over the ranks of a process group,
    row-major, tp the fastest axis: rank ``rank`` at ``coords``, on
    ``device``. ``tp_group`` is the process group of the T ranks at its
    ``(pod, batch)`` coordinate (None when T = 1). One device: (1, 1, 1),
    rank 0, no group."""
    dims: tuple
    device: torch.device
    rank: int = 0
    tp_group: object = dataclasses.field(default=None, compare=False)

    @property
    def axis_names(self) -> tuple:
        return SERVE_AXES

    @property
    def shape(self) -> dict:
        """``{"pod": p, "batch": b, "tp": T}``, as a JAX mesh's ``shape``
        reads."""
        return dict(zip(SERVE_AXES, self.dims))

    @property
    def tp(self) -> int:
        return int(self.dims[2])

    @property
    def n_ranks(self) -> int:
        return math.prod(self.dims)

    @property
    def coords(self) -> tuple:
        """This rank's ``(pod, batch, tp)`` coordinates."""
        return _coords(self.rank, self.dims)

    @property
    def tp_rank(self) -> int:
        return self.coords[2]

    @property
    def tp_context(self):
        """The ``models.tp.TPContext`` of this rank's tp group (the
        serving layers' ``tp=``), None when T = 1."""
        if self.tp == 1:
            return None
        return tp_mod.TPContext(self.tp_group, self.tp, self.tp_rank)

    def index(self, spec: tuple, shape) -> tuple:
        """This rank's index into a leaf of ``shape`` laid out by
        ``spec`` (``_serve_index``)."""
        return _serve_index(spec, tuple(shape), self.dims, self.coords)


def _coords(rank: int, dims: tuple) -> tuple:
    return tuple(int(c) for c in np.unravel_index(rank, dims))


def _serve_index(spec: tuple, shape: tuple, dims: tuple, coords: tuple):
    """The index of the rank at ``coords`` of a serve mesh ``dims`` into
    a leaf of ``shape`` laid out by ``spec``: one slice per entry, a
    dimension split over the entry's axes cut into as many equal
    contiguous blocks as they have ranks, the block of the rank's
    coordinates over them in row-major order (``("pod", "batch")``: pod
    p, batch b holds block p B + b, as a ``NamedSharding`` reads two
    axes); an entry whose axes have one rank, and None, whole. An entry
    over both ``"batch"`` (of more than one rank) and ``"tp"``, the
    reference's ``fsdp_serve`` weights, raises ``NotImplementedError``
    (item 10 (b)); a dimension its blocks do not divide ``ValueError``."""
    sizes = dict(zip(SERVE_AXES, dims))
    at = dict(zip(SERVE_AXES, coords))
    out = []
    for i, entry in enumerate(spec):
        axes = () if entry is None else \
            entry if isinstance(entry, tuple) else (entry,)
        wide = [a for a in axes if sizes[a] > 1]
        if "batch" in wide and "tp" in wide:
            raise NotImplementedError(
                f"spec {spec} merges a weight's dimension over ('batch', "
                f"'tp') (the reference's fsdp_serve): {MESH_ITEM}")
        n, k = 1, 0
        for a in wide:
            n, k = n * sizes[a], k * sizes[a] + at[a]
        if n == 1:
            out.append(slice(None))
            continue
        if shape[i] % n:
            raise ValueError(f"spec {spec} splits dimension {i} of {shape} "
                             f"into {n} blocks")
        m = shape[i] // n
        out.append(slice(k * m, (k + 1) * m))
    return tuple(out)


def make_serve_mesh(tp: int, *, ranks=None, device="cuda") -> ServeMesh:
    """A serve mesh of ``ranks`` = (pod, batch) rank coordinates (default
    ``(1, world / tp)``; one device without a process group) times
    ``tp`` tp ranks, over an initialised process group of exactly that
    many ranks, row-major over ``(pod, batch, tp)``. It builds the tp
    groups with ``dist.new_group``, so every rank calls it with the same
    arguments; ``device="cuda"`` puts this rank's blocks on ``cuda:{r %
    cards}``. ``ValueError`` where the group does not fit the mesh."""
    tp = int(tp)
    dist = _world()
    world = dist.get_world_size() if dist is not None else 1
    if ranks is None:
        if tp < 1 or world % tp:
            raise ValueError(f"tp={tp} does not divide the world's {world} "
                             f"ranks")
        ranks = (1, world // tp)
    dims = tuple(int(a) for a in ranks) + (tp,)
    if len(dims) != 3 or min(dims) < 1:
        raise ValueError(f"serve mesh {dims} must be (pod, batch, tp) >= 1")
    k = math.prod(dims)
    if k == 1:
        return ServeMesh(dims=dims, device=resolve_device(device))
    if world != k:
        raise ValueError(f"serve mesh {dims} needs an initialised "
                         f"torch.distributed process group of {k} ranks")
    rank = dist.get_rank()
    dev = _rank_device(device)
    group = None
    if tp > 1:
        for members in np.arange(k).reshape(-1, tp):
            g = dist.new_group(members.tolist())     # every rank, in order
            if rank in members:
                group = g
    return ServeMesh(dims=dims, device=dev, rank=rank, tp_group=group)


def gather_serve(block, spec: tuple, mesh: ServeMesh):
    """The whole leaf on every rank from each rank's ``block`` of it laid
    out by ``spec`` over ``mesh`` (``shardings``): one ``all_gather`` of
    the blocks' bytes over the mesh's ranks (every rank calls it), each
    placed at its rank's index; of ranks that hold the same block (an
    axis the spec does not name) the lowest rank's is kept. The block
    itself when ``spec`` splits nothing."""
    sizes = mesh.shape
    n = []
    for entry in spec:
        axes = () if entry is None else \
            entry if isinstance(entry, tuple) else (entry,)
        n.append(math.prod(sizes[a] for a in axes))
    n += [1] * (block.dim() - len(n))
    if math.prod(n) == 1:
        return block
    whole_shape = tuple(s * m for s, m in zip(block.shape, n))
    raw = block.contiguous().view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(mesh.n_ranks)]
    _world().all_gather(parts, raw)
    whole = torch.empty(whole_shape, dtype=block.dtype, device=block.device)
    for r in reversed(range(mesh.n_ranks)):    # the lowest rank writes last
        idx = _serve_index(spec, whole_shape, mesh.dims,
                           _coords(r, mesh.dims))
        whole[idx] = parts[r].view(block.dtype).view(block.shape)
    return whole


# ---------------------------------------------------------------------------
# parameter PartitionSpecs, as tuples of axis names
# ---------------------------------------------------------------------------

_FT = TENSOR_AXES           # combined 'fsdp','tp' mega-tensor axis
_TP = "tp"


def _spec_for(path: str, ndim: int, ep: bool) -> tuple:
    """Tensor-sharding spec of one (serve-layout) parameter leaf, the
    reference's ``_spec_for`` case for case. ``path`` is the '/'-joined
    key path; stacked layer leaves carry a leading L axis (never
    sharded)."""
    name = path.split("/")[-1]
    nd = ndim

    def last2(row_axes, col_axes):
        return (None,) * (nd - 2) + (row_axes, col_axes)

    def last1(axes):
        return (None,) * (nd - 1) + (axes,)

    moe = "moe" in path
    if name == "embed":
        return (_FT, None)
    if name == "unembed":
        return (None, _FT)
    if name == "vis_proj":
        return (None, _TP)
    if name == "dec_pos":
        return ()
    if name in ("wq", "wk", "wv"):
        return last2(None, _TP)
    if name == "wo":
        return last2(_TP, None)
    if name in ("bq", "bk", "bv"):
        return last1(_TP)
    if name in ("w_gate", "w_up"):
        if moe and ep:       # expert parallel: experts over tp
            return (None,) * (nd - 3) + (_TP, None, None)
        return last2(None, _FT)
    if name == "w_down":
        if moe and ep:
            return (None,) * (nd - 3) + (_TP, None, None)
        return last2(_FT, None)
    if name == "b_up":
        return last1(_FT)
    if name in ("w_r", "w_k", "w_v", "w_g") and "tmix" in path:
        return last2(None, _TP)
    if name == "w_o" and "tmix" in path:
        return last2(_TP, None)
    if name == "bonus_u":
        return (None,) * (nd - 2) + (_TP, None)
    if name == "w_k" and "cmix" in path:
        return last2(None, _FT)
    if name == "w_v" and "cmix" in path:
        return last2(_FT, None)
    if name == "w_r" and "cmix" in path:
        return last2(None, _TP)
    if name in ("w_z", "w_x"):
        return last2(None, _TP)
    if name == "w_dt":
        return last2(None, None)
    if name == "w_out":
        return last2(_TP, None)
    if name == "norm" and nd >= 1:
        return last1(_TP)
    return (None,) * nd      # norms, scalars, conv, lora, router, biases


def _map_paths(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a nested dict (lists index by position),
    keeping its structure; ``path`` joins the keys with '/'."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_paths(fn, v, f"{path}/{i}" if path else
                                     str(i)) for i, v in enumerate(tree))
    return fn(path, tree)


def serve_param_specs(cfg, params_shape) -> dict:
    """The spec tree of the (unreplicated) parameter tree
    ``params_shape``: any nested dict whose leaves have ``.shape``
    (tensors, meta tensors, shape structs)."""
    ep = cfg.moe is not None and cfg.moe.parallelism == "expert"
    return _map_paths(lambda p, leaf: _spec_for(p, len(leaf.shape), ep),
                      params_shape)


def _guard_divisibility(spec: tuple, shape, axis_sizes: dict) -> tuple:
    """Drop the shardings that do not divide their dimension (the
    reference's jax would reject them, e.g. whisper's odd vocab over
    fsdp)."""
    out = []
    for i, s_ in enumerate(spec):
        if s_ is not None:
            size = 1
            for a in (s_ if isinstance(s_, tuple) else (s_,)):
                size *= axis_sizes.get(a, 1)
            if i < len(shape) and shape[i] % size != 0:
                s_ = None
        out.append(s_)
    return tuple(out)


def hfl_param_specs(cfg, params_shape, mesh=None) -> dict:
    """HFL layout: every leaf gains leading ("pod", "edge", "fl") replica
    dims; with ``mesh``, shardings its sizes cannot honour are
    dropped."""
    sizes = dict(mesh.shape) if mesh is not None else {}
    ep = cfg.moe is not None and cfg.moe.parallelism == "expert"

    def lift(path, leaf):
        spec = _spec_for(path, len(leaf.shape), ep)
        if mesh is not None:
            spec = _guard_divisibility(spec, tuple(leaf.shape), sizes)
        return REPLICA_AXES + spec

    return _map_paths(lift, params_shape)


def _map_specs(fn, tree, shapes=None):
    """``fn(spec, shape)`` over a tree of specs (dicts and lists of
    tuples), ``shape`` the ``.shape`` of the leaf at the same place in
    ``shapes`` (a tuple there is the shape itself; None without
    ``shapes``)."""
    at = (lambda k: None) if shapes is None else (lambda k: shapes[k])
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, at(k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_specs(fn, v, at(i)) for i, v in enumerate(tree)]
    if shapes is None:
        return fn(tree, None)
    return fn(tree, tuple(getattr(shapes, "shape", shapes)))


def shardings(mesh, specs, shapes=None):
    """For each spec of ``specs`` (``hfl_param_specs``), this rank's
    index into its leaf: one slice per spec entry, the rank's block of a
    replica axis (``HFLMesh.block_slice``), of a dimension split over
    tensor axes its block as ``tp_blocks`` cuts it (fsdp-major over
    ``("fsdp", "tp")``), as a ``PartitionSpec`` reads, and the whole of
    every other dimension. A tensor block needs the leaf's size:
    ``shapes`` is a tree of the whole leaves (anything with ``.shape``,
    or shape tuples, lifted as the specs are), else ``ValueError``. On a
    :class:`ServeMesh` the specs are the serve layout's
    (``launch.serve``'s ``serve_specs_for_params``, ``cache_specs``) and
    each index is the rank's block under them (``ServeMesh.index``:
    ``shapes`` needed). An entry naming a tensor axis of more than one
    rank of a layout only (a :class:`RankMesh`'s tp, say) raises
    ``NotImplementedError``: the tensor plane of item 10 (b)."""
    if isinstance(mesh, ServeMesh):
        return _map_specs(mesh.index, specs, shapes)
    hfl = isinstance(mesh, HFLMesh)
    sizes = dict(mesh.shape)

    def index(spec, shape):
        out = []
        for i, entry in enumerate(spec):
            axes = () if entry is None else \
                entry if isinstance(entry, tuple) else (entry,)
            wide = [a for a in axes
                    if a not in REPLICA_AXES and sizes.get(a, 1) > 1]
            if wide and not hfl:
                raise NotImplementedError(
                    f"spec {spec} shards a replica's tensors over {wide}: "
                    f"the tensor plane of {MESH_ITEM}")
            rep = [a for a in axes if a in REPLICA_AXES]
            if rep:
                out.append(mesh.block_slice(rep[0]))
            elif wide:
                _, n, k, _ = tensor_cut((entry,), mesh)
                if shape is None or shape[i] % n:
                    raise ValueError(
                        f"spec {spec} splits dimension {i} into {n} "
                        f"blocks: shardings needs a leaf shape it "
                        f"divides, got {shape}")
                m = shape[i] // n
                out.append(slice(k * m, (k + 1) * m))
            else:
                out.append(slice(None))
        return tuple(out)

    return _map_specs(index, specs, shapes)


# ---------------------------------------------------------------------------
# the bank mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BankMesh:
    """``dims`` = (edge shards, fl shards) over the ranks of ``group``
    (``None``: the default group); ``rank`` is this process's rank in
    it and ``device`` the device its rows live on."""
    dims: tuple
    rank: int
    device: torch.device
    group: object = dataclasses.field(default=None, compare=False)

    @property
    def axis_names(self) -> tuple:
        return BANK_AXES

    @property
    def shape(self) -> dict:
        """``{"edge": e, "fl": f}``, as a JAX mesh's ``shape`` reads."""
        return dict(zip(BANK_AXES, self.dims))

    @property
    def size(self) -> int:
        return int(self.dims[0]) * int(self.dims[1])


def make_bank_mesh(n_edge_shards: int, fl: int = 1, *, group=None,
                   device="cuda") -> BankMesh:
    """A ``("edge", "fl")`` bank mesh of ``n_edge_shards * fl`` shards
    over an initialised process group (``group``, default the world) of
    exactly that many ranks; raises ``ValueError`` otherwise, or when
    this process is not in ``group``.

    ``device="cuda"`` puts this rank's rows on ``cuda:{r % cards}``, r
    the process's global rank, and makes that card the current one;
    ``"cpu"`` keeps them on the CPU (the gloo backend runs both)."""
    import torch.distributed as dist
    need = int(n_edge_shards) * int(fl)
    if need < 1:
        raise ValueError(f"bank mesh ({n_edge_shards}, {fl}) has no shards")
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"bank mesh ({n_edge_shards}, {fl}) needs an "
                         f"initialised torch.distributed process group of "
                         f"{need} ranks")
    size = dist.get_world_size(group)
    if size != need:
        raise ValueError(f"bank mesh ({n_edge_shards}, {fl}) needs {need} "
                         f"ranks, the process group has {size}")
    rank = dist.get_rank(group)
    if rank < 0:
        raise ValueError("this process is not a member of the bank mesh's "
                         "process group")
    return BankMesh(dims=(int(n_edge_shards), int(fl)), rank=int(rank),
                    device=_rank_device(device), group=group)


def derive_bank_mesh(hfl_mesh) -> BankMesh:
    """The HFL mesh's ``(edge, fl)`` plane of pod 0 as a bank mesh (the
    reference's ``devices[0, :, :, 0, 0]``): its ``e_r x f_r`` ranks at
    tensor coordinates (0, 0), bank rows edge-major over them. With more
    than one pod of ranks, or F x T > 1, it builds their process group
    (``dist.new_group``, so every rank calls it) and raises
    ``ValueError`` on a rank outside it; so does a mesh that is not an
    HFL mesh, as in the reference."""
    if not isinstance(hfl_mesh, HFLMesh):
        raise ValueError(f"expected an HFL mesh with axes {HFL_AXES}, got "
                         f"{tuple(getattr(hfl_mesh, 'axis_names', ()))}")
    p_r, e_r, f_r = hfl_mesh.grid
    group, rank, ft = None, hfl_mesh.rank, hfl_mesh.ft
    if p_r > 1 or ft > 1:
        group = _world().new_group([b * ft for b in range(e_r * f_r)])
        if hfl_mesh.coords[0] != 0 or hfl_mesh.ft_rank != 0:
            raise ValueError(f"rank {hfl_mesh.rank} is not in pod 0 at "
                             f"tensor coordinates (0, 0) of the HFL mesh")
        rank = hfl_mesh.rank // ft
    return BankMesh(dims=(e_r, f_r), rank=rank, device=hfl_mesh.device,
                    group=group)


def make_bank_context(n_edge_shards: int, fl: int = 1, *, group=None,
                      device="cuda"):
    """``AggContext.for_mesh(make_bank_mesh(n_edge_shards, fl, ...))``:
    the one object every ``hfl`` entry point, ``StalenessBuffer`` and
    ``EnvConfig(agg=)`` take."""
    from repro_torch.core.hfl import AggContext    # local: hfl imports us
    return AggContext.for_mesh(
        make_bank_mesh(n_edge_shards, fl, group=group, device=device))
