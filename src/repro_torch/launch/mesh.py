"""Meshes: the HFL mesh of the LLM train step and the bank mesh of the
sharded ``(N, P)`` model bank; the port of ``repro.launch.mesh``.

**HFL mesh.** The reference factors a TPU pod into the five axes
``("pod", "edge", "fl", "fsdp", "tp")``: ``pod`` x ``edge`` x ``fl``
index the diverging model replicas (Arena's edges and their devices),
``fsdp`` x ``tp`` shard each replica. Here an :class:`HFLMesh` names the
same five axes over ONE device, which holds every replica as the leading
``(pod, edge, fl)`` axes of each parameter leaf (``launch.train.
lift_params``), with fsdp = tp = 1. A mesh of several devices (replica
axes over a ``torch.distributed`` group, tensor axes over cards) is
ROADMAP item 10 (b), and so is ``derive_bank_mesh``, the replica plane
of such a mesh. The parameter PartitionSpecs (``serve_param_specs``,
``hfl_param_specs``) are pure functions here: a spec is a tuple with one
entry per dimension, ``None``, an axis name or a tuple of axis names,
as the reference's ``PartitionSpec`` reads entry for entry. On one
device they describe the layout and shard nothing.

**Bank mesh.** The reference's bank mesh is a ``jax.sharding.Mesh``
with axes ``("edge", "fl")``, the HFL mesh's replica plane. Here a
:class:`BankMesh` names the same two axes over the ranks of a process
group, one rank per shard, ranks in ``edge``-major order: rank ``r``
holds bank rows ``[r N/k, (r + 1) N/k)`` of ``k = edge * fl`` shards
(``repro_torch.core.flatbank.place_bank``).

Importing this module touches neither ``torch.distributed`` nor the
card: everything happens inside the functions.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device

HFL_AXES = ("pod", "edge", "fl", "fsdp", "tp")
REPLICA_AXES = ("pod", "edge", "fl")
TENSOR_AXES = ("fsdp", "tp")
SERVE_AXES = ("pod", "batch", "tp")
BANK_AXES = ("edge", "fl")      # flat-bank row shards (replica plane)
MESH_ITEM = "ROADMAP.md, 'Modules still to port', item 10 (b)"


# ---------------------------------------------------------------------------
# the HFL mesh (one device)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HFLMesh:
    """``dims`` over ``HFL_AXES`` on one ``device``: the replicas of the
    ``(pod, edge, fl)`` axes all live there."""
    dims: tuple
    device: torch.device

    @property
    def axis_names(self) -> tuple:
        return HFL_AXES

    @property
    def shape(self) -> dict:
        """``{"pod": p, "edge": e, "fl": f, "fsdp": 1, "tp": 1}``, as a
        JAX mesh's ``shape`` reads."""
        return dict(zip(HFL_AXES, self.dims))


def make_hfl_mesh(replicas: tuple, *, fsdp: int = 1, tp: int = 1,
                  device="cuda") -> HFLMesh:
    """An HFL mesh of ``replicas = (pod, edge, fl)`` model replicas on one
    device. fsdp or tp above 1 raise ``NotImplementedError``: sharding a
    replica needs several devices (item 10 (b))."""
    pod, edge, fl = (int(a) for a in replicas)
    if min(pod, edge, fl) < 1:
        raise ValueError(f"HFL mesh replicas {replicas} must be >= 1")
    if fsdp != 1 or tp != 1:
        raise NotImplementedError(
            f"fsdp={fsdp}, tp={tp}: a sharded replica needs a multi-device "
            f"HFL mesh: see {MESH_ITEM}")
    return HFLMesh(dims=(pod, edge, fl, 1, 1), device=resolve_device(device))


def derive_hfl_mesh(devices, topology: tuple, n_pods: int = 1) -> HFLMesh:
    """The reference's ``derive_hfl_mesh``: ``topology`` = (M edges, D
    fl-devices, F fsdp, T tp) must factor the devices of a pod
    (``len(devices) / n_pods``), else ``ValueError``, as in the
    reference. One device (topology (1, 1, 1, 1)) gives a one-replica
    mesh; more devices raise ``NotImplementedError`` (item 10 (b))."""
    devices = list(devices)
    m, d, f, t = (int(a) for a in topology)
    per_pod = len(devices) // max(int(n_pods), 1)
    if m * d * f * t != per_pod or per_pod * n_pods != len(devices):
        raise ValueError(
            f"topology {tuple(topology)} does not factor {per_pod} "
            f"devices/pod")
    if len(devices) > 1:
        raise NotImplementedError(
            f"an HFL mesh over {len(devices)} devices: see {MESH_ITEM}")
    return HFLMesh(dims=(1, m, d, f, t), device=resolve_device(devices[0]))


def n_replicas(hfl_mesh) -> tuple:
    s = hfl_mesh.shape
    return s["pod"], s["edge"], s["fl"]


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
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.device(device).index is None:
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return BankMesh(dims=(int(n_edge_shards), int(fl)), rank=int(rank),
                    device=dev, group=group)


def make_bank_context(n_edge_shards: int, fl: int = 1, *, group=None,
                      device="cuda"):
    """``AggContext.for_mesh(make_bank_mesh(n_edge_shards, fl, ...))``:
    the one object every ``hfl`` entry point, ``StalenessBuffer`` and
    ``EnvConfig(agg=)`` take."""
    from repro_torch.core.hfl import AggContext    # local: hfl imports us
    return AggContext.for_mesh(
        make_bank_mesh(n_edge_shards, fl, group=group, device=device))
