"""The bank mesh: the ranks of a ``torch.distributed`` group over which
the ``(N, P)`` model bank's rows are sharded.

The port of the bank helpers of ``repro.launch.mesh``. The reference's
bank mesh is a ``jax.sharding.Mesh`` with axes ``("edge", "fl")``, the
HFL mesh's replica plane. Here a :class:`BankMesh` names the same two
axes over the ranks of a process group, one rank per shard, ranks in
``edge``-major order: rank ``r`` holds bank rows ``[r N/k, (r + 1) N/k)``
of ``k = edge * fl`` shards (``repro_torch.core.flatbank.place_bank``).

``derive_bank_mesh`` (the replica plane of the 5-axis HFL mesh) waits
for the HFL mesh, which only the LLM training path builds (ROADMAP item
10 (b)); the production and serving meshes belong to that path too.

Importing this module touches neither ``torch.distributed`` nor the
card: everything happens inside the functions.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device

BANK_AXES = ("edge", "fl")      # flat-bank row shards (replica plane)


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
