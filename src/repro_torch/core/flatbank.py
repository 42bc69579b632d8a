"""Flat-bank engine: the model bank as one ``(N, P)`` matrix.

The port of ``repro.core.flatbank``. A *bank* is a dict of tensors whose
leaves carry a leading row axis (every device's parameters stacked);
``BankSpec`` is the recipe that lays its leaves side by side as the
columns of one ``(rows, P)`` matrix, so Eqs. 1/2 and the resync run as
one kernel launch each (``repro_torch.kernels.ops``).

* Leaf order is sorted by key, which is the order in which JAX flattens
  a dict, so the port's offsets and width equal the reference's
  ``bank_spec`` and a port matrix is column-for-column comparable with
  a reference one.
* If every leaf shares one dtype the matrix keeps it; mixed-dtype banks
  promote to f32, and ``unflatten`` casts each leaf back to its dtype.
* A bank whose leaves all have the matrix dtype can *live* as one
  contiguous ``(N, P)`` tensor with the leaves as views into it
  (``unflatten`` of a contiguous matrix returns exactly such views).
  ``flatten`` recognises that layout and returns the matrix without a
  copy, so local SGD that updates the leaves in place updates the
  matrix, and the resync kernel can write the bank in place.

The row-sharded layout over a bank mesh
(``repro_torch.launch.mesh.BankMesh``; ``local_rows``, ``row_slice``,
``place_bank``, ``place_rows``, ``place_replicated``, and
``gather_rows``, the inverse of ``place_rows``): rows shard over
all the mesh's axes, ``edge``-major, so rank ``r`` of ``k`` holds rows
``[r N/k, (r + 1) N/k)``, and columns are never split. A rank's part of
a bank (``place_bank``) is its rows as a new contiguous ``(N/k, P)``
matrix on its device, with the leaves as views into it, so no rank
holds the full bank. Edge and global
models are replicated: every rank holds them whole. The reference's
PartitionSpec helpers (``pspec``, ``tree_pspecs``) have no counterpart:
a torch rank holds its rows as a plain tensor.
"""
from __future__ import annotations

import dataclasses
import math

import torch


def _contiguous_strides(shape) -> tuple:
    strides, acc = [], 1
    for d in reversed(shape):
        strides.append(acc)
        acc *= int(d)
    return tuple(reversed(strides))


@dataclasses.dataclass(frozen=True)
class BankSpec:
    """Flattening recipe for one bank/model dict structure."""
    keys: tuple            # leaf names in sorted order
    shapes: tuple          # per-leaf trailing shape (no row axis)
    dtypes: tuple          # per-leaf storage dtype
    sizes: tuple           # per-leaf parameter count
    offsets: tuple         # per-leaf column offset into the flat matrix
    width: int             # P = total parameters per row
    dtype: torch.dtype     # flat matrix dtype (common leaf dtype or f32)

    # -- zero-copy detection --------------------------------------------
    def _shared_matrix(self, leaves, lead: tuple):
        """The (rows, P) or (P,) tensor the leaves are views of, or None
        when they are not laid out as one contiguous matrix."""
        first = leaves[0]
        ptr = first.untyped_storage().data_ptr()
        base = first.storage_offset() - self.offsets[0]
        row_stride = (self.width,) if lead else ()
        for leaf, off, shp in zip(leaves, self.offsets, self.shapes):
            if (leaf.dtype != self.dtype
                    or leaf.untyped_storage().data_ptr() != ptr
                    or leaf.storage_offset() != base + off):
                return None
            want = row_stride + _contiguous_strides(shp)
            # the stride of a size-1 dimension is never used
            if any(w != g for w, g, d in zip(want, leaf.stride(), leaf.shape)
                   if d != 1):
                return None
        rows = lead[0] if lead else 1
        need = (base + rows * self.width) * first.element_size()
        if base < 0 or need > first.untyped_storage().nbytes():
            return None
        shape = lead + (self.width,)
        return first.as_strided(shape, row_stride + (1,), base)

    # -- flat views -------------------------------------------------------
    def flatten(self, bank: dict):
        """Bank dict (leaves (rows, *shape)) -> (rows, P) matrix; no copy
        when the leaves are views of one contiguous matrix."""
        leaves = [bank[k] for k in self.keys]
        rows = leaves[0].shape[0]
        mat = self._shared_matrix(leaves, (rows,))
        if mat is not None:
            return mat
        cols = [leaf.reshape(rows, -1).to(self.dtype) for leaf in leaves]
        return cols[0].contiguous() if len(cols) == 1 \
            else torch.cat(cols, dim=1)

    def unflatten(self, mat) -> dict:
        """(rows, P) matrix -> bank dict, leaf dtypes restored; views into
        ``mat`` wherever the dtype is unchanged and ``mat`` is
        contiguous."""
        rows = mat.shape[0]
        return {k: mat[:, o:o + s].reshape((rows,) + shp).to(dt)
                for k, o, s, shp, dt in zip(self.keys, self.offsets,
                                            self.sizes, self.shapes,
                                            self.dtypes)}

    def flatten_model(self, model: dict):
        """Single model dict -> (P,) vector (no copy for a view layout)."""
        leaves = [model[k] for k in self.keys]
        vec = self._shared_matrix(leaves, ())
        if vec is not None:
            return vec
        return torch.cat([leaf.reshape(-1).to(self.dtype)
                          for leaf in leaves])

    def unflatten_model(self, vec) -> dict:
        """(P,) vector -> single model dict, leaf dtypes restored."""
        return {k: vec[o:o + s].reshape(shp).to(dt)
                for k, o, s, shp, dt in zip(self.keys, self.offsets,
                                            self.sizes, self.shapes,
                                            self.dtypes)}


def local_rows(n: int, mesh) -> int:
    """Rows per shard for ``n`` bank rows on ``mesh``: the one statement
    of the rows-divide-shards contract (the placement helpers here and
    the sharded rounds of ``repro_torch.core.hfl`` use it)."""
    k = int(mesh.size)
    if n % k:
        raise ValueError(
            f"bank rows N={n} must be divisible by the {k}-shard mesh "
            f"{mesh.shape}")
    return n // k


def row_slice(n: int, mesh) -> slice:
    """This rank's rows of an ``n``-row bank on ``mesh``."""
    per = local_rows(n, mesh)
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def place_rows(arr, mesh):
    """This rank's rows of one row-aligned array ((N,), (N, P),
    (N, ...)), copied onto the mesh's device."""
    arr = torch.as_tensor(arr)
    return arr[row_slice(arr.shape[0], mesh)].to(mesh.device, copy=True)


def gather_rows(arr, mesh):
    """The inverse of ``place_rows``: every rank's ``N/k`` rows of a
    row-aligned tensor joined in rank order, the whole ``(N, ...)``
    tensor on the mesh's device of every rank (one ``all_gather`` over
    the mesh's group; every rank of it calls this). The port's stand-in
    for the global view of a row-sharded ``jax.Array``."""
    import torch.distributed as dist
    part = torch.as_tensor(arr).to(mesh.device).contiguous()
    out = torch.empty((part.shape[0] * mesh.size,) + tuple(part.shape[1:]),
                      dtype=part.dtype, device=mesh.device)
    dist.all_gather(list(out.chunk(mesh.size)), part, group=mesh.group)
    return out


def place_replicated(tree, mesh):
    """A tensor, or a dict/list/tuple of them, whole on the mesh's
    device."""
    if isinstance(tree, dict):
        return {k: place_replicated(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place_replicated(v, mesh) for v in tree)
    return torch.as_tensor(tree).to(mesh.device)


def place_bank(bank: dict, mesh) -> dict:
    """This rank's rows of a full ``(N, ...)``-leaf bank, copied into one
    new contiguous ``(N/k, P)`` matrix on the mesh's device; the returned
    leaves are views into it where their dtype is the matrix's."""
    spec = bank_spec(bank)
    rows = row_slice(bank[spec.keys[0]].shape[0], mesh)
    mine = spec.flatten({k: v[rows] for k, v in bank.items()})
    return spec.unflatten(mine.to(mesh.device, copy=True).contiguous())


_SPEC_CACHE: dict = {}


def _build_spec(keys, shapes, dtypes) -> BankSpec:
    sizes = tuple(math.prod(s) for s in shapes)
    offsets, acc = [], 0
    for s in sizes:
        offsets.append(acc)
        acc += s
    flat_dtype = dtypes[0] if all(d == dtypes[0] for d in dtypes) \
        else torch.float32
    return BankSpec(keys=keys, shapes=shapes, dtypes=dtypes, sizes=sizes,
                    offsets=tuple(offsets), width=acc, dtype=flat_dtype)


def _spec(tree: dict, lead: int) -> BankSpec:
    if not isinstance(tree, dict) or not tree:
        raise TypeError("a bank or model is a non-empty dict of tensors")
    keys = tuple(sorted(tree))
    shapes = tuple(tuple(tree[k].shape[lead:]) for k in keys)
    dtypes = tuple(tree[k].dtype for k in keys)
    key = (keys, shapes, dtypes)
    spec = _SPEC_CACHE.get(key)
    if spec is None:
        spec = _SPEC_CACHE[key] = _build_spec(keys, shapes, dtypes)
    return spec


def bank_spec(bank: dict) -> BankSpec:
    """Spec for a bank dict whose leaves carry a leading row axis."""
    return _spec(bank, 1)


def model_spec(model: dict) -> BankSpec:
    """Spec for a single model dict (no leading row axis)."""
    return _spec(model, 0)
