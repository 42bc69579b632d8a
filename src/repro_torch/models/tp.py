"""Tensor parallelism of one model replica over the ranks of a process
group (Megatron-LM's scheme, arXiv:1909.08053); a port-only module.

The reference shards a replica by annotation only (``launch.mesh``'s
PartitionSpecs) and XLA's partitioner inserts the collectives. The port
has no partitioner, so the dense family's layers call them here, by
hand, through a :class:`TPContext` (the tp group, its size T and this
rank's place in it), the ``tp=`` argument of ``Model.loss``. Megatron's
two conjugate operators:

- *f*: the identity forward, an ``all_reduce`` of the gradient
  backward. It goes before a column-parallel product (each rank's
  columns see the whole input; its gradient there is the sum of the
  ranks' parts: ``column``) and on a replicated parameter that each rank
  applies to its own heads only (``q_norm``, ``k_norm``: ``copy_to``).
- *g*: an ``all_reduce`` forward, the identity backward. It follows a
  row-parallel product (each rank's rows give a partial sum of the
  output: ``row``) and the vocab-parallel lookup and loss sums
  (``reduce_from``). Its backward must stay the identity: the loss is
  replicated on every rank, and a second ``all_reduce`` there
  (``torch.distributed.nn.functional.all_reduce``) would scale the
  gradients by T.

The products carry *f* and *g* themselves (``column``, ``row``) so that
a split product rounds where the one-device product rounds: a bf16
product accumulates in f32 and rounds once, so the ranks' partial sums
meet in f32 and are rounded once after the ``all_reduce``, never each
on its own (that would change every rounding of a bf16 round, which
moves its loss as much as any other change of summation order does).
Every rank gets the same bits from a gloo ``all_reduce``, so what each
computes from its result is the same on every rank.

The column blocks of ``wq``/``wk``/``wv`` are whole heads only where T
divides both head counts (``check``): rank t holds query heads ``[t H/T,
(t + 1) H/T)`` and kv heads ``[t Hkv/T, (t + 1) Hkv/T)``, so query head h
still reads kv head ``h // (H / Hkv)``. A leaf whose split dimension T
does not divide stays whole on every rank (``launch.mesh``'s guard, the
reference's rule); ``split`` tells the layers which leaves are split
from their shapes.
"""
from __future__ import annotations

import dataclasses

import torch

TP_ITEM = "ROADMAP.md, 'Modules still to port', item 10 (b)"


@dataclasses.dataclass(frozen=True)
class TPContext:
    """The tp group of one model replica: ``size`` ranks, this one at
    ``rank`` in it (``launch.mesh.HFLMesh.tp_context``)."""
    group: object = dataclasses.field(compare=False)
    size: int
    rank: int


def check(cfg, size: int) -> None:
    """Raise where a replica of ``cfg`` cannot be split over ``size`` tp
    ranks: ``NotImplementedError`` outside the dense family (the tensor
    plane of item 10 (b)), ``ValueError`` where ``size`` does not divide
    the query or kv heads (a column block would cut a head; the
    reference's partitioner would split inside it)."""
    if size == 1:
        return
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: tensor parallelism (tp={size}) of the "
            f"{cfg.family!r} family is the tensor plane of {TP_ITEM}; only "
            f"the dense family is split")
    if cfg.n_heads % size or cfg.n_kv_heads % size:
        raise ValueError(
            f"{cfg.name}: tp={size} does not divide n_heads={cfg.n_heads} "
            f"and n_kv_heads={cfg.n_kv_heads} into whole heads")


def split(ctx, local: int, whole: int):
    """``ctx`` where a leaf's dimension is split (``local`` = ``whole`` /
    T), None where it stays whole on every rank."""
    if ctx is None or local == whole:
        return None
    if local * ctx.size != whole:
        raise ValueError(f"a dimension of {local} is neither the whole "
                         f"{whole} nor its 1/{ctx.size} block")
    return ctx


def _all_reduce(x, ctx, op=None):
    """A contiguous copy of ``x`` summed (or reduced by ``op``) over the
    tp group."""
    import torch.distributed as dist
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.SUM if op is None else op,
                    group=ctx.group)
    return y


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.tp = ctx
        return x.view_as(x)

    @staticmethod
    def backward(fctx, grad):
        return _all_reduce(grad, fctx.tp), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        return _all_reduce(x, ctx)

    @staticmethod
    def backward(fctx, grad):
        return grad, None


def _mm(a, b):
    """``a @ b`` with ``a``'s leading dimensions folded, as
    ``torch.matmul`` folds them (one 2-D product)."""
    return a.reshape(-1, a.shape[-1]).mm(b).view(a.shape[:-1] + (-1,))


class _Column(torch.autograd.Function):
    @staticmethod
    def forward(fctx, ctx, x, *ws):
        fctx.tp = ctx
        fctx.save_for_backward(x, *ws)
        return tuple(_mm(x, w) for w in ws)

    @staticmethod
    def backward(fctx, *grads):
        x, *ws = fctx.saved_tensors
        x2 = x.reshape(-1, x.shape[-1])
        g2 = [g.reshape(-1, g.shape[-1]) for g in grads]
        gws = [x2.t().mm(g) for g in g2]
        # each product's input gradient, its f32 partial summed over the
        # group in one all_reduce, then rounded once
        parts = torch.stack([g.float().mm(w.float().t())
                             for g, w in zip(g2, ws)])
        parts = _all_reduce(parts, fctx.tp).to(x.dtype)
        # summed as autograd sums the one-device products' gradients of
        # their shared input: the last product's first
        gx = parts[-1]
        for p in reversed(parts[:-1]):
            gx = gx + p
        return (None, gx.view(x.shape), *gws)


class _Row(torch.autograd.Function):
    @staticmethod
    def forward(fctx, ctx, x, w):
        fctx.save_for_backward(x, w)
        out = _all_reduce(_mm(x.float(), w.float()), ctx)
        return out.to(x.dtype)

    @staticmethod
    def backward(fctx, grad):
        x, w = fctx.saved_tensors
        x2, g2 = x.reshape(-1, x.shape[-1]), grad.reshape(-1, grad.shape[-1])
        return None, g2.mm(w.t()).view(x.shape), x2.t().mm(g2)


def column(x, ws, ctx) -> tuple:
    """*f* and the column-parallel products ``x @ w`` for each ``w`` of
    ``ws`` (this rank's column blocks, in ``x``'s dtype): each product as
    one device computes it; backward, each input gradient's f32 partial
    summed over the group (one ``all_reduce`` for all of them), rounded
    to ``x``'s dtype, and the products' gradients summed as autograd sums
    them on one device."""
    return _Column.apply(ctx, x, *ws)


def row(x, w, ctx):
    """The row-parallel product ``x @ w`` (``x`` this rank's columns of
    the input, ``w`` its row block, in ``x``'s dtype) and *g*: the f32
    partial products summed over the group, then rounded once to
    ``x``'s dtype; backward, the gradients of ``x @ w`` as one device
    computes them (the identity of *g*)."""
    return _Row.apply(ctx, x, w)


def copy_to(x, ctx):
    """*f*: ``x`` forward, the gradient summed over the tp group
    backward."""
    return _CopyTo.apply(x, ctx)


def reduce_from(x, ctx):
    """*g*: ``x`` summed over the tp group forward, the gradient as it
    is backward."""
    return _ReduceFrom.apply(x, ctx)


def all_max(x, ctx):
    """``x`` (no gradient) reduced by max over the tp group."""
    import torch.distributed as dist
    return _all_reduce(x.detach(), ctx, dist.ReduceOp.MAX)
