"""Tensor parallelism of one model replica over the ranks of a process
group (Megatron-LM's scheme, arXiv:1909.08053); a port-only module.

The reference shards a replica by annotation only (``launch.mesh``'s
PartitionSpecs) and XLA's partitioner inserts the collectives. The port
has no partitioner, so the layers call them here, by hand, through a
:class:`TPContext` (a group, its size and this rank's place in it). A
replica's F x T tensor ranks give two groups (``launch.mesh.HFLMesh``):
the *tp group*, the T ranks at one fsdp coordinate, and the *ft group*,
all F x T of them, rank (f, t) at place f T + t. The layers take the
group of each leaf's spec: ``Model.loss(tp=, ft=)``, ``ft`` defaulting
to ``tp`` (the same group at F = 1).

- ``ft`` (the reference's ``("fsdp", "tp")``): the embedding and the
  unembedding (vocab-parallel lookup and loss), the FFN's matrices
  (SwiGLU's ``w_gate``/``w_up``/``w_down``, the GELU MLP's ``w_up``,
  ``b_up`` and ``w_down``) and RWKV6's channel-mix ``w_k``/``w_v``
  (taken at F = 1 only, where ft is tp).
- ``tp`` (the reference's ``"tp"``): attention's ``wq``/``wk``/``wv``
  and ``wo`` (and their *f* leaves ``q_norm``/``k_norm``), RWKV6's
  time-mix and the channel-mix gate ``w_r``. Attention is replicated
  over fsdp: ranks with the same t compute the same attention.

Every other leaf is whole on every rank and every rank computes the same
gradient for it. Megatron's two conjugate operators, and a third:

- *f*: the identity forward, an ``all_reduce`` of the gradient
  backward. It goes before a column-parallel product (each rank's
  columns see the whole input; its gradient there is the sum of the
  ranks' parts: ``column``, ``column_pairs``) and on a replicated
  parameter that each rank applies to its own heads or channels only
  (``q_norm``, ``k_norm``; RWKV6's ``ln_w``, ``ln_b``, ``decay_w0``,
  ``decay_B``: ``copy_to``).
- *g*: an ``all_reduce`` forward, the identity backward. It follows a
  row-parallel product (each rank's rows give a partial sum of the
  output: ``row``) and the vocab-parallel lookup and loss sums
  (``reduce_from``). Its backward must stay the identity: the loss is
  replicated on every rank, and a second ``all_reduce`` there
  (``torch.distributed.nn.functional.all_reduce``) would scale the
  gradients by T.
- *gather*: an ``all_gather`` along the last dimension forward, this
  rank's slice of the gradient backward. It joins a column-parallel
  result whose consumer runs whole on every rank (RWKV6's channel-mix
  gate ``sigmoid(xr @ w_r)``, multiplied into the row product's whole
  output). That consumer computes the same gradient on every rank, so
  the backward needs no sum (``gather``).

The products carry *f* and *g* themselves (``column``, ``row``) so that
a split product rounds where the one-device product rounds: a bf16
product accumulates in f32 and rounds once, so the ranks' partial sums
meet in f32 and are rounded once after the ``all_reduce``, never each
on its own (that would change every rounding of a bf16 round, which
moves its loss as much as any other change of summation order does).
Every rank gets the same bits from a gloo ``all_reduce``, so what each
computes from its result is the same on every rank.

The column blocks of ``wq``/``wk``/``wv`` are whole heads only where T
divides both head counts (``check``): tp rank t holds query heads ``[t H/T,
(t + 1) H/T)`` and kv heads ``[t Hkv/T, (t + 1) Hkv/T)``, so query head h
still reads kv head ``h // (H / Hkv)``. An RWKV6 replica has only its
wkv heads (its ``n_kv_heads`` plays no part): rank t holds heads ``[t
nh/T, (t + 1) nh/T)`` of r, k, v, g and the decay, and their rows of
``bonus_u``; the group norm is per head. A leaf whose split dimension T
does not divide stays whole on every rank (``launch.mesh``'s guard, the
reference's rule: whisper's vocabulary of 51,865 over F x T = 2);
``split`` tells the layers which leaves are split from their shapes.

Serving over a serve mesh (``launch.serve``) runs the same forward
products on a rank's blocks, without gradients: the attention and FFN
products through ``column`` and ``row``, the vocab-parallel lookup
through ``reduce_from``, and the logits as the rank's vocabulary block
(``check_serve`` says which models it takes).
"""
from __future__ import annotations

import dataclasses

import torch

TP_ITEM = "ROADMAP.md, 'Modules still to port', item 10 (b)"


@dataclasses.dataclass(frozen=True)
class TPContext:
    """A group of one model replica's tensor ranks: ``size`` ranks, this
    one at ``rank`` in it (``launch.mesh.HFLMesh.tp_context`` and
    ``ft_context``)."""
    group: object = dataclasses.field(compare=False)
    size: int
    rank: int


def check(cfg, size: int, fsdp: int = 1) -> None:
    """Raise where a replica of ``cfg`` cannot be split over ``fsdp`` x
    ``size`` tensor ranks (``size`` the tp ranks T):
    ``NotImplementedError`` for fsdp above 1 outside the dense and audio
    families and for T above 1 outside the dense and ssm families (the
    tensor plane of item 10 (b)), ``ValueError`` where T does not divide
    the heads (a column block would cut a head; the reference's
    partitioner would split inside it): the query and kv heads of a
    dense model, the wkv heads (``n_heads``) of an ssm one. The FFN and
    the vocabulary need no check: the guard keeps a dimension F x T does
    not divide whole."""
    if fsdp > 1 and cfg.family not in ("dense", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: fsdp={fsdp} of the {cfg.family!r} family is the "
            f"tensor plane of {TP_ITEM}; only the dense and audio families "
            f"split over fsdp")
    if size == 1:
        return
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"{cfg.name}: tensor parallelism (tp={size}) of the "
            f"{cfg.family!r} family is the tensor plane of {TP_ITEM}; only "
            f"the dense and ssm families are split")
    heads = {"n_heads": cfg.n_heads}
    if cfg.family == "dense":
        heads["n_kv_heads"] = cfg.n_kv_heads
    if any(n % size for n in heads.values()):
        raise ValueError(
            f"{cfg.name}: tp={size} does not divide " + " and ".join(
                f"{k}={v}" for k, v in heads.items()) + " into whole heads")


def check_serve(cfg, size: int) -> None:
    """Raise where ``cfg`` cannot be served over a serve mesh whose
    replicas are split over ``size`` tp ranks (``launch.serve``'s steps
    over a ``launch.mesh.ServeMesh``): ``NotImplementedError`` outside
    the dense family (mesh serving of the other families is the tensor
    plane of item 10 (b)), ``ValueError`` where T does not divide both
    head counts. There the reference's ``cache_specs`` splits the cache
    length over tp instead of the kv heads, which the port does not run
    yet."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: mesh serving of the {cfg.family!r} family is the "
            f"tensor plane of {TP_ITEM}; only the dense family is served "
            f"over a serve mesh")
    if cfg.n_heads % size or cfg.n_kv_heads % size:
        raise ValueError(
            f"{cfg.name}: tp={size} does not divide n_heads={cfg.n_heads} "
            f"and n_kv_heads={cfg.n_kv_heads} into whole heads (the cache "
            f"split over its length is {TP_ITEM})")


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
    """A contiguous copy of ``x`` summed (or reduced by ``op``) over
    ``ctx``'s group."""
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
    """Column-parallel products in groups: group i is one input and the
    ``sizes[i]`` weights it multiplies (``tensors`` lists each group's
    input, then its weights)."""

    @staticmethod
    def forward(fctx, ctx, sizes, *tensors):
        fctx.tp, fctx.sizes = ctx, sizes
        fctx.save_for_backward(*tensors)
        out = []
        for x, ws in _groups(sizes, tensors):
            out.extend(_mm(x, w) for w in ws)
        return tuple(out)

    @staticmethod
    def backward(fctx, *grads):
        groups = _groups(fctx.sizes, fctx.saved_tensors)
        grads = iter(grads)
        gws, parts = [], []
        for x, ws in groups:
            x2 = x.reshape(-1, x.shape[-1])
            g2 = [next(grads).reshape(-1, w.shape[-1]) for w in ws]
            gws.append([x2.t().mm(g) for g in g2])
            parts.append(torch.stack([g.float().mm(w.float().t())
                                      for g, w in zip(g2, ws)]))
        # every input gradient's f32 partial summed over the group in one
        # all_reduce, then rounded once to its input's dtype
        sums = _all_reduce(torch.cat([p.view(-1) for p in parts]),
                           fctx.tp).split([p.numel() for p in parts])
        out = [None, None]
        for (x, _), s, part, gw in zip(groups, sums, parts, gws):
            part = s.view(part.shape).to(x.dtype)
            # summed as autograd sums the one-device products' gradients
            # of their shared input: the last product's first
            gx = part[-1]
            for p in reversed(part[:-1]):
                gx = gx + p
            out += [gx.view(x.shape), *gw]
        return tuple(out)


def _groups(sizes, tensors) -> list:
    """``tensors`` (each group's input, then its ``sizes[i]`` weights) as
    [(input, [weights]), ...]."""
    out, i = [], 0
    for n in sizes:
        out.append((tensors[i], list(tensors[i + 1:i + 1 + n])))
        i += 1 + n
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        import torch.distributed as dist
        fctx.tp, fctx.n = ctx, x.shape[-1]
        # gathered as raw bytes (gloo need not take every float dtype),
        # each rank's block whole elements of the last dimension
        raw = x.contiguous().view(torch.uint8)
        parts = [torch.empty_like(raw) for _ in range(ctx.size)]
        dist.all_gather(parts, raw, group=ctx.group)
        return torch.cat(parts, dim=-1).view(x.dtype)

    @staticmethod
    def backward(fctx, grad):
        return grad.narrow(-1, fctx.tp.rank * fctx.n, fctx.n), None


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
    return _Column.apply(ctx, (len(ws),), x, *ws)


def column_pairs(pairs, ctx) -> tuple:
    """``column`` of several inputs: ``x @ w`` for each pair ``(x, w)``
    of ``pairs`` (``w`` this rank's column block, in ``x``'s dtype), each
    product as one device computes it; backward, the f32 partials of
    every input's gradient summed over the group in one ``all_reduce``
    and each rounded once to its input's dtype."""
    return _Column.apply(ctx, (1,) * len(pairs),
                         *(t for pair in pairs for t in pair))


def row(x, w, ctx):
    """The row-parallel product ``x @ w`` (``x`` this rank's columns of
    the input, ``w`` its row block, in ``x``'s dtype) and *g*: the f32
    partial products summed over the group, then rounded once to
    ``x``'s dtype; backward, the gradients of ``x @ w`` as one device
    computes them (the identity of *g*)."""
    return _Row.apply(ctx, x, w)


def copy_to(x, ctx):
    """*f*: ``x`` forward, the gradient summed over ``ctx``'s group
    backward."""
    return _CopyTo.apply(x, ctx)


def gather(x, ctx):
    """*gather*: the ranks' blocks of ``x``'s last dimension joined in
    rank order forward (one ``all_gather``, bitwise), this rank's block
    of the gradient backward (the gradient of a result that every rank
    consumes whole is the same on every rank)."""
    return _Gather.apply(x, ctx)


def reduce_from(x, ctx):
    """*g*: ``x`` summed over ``ctx``'s group forward, the gradient as
    it is backward."""
    return _ReduceFrom.apply(x, ctx)


def all_max(x, ctx):
    """``x`` (no gradient) reduced by max over ``ctx``'s group."""
    import torch.distributed as dist
    return _all_reduce(x.detach(), ctx, dist.ReduceOp.MAX)
