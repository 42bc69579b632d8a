"""Hierarchical train step: Arena's synchronization scheme on LLM
replicas, on one card or over the ranks of a process group; the port of
``repro.launch.train``.

One ``train_step`` call is one cloud round (Eq. 5):

    gamma2 x [ gamma1 x [ local SGD epoch of every replica ],
               edge mean (Eq. 1) ]
    cloud mean (Eq. 2)

Model replicas live as leading ``(pod, edge, fl)`` axes of every
parameter leaf, the reference's layout (``lift_params``), laid over the
ranks of an ``HFLMesh`` (``launch.mesh.make_hfl_mesh``): each rank holds
its block of them, one device all of them. On a mesh with F x T > 1
tensor ranks each replica is split over F x T ranks as the reference's
specs split it (``models.tp``): the FFN and the vocabulary over the F x
T ranks of its ft group (a dense or audio model at F > 1; dense, audio
or ssm at F = 1), attention over the T ranks of its tp group (a dense
or ssm model). Each rank holds its tensor blocks of its block's
replicas and trains them with both contexts (``Model.loss(tp=,
ft=)``). A local epoch is
``mb_per_epoch`` minibatches through ``Model.loss`` and autograd, one
SGD step each. The port loops over a rank's replicas where the
reference vmaps over the three replica axes: the replicas are
independent, so the values are the same, and one replica's gradients
are held at a time (a full-width qwen3-1.7b replica's are 8.1 GB).

Eq. 1 and Eq. 2 are the reference's uniform means (``_edge_mean``,
``_cloud_mean``), computed by the two kernels written for their
size-weighted general form (``repro_torch.kernels.ops``): per leaf,
viewed as the rank's ``(R/k, numel)`` bank of replica rows (of its
tensor block, under fsdp and tp), one launch
of the ``segment_agg`` kernel with weights 1 and segment ids ``pod *
n_edge + edge`` (E = 1 for the cloud mean) and one ``segment_broadcast``
launch writing the means back into the rank's rows. Where a mean's
replicas span ranks, the launch is the rank's partial
(``segment_sum_partial``) and its sums meet in an ``all_reduce`` over
the ranks the mean crosses at the rank's tensor coordinate (f, t): its
fl group for Eq. 1, its replica group (the world when F = T = 1) for
Eq. 2
(``ops.segment_agg_sharded``). A static round launches each
kernel ``(g2 + 1)`` times per leaf on every rank. The training forward
reaches no kernel: attention, WKV and the loss are the reference's
plain tensor math (``Model.loss``).

``static`` frequencies run ``g1``/``g2`` fixed loops; ``dynamic`` takes
per-edge ``(g1e, g2e)`` host integers (the Arena action) with the
reference's masked upper-bound loops: an edge past its budget keeps its
values.
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import disable_tf32
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import tp as tp_mod
from repro_torch.models import transformer
from repro_torch.models.model import build_model


def _leaves(tree) -> list:
    """The leaves of a nested dict in key order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _sgd(p, g, lr: float) -> None:
    """``p <- (p.f32 - lr * g.f32).to(p.dtype)``, in place."""
    step = g.to(torch.float32) * lr
    if p.dtype == torch.float32:
        p.sub_(step)
    else:
        p.copy_((p.to(torch.float32) - step).to(p.dtype))


def _bank_inputs(n_rows: int, n_seg: int, device):
    """The (n_rows,) f32 weights (all 1) and int32 segment ids of a
    rank's replicas in (pod, edge, fl) order, ``n_rows / n_seg``
    consecutive rows per segment."""
    ids = np.repeat(np.arange(n_seg), n_rows // n_seg).astype(np.int32)
    return (torch.ones((n_rows,), dtype=torch.float32, device=device),
            torch.as_tensor(ids, device=device))


def _row_mean(group, spread: bool):
    """The per-leaf segment means of rows that lie on this rank alone
    (``spread`` False: one ``segment_agg`` launch) or on every rank of
    ``group``: one ``segment_sum_partial`` launch and an ``all_reduce``
    (``ops.segment_agg_sharded``), chained in rank order in deterministic
    mode (``ops.segment_agg_ordered``)."""
    if not spread:
        return ops.segment_agg
    ordered = torch.are_deterministic_algorithms_enabled()
    agg = ops.segment_agg_ordered if ordered else ops.segment_agg_sharded
    return lambda v, w, s, e: agg(v, w, s, e, group)


def _edge_mean(params, hfl_mesh, active=None) -> None:
    """Eq. 1 on every leaf, in place: each replica takes the mean of its
    (pod, edge)'s fl replicas. Per leaf, viewed as this rank's (R/k,
    numel) rows, the means of the rank's (pod, edge) segments
    (``_row_mean``: they cross the rank's fl group when f_r > 1), then
    one ``segment_broadcast`` writing every replica of the rank; with
    ``active`` (an (n_edge,) bool with some False) only the active edges'
    replicas are written, one ``segment_broadcast`` per active (pod,
    edge). A rank none of whose edges is active does nothing: every rank
    of its fl group holds the same edges, so their collectives line up."""
    bp, be, bf = hfl_mesh.block
    n_seg = bp * be
    mine = None
    if active is not None:
        e0 = hfl_mesh.coords[1] * be
        mine = np.tile(np.asarray(active, bool)[e0:e0 + be], bp)
        if not mine.any():
            return
    leaves = _leaves(params)
    ones, seg = _bank_inputs(n_seg * bf, n_seg, leaves[0].device)
    zeros = torch.zeros((bf,), dtype=torch.int32, device=seg.device)
    mean = _row_mean(hfl_mesh.fl_group, hfl_mesh.grid[2] > 1)
    for leaf in leaves:
        view = leaf.view(seg.shape[0], -1)
        means = mean(view, ones, seg, n_seg)
        if mine is None or mine.all():
            ops.segment_broadcast(means, seg, out=view)
            continue
        for j in np.flatnonzero(mine):
            ops.segment_broadcast(means[j:j + 1], zeros,
                                  out=view[j * bf:(j + 1) * bf])


def _cloud_mean(params, hfl_mesh, collective_dtype=None) -> None:
    """Eq. 2 on every leaf, in place: every replica takes the mean over
    all of them, one ``segment_broadcast`` writing the rank's replicas.
    The mean is one ``segment_agg`` launch where one rank holds every
    replica (of its tensor block); otherwise one ``segment_sum_partial``
    launch on the rank's rows and an ``all_reduce`` over its replica
    group (``ops.segment_agg_sharded``). In
    deterministic mode every rank gathers the replicas in the one-device
    order (``mesh.gather_replicas``) and runs the one-device launch on
    them: a chain in rank order is that order only where each rank's
    replicas are consecutive rows, and a rank grid with f_r > 1 and
    several edges per rank interleaves them. With ``collective_dtype``
    the rows are cast to it first and the mean written in it (the
    reference's quantized sync), then restored to the leaf's dtype."""
    leaves = _leaves(params)
    n = math.prod(hfl_mesh.block)
    ones, zeros = _bank_inputs(n, 1, leaves[0].device)
    spread = hfl_mesh.replica_ranks > 1
    gather = spread and torch.are_deterministic_algorithms_enabled()
    mean = _row_mean(hfl_mesh.replica_group, spread)
    if gather:
        r_all = math.prod(hfl_mesh.dims[:3])
        ones_all, zeros_all = _bank_inputs(r_all, 1, zeros.device)
    for leaf in leaves:
        view = leaf.view(n, -1)
        low = view if collective_dtype is None or \
            view.dtype == collective_dtype else view.to(collective_dtype)
        if gather:
            whole = mesh_lib.gather_replicas(
                low.view(hfl_mesh.block + (-1,)), hfl_mesh).view(r_all, -1)
            means = ops.segment_agg(whole, ones_all, zeros_all, 1)
            del whole
        else:
            means = mean(low, ones, zeros, 1)
        if low is view:
            ops.segment_broadcast(means, zeros, out=view)
            continue
        del low
        view.copy_(ops.segment_broadcast(means, zeros,
                                         out_dtype=collective_dtype))


def make_hfl_train_step(cfg, hfl_mesh, *, lr: float = 1e-3,
                        mb_per_epoch: int = 4, remat: bool = True,
                        g1: int = 2, g2: int = 2, dynamic: bool = False,
                        max_g1: int = 4, max_g2: int = 4,
                        attn_chunk: int = 1024,
                        collective_dtype: Optional[str] = None,
                        wkv_chunked: bool = False,
                        seq_shard_acts: bool = False):
    """Returns ``(train_step, param_specs, batch_spec)``.

    static:  ``train_step(params, batch)``, g1/g2 fixed;
    dynamic: ``train_step(params, batch, g1e, g2e)``, per-edge (n_edge,)
    integer frequencies (host arrays or tensors), at most
    ``max_g1``/``max_g2``.

    ``params``: the lifted tree of this rank's replicas, every leaf
    ``(pod/p_r, edge/e_r, fl/f_r, ...)`` (the mesh's ``block``) and
    contiguous on the mesh's device: ``lift_params`` on one device,
    ``mesh.place_params`` of it, or ``lift_params`` to the block, on the
    ranks of a multi-rank mesh; under tp, of the rank's tp blocks
    (``mesh.place_params``, or ``lift_params`` of ``mesh.tp_blocks``). It
    is updated in place and returned.
    ``batch``: {"tokens", "labels"} (B, S) int, plus the stub front
    ends' inputs a model reads (``enc_embed`` (B, enc_seq, d) for
    ``audio``, ``vision_embed`` (B, n_vis, d) for ``vlm``), the whole
    batch on every rank, with B a multiple of the replica count R;
    replica r (in (pod, edge, fl) order) trains on rows ``[r B/R, (r +
    1) B/R)`` of every key, split into ``mb_per_epoch`` minibatches, as
    the reference slices every leaf of the batch, and a rank takes its
    replicas' rows (the batch splits over ``REPLICA_AXES``).
    ``collective_dtype`` casts
    the params before the cloud mean only (the reference's quantized
    cloud sync). ``param_specs`` is the tree of ``mesh.hfl_param_specs``
    and ``batch_spec`` the batch's, ``(("pod", "edge", "fl"),)``.

    On a multi-rank mesh every rank calls the step with the same
    arguments; Eq. 1 crosses the rank's fl group where f_r > 1 and Eq. 2
    its replica group (``_edge_mean``, ``_cloud_mean``). Under
    ``device.deterministic_algorithms`` both keep the one-device
    summation order, so at T = 1 the round is bitwise the one-device
    round. With F x T > 1 tensor ranks the forward and backward run
    Megatron's collectives over the ft group (the FFN, the vocabulary)
    and the tp group (attention; ``models.tp``; the leaves no spec
    splits stay bitwise equal across both), a split product sums in
    another order than the one-device product, and a dense or ssm model
    whose heads T does not divide raises ``ValueError``, a family the
    mesh's F or T does not take ``NotImplementedError``
    (``models.tp.check``).

    Dynamic rounds: in epoch t1 of edge period t2 a replica of edge j
    trains only if ``t1 < g1e[j]`` and ``t2 < g2e[j]``, and only edges
    with ``t2 < g2e[j]`` take their edge mean. The reference computes
    every replica in every step and discards the masked results with
    ``_edge_mask``; the port skips that compute, so the values are the
    same, and a dynamic round with ``g1e = g1``, ``g2e = g2`` everywhere
    launches what the static round launches.

    TF32 stays off (``device.disable_tf32``). ``seq_shard_acts`` shards
    activations over the tensor axes and raises (the tensor plane of
    item 10 (b))."""
    if seq_shard_acts:
        raise NotImplementedError(
            f"seq_shard_acts shards activations over fsdp x tp: the tensor "
            f"plane of {mesh_lib.MESH_ITEM}")
    model = build_model(cfg)
    tp, ft = hfl_mesh.tp_context, hfl_mesh.ft_context
    tp_mod.check(cfg, hfl_mesh.tp, hfl_mesh.fsdp)
    n_pod, n_edge, n_fl = mesh_lib.n_replicas(hfl_mesh)
    repl = n_pod * n_edge * n_fl
    block = hfl_mesh.block
    mine = math.prod(block)
    rows = tuple(hfl_mesh.block_slice(a) for a in mesh_lib.REPLICA_AXES)
    e0 = hfl_mesh.coords[1] * block[1]
    low = None if collective_dtype is None else getattr(torch,
                                                        collective_dtype)
    disable_tf32()

    def replica_epoch(params, batch, r: int) -> None:
        """One local epoch of this rank's replica r: ``mb_per_epoch`` SGD
        steps."""
        views = [leaf.view((mine,) + leaf.shape[3:])[r]
                 for leaf in _leaves(params)]
        rows = {k: v[r] for k, v in batch.items()}
        per = rows["tokens"].shape[0] // mb_per_epoch
        for i in range(mb_per_epoch):
            leaves = [v.detach().requires_grad_(True) for v in views]
            it = iter(leaves)
            p = _map(lambda _: next(it), params)
            mb = {k: v[i * per:(i + 1) * per] for k, v in rows.items()}
            with torch.enable_grad():
                loss = model.loss(p, mb, remat=remat, attn_chunk=attn_chunk,
                                  wkv_chunked=wkv_chunked, tp=tp, ft=ft)
                grads = torch.autograd.grad(loss, leaves)
            del loss, p, leaves
            with torch.no_grad():
                for v, g in zip(views, grads):
                    _sgd(v, g, lr)
            del grads

    def reshape_batch(batch):
        """This rank's replicas' rows of the whole batch, (R/k, B/R,
        ...)."""
        def r(a):
            b = a.shape[0]
            if b % repl:
                raise ValueError(f"batch of {b} does not split over "
                                 f"{repl} replicas")
            a = a.reshape((n_pod, n_edge, n_fl, b // repl)
                          + tuple(a.shape[1:]))
            return a[rows].reshape((mine, b // repl) + tuple(a.shape[4:]))
        return {k: r(v) for k, v in batch.items()}

    def check_params(params) -> None:
        shape = tuple(_leaves(params)[0].shape[:3])
        if shape != block:
            raise ValueError(f"params hold {shape} replicas, this rank's "
                             f"block is {block} (mesh.place_params)")

    def epoch(params, batch, edges) -> None:
        """One local epoch of every replica of this rank whose edge is in
        ``edges`` (an (n_edge,) bool)."""
        for r in range(mine):
            if edges[e0 + (r // block[2]) % block[1]]:
                replica_epoch(params, batch, r)

    everyone = np.ones(n_edge, bool)

    if not dynamic:
        def train_step(params, batch):
            check_params(params)
            batch = reshape_batch(batch)
            with torch.no_grad():
                for _ in range(g2):
                    for _ in range(g1):
                        epoch(params, batch, everyone)
                    _edge_mean(params, hfl_mesh)
                _cloud_mean(params, hfl_mesh, low)
            return params
    else:
        def train_step(params, batch, g1e, g2e):
            check_params(params)
            batch = reshape_batch(batch)
            g1e = np.asarray(torch.as_tensor(g1e).cpu(), np.int64)
            g2e = np.asarray(torch.as_tensor(g2e).cpu(), np.int64)
            with torch.no_grad():
                for t2 in range(max_g2):
                    active2 = t2 < g2e
                    if not active2.any():
                        continue
                    for t1 in range(max_g1):
                        act = (t1 < g1e) & active2
                        if act.any():
                            epoch(params, batch, act)
                    _edge_mean(params, hfl_mesh, active2)
                _cloud_mean(params, hfl_mesh, low)
            return params

    param_specs = mesh_lib.hfl_param_specs(
        cfg, transformer.meta_params(cfg), hfl_mesh)
    batch_spec = (mesh_lib.REPLICA_AXES,)
    return train_step, param_specs, batch_spec


def lift_params(params, n_pod: int, n_edge: int, n_fl: int) -> dict:
    """Broadcast one model copy into the replicated HFL layout: every
    leaf ``(n_pod, n_edge, n_fl, ...)``, a new contiguous tensor (also for
    one replica, where ``contiguous`` would return a view of the copy and
    the round would train it in place)."""
    return _map(lambda a: a.expand((n_pod, n_edge, n_fl) + tuple(a.shape))
                .clone(memory_format=torch.contiguous_format), params)


def main(argv=None):
    """Launcher CLI.

        PYTHONPATH=src python -m repro_torch.launch.train --arch \\
            qwen3-1.7b --mesh micro --rounds 10 [--dynamic] [--device cpu]
        PYTHONPATH=src torchrun --nproc-per-node 4 -m \\
            repro_torch.launch.train --device cpu --mesh micro \\
            [--fsdp 2] [--tp 2]

    --mesh micro  : the reduced config, replicas (1, 2, 2): on one device,
                    or, under torchrun (or in an initialised process
                    group), spread over the world's ranks, each replica
                    over ``--fsdp`` x ``--tp`` of them (``mesh.rank_grid``
                    of the world / (fsdp x tp) ranks: 2 (1, 1, 2), 4 (1,
                    2, 2)); only rank 0 prints
    --mesh single / multi : the full config on the reference's 256 /
                    512-rank production mesh, replicas, fsdp and tp from
                    the config's ``hfl_topology``
                    (``mesh.derive_hfl_mesh``): ``ValueError`` in a
                    smaller world; fsdp above 1 outside the dense and
                    audio families, or tp above 1 outside the dense and
                    ssm families, raise ``NotImplementedError`` (item 10
                    (b))
    --dynamic uses the masked per-edge-frequency step with a Var-Freq-B
    style schedule (the Arena agent plugs in through the same signature).
    The batch carries the stub front ends' inputs of an audio or vlm
    model (``serve.stub_extras``, seeded by the round). Runs on the card
    unless ``--device cpu``."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batch
    from repro_torch.launch.serve import stub_extras

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--mesh", default="micro",
                    choices=["micro", "single", "multi"])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--g1", type=int, default=2)
    ap.add_argument("--g2", type=int, default=2)
    ap.add_argument("--dynamic", action="store_true")
    ap.add_argument("--fsdp", type=int, default=1,
                    help="--mesh micro: fsdp ranks per replica")
    ap.add_argument("--tp", type=int, default=1,
                    help="--mesh micro: tp ranks per replica")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    owned = mesh_lib.torchrun_world()
    try:
        k = dist.get_world_size() if dist.is_initialized() else 1
        if args.mesh == "micro":
            cfg = get_config(args.arch).reduce()
            reps = (1, 2, 2)
            ft = args.fsdp * args.tp
            if k % ft:
                raise ValueError(f"--fsdp {args.fsdp} x --tp {args.tp} does "
                                 f"not divide the world's {k} ranks")
            hfl_mesh = mesh_lib.make_hfl_mesh(
                reps, ranks=mesh_lib.rank_grid(reps, k // ft),
                fsdp=args.fsdp, tp=args.tp, device=args.device)
        else:
            mesh_lib.make_production_mesh(multi_pod=args.mesh == "multi",
                                          n_ranks=k)
            cfg = get_config(args.arch)
            hfl_mesh = mesh_lib.derive_hfl_mesh(
                [args.device] * k, cfg.hfl_topology,
                n_pods=2 if args.mesh == "multi" else 1)
            reps = mesh_lib.n_replicas(hfl_mesh)
        dev, lead = hfl_mesh.device, hfl_mesh.rank == 0
        n_edge, repl = reps[1], math.prod(reps)
        if args.batch % repl:
            args.batch = repl * max(1, args.batch // repl)

        kw = dict(lr=3e-3, mb_per_epoch=max(1, args.batch // repl),
                  remat=False, attn_chunk=min(1024, args.seq))
        if args.dynamic:
            step, _, _ = make_hfl_train_step(
                cfg, hfl_mesh, dynamic=True, max_g1=args.g1 + 2,
                max_g2=args.g2 + 2, **kw)
        else:
            step, _, _ = make_hfl_train_step(cfg, hfl_mesh, g1=args.g1,
                                             g2=args.g2, **kw)
        model = build_model(cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = lift_params(mesh_lib.tp_blocks(model.init(gen, device=dev),
                                                hfl_mesh), *hfl_mesh.block)
        rng = np.random.default_rng(0)

        def batch_of(seed):
            return {**token_batch(seed, args.batch, args.seq, cfg.vocab,
                                  device=dev),
                    **stub_extras(cfg, args.batch, seed, dev)}

        for i in range(args.rounds):
            batch = batch_of(i)
            t0 = time.time()
            if args.dynamic:
                # Var-Freq-B style: per-edge freqs (Arena's agent drops in)
                g1e = rng.integers(1, args.g1 + 1, n_edge)
                g2e = rng.integers(1, args.g2 + 1, n_edge)
                params = step(params, batch, g1e, g2e)
            else:
                params = step(params, batch)
            if hfl_mesh.coords == (0, 0, 0):   # replica (0, 0, 0)'s ranks
                p0 = _map(lambda a: a[0, 0, 0], params)
                with torch.no_grad():
                    loss = float(model.loss(
                        p0, batch_of(9999), tp=hfl_mesh.tp_context,
                        ft=hfl_mesh.ft_context))
                if lead:
                    print(f"round {i} loss={loss:.4f} "
                          f"dt={time.time() - t0:.1f}s", flush=True)
    finally:
        if owned:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
