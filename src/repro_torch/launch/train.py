"""Hierarchical train step: Arena's synchronization scheme on the LLM
replicas of one card; the port of ``repro.launch.train``.

One ``train_step`` call is one cloud round (Eq. 5):

    gamma2 x [ gamma1 x [ local SGD epoch of every replica ],
               edge mean (Eq. 1) ]
    cloud mean (Eq. 2)

Model replicas live as leading ``(pod, edge, fl)`` axes of every
parameter leaf, the reference's layout (``lift_params``), here all on the
one device of an ``HFLMesh`` (``launch.mesh.make_hfl_mesh``). A local
epoch is ``mb_per_epoch`` minibatches through ``Model.loss`` and
autograd, one SGD step each. The port loops over the replicas where the
reference vmaps over the three replica axes: the replicas are
independent, so the values are the same, and one replica's gradients
are held at a time (a full-width qwen3-1.7b replica's are 8.1 GB).

Eq. 1 and Eq. 2 are the reference's uniform means (``_edge_mean``,
``_cloud_mean``), computed by the two kernels written for their
size-weighted general form (``repro_torch.kernels.ops``): per leaf,
viewed as an ``(R, numel)`` bank of R = pod * edge * fl rows, one
``segment_agg`` launch with weights 1 and segment ids ``pod * n_edge +
edge`` (E = 1 for the cloud mean) and one ``segment_broadcast`` launch
writing the means back into the leaf. A static round launches each
kernel ``(g2 + 1)`` times per leaf. The training forward reaches no
kernel: attention, WKV and the loss are the reference's plain tensor
math (``Model.loss``).

``static`` frequencies run ``g1``/``g2`` fixed loops; ``dynamic`` takes
per-edge ``(g1e, g2e)`` host integers (the Arena action) with the
reference's masked upper-bound loops: an edge past its budget keeps its
values.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import disable_tf32
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
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


def _bank_inputs(reps: tuple, per_edge: bool, device):
    """The (R,) f32 weights (all 1) and int32 segment ids of the replicas
    in (pod, edge, fl) order: ``pod * n_edge + edge`` for the edge mean,
    0 for the cloud mean."""
    n_pod, n_edge, n_fl = reps
    r = n_pod * n_edge * n_fl
    ids = np.repeat(np.arange(n_pod * n_edge), n_fl) if per_edge else \
        np.zeros(r, np.int64)
    return (torch.ones((r,), dtype=torch.float32, device=device),
            torch.as_tensor(ids.astype(np.int32), device=device))


def _edge_mean(params, reps: tuple, active=None) -> None:
    """Eq. 1 on every leaf, in place: each replica takes the mean of its
    (pod, edge)'s fl replicas. One ``segment_agg`` launch per leaf, then
    one ``segment_broadcast`` writing every replica; with ``active`` (an
    (n_edge,) bool with some False) only the active edges' replicas are
    written, one ``segment_broadcast`` per active (pod, edge)."""
    n_pod, n_edge, n_fl = reps
    leaves = _leaves(params)
    ones, seg = _bank_inputs(reps, True, leaves[0].device)
    zeros = torch.zeros((n_fl,), dtype=torch.int32, device=seg.device)
    for leaf in leaves:
        view = leaf.view(seg.shape[0], -1)
        means = ops.segment_agg(view, ones, seg, n_pod * n_edge)
        if active is None or bool(np.all(active)):
            ops.segment_broadcast(means, seg, out=view)
            continue
        for pod in range(n_pod):
            for j in np.flatnonzero(active):
                e = pod * n_edge + int(j)
                ops.segment_broadcast(means[e:e + 1], zeros,
                                      out=view[e * n_fl:(e + 1) * n_fl])


def _cloud_mean(params, reps: tuple, collective_dtype=None) -> None:
    """Eq. 2 on every leaf, in place: every replica takes the mean over
    all of them. With ``collective_dtype`` the leaf is cast to it first
    and the mean written in it (the reference's quantized sync), then
    restored to the leaf's dtype."""
    leaves = _leaves(params)
    ones, seg = _bank_inputs(reps, False, leaves[0].device)
    for leaf in leaves:
        view = leaf.view(seg.shape[0], -1)
        if collective_dtype is None or view.dtype == collective_dtype:
            means = ops.segment_agg(view, ones, seg, 1)
            ops.segment_broadcast(means, seg, out=view)
            continue
        low = view.to(collective_dtype)
        means = ops.segment_agg(low, ones, seg, 1)
        del low
        view.copy_(ops.segment_broadcast(means, seg,
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

    ``params``: the lifted tree (``lift_params``), every leaf
    ``(pod, edge, fl, ...)`` and contiguous on the mesh's device; it is
    updated in place and returned. ``batch``: {"tokens", "labels"} (B,
    S) int with B a multiple of the replica count; replica r (in (pod,
    edge, fl) order) trains on rows ``[r B/R, (r + 1) B/R)``, split into
    ``mb_per_epoch`` minibatches. ``collective_dtype`` casts the params
    before the cloud mean only (the reference's quantized cloud sync).
    ``param_specs`` is the tree of ``mesh.hfl_param_specs`` and
    ``batch_spec`` the batch's, ``(("pod", "edge", "fl"),)``: on one
    device they describe the layout and shard nothing.

    Dynamic rounds: in epoch t1 of edge period t2 a replica of edge j
    trains only if ``t1 < g1e[j]`` and ``t2 < g2e[j]``, and only edges
    with ``t2 < g2e[j]`` take their edge mean. The reference computes
    every replica in every step and discards the masked results with
    ``_edge_mask``; the port skips that compute, so the values are the
    same, and a dynamic round with ``g1e = g1``, ``g2e = g2`` everywhere
    launches what the static round launches.

    TF32 stays off (``device.disable_tf32``). ``seq_shard_acts`` needs a
    multi-device mesh and raises (item 10 (b))."""
    if seq_shard_acts:
        raise NotImplementedError(
            f"seq_shard_acts needs a multi-device HFL mesh: see "
            f"{mesh_lib.MESH_ITEM}")
    model = build_model(cfg)
    reps = mesh_lib.n_replicas(hfl_mesh)
    n_pod, n_edge, n_fl = reps
    repl = n_pod * n_edge * n_fl
    low = None if collective_dtype is None else getattr(torch,
                                                        collective_dtype)
    disable_tf32()

    def replica_epoch(params, batch, r: int) -> None:
        """One local epoch of replica r: ``mb_per_epoch`` SGD steps."""
        views = [leaf.view((repl,) + leaf.shape[3:])[r]
                 for leaf in _leaves(params)]
        toks, labs = batch["tokens"][r], batch["labels"][r]
        per = toks.shape[0] // mb_per_epoch
        for i in range(mb_per_epoch):
            leaves = [v.detach().requires_grad_(True) for v in views]
            it = iter(leaves)
            p = _map(lambda _: next(it), params)
            mb = {"tokens": toks[i * per:(i + 1) * per],
                  "labels": labs[i * per:(i + 1) * per]}
            with torch.enable_grad():
                loss = model.loss(p, mb, remat=remat, attn_chunk=attn_chunk,
                                  wkv_chunked=wkv_chunked)
                grads = torch.autograd.grad(loss, leaves)
            del loss, p, leaves
            with torch.no_grad():
                for v, g in zip(views, grads):
                    _sgd(v, g, lr)
            del grads

    def reshape_batch(batch):
        def r(a):
            b = a.shape[0]
            if b % repl:
                raise ValueError(f"batch of {b} does not split over "
                                 f"{repl} replicas")
            return a.reshape((repl, b // repl) + tuple(a.shape[1:]))
        return {k: r(v) for k, v in batch.items()}

    def epoch(params, batch, edges) -> None:
        """One local epoch of every replica whose edge is in ``edges``
        (an (n_edge,) bool)."""
        for r in range(repl):
            if edges[(r // n_fl) % n_edge]:
                replica_epoch(params, batch, r)

    everyone = np.ones(n_edge, bool)

    if not dynamic:
        def train_step(params, batch):
            batch = reshape_batch(batch)
            with torch.no_grad():
                for _ in range(g2):
                    for _ in range(g1):
                        epoch(params, batch, everyone)
                    _edge_mean(params, reps)
                _cloud_mean(params, reps, low)
            return params
    else:
        def train_step(params, batch, g1e, g2e):
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
                    _edge_mean(params, reps, active2)
                _cloud_mean(params, reps, low)
            return params

    param_specs = mesh_lib.hfl_param_specs(cfg, _meta_params(cfg), hfl_mesh)
    batch_spec = (mesh_lib.REPLICA_AXES,)
    return train_step, param_specs, batch_spec


def _meta_params(cfg) -> dict:
    """The parameter tree's shapes, as meta tensors (nothing allocated)."""
    from repro_torch.models import transformer
    return transformer.init_params(torch.Generator(), cfg,
                                   torch.device("meta"))


def lift_params(params, n_pod: int, n_edge: int, n_fl: int) -> dict:
    """Broadcast one model copy into the replicated HFL layout: every
    leaf ``(n_pod, n_edge, n_fl, ...)``, contiguous."""
    return _map(lambda a: a.expand((n_pod, n_edge, n_fl) + tuple(a.shape))
                .contiguous(), params)


def main(argv=None):
    """Launcher CLI.

        PYTHONPATH=src python -m repro_torch.launch.train --arch \\
            qwen3-1.7b --mesh micro --rounds 10 [--dynamic] [--device cpu]

    --mesh micro  : the reduced config, replicas (1, 2, 2) on one device
    --mesh single / multi : the reference's 256 / 512-device production
                    meshes; they raise here (item 10 (b))
    --dynamic uses the masked per-edge-frequency step with a Var-Freq-B
    style schedule (the Arena agent plugs in through the same signature).
    Runs on the card unless ``--device cpu``."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batch

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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh != "micro":
        raise NotImplementedError(
            f"--mesh {args.mesh} needs the {256 if args.mesh == 'single' else 512}"
            f"-device production mesh: see {mesh_lib.MESH_ITEM}")
    cfg = get_config(args.arch).reduce()
    hfl_mesh = mesh_lib.make_hfl_mesh((1, 2, 2), device=args.device)
    dev = hfl_mesh.device
    n_pod, n_edge, n_fl = mesh_lib.n_replicas(hfl_mesh)
    repl = n_pod * n_edge * n_fl
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
    params = lift_params(model.init(gen, device=dev), n_pod, n_edge, n_fl)
    rng = np.random.default_rng(0)
    for i in range(args.rounds):
        batch = token_batch(i, args.batch, args.seq, cfg.vocab, device=dev)
        t0 = time.time()
        if args.dynamic:
            # Var-Freq-B style: per-edge freqs (Arena's agent drops in here)
            g1e = rng.integers(1, args.g1 + 1, n_edge)
            g2e = rng.integers(1, args.g2 + 1, n_edge)
            params = step(params, batch, g1e, g2e)
        else:
            params = step(params, batch)
        p0 = _map(lambda a: a[0, 0, 0], params)
        with torch.no_grad():
            loss = float(model.loss(p0, token_batch(
                9999, args.batch, args.seq, cfg.vocab, device=dev)))
        print(f"round {i} loss={loss:.4f} dt={time.time() - t0:.1f}s",
              flush=True)


if __name__ == "__main__":
    main()
