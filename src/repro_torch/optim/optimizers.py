"""Hand-rolled optimizers (the paper trains with plain SGD; Adam drives the
PPO agent); the port of ``repro.optim.optimizers``. Interface mirrors the
(init, update) pair convention:

    opt = sgd(lr=0.01)
    state = opt.init(params)
    params, state = opt.update(params, grads, state)

Parameters, gradients and states are dicts of tensors. Updates run under
``torch.no_grad()`` and return new dicts; the inputs are not modified.
Adam keeps the reference's state ``{"m", "v", "t"}`` (``t`` an int32
count) and its exact update ``(m / bc1) / (sqrt(v / bc2) + eps)`` with
``bc = 1 - b ** t`` in f32, so a reference optimizer state carries over
by name. ``torch.optim.Adam`` is not used: its denominator
``sqrt(v) / sqrt(bc2) + eps`` rounds differently.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


def _zeros_f32(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    @torch.no_grad()
    def update(params, grads, state):
        new = {k: (p - lr * grads[k].float()).to(p.dtype)
               for k, p in params.items()}
        return new, state

    return Optimizer(init, update)


def sgd_momentum(lr: float, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return _zeros_f32(params)

    @torch.no_grad()
    def update(params, grads, vel):
        vel = {k: momentum * v + grads[k].float() for k, v in vel.items()}
        new = {k: (p.float() - lr * vel[k]).to(p.dtype)
               for k, p in params.items()}
        return new, vel

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        dev = next(iter(params.values())).device
        return {"m": _zeros_f32(params), "v": _zeros_f32(params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(params, grads, state):
        t = state["t"] + 1
        m = {k: b1 * m_ + (1 - b1) * grads[k].float()
             for k, m_ in state["m"].items()}
        v = {k: b2 * v_ + (1 - b2) * grads[k].float().square()
             for k, v_ in state["v"].items()}
        tf = t.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=tf.device), tf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=tf.device), tf)

        def step(p, m_, v_):
            upd = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            return (p.float() - lr * upd).to(p.dtype)

        new = {k: step(p, m[k], v[k]) for k, p in params.items()}
        return new, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


@torch.no_grad()
def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, summed leaf by leaf in
    sorted-key order (the reference's ``jax.tree.leaves`` order)."""
    return torch.sqrt(sum(tree[k].float().square().sum()
                          for k in sorted(tree)))


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float):
    """Scale ``grads`` by ``min(1, max_norm / max(norm, 1e-9))``; returns
    ``(clipped, norm)``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm
