"""PPO with clipped surrogate (Eq. 13) + GAE (Eq. 14); the port of
``repro.core.agent.ppo``.

``enhancements=False`` reproduces the conference-version agent (*Hwamei*):
no GAE (plain discounted-return advantages) and the un-shaped linear
accuracy reward is expected from the env side -- used by the Table 2
ablation.

The network runs on the agent's device in full f32 (the agent turns
TF32 off, ``repro_torch.device.disable_tf32``); gradients come from
``torch.autograd`` on the plain network (no kernel), then clip by global
norm and an Adam step (``repro_torch.optim``). The rollout memory and the
advantages stay numpy float32, computed exactly as the reference writes
them.

Randomness. The reference draws the init, each action's noise and each
update's shuffle seed from one ``jax.random`` key chain. The port draws
them, in that order, from one ``torch.Generator`` (``gen_or_seed``: a
generator, or an int seeding a CPU generator) on the generator's own
device, and moves what it draws to the agent's device, so one seed gives
the same draws on the CPU and the card. Three hooks replace the draws:
``init_params`` (a dict of arrays in the reference layout),
``noise_source()`` (returns one (A,) standard-normal array) and
``shuffle_seed_source()`` (returns the int that seeds an update's numpy
shuffle); the parity tests inject the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch import weights
from repro_torch.core.agent import networks
from repro_torch.device import disable_tf32, resolve_device
from repro_torch.optim import optimizers


@dataclasses.dataclass
class PPOConfig:
    lr: float = 3e-4
    clip_eps: float = 0.2            # epsilon in Eq. 13
    discount: float = 0.9            # xi (paper 4.1)
    gae_lambda: float = 0.9          # lambda (paper 4.1)
    update_epochs: int = 6
    minibatch: int = 64
    vf_coef: float = 0.5
    ent_coef: float = 1e-3
    max_grad_norm: float = 0.5
    enhancements: bool = True        # False -> Hwamei agent


class PPOAgent:
    def __init__(self, gen_or_seed, state_shape, action_dim: int,
                 cfg: PPOConfig = PPOConfig(), *, device="cuda",
                 init_params: Optional[dict] = None,
                 noise_source: Optional[Callable] = None,
                 shuffle_seed_source: Optional[Callable] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        disable_tf32()
        if isinstance(gen_or_seed, torch.Generator):
            self._gen = gen_or_seed
        else:
            self._gen = torch.Generator().manual_seed(int(gen_or_seed))
        if init_params is not None:
            self.params = weights.params_from_numpy(init_params,
                                                    self.device)
        else:
            self.params = networks.init_net(self._gen, state_shape,
                                            action_dim, self.device)
        self.opt = optimizers.adam(cfg.lr)
        self.opt_state = self.opt.init(self.params)
        self.action_dim = action_dim
        self._noise_source = noise_source
        self._shuffle_seed_source = shuffle_seed_source
        self.memory: List[dict] = []

    # ------------------------------------------------------------------
    def _loss(self, params: dict, batch: dict):
        cfg = self.cfg
        mu, std, v = networks.actor_critic(params, batch["s"])
        logp = networks.gaussian_logp(mu, std, batch["a"])
        ratio = torch.exp(logp - batch["logp_old"])
        adv = batch["adv"]
        surr = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv)
        pi_loss = -surr.mean()
        v_loss = (v - batch["ret"]).square().mean()
        ent = torch.log(std).sum(-1).mean()
        return pi_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent

    def _update_step(self, batch: dict) -> None:
        keys = sorted(self.params)
        leaves = [self.params[k].detach().requires_grad_() for k in keys]
        loss = self._loss(dict(zip(keys, leaves)), batch)
        grads = dict(zip(keys, torch.autograd.grad(loss, leaves)))
        grads, _ = optimizers.clip_by_global_norm(grads,
                                                  self.cfg.max_grad_norm)
        self.params, self.opt_state = self.opt.update(
            self.params, grads, self.opt_state)

    def _noise(self) -> torch.Tensor:
        if self._noise_source is not None:
            return torch.tensor(np.asarray(self._noise_source()),
                                dtype=torch.float32, device=self.device)
        return torch.randn((self.action_dim,), generator=self._gen,
                           device=self._gen.device).to(self.device)

    def _shuffle_seed(self) -> int:
        if self._shuffle_seed_source is not None:
            return int(self._shuffle_seed_source())
        return int(torch.randint(0, 2**31 - 1, (), generator=self._gen,
                                 device=self._gen.device))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def act(self, state: np.ndarray, deterministic: bool = False):
        """One (H, W) state -> (action (A,) float32, logp, value): one
        copy to the device and one back."""
        s = torch.from_numpy(np.asarray(state, np.float32)).to(self.device)
        mu, std, v = networks.actor_critic(self.params, s[None])
        mu, std, v = mu[0], std[0], v[0]
        a = mu if deterministic else mu + std * self._noise()
        logp = networks.gaussian_logp(mu, std, a)
        out = torch.cat([a, logp[None], v[None]]).cpu().numpy()
        return out[:-2], float(out[-2]), float(out[-1])

    def remember(self, s, a, logp, r, v, done):
        self.memory.append({"s": s, "a": a, "logp": logp, "r": r,
                            "v": v, "done": done})

    # ------------------------------------------------------------------
    def _advantages(self):
        cfg = self.cfg
        r = np.array([m["r"] for m in self.memory], np.float32)
        v = np.array([m["v"] for m in self.memory], np.float32)
        done = np.array([m["done"] for m in self.memory], bool)
        n = len(r)
        adv = np.zeros(n, np.float32)
        ret = np.zeros(n, np.float32)
        if cfg.enhancements:
            # GAE (Eq. 14)
            last = 0.0
            next_v = 0.0
            for t in range(n - 1, -1, -1):
                nv = 0.0 if done[t] else next_v
                delta = r[t] + cfg.discount * nv - v[t]
                last = delta + cfg.discount * cfg.gae_lambda \
                    * (0.0 if done[t] else last)
                adv[t] = last
                next_v = v[t]
            ret = adv + v
        else:
            # Hwamei: plain discounted returns
            acc = 0.0
            for t in range(n - 1, -1, -1):
                acc = r[t] + cfg.discount * (0.0 if done[t] else acc)
                ret[t] = acc
            adv = ret - v
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)
        return adv, ret

    def update(self):
        """End-of-episode agent update (Algorithm 1 line 19): the rollout
        goes to the device once, and each minibatch is an index into it
        in the order of the reference's numpy shuffles."""
        if not self.memory:
            return 0.0
        cfg = self.cfg
        adv, ret = self._advantages()
        s = np.stack([m["s"] for m in self.memory]).astype(np.float32)
        a = np.stack([m["a"] for m in self.memory]).astype(np.float32)
        logp = np.array([m["logp"] for m in self.memory], np.float32)
        n = len(s)
        idx = np.arange(n)
        rng = np.random.default_rng(self._shuffle_seed())
        order = []
        for _ in range(cfg.update_epochs):
            rng.shuffle(idx)
            order.append(idx.copy())
        dev = self.device
        data = {k: torch.from_numpy(x).to(dev) for k, x in (
            ("s", s), ("a", a), ("logp_old", logp), ("adv", adv),
            ("ret", ret))}
        order = torch.from_numpy(np.stack(order)).to(dev)
        for ep in range(cfg.update_epochs):
            for lo in range(0, n, cfg.minibatch):
                mb = order[ep, lo:lo + cfg.minibatch]
                self._update_step({k: x[mb] for k, x in data.items()})
        self.memory.clear()
        return float(adv.std())
