"""Synchronization schemes: Arena + every baseline the paper compares
against (2.2 Var-Freq, 4.1 benchmarks); the port of ``repro.core.sync``.

All schemes drive the same ``HFLEnv`` (one call = one cloud round), so
time/energy/accuracy are measured identically:

  vanilla-fl   : FedAvg, random participation, gamma2 = 1 [1]
  vanilla-hfl  : fixed (gamma1, gamma2) at every edge [8]
  var-freq-a   : per-edge time-equalizing frequencies (2.2)
  var-freq-b   : var-freq-a minus energy-hungry fast edges (2.2)
  favor        : FedAvg + value-guided device selection [5] (the DQN
                 device-selector is realized as an EMA-value bandit over
                 per-device marginal accuracy, epsilon-greedy)
  share        : data-distribution-aware topology shaping [9] + HFL
  hwamei       : the conference-version agent (PPO, no GAE, linear reward)
  arena        : this paper (PPO + GAE + shaped reward + projection)

Asynchronous runtime schemes (one env call = one edge upload event):

  async-fedavg : fixed (gamma1, gamma2) at every upload event; the cloud
                 aggregates the staleness-decayed update buffer
  async-arena  : the PPO agent picks (gamma1, gamma2) per edge at its
                 upload event

They drive the port's ``repro_torch.sim.AsyncHFLEnv``; on a
synchronous ``HFLEnv`` they raise the reference's ``TypeError``.

**Unified runner surface**: every scheme is a :class:`SchemeSpec` in
the :data:`SCHEMES` registry -- one callable shape
``spec(env, agent=None, **overrides)`` with the per-scheme defaults
(``g1``/``frac``/``eps``/...) living in the spec, not in drifting
function signatures. :func:`run_scheme` is the one dispatch point; the
historical ``run_*`` functions are thin wrappers that forward into the
registry (so their defaults cannot drift from it).

The agent runs on the env's device (``env.device``). ``run_scheme``
records each run in the run ledger (``repro_torch.telemetry.ledger``)
when one is given or installed as the process default.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

import torch

from repro_torch.core.agent import PPOAgent, PPOConfig
from repro_torch.telemetry import ledger as ledger_mod


# ---------------------------------------------------------------------------
# the unified scheme-runner surface
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SchemeSpec:
    """One synchronization scheme behind the unified runner surface.

    ``runner(env, **params)`` (or ``runner(env, agent, **params)`` when
    ``needs_agent``) holds the logic; ``defaults`` — a tuple of
    ``(name, value)`` pairs so the spec stays hashable — is the single
    home of the scheme's tunables. Calling the spec merges keyword
    overrides over the defaults and rejects unknown parameters, so
    every scheme exposes the same calling convention:

        SCHEMES["vanilla-hfl"](env, g1=2, g2=2)
        SCHEMES["arena"](env, agent=agent)
    """
    name: str
    runner: Callable
    defaults: tuple = ()
    needs_agent: bool = False
    needs_async: bool = False
    doc: str = ""

    @property
    def params(self) -> dict:
        return dict(self.defaults)

    def __call__(self, env, agent=None, **overrides):
        params = self.params
        bad = sorted(set(overrides) - set(params))
        if bad:
            raise TypeError(
                f"scheme {self.name!r} got unknown parameter(s) {bad}; "
                f"it accepts {sorted(params) or 'no parameters'}")
        if self.needs_agent and agent is None:
            raise ValueError(f"scheme {self.name!r} needs a trained "
                             f"agent (pass agent=...)")
        if self.needs_async and not hasattr(env, "buffer_k"):
            raise TypeError(
                f"scheme {self.name!r} drives an AsyncHFLEnv (one step "
                f"= one upload event), got {type(env).__name__}")
        params.update(overrides)
        if self.needs_agent:
            return self.runner(env, agent, **params)
        return self.runner(env, **params)


def run_scheme(name: str, env, *, agent=None, ledger=None, **overrides):
    """The one dispatch point: look the scheme up in :data:`SCHEMES` and
    run it with ``overrides`` merged over the registry defaults.

    ``ledger``: where to record the run (``repro_torch.telemetry.
    ledger``). ``None`` falls through to the process default (installed
    by ``ledger.enable()``; none by default), ``False`` forces recording
    off, ``True``/a path/a :class:`RunLedger` records there. Recording
    happens *after* the episode from host-side history, so ledger-on vs
    ledger-off trajectories are bitwise identical. The recorded run id
    is returned in the history dict as ``"ledger_run_id"``."""
    try:
        spec = SCHEMES[name]
    except KeyError:
        raise KeyError(f"unknown scheme {name!r}; available: "
                       f"{sorted(SCHEMES)}") from None
    lg = ledger_mod.resolve(ledger)
    h = spec(env, agent=agent, **overrides)
    if lg is not None:
        params = spec.params
        params.update(overrides)
        h["ledger_run_id"] = lg.record_run(
            scheme=name, env=env, history=h, params=params)
    return h


def _given(**kw) -> dict:
    """Drop unset (None) kwargs so the thin ``run_*`` wrappers inherit
    their defaults from the registry instead of duplicating them."""
    return {k: v for k, v in kw.items() if v is not None}


# ---------------------------------------------------------------------------
# static schemes
# ---------------------------------------------------------------------------

def _vanilla_fl(env, *, g1: int, frac: float, seed: int):
    """FedAvg: γ1 local epochs, direct cloud sync (γ2=1), random
    participation. (Edge agg followed immediately by cloud agg equals the
    global weighted mean, so the HFL env expresses FL exactly.)"""
    rng = np.random.default_rng(seed)
    env.reset()
    done = False
    while not done:
        part = rng.random(env.cfg.n_devices) < frac
        if not part.any():
            part[rng.integers(env.cfg.n_devices)] = True
        m = env.cfg.n_edges
        _, _, done, info = env.step_raw(np.full(m, g1), np.ones(m), part)
    return _history(env)


def _vanilla_hfl(env, *, g1: int, g2: int):
    env.reset()
    done = False
    m = env.cfg.n_edges
    while not done:
        _, _, done, info = env.step_raw(np.full(m, g1), np.full(m, g2))
    return _history(env)


def _time_equalizing_freqs(env, budget_epochs: float = 20.0):
    """Var-Freq A: pick per-edge γ1 so γ1_j · t_j ≈ const, with the mean
    epoch budget fixed; γ2 fixed at 2."""
    t_edge = np.array([
        env.profiles.epoch_time(np.random.default_rng(0))[
            env.edge_assign == j].max()
        for j in range(env.cfg.n_edges)])
    inv = 1.0 / t_edge
    g1 = inv / inv.mean() * (budget_epochs / 2.0)
    g1 = np.clip(np.round(g1), 1, env.cfg.gamma_max).astype(np.int64)
    g2 = np.full(env.cfg.n_edges, 2, np.int64)
    return g1, g2


def _var_freq_a(env):
    env.reset()
    g1, g2 = _time_equalizing_freqs(env)
    done = False
    while not done:
        _, _, done, _ = env.step_raw(g1, g2)
    return _history(env)


def _var_freq_b(env):
    """Var-Freq B: A, then reduce frequencies of fast-but-power-hungry
    edges (§2.2: 'appropriately reduce the aggregation frequency of fast
    devices with high energy consumption')."""
    env.reset()
    g1, g2 = _time_equalizing_freqs(env)
    e_edge = np.array([
        env.profiles.epoch_energy(np.random.default_rng(0))[
            env.edge_assign == j].mean()
        for j in range(env.cfg.n_edges)])
    hungry = e_edge > np.median(e_edge)
    g1 = np.where(hungry, np.maximum(g1 - 2, 1), g1).astype(np.int64)
    done = False
    while not done:
        _, _, done, _ = env.step_raw(g1, g2)
    return _history(env)


def _favor(env, *, g1: int, frac: float, eps: float, seed: int):
    """Favor-style selection: per-device EMA value of the global accuracy
    delta when it participates; pick top-frac with ε-greedy exploration."""
    rng = np.random.default_rng(seed)
    env.reset()
    n = env.cfg.n_devices
    value = np.zeros(n)
    done = False
    m = env.cfg.n_edges
    k_sel = max(1, int(frac * n))
    while not done:
        explore = rng.random(n) < eps
        score = np.where(explore, rng.random(n) + value.max(), value)
        sel = np.zeros(n, bool)
        sel[np.argsort(-score)[:k_sel]] = True
        acc_old = env.acc
        _, _, done, info = env.step_raw(np.full(m, g1), np.ones(m), sel)
        delta = info["acc"] - acc_old
        value[sel] = 0.8 * value[sel] + 0.2 * delta
    return _history(env)


def share_topology(env) -> np.ndarray:
    """Share [9]: assign devices to edges so every edge's label histogram
    approaches the global distribution (greedy, size-balanced). Reads
    every device's labels: a sharded env gathers its ranks' rows of them
    first (``AggContext.gather_rows``), so every rank computes the same
    assignment (the reference reads a sharded array's global view)."""
    y = env.agg_ctx.gather_rows(env.fed.y).cpu().numpy()   # (N, n_local)
    n, m = env.cfg.n_devices, env.cfg.n_edges
    n_classes = int(y.max()) + 1
    hist = np.stack([np.bincount(y[i], minlength=n_classes)
                     for i in range(n)]).astype(np.float64)
    hist /= hist.sum(1, keepdims=True)
    glob = hist.mean(0)
    cap = -(-n // m)
    edge_hist = np.zeros((m, n_classes))
    counts = np.zeros(m, np.int64)
    assign = np.full(n, -1, np.int64)
    # most-skewed devices first; place where the edge mix improves most
    order = np.argsort(-np.abs(hist - glob).sum(1))
    for i in order:
        best, best_cost = -1, np.inf
        for j in range(m):
            if counts[j] >= cap:
                continue
            mix = (edge_hist[j] * counts[j] + hist[i]) / (counts[j] + 1)
            cost = np.abs(mix - glob).sum()
            if cost < best_cost:
                best, best_cost = j, cost
        assign[i] = best
        edge_hist[best] = (edge_hist[best] * counts[best] + hist[i]) \
            / (counts[best] + 1)
        counts[best] += 1
    return assign


def _share(env, *, g1: int, g2: int):
    assign = share_topology(env)
    env.set_topology(assign)
    return _vanilla_hfl(env, g1=g1, g2=g2)


# ---------------------------------------------------------------------------
# asynchronous runtime schemes (event-driven AsyncHFLEnv)
# ---------------------------------------------------------------------------

def _async_fedavg(env, *, g1: int, g2: int, max_events: int):
    """Async FedAvg-over-HFL: every edge re-launches with the same
    fixed (γ1, γ2) at each of its upload events; the cloud advances on
    the staleness-decayed buffer. ``env`` must be an ``AsyncHFLEnv``
    (its per-event step signature is what makes this asynchronous)."""
    env.reset()
    done, i = False, 0
    while not done and i < max_events:
        _, _, done, _ = env.step(np.array([g1, g2], np.float64))
        i += 1
    return _history(env)


# ---------------------------------------------------------------------------
# learned schemes (Arena / Hwamei / async-Arena)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainLog:
    episode_rewards: list
    episode_acc: list
    episode_energy: list


def train_agent(env, episodes: int, *, enhancements: bool = True,
                seed: int = 0, ppo: Optional[PPOConfig] = None,
                log_every: int = 0, init_params: Optional[dict] = None,
                noise_source: Optional[Callable] = None,
                shuffle_seed_source: Optional[Callable] = None):
    """Algorithm 1: Omega episodes; agent update + memory clear per
    episode. ``enhancements=False`` trains the Hwamei agent (no GAE +
    linear reward shaping). The agent lives on ``env.device`` and draws
    from ``torch.Generator().manual_seed(seed)``; ``init_params``,
    ``noise_source`` and ``shuffle_seed_source`` go to :class:`PPOAgent`
    and replace its draws."""
    ppo = ppo or PPOConfig(enhancements=enhancements)
    agent = PPOAgent(torch.Generator().manual_seed(seed), env.state_shape,
                     env.action_dim, ppo, device=env.device,
                     init_params=init_params, noise_source=noise_source,
                     shuffle_seed_source=shuffle_seed_source)
    log = TrainLog([], [], [])
    for ep in range(episodes):
        s = env.reset()
        done = False
        ep_r = 0.0
        while not done:
            a, logp, v = agent.act(s)
            s2, r, done, info = env.step(a)
            if not enhancements:
                # Hwamei reward: linear accuracy delta
                r = (info["acc"] - (env.acc_hist[-2]
                                    if len(env.acc_hist) > 1 else 0.1)) \
                    - env.cfg.epsilon * info["energy"] / 10.0
            agent.remember(s, a, logp, r, v, done)
            s = s2
            ep_r += r
        agent.update()
        log.episode_rewards.append(ep_r)
        log.episode_acc.append(env.acc)
        log.episode_energy.append(float(np.mean(env.energy_hist)))
        if log_every and (ep + 1) % log_every == 0:
            print(f"  ep {ep+1}/{episodes} reward={ep_r:.3f} "
                  f"acc={env.acc:.3f} "
                  f"E={np.mean(env.energy_hist):.1f}mAh", flush=True)
    return agent, log


def _learned(env, agent):
    """One evaluation episode with a trained agent (deterministic).
    Serves arena and hwamei on the synchronous env (the agents differ,
    not the episode loop) and async-arena on the event-driven env (the
    2-dim action programs the deciding edge's next round)."""
    s = env.reset()
    done = False
    while not done:
        a, _, _ = agent.act(s, deterministic=True)
        s, _, done, _ = env.step(a)
    return _history(env)


# ---------------------------------------------------------------------------

def _history(env):
    out = {"acc": list(env.acc_hist), "energy": list(env.energy_hist),
           "time": list(env.time_hist), "final_acc": env.acc,
           "total_energy": float(np.sum(env.energy_hist)),
           "avg_energy": float(np.mean(env.energy_hist)),
           "rounds": len(env.acc_hist)}
    # async envs built with telemetry carry the episode's metric snapshot
    # (staleness/coverage/retry statistics) into the scheme result
    tm = getattr(env, "telemetry", None)
    if tm is not None and tm.enabled:
        out["telemetry"] = tm.metrics.snapshot()
    return out


SCHEMES: dict[str, SchemeSpec] = {s.name: s for s in [
    SchemeSpec("vanilla-fl", _vanilla_fl,
               defaults=(("g1", 20), ("frac", 0.8), ("seed", 0)),
               doc="FedAvg: random participation, γ2 ≡ 1"),
    SchemeSpec("vanilla-hfl", _vanilla_hfl,
               defaults=(("g1", 5), ("g2", 4)),
               doc="fixed (γ1, γ2) at every edge"),
    SchemeSpec("var-freq-a", _var_freq_a,
               doc="per-edge time-equalizing frequencies (§2.2)"),
    SchemeSpec("var-freq-b", _var_freq_b,
               doc="var-freq-a minus energy-hungry fast edges"),
    SchemeSpec("favor", _favor,
               defaults=(("g1", 20), ("frac", 0.6), ("eps", 0.2),
                         ("seed", 0)),
               doc="FedAvg + EMA-value ε-greedy device selection"),
    SchemeSpec("share", _share, defaults=(("g1", 5), ("g2", 4)),
               doc="label-histogram topology shaping + vanilla-hfl"),
    SchemeSpec("async-fedavg", _async_fedavg,
               defaults=(("g1", 5), ("g2", 4), ("max_events", 10000)),
               needs_async=True,
               doc="fixed (γ1, γ2) per upload event, buffered cloud"),
    SchemeSpec("async-arena", _learned, needs_agent=True,
               needs_async=True,
               doc="trained PPO agent acting per upload event"),
    SchemeSpec("arena", _learned, needs_agent=True,
               doc="this paper's PPO agent (deterministic eval)"),
    SchemeSpec("hwamei", _learned, needs_agent=True,
               doc="conference-version agent (train with "
                   "enhancements=False)"),
]}


# ---------------------------------------------------------------------------
# thin wrappers — the historical API, forwarding into the registry so
# the per-scheme defaults live in exactly one place (None = inherit)
# ---------------------------------------------------------------------------

def run_vanilla_fl(env, g1: Optional[int] = None,
                   frac: Optional[float] = None,
                   seed: Optional[int] = None):
    return run_scheme("vanilla-fl", env,
                      **_given(g1=g1, frac=frac, seed=seed))


def run_vanilla_hfl(env, g1: Optional[int] = None,
                    g2: Optional[int] = None):
    return run_scheme("vanilla-hfl", env, **_given(g1=g1, g2=g2))


def run_var_freq_a(env):
    return run_scheme("var-freq-a", env)


def run_var_freq_b(env):
    return run_scheme("var-freq-b", env)


def run_favor(env, g1: Optional[int] = None, frac: Optional[float] = None,
              eps: Optional[float] = None, seed: Optional[int] = None):
    return run_scheme("favor", env,
                      **_given(g1=g1, frac=frac, eps=eps, seed=seed))


def run_share(env, g1: Optional[int] = None, g2: Optional[int] = None):
    return run_scheme("share", env, **_given(g1=g1, g2=g2))


def run_async_fedavg(env, g1: Optional[int] = None,
                     g2: Optional[int] = None,
                     max_events: Optional[int] = None):
    return run_scheme("async-fedavg", env,
                      **_given(g1=g1, g2=g2, max_events=max_events))


def run_async_arena(env, agent):
    return run_scheme("async-arena", env, agent=agent)


def run_learned(env, agent):
    return run_scheme("arena", env, agent=agent)
