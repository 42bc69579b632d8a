"""The HFL environment the DRL agent interacts with (paper Fig. 5 + Alg. 1).

The port of the synchronous ``repro.sim.env.HFLEnv``, in both modes:

* ``mode="real"`` -- devices train the testbed CNN on federated
  synthetic MNIST/CIFAR shards through ``repro_torch.core.hfl``, and
  accuracy is measured on the held-out test set;
* ``mode="analytic"`` -- accuracy follows the reference's calibrated
  saturating-progress model (numpy end to end).

One ``HFLEnv`` step = one cloud round driven by the per-edge action
(gamma1, gamma2), with the synchronous barrier t_use = max_j t_edge_j.

Randomness: the numpy generator makes the same draws in the same order
as the reference (hardware costs, clustering, data, analytic noise). The
reference's ``jax.random`` draws become a ``torch.Generator`` on the
env's device: ``w(0)`` from a generator seeded ``seed + 1000`` at each
reset, and each round's shuffles from a generator seeded ``seed``.
Two test hooks replace them: ``init_params`` (the ``w(0)`` model) and
``perm_source`` (a callable returning one round's
``(gamma_max, gamma_max, N, n_local)`` permutations per call).

``AsyncHFLEnv`` (below) removes the barrier: edges run on their own
clocks through the event-driven runtime (``repro_torch.runtime``), the
cloud aggregates a staleness-decayed update buffer, and one env step is
one edge upload event (2-dim per-edge action). It takes a third hook,
``edge_perm_source(version)``, for the shuffles of edge rounds trained
from global ``version``.

``EnvConfig.deterministic`` builds the rounds in PyTorch's deterministic
mode (``repro_torch.device.deterministic_algorithms``): the same seed
gives the same bank bits on every run on the card too.

Observation (``repro_torch.telemetry``): ``EnvConfig.health`` or
``HFLEnv(health=)`` attaches a :class:`HealthMonitor` whose new events
ride ``info["health"]``; ``EnvConfig.telemetry`` or
``AsyncHFLEnv(telemetry=)`` records the async runtime's trace and
metrics (``info["telemetry"]``). Both only read: on or off, the
trajectory is bitwise the same.

Multi-GPU bank: ``EnvConfig.agg`` takes an ``hfl.AggContext``
(``AggContext.for_mesh(launch.mesh.make_bank_mesh(k))``; the
reference's deprecated ``EnvConfig.mesh`` has no counterpart).
Under a mesh every rank builds the env from the same config and seed
and runs the same host code and draws; it keeps its ``N/k`` rows of the
bank, the data shards, the device sizes and the edge assignment, on the
mesh's device, while the edge matrix, the global model, the PCA state,
the hardware costs and the fault draws are the same on every rank. The
rounds, the flushes and the churn-join resync take the context.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import flatbank, hfl, pca, profiling
from repro_torch.core import reward as reward_mod
from repro_torch.core import state as state_mod
from repro_torch.data import federated, synthetic
from repro_torch.device import resolve_device
from repro_torch.models import model as model_mod
from repro_torch.runtime import (AsyncConfig, EventQueue, FaultInjector,
                                 StalenessBuffer, edge_round_cost)
from repro_torch.sim import hardware
from repro_torch.telemetry import HealthConfig, HealthMonitor, Telemetry


@dataclasses.dataclass
class EnvConfig:
    task: str = "mnist"              # mnist | cifar
    mode: str = "real"               # real | analytic
    n_devices: int = 50
    n_edges: int = 5
    n_local: int = 1200              # samples per device (paper: 1200/1000)
    batch_size: int = 32
    lr: float = 0.003                # paper: 0.003 MNIST, 0.01 Cifar
    data_scheme: str = "label2"      # iid | labelK | dirichlet
    dirichlet_alpha: float = 0.5
    threshold_time: float = 3000.0   # T (paper: 3000 s MNIST, 12000 s Cifar)
    epsilon: float = 0.002           # reward energy weight
    gamma_max: int = 8               # action upper bound per frequency
    n_pca: int = 6
    edge_regions: Optional[tuple] = None   # default 3x cn + 2x us (paper)
    use_profiling: bool = True       # cluster devices by capability
    seed: int = 0
    # device mobility (paper 2.3)
    churn_prob: float = 0.0
    recluster_every: int = 0
    # multi-GPU bank: the aggregation context (hfl.AggContext) every
    # round/flush/resync runs under -- build it once with
    # launch.mesh.make_bank_context(k); None = one device
    agg: Optional[object] = None
    # observability (repro_torch.telemetry): True builds the async env
    # with an enabled Telemetry facade; on vs off is bitwise-identical
    telemetry: bool = False
    # per-run health monitors (repro_torch.telemetry.health): True
    # attaches a HealthMonitor with the default HealthConfig; its events
    # ride info["health"]. Observation only: bitwise-identical on vs off
    health: bool = False
    # analytic-mode calibration
    a_max: float = 0.80
    a_rate: float = 0.016            # per-local-epoch progress rate
    drift_coef: float = 0.25         # non-IID drift per unbalanced epoch
    stale_coef: float = 0.015        # large-gamma2 staleness penalty
    noise: float = 0.004
    cov_pow: float = 0.5             # async: partial-buffer coverage
                                     # exponent
    device: str = "cuda"             # where the env's tensors live
    deterministic: bool = False      # rounds in deterministic mode

    def fixup(self) -> "EnvConfig":
        if self.task == "cifar" and self.threshold_time == 3000.0:
            # the reference's CIFAR schedule: T=12000 s, lr=0.01, reward
            # weight rescaled to its 50-device energy total
            return dataclasses.replace(self, threshold_time=12000.0,
                                       lr=0.01, epsilon=0.004,
                                       n_local=1000)
        return self


class HFLEnv:
    """Gym-ish: reset() -> state; step(a) -> (state, reward, done, info)."""

    def __init__(self, cfg: EnvConfig, health=None, *,
                 init_params: Optional[dict] = None,
                 perm_source: Optional[Callable] = None):
        cfg = cfg.fixup()
        self.cfg = cfg
        # per-run health monitors: an explicit HealthMonitor (or a bare
        # HealthConfig) wins; else cfg.health toggles the defaults on.
        # None = disabled, and the health-off path is unchanged
        if health is None and cfg.health:
            health = HealthMonitor()
        elif isinstance(health, HealthConfig):
            health = HealthMonitor(health)
        self.health = health
        # one AggContext carries the mesh and row placement of every
        # aggregation this env runs
        self.agg_ctx = hfl._resolve_ctx(cfg.agg, "EnvConfig")
        self.device = resolve_device(cfg.device)
        if self.agg_ctx.sharded:
            if self.agg_ctx.mesh.device.type != self.device.type:
                raise ValueError(f"EnvConfig.device {cfg.device!r} and the "
                                 f"bank mesh's {self.agg_ctx.mesh.device} "
                                 f"differ")
            self.device = self.agg_ctx.mesh.device
        self.rng = np.random.default_rng(cfg.seed)
        self.profiles = hardware.DeviceProfiles.sample(
            self.rng, cfg.n_devices, task=cfg.task)
        regions = cfg.edge_regions or tuple(
            ["cn"] * (cfg.n_edges - cfg.n_edges // 2)
            + ["us"] * (cfg.n_edges // 2))
        self.comm = hardware.CommModel(list(regions), task=cfg.task)
        # ---- topology: profiling module or round-robin -------------------
        if cfg.use_profiling:
            edge_assign = profiling.cluster_devices(
                self.profiles, cfg.n_edges, seed=cfg.seed)
        else:
            edge_assign = np.arange(cfg.n_devices) % cfg.n_edges
        self.set_topology(edge_assign)
        self._init_params = init_params
        # ---- task / data --------------------------------------------------
        if cfg.mode == "real":
            synth = (synthetic.synth_mnist if cfg.task == "mnist"
                     else synthetic.synth_cifar)
            train, test = synth(n_train=max(20000, cfg.n_devices
                                            * cfg.n_local),
                                n_test=2000, seed=cfg.seed,
                                device=self.device)
            if cfg.task == "mnist":
                self._init_fn = model_mod.mnist_cnn_init
                self._apply_fn = model_mod.mnist_cnn_apply
            else:
                self._init_fn = model_mod.cifar_cnn_init
                self._apply_fn = model_mod.cifar_cnn_apply
            self.fed = federated.make_federated(
                train, test, cfg.n_devices, cfg.n_local,
                scheme=cfg.data_scheme, seed=cfg.seed,
                alpha=cfg.dirichlet_alpha)
            # this rank's data shards (identity on one device)
            self.fed.x = self.agg_ctx.place_rows(self.fed.x)
            self.fed.y = self.agg_ctx.place_rows(self.fed.y)
            apply_fn = self._apply_fn
            self._loss_fn = lambda p, b: model_mod.cnn_loss(apply_fn, p, b)
            self._cloud_round = hfl.make_cloud_round(
                self._loss_fn, cfg.lr, cfg.batch_size, cfg.n_edges,
                cfg.gamma_max, cfg.gamma_max, ctx=self.agg_ctx,
                deterministic=cfg.deterministic)
            self._perm_gen = torch.Generator(device=self.device)
            self._perm_gen.manual_seed(cfg.seed)
            self._perm_source = perm_source or self._draw_perms
        else:
            # analytic mode still needs a (tiny) parameter vector so the
            # PCA state path exercises the real machinery
            self._init_fn = model_mod.mnist_cnn_init
            self.fed = None
        self.model_dim_mb = hardware.MODEL_MB[cfg.task]
        self.episode = 0

    # ------------------------------------------------------------------
    def _draw_perms(self, gen: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        """One round's shuffles, (gamma_max, gamma_max, N, n_local), from
        ``gen`` (default: the env's round generator)."""
        g = self.cfg.gamma_max
        shape = (g, g, self.cfg.n_devices, self.fed.n_local)
        keys = torch.rand(shape, generator=gen or self._perm_gen,
                          device=self.device)
        return keys.argsort(dim=-1, stable=True)

    @torch.no_grad()
    def _test_accuracy(self) -> float:
        """The global model's accuracy on the held-out test set."""
        return float(model_mod.cnn_accuracy(
            self._apply_fn, self.global_model,
            {"x": self.fed.test_x, "y": self.fed.test_y}))

    def _w0(self) -> dict:
        """w(0): the injected model, or a draw from ``seed + 1000``."""
        if self._init_params is not None:
            return {k: torch.as_tensor(v).to(self.device, copy=True)
                    for k, v in self._init_params.items()}
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.cfg.seed + 1000)        # same w(0) each episode
        return self._init_fn(gen, self.device)

    def reset(self) -> np.ndarray:
        cfg = self.cfg
        self.k = 0
        self.t_re = cfg.threshold_time
        self.acc = 0.1
        self.total_energy = 0.0
        self.energy_hist = []
        self.acc_hist = []
        self.time_hist = []
        self.episode += 1
        if self.health is not None:
            self.health.reset()
        p0 = self._w0()
        if cfg.mode == "real":
            # every row starts from w(0): a rank builds its N/k rows only
            self.bank = hfl.broadcast_model(
                p0, self.agg_ctx.check_rows(cfg.n_devices))
            self.global_model = hfl.bank_select(self.bank, 0)
        else:
            self.global_model = p0
            self._edge_acc = np.full(cfg.n_edges, 0.1, np.float32)
        self.edge_models = hfl.broadcast_model(self.global_model,
                                               cfg.n_edges)
        # Algorithm 1 line 3-5: one fixed-frequency round, fit PCA
        g0 = np.full(cfg.n_edges, 2, np.int64)
        h_edges, t_use, e_tot = self._run_round(g0, g0)
        self._fit_pca()
        self.t_re -= t_use
        self.k = 1
        self._h_edges = h_edges
        return self._state()

    def _fit_pca(self):
        flat = [pca.flatten_model(self.global_model)]
        for j in range(self.cfg.n_edges):
            flat.append(pca.flatten_model(
                hfl.bank_select(self.edge_models, j)))
        self.pca_state = pca.fit(torch.stack(flat), self.cfg.n_pca)

    # ------------------------------------------------------------------
    def _run_round(self, g1: np.ndarray, g2: np.ndarray,
                   participate: Optional[np.ndarray] = None):
        """Executes one cloud round; returns (h_edges (M,3), t_use, E)."""
        cfg = self.cfg
        m = cfg.n_edges
        # --- device mobility ------------------------------------------------
        if cfg.churn_prob > 0:
            moved = self.rng.random(cfg.n_devices) < cfg.churn_prob
            if moved.any():
                self.profiles.cpu_usage[moved] = self.rng.choice(
                    [0.1, 0.2, 0.3, 0.4, 0.5], size=int(moved.sum()))
            if (cfg.recluster_every and cfg.use_profiling
                    and self.k % cfg.recluster_every == 0 and self.k > 0):
                self.set_topology(profiling.cluster_devices(
                    self.profiles, cfg.n_edges, seed=cfg.seed + self.k))
        # --- hardware costs ------------------------------------------------
        et = self.profiles.epoch_time(self.rng)          # (N,)
        ee = self.profiles.epoch_energy(self.rng)        # (N,)
        ec = self.comm.ec_time(self.rng)                 # (M,)
        de = self.comm.de_time(self.rng, m)              # (M,)
        if participate is None:
            participate = np.ones(cfg.n_devices, bool)
        t_sgd = np.zeros(m)
        e_edge = np.zeros(m)
        for j in range(m):
            sel = (self.edge_assign == j) & participate
            if sel.any():
                t_sgd[j] = et[sel].max()
                e_edge[j] = (ee[sel] * g1[j] * g2[j]).sum()
        t_edge = g2 * (g1 * t_sgd + de) + ec
        t_use = float(t_edge.max())
        e_tot = float(e_edge.sum())
        # --- model update ---------------------------------------------------
        if cfg.mode == "real":
            part = self.agg_ctx.place_rows(torch.as_tensor(
                np.asarray(participate, np.float32), device=self.device))
            sizes = self.fed.device_sizes() * part
            self.bank, self.global_model, self.edge_models = \
                self._cloud_round(
                    self.bank, self.fed.x, self.fed.y, sizes,
                    self._edge_assign_t, np.minimum(g1, cfg.gamma_max),
                    np.minimum(g2, cfg.gamma_max), self._perm_source())
            acc = self._test_accuracy()
        else:
            acc = self._analytic_update(g1, g2, participate)
        self.acc = acc
        self.total_energy += e_tot
        h_edges = np.stack([t_sgd * g1 * g2, ec, e_edge], axis=1)
        return h_edges.astype(np.float32), t_use, e_tot

    def _analytic_update(self, g1, g2, participate) -> float:
        """Saturating progress + drift/staleness penalties (the
        reference's real-mode calibration)."""
        cfg = self.cfg
        epochs = g1.astype(np.float64) * g2.astype(np.float64)
        w = self._edge_sizes / self._edge_sizes.sum()
        progress = float(np.sum(w * (1.0 - np.exp(-cfg.a_rate * epochs))))
        drift = cfg.drift_coef * float(np.std(epochs)) / max(
            float(np.mean(epochs)), 1.0) * cfg.a_rate
        stale = cfg.stale_coef * cfg.a_rate * float(np.mean(
            np.maximum(g2 - 4, 0)))
        gap = cfg.a_max - self.acc
        noise = self.rng.normal(0, cfg.noise)
        new = self.acc + gap * max(progress - drift - stale, 0.0) + noise
        return float(np.clip(new, 0.05, cfg.a_max))

    # ------------------------------------------------------------------
    def _state(self) -> np.ndarray:
        if self.cfg.mode == "real":
            return state_mod.build_state(
                self.pca_state, self.global_model, self.edge_models,
                self._h_edges, self.k, self.t_re, self.acc,
                t_threshold=self.cfg.threshold_time)
        # analytic mode: PCA rows replaced by per-edge epoch statistics
        m = self.cfg.n_edges
        s1 = np.zeros((m + 1, self.cfg.n_pca), np.float32)
        s1[0, 0] = self.acc
        s1[1:, 0] = self._h_edges[:, 0] / 100.0
        s1[1:, 1] = self._h_edges[:, 2] / 50.0
        s3 = np.array([[self.k / 50.0,
                        self.t_re / self.cfg.threshold_time,
                        self.acc]], np.float32)
        s2 = self._h_edges / np.array([[100.0, 100.0, 50.0]], np.float32)
        return np.concatenate([s1, np.concatenate([s3, s2], 0)], axis=1)

    def step(self, action: np.ndarray):
        """action: (2M,) raw continuous; projected to gamma in
        [1, gamma_max]^2M (nearest feasible point: clip(round(.)))."""
        cfg = self.cfg
        m = cfg.n_edges
        a = np.clip(np.round(np.asarray(action)), 1, cfg.gamma_max)
        g1 = a[:m].astype(np.int64)
        g2 = a[m:].astype(np.int64)
        acc_old = self.acc
        h_edges, t_use, e_tot = self._run_round(g1, g2)
        self.t_re -= t_use
        self.k += 1
        self._h_edges = h_edges
        r = reward_mod.reward(self.acc, acc_old, e_tot, cfg.epsilon)
        done = self.t_re < 0
        self.energy_hist.append(e_tot)
        self.acc_hist.append(self.acc)
        self.time_hist.append(t_use)
        info = {"acc": self.acc, "energy": e_tot, "t_use": t_use,
                "t_re": self.t_re, "g1": g1, "g2": g2}
        self._observe_health(info)
        return self._state(), float(r), bool(done), info

    def _observe_health(self, info: dict, *, flushed: bool = True) -> None:
        """Feed the (optional) health monitor and surface its new events
        in ``info["health"]``. Reads only -- no state change, no draw --
        so health-on vs health-off trajectories are bitwise the same. The
        bank check reads the global model on its device with one host
        read. May raise :class:`HealthAbort` when the opt-in abort policy
        is armed and a critical event fires."""
        if self.health is None:
            return
        bank_finite = None
        if (flushed and self.cfg.mode == "real"
                and self.health.cfg.check_bank):
            vec = getattr(self, "_global_vec", None)
            leaves = ([vec] if vec is not None    # async: flat global
                      else list(self.global_model.values()))
            bank_finite = bool(torch.stack(
                [torch.isfinite(t).all() for t in leaves]).all())
        info["health"] = [e.to_dict() for e in self.health.observe(
            step=self.k,
            sim_time=self.cfg.threshold_time - self.t_re,
            acc=self.acc, flushed=flushed, bank_finite=bank_finite)]

    # hooks for baselines --------------------------------------------------
    def set_topology(self, edge_assign: np.ndarray) -> None:
        """Replace the device->edge assignment (the profiling module's
        periodic re-cluster, paper 3.1)."""
        self.edge_assign = np.asarray(edge_assign, np.int64)
        self._edge_assign_t = self.agg_ctx.place_rows(torch.as_tensor(
            self.edge_assign.astype(np.int32), device=self.device))
        self._edge_sizes = np.array(
            [np.sum(self.edge_assign == j) * self.cfg.n_local
             for j in range(self.cfg.n_edges)], np.float32)

    def run_fixed(self, g1: int, g2: int,
                  participate: Optional[np.ndarray] = None):
        """One round at uniform frequencies (Vanilla-HFL / Favor / etc.)."""
        m = self.cfg.n_edges
        return self.step_raw(np.full(m, g1), np.full(m, g2), participate)

    def step_raw(self, g1: np.ndarray, g2: np.ndarray,
                 participate: Optional[np.ndarray] = None):
        acc_old = self.acc
        h_edges, t_use, e_tot = self._run_round(
            np.asarray(g1, np.int64), np.asarray(g2, np.int64), participate)
        self.t_re -= t_use
        self.k += 1
        self._h_edges = h_edges
        r = reward_mod.reward(self.acc, acc_old, e_tot, self.cfg.epsilon)
        self.energy_hist.append(e_tot)
        self.acc_hist.append(self.acc)
        self.time_hist.append(t_use)
        info = {"acc": self.acc, "energy": e_tot, "t_use": t_use,
                "t_re": self.t_re}
        self._observe_health(info)
        return self._state(), float(r), bool(self.t_re < 0), info

    @property
    def state_shape(self):
        return (self.cfg.n_edges + 1, self.cfg.n_pca + 3)

    @property
    def action_dim(self):
        return 2 * self.cfg.n_edges


# ---------------------------------------------------------------------------
# event-driven asynchronous mode (repro_torch.runtime)
# ---------------------------------------------------------------------------

class AsyncHFLEnv(HFLEnv):
    """Event-driven asynchronous HFL: edges report on their own clocks.

    The port of ``repro.sim.env.AsyncHFLEnv``. Each edge trains
    continuously: it downloads the current global model, runs its
    (gamma1, gamma2) round, and posts an *upload event* after its
    simulated per-edge duration (``repro_torch.runtime.clock``). The
    cloud holds uploads in a FedBuff-style buffer
    (``repro_torch.runtime.buffer``) and advances the global model --
    with staleness-decayed weights ``w_j s(tau_j)`` -- once ``buffer_k``
    updates are in.

    One env **step = one upload event**: the action ``(gamma1, gamma2)``
    programs the *next* round of the edge whose upload was just
    processed (``action_dim`` 2). The observation appends six columns to
    the synchronous state: per-edge staleness, in-flight status, a
    deciding-edge one-hot (row 0 carries the buffer fill fraction), and
    the fault columns: dropped-upload counts, pending-retry attempts,
    and an outage/departed flag.

    **Faults** (``repro_torch.runtime.faults``): a :class:`FaultSpec`
    injects per-edge upload dropout, transient failures with capped
    exponential-backoff retries, edge-outage windows and join/leave
    churn, all as events on the same queue. ``AsyncConfig.
    flush_deadline`` adds graceful degradation: a buffer that cannot
    reach K in time flushes the survivors with coverage-corrected
    weights (the current global vector anchors the missing mass). A
    null or omitted spec gives the fault-free runtime.

    **Kernels** (real mode): every landed upload realises one
    ``hfl.make_edge_round`` (1 + gamma2 ``segment_agg`` and gamma2
    ``segment_broadcast`` launches); every applied flush is one
    ``segment_agg`` launch; every join resyncs the joining edge's rows
    with one ``segment_broadcast`` (``hfl.masked_resync``).

    **Draws.** The numpy generator makes the reference's draws in the
    reference's order. The reference keys the edge round trained from
    version v with ``fold_in(abase, v)``, ``abase`` split from its key
    chain right after the warmup round; here ``edge_perm_source(v)``
    returns that round's ``(gamma_max, gamma_max, N, n_local)`` shuffles.
    Its default draws one base seed per episode from the round generator
    after the warmup round and seeds a generator with ``base + v``: two
    uploads trained from one version get the same shuffles, which is
    what makes a zero-decay, ``buffer_k == n_edges`` first flush the
    synchronous round.

    The snapshot an upload trains from is the ``_global_vec`` tensor of
    its launch; a flush assigns a new tensor and nothing writes one in
    place, so the snapshot keeps its version.

    **Observation.** ``telemetry`` (a :class:`Telemetry`; default: an
    enabled one iff ``EnvConfig.telemetry``) receives the queue's
    schedule/pop events and every round, upload, retry, fault, buffer
    and flush hook; ``health`` as in :class:`HFLEnv`. Neither draws or
    writes runtime state. Crash recovery:
    ``repro_torch.checkpoint.store.save_runtime`` / ``load_runtime``.
    """

    def __init__(self, cfg: EnvConfig, async_cfg=None, faults=None,
                 telemetry=None, health=None, *,
                 init_params: Optional[dict] = None,
                 perm_source: Optional[Callable] = None,
                 edge_perm_source: Optional[Callable] = None):
        super().__init__(cfg, health=health, init_params=init_params,
                         perm_source=perm_source)
        cfg = self.cfg
        self.acfg = async_cfg or AsyncConfig()
        self.buffer_k = self.acfg.buffer_k or cfg.n_edges
        self.faults = faults
        # an explicit facade wins; else EnvConfig.telemetry toggles one
        # on. A disabled facade keeps every hook a no-op and the queue
        # observer None, so the telemetry-off path is unchanged
        if telemetry is None:
            telemetry = (Telemetry() if cfg.telemetry
                         else Telemetry.disabled())
        self.telemetry = telemetry
        # the checkpoint store keeps the state of the env's own draws,
        # not of injected sources
        self._injected_perms = (perm_source is not None
                                or edge_perm_source is not None)
        if cfg.mode == "real":
            self._edge_round = hfl.make_edge_round(
                self._loss_fn, cfg.lr, cfg.batch_size, cfg.n_edges,
                cfg.gamma_max, cfg.gamma_max, ctx=self.agg_ctx,
                deterministic=cfg.deterministic)
            self._edge_perm_source = edge_perm_source or self._edge_perms

    def _edge_perms(self, version: int) -> torch.Tensor:
        """Shuffles of an edge round trained from ``version``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self._edge_perm_base + int(version))
        return self._draw_perms(gen)

    # ------------------------------------------------------------------
    def reset(self) -> np.ndarray:
        cfg = self.cfg
        m = cfg.n_edges
        # placeholders: the superclass warmup round builds a state
        # before the async structures exist
        self.buffer = None
        self._deciding = None
        self._in_flight = np.zeros(m, bool)
        self._staleness = np.zeros(m, np.float32)
        # per-episode fault state: its generator folds the episode index
        # in, so PPO episodes see varied fault traces
        tm = self.telemetry if self.telemetry.enabled else None
        self._injector = FaultInjector(self.faults, m,
                                       seed_offset=self.episode,
                                       telemetry=tm)
        self._incarnation = np.zeros(m, np.int64)
        self._last_action = [(2, 2)] * m
        super().reset()                 # sync warmup round + PCA fit
        self.version = 0
        if cfg.mode == "real":
            self._edge_perm_base = int(torch.randint(
                0, 2**62, (), generator=self._perm_gen, device=self.device))
            self._spec = flatbank.bank_spec(self.bank)
            self._global_vec = self._spec.flatten_model(self.global_model)
            self._edge_mat = self._spec.flatten(self.edge_models)
            self._dev_sizes = self.fed.device_sizes()
            self._edge_w = self.agg_ctx.segment_weight_sums(
                self._dev_sizes, self._edge_assign_t, m).cpu().numpy()
        else:
            self._edge_w = self._edge_sizes.copy()
        self.queue = EventQueue()
        self.queue.now = cfg.threshold_time - self.t_re  # after warmup
        # fresh trace per episode; the observer is None when telemetry is
        # disabled, so pop/schedule stay untouched
        self.telemetry.begin_episode(self.episode, self.queue.now, m)
        self.queue.observer = tm
        self.buffer = StalenessBuffer(
            self.buffer_k, decay=self.acfg.decay,
            decay_a=self.acfg.decay_a, ctx=self.agg_ctx, telemetry=tm,
            clock=self.queue, device=self.device)
        self.n_flushes = 0
        self._edge_version = np.zeros(m, np.int64)
        self._last_time = self.queue.now
        self._last_flush_time = self.queue.now
        self._last_upload_lost = False
        self._flush_info = None
        # declared faults (outage windows, churn) become events on the
        # same queue; a null spec schedules nothing
        self._injector.schedule_initial(self.queue)
        for j in range(m):
            self._launch_round(j, 2, 2)  # warmup frequencies (Alg. 1 l.3)
        ev = self._process_upload()     # first upload picks first decider
        if ev is not None:
            self._deciding = ev.edge
        return self._state()

    # ------------------------------------------------------------------
    def _launch_round(self, edge: int, g1: int, g2: int) -> None:
        """Edge downloads the current global model and starts a
        (gamma1, gamma2) round now; its upload lands after the simulated
        per-edge duration. Departed edges stay dormant until a join
        event relaunches them."""
        if not self._injector.alive[edge]:
            return
        self._last_action[edge] = (int(g1), int(g2))
        cost = edge_round_cost(self.profiles, self.comm, self.edge_assign,
                               edge, g1, g2, self.rng)
        snapshot = self._global_vec if self.cfg.mode == "real" else None
        self.queue.schedule(cost.time, edge, kind="upload",
                            g1=g1, g2=g2, cost=cost, version=self.version,
                            snapshot=snapshot,
                            incarnation=int(self._incarnation[edge]))
        self._edge_version[edge] = self.version
        self._in_flight[edge] = True
        self.telemetry.round_launched(edge, self.queue.now, cost,
                                      g1, g2, self.version)

    # ------------------------------------------------------------------
    # fault-event handlers (repro_torch.runtime.faults)
    # ------------------------------------------------------------------
    def _handle_leave(self, j: int) -> None:
        """Mobility churn: edge ``j`` departs. Its in-flight round is
        voided (the incarnation bump makes the pending upload a ghost);
        its bank rows stay bit-identical until it rejoins."""
        fi = self._injector
        if not fi.alive[j]:
            return
        fi.alive[j] = False
        fi.retry_pending[j] = 0
        self._incarnation[j] += 1
        self._in_flight[j] = False
        self.telemetry.churn(j, self.queue.now, "leave")

    def _handle_join(self, j: int) -> None:
        """Mobility churn: edge ``j`` (re)joins. Real mode resyncs only
        the joining edge's bank rows to the current global model
        (``hfl.masked_resync``, one ``segment_broadcast``; every other
        row comes back bit-identical), then the edge relaunches with its
        last programmed frequencies."""
        fi = self._injector
        if fi.alive[j]:
            return
        fi.alive[j] = True
        self._incarnation[j] += 1
        self.telemetry.churn(j, self.queue.now, "join")
        if self.cfg.mode == "real":
            self._edge_mat[j] = self._global_vec.to(self._edge_mat.dtype)
            mat = hfl.masked_resync(self._edge_mat,
                                    self._spec.flatten(self.bank),
                                    self._edge_assign_t,
                                    np.arange(self.cfg.n_edges) == j,
                                    ctx=self.agg_ctx)
            self.bank = self._spec.unflatten(mat)
            self.edge_models = self._spec.unflatten(self._edge_mat)
        self._edge_version[j] = self.version
        g1, g2 = self._last_action[j]
        self._launch_round(j, g1, g2)

    def _maybe_deadline_flush(self) -> None:
        """Graceful degradation: if K has not been met within the flush
        deadline, proceed with the survivors (coverage-corrected)."""
        dl = self.acfg.flush_deadline
        if dl > 0 and len(self.buffer) > 0 and not self.buffer.ready \
                and self.queue.now - self._last_flush_time >= dl:
            self._flush(degraded=True)

    def _process_upload(self):
        """Pop events until one upload lands (or is permanently
        dropped): fault events (outage boundaries, churn, retries) are
        handled in between. Realises the landed upload's training,
        buffers the update, and flushes the cloud when the buffer fills
        (or the flush deadline lapses). Returns ``None`` iff the queue
        drained (every edge departed)."""
        cfg = self.cfg
        fi = self._injector
        while True:
            if not len(self.queue):
                return None
            ev = self.queue.pop()
            kind = ev.kind
            if kind == "outage_start":
                fi.in_outage[ev.edge] = True
                self.telemetry.outage(ev.edge, ev.time, started=True)
            elif kind == "outage_end":
                fi.in_outage[ev.edge] = False
                self.telemetry.outage(ev.edge, ev.time, started=False)
            elif kind == "leave":
                self._handle_leave(ev.edge)
            elif kind == "join":
                self._handle_join(ev.edge)
            else:                                   # an upload attempt
                pay = ev.payload
                if pay.get("incarnation", 0) \
                        != int(self._incarnation[ev.edge]):
                    self.telemetry.ghost_upload(ev.edge, ev.time)
                    continue    # ghost: the edge departed mid-round
                attempt = pay.get("attempt", 0)
                first = pay.get("first_try", ev.time)
                fate = fi.upload_fate(ev.edge, attempt, ev.time, first)
                if fate == "retry":
                    fi.retry_pending[ev.edge] = attempt + 1
                    # capped exponential backoff + a fresh comm-model
                    # upload draw prices the retry
                    delay = fi.retry_delay(self.comm, ev.edge, attempt)
                    self.telemetry.retry_scheduled(ev.edge, ev.time,
                                                   attempt, delay)
                    self.queue.schedule(
                        delay, ev.edge, kind="upload",
                        **{**pay, "attempt": attempt + 1,
                           "first_try": first})
                    self._maybe_deadline_flush()
                    continue
                fi.retry_pending[ev.edge] = 0
                break
            self._maybe_deadline_flush()
        j, pay, cost = ev.edge, ev.payload, ev.payload["cost"]
        lost = fate == "drop"
        self._in_flight[j] = False
        if lost:
            self.telemetry.upload_dropped(j, ev.time, attempt)
        else:
            self.telemetry.upload_landed(
                j, ev.time, pay["version"],
                self.version - pay["version"], attempt)
        if lost:
            # the round's compute (and energy) is spent, but the update
            # never reaches the cloud: nothing is buffered, and in real
            # mode the edge round is not realised (its bank rows keep
            # their previous values)
            pass
        elif cfg.mode == "real":
            self.bank, edge_vec = self._edge_round(
                self.bank, self.fed.x, self.fed.y, self._dev_sizes,
                self._edge_assign_t, j, pay["g1"], pay["g2"],
                pay["snapshot"], self._edge_perm_source(pay["version"]))
            self._edge_mat[j] = edge_vec.to(self._edge_mat.dtype)
            self.edge_models = self._spec.unflatten(self._edge_mat)
            self.buffer.push(j, edge_vec, float(self._edge_w[j]),
                             pay["version"])
        else:
            self.buffer.push(j, None, float(self._edge_w[j]),
                             pay["version"],
                             epochs=pay["g1"] * pay["g2"], g2=pay["g2"])
        self.total_energy += cost.energy
        self._h_edges[j] = np.float32(
            [cost.t_sgd * pay["g1"] * pay["g2"], cost.ec, cost.energy])
        self._flushed = False
        if self.buffer.ready:
            self._flush()
        else:
            self._maybe_deadline_flush()
        self._staleness = np.float32(self.version - self._edge_version)
        dt = self.queue.now - self._last_time
        self._last_time = self.queue.now
        self.t_re = cfg.threshold_time - self.queue.now
        self.energy_hist.append(cost.energy)
        self.acc_hist.append(self.acc)
        self.time_hist.append(dt)
        self._last_upload_lost = lost
        return ev

    def _flush(self, degraded: bool = False) -> None:
        """Cloud aggregation of the buffered updates (staleness-decayed
        weights); bumps the model version and re-measures accuracy.

        ``degraded=True`` is the deadline path: K was not met, so the
        survivors aggregate with coverage-corrected weights -- in real
        mode the current global vector anchors the missing data mass
        (``ref.coverage_aggregate_ref``); the analytic model's coverage
        factor already damps partial flushes."""
        cfg = self.cfg
        anchor, m_w = None, 0.0
        if degraded and cfg.mode == "real":
            missing = max(self.buffer_k - len(self.buffer), 0)
            anchor = self._global_vec
            m_w = float(missing * np.mean(self._edge_w))
        flush_version = self.version
        glob, info = self.buffer.flush(self.version,
                                       self.acfg.max_staleness,
                                       anchor=anchor, anchor_weight=m_w)
        info["degraded"] = degraded
        self._flush_info = info
        applied = False
        if cfg.mode == "real":
            if glob is not None:
                self._global_vec = glob
                self.global_model = self._spec.unflatten_model(glob)
                self.acc = self._test_accuracy()
                applied = True
        elif info["edges"]:
            self.acc = self._analytic_flush(info)
            applied = True
        if applied:
            self.version += 1
            self.n_flushes += 1
            self.k += 1
        self._flushed = applied
        # reset the deadline clock even for a vacuous flush (every slot
        # staleness-dropped) -- otherwise it would re-trigger every event
        self._last_flush_time = self.queue.now
        self.telemetry.flush_event(self.queue.now, flush_version, info,
                                   applied, degraded)

    def _analytic_flush(self, info) -> float:
        """Analytic-mode accuracy update per flush -- the synchronous
        saturating-progress model transplanted to buffered aggregation:

        * each buffered update contributes its per-epoch progress with
          the buffer-normalised staleness weight q_j = w_j s(tau_j) /
          sum w s (a stale update loses influence, it does not shrink
          the step);
        * a partial buffer only represents sum_b w_j / W of the data, so
          progress scales by coverage^cov_pow (K = M fresh reduces
          exactly to the synchronous update);
        * staleness adds to the gamma2 penalty via the mean buffer tau.
        """
        cfg = self.cfg
        slots = info["meta"]
        epochs = np.float64([s["epochs"] for s in slots])
        p = 1.0 - np.exp(-cfg.a_rate * epochs)
        q = np.float64(info["weights"])
        q = q / max(q.sum(), 1e-12)                  # within-buffer norm
        coverage = float(sum(self._edge_sizes[j]
                             for j in set(info["edges"]))
                         / self._edge_sizes.sum())
        info["coverage"] = coverage
        progress = float(np.sum(q * p)) * coverage ** cfg.cov_pow
        drift = cfg.drift_coef * float(np.std(epochs)) / max(
            float(np.mean(epochs)), 1.0) * cfg.a_rate
        g2s = np.float64([s["g2"] for s in slots])
        stale = cfg.stale_coef * cfg.a_rate * (
            float(np.mean(np.maximum(g2s - 4, 0)))
            + float(np.mean(info["staleness"])))
        gap = cfg.a_max - self.acc
        noise = self.rng.normal(0, cfg.noise)
        new = self.acc + gap * max(progress - drift - stale, 0.0) + noise
        return float(np.clip(new, 0.05, cfg.a_max))

    # ------------------------------------------------------------------
    def step(self, action: np.ndarray):
        """action: (2,) raw continuous (gamma1, gamma2) for the deciding
        edge's next round (the synchronous env's projection). Advances
        the simulation by exactly one upload event."""
        cfg = self.cfg
        a = np.clip(np.round(np.asarray(action).reshape(-1)[:2]), 1,
                    cfg.gamma_max).astype(np.int64)
        acc_old = self.acc
        if self._deciding is not None:
            self._launch_round(self._deciding, int(a[0]), int(a[1]))
        ev = self._process_upload()
        if ev is None:
            # the queue drained: every edge departed (mobility churn)
            # and nothing can ever arrive again -- terminal state
            self._deciding = None
            self.telemetry.fleet_down(self.queue.now)
            info = {"acc": self.acc, "energy": 0.0, "t_use": 0.0,
                    "t_re": self.t_re, "edge": -1, "g1": 0, "g2": 0,
                    "flushed": False, "version": self.version,
                    "staleness": self._staleness.copy(),
                    "fleet_down": True, "dropped": False}
            self._observe_health(info, flushed=False)
            if self.telemetry.enabled:
                info["telemetry"] = self.telemetry.metrics.brief()
            return self._state(), 0.0, True, info
        self._deciding = ev.edge
        cost = ev.payload["cost"]
        r = reward_mod.reward(self.acc, acc_old, cost.energy, cfg.epsilon)
        done = self.t_re < 0
        info = {"acc": self.acc, "energy": cost.energy,
                "t_use": self.time_hist[-1], "t_re": self.t_re,
                "edge": ev.edge, "g1": ev.payload["g1"],
                "g2": ev.payload["g2"], "flushed": self._flushed,
                "version": self.version,
                "staleness": self._staleness.copy(),
                "dropped": self._last_upload_lost,
                "retries": int(ev.payload.get("attempt", 0))}
        self._observe_health(info, flushed=self._flushed)
        if self.telemetry.enabled:
            info["telemetry"] = self.telemetry.metrics.brief()
        return self._state(), float(r), bool(done), info

    # ------------------------------------------------------------------
    def _state(self) -> np.ndarray:
        base = super()._state()                      # (M+1, n_pca+3)
        m = self.cfg.n_edges
        extra = np.zeros((m + 1, 6), np.float32)
        if self.buffer is not None:
            extra[0, 0] = len(self.buffer) / max(self.buffer_k, 1)
        extra[1:, 0] = self._staleness / 10.0
        extra[1:, 1] = self._in_flight.astype(np.float32)
        if self._deciding is not None:
            extra[1 + self._deciding, 2] = 1.0
        fi = self._injector
        # fault columns: cumulative dropped uploads, pending retry
        # attempt, and outage/departed status (0.5 = outage, 1 =
        # departed); row 0 carries fleet totals
        extra[1:, 3] = fi.n_dropped / 10.0
        extra[1:, 4] = np.minimum(fi.retry_pending, 10) / 10.0
        extra[1:, 5] = np.where(~fi.alive, 1.0,
                                np.where(fi.in_outage, 0.5, 0.0))
        extra[0, 3] = float(fi.n_dropped.sum()) / 10.0
        extra[0, 4] = float(fi.n_retries.sum()) / 10.0
        extra[0, 5] = float((~fi.alive).sum()) / max(m, 1)
        return np.concatenate([base, extra], axis=1)

    @property
    def state_shape(self):
        return (self.cfg.n_edges + 1, self.cfg.n_pca + 9)

    @property
    def action_dim(self):
        return 2
