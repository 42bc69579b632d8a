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

Not ported yet, and refused when set: ``EnvConfig.agg`` with a mesh,
``mesh``, ``telemetry`` and ``health``; ``AsyncHFLEnv``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import hfl, pca, profiling
from repro_torch.core import reward as reward_mod
from repro_torch.core import state as state_mod
from repro_torch.data import federated, synthetic
from repro_torch.device import resolve_device
from repro_torch.models import model as model_mod
from repro_torch.sim import hardware


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
    # not ported yet: multi-GPU aggregation context, the deprecated mesh
    # spelling, telemetry and health monitors
    agg: Optional[object] = None
    mesh: Optional[object] = None
    telemetry: bool = False
    health: bool = False
    # analytic-mode calibration
    a_max: float = 0.80
    a_rate: float = 0.016            # per-local-epoch progress rate
    drift_coef: float = 0.25         # non-IID drift per unbalanced epoch
    stale_coef: float = 0.015        # large-gamma2 staleness penalty
    noise: float = 0.004
    cov_pow: float = 0.5             # async coverage exponent (unused here)
    device: str = "cuda"             # where the env's tensors live

    def fixup(self) -> "EnvConfig":
        if self.task == "cifar" and self.threshold_time == 3000.0:
            # the reference's CIFAR schedule: T=12000 s, lr=0.01, reward
            # weight rescaled to its 50-device energy total
            return dataclasses.replace(self, threshold_time=12000.0,
                                       lr=0.01, epsilon=0.004,
                                       n_local=1000)
        return self


def _refuse_unported(cfg: EnvConfig, health) -> None:
    if cfg.agg is not None and not isinstance(cfg.agg, hfl.AggContext):
        raise NotImplementedError(
            "EnvConfig.agg: only repro_torch.core.hfl.AggContext."
            "single_chip() is ported; the multi-GPU bank is ROADMAP item 10")
    if cfg.mesh is not None:
        raise NotImplementedError("EnvConfig.mesh: the multi-GPU bank is "
                                  "not ported yet (ROADMAP item 10)")
    if cfg.telemetry:
        raise NotImplementedError("EnvConfig.telemetry: telemetry is not "
                                  "ported yet (ROADMAP item 9)")
    if cfg.health or health is not None:
        raise NotImplementedError("health monitors are not ported yet "
                                  "(ROADMAP item 9)")


class HFLEnv:
    """Gym-ish: reset() -> state; step(a) -> (state, reward, done, info)."""

    def __init__(self, cfg: EnvConfig, health=None, *,
                 init_params: Optional[dict] = None,
                 perm_source: Optional[Callable] = None):
        cfg = cfg.fixup()
        _refuse_unported(cfg, health)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.agg_ctx = cfg.agg or hfl.AggContext.single_chip()
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
            apply_fn = self._apply_fn
            self._loss_fn = lambda p, b: model_mod.cnn_loss(apply_fn, p, b)
            self._cloud_round = hfl.make_cloud_round(
                self._loss_fn, cfg.lr, cfg.batch_size, cfg.n_edges,
                cfg.gamma_max, cfg.gamma_max, ctx=self.agg_ctx)
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
    def _draw_perms(self) -> torch.Tensor:
        """One round's shuffles, (gamma_max, gamma_max, N, n_local)."""
        g = self.cfg.gamma_max
        shape = (g, g, self.cfg.n_devices, self.fed.n_local)
        keys = torch.rand(shape, generator=self._perm_gen,
                          device=self.device)
        return keys.argsort(dim=-1, stable=True)

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
        p0 = self._w0()
        if cfg.mode == "real":
            self.bank = hfl.broadcast_model(p0, cfg.n_devices)
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
            part = torch.as_tensor(np.asarray(participate, np.float32),
                                   device=self.device)
            sizes = self.fed.device_sizes() * part
            self.bank, self.global_model, self.edge_models = \
                self._cloud_round(
                    self.bank, self.fed.x, self.fed.y, sizes,
                    self._edge_assign_t, np.minimum(g1, cfg.gamma_max),
                    np.minimum(g2, cfg.gamma_max), self._perm_source())
            with torch.no_grad():
                acc = float(model_mod.cnn_accuracy(
                    self._apply_fn, self.global_model,
                    {"x": self.fed.test_x, "y": self.fed.test_y}))
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
        return self._state(), float(r), bool(done), info

    # hooks for baselines --------------------------------------------------
    def set_topology(self, edge_assign: np.ndarray) -> None:
        """Replace the device->edge assignment (the profiling module's
        periodic re-cluster, paper 3.1)."""
        self.edge_assign = np.asarray(edge_assign, np.int64)
        self._edge_assign_t = torch.as_tensor(
            self.edge_assign.astype(np.int32), device=self.device)
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
        return self._state(), float(r), bool(self.t_re < 0), info

    @property
    def state_shape(self):
        return (self.cfg.n_edges + 1, self.cfg.n_pca + 3)

    @property
    def action_dim(self):
        return 2 * self.cfg.n_edges
