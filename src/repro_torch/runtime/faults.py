"""Deterministic fault injection for the async HFL runtime.

The port's own copy of ``repro.runtime.faults`` (pure numpy; the port
imports nothing of the reference). The fault model is data, not code
paths scattered through the simulator:

* :class:`FaultSpec` -- a declarative, seeded description of everything
  that can go wrong: per-edge permanent upload dropout, transient
  upload failures (retryable), edge-outage windows, and mobility churn
  as join/leave events.
* :class:`FaultInjector` -- the runtime half: it owns a *dedicated*
  ``numpy`` generator (``spec.seed`` plus the episode index), schedules
  outage/churn boundaries as first-class events into the deterministic
  :class:`repro_torch.runtime.clock.EventQueue`, decides the fate of
  each upload in pop order, and prices retries from the
  ``sim.hardware`` comm model with capped exponential backoff.

Determinism contract (``tests/test_torch_runtime.py`` holds it against
the reference):

* same seed + same spec => the same trajectory -- all fault randomness
  flows through the injector's own generator, drawn in the
  deterministic event-pop order, and never touches the environment's
  round-cost generator;
* an all-zeros (null) spec schedules no events and makes **no draws**,
  so the runtime reproduces the fault-free trajectory exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class Outage:
    """Edge ``edge`` cannot reach the cloud during
    ``[start, start + duration)`` (simulated seconds, absolute event
    time). Uploads landing inside the window fail transiently and
    retry; training on the edge continues (the outage models the
    uplink, not the devices)."""
    edge: int
    start: float
    duration: float


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    """Mobility churn: edge ``edge`` leaves or (re)joins the fleet at
    absolute simulated time ``time``. ``leave`` voids the edge's
    in-flight round (its upload never lands); ``join`` resyncs the
    edge from the current global model and relaunches it with its last
    programmed frequencies."""
    time: float
    edge: int
    kind: str          # "leave" | "join"

    def __post_init__(self):
        if self.kind not in ("leave", "join"):
            raise ValueError(f"churn kind must be leave|join, "
                             f"got {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Seeded, declarative fault model for one async run.

    ``drop_prob`` -- probability an upload is *permanently* lost
    (device dropout mid-round; the update never reaches the cloud).
    Scalar, or a per-edge sequence.
    ``transient_prob`` -- probability any upload attempt fails
    transiently (congestion, flaky link); the edge retries with capped
    exponential backoff until ``max_retries``/``retry_timeout``.
    ``outages`` / ``churn`` -- scheduled edge-outage windows and
    join/leave events, injected as first-class clock events.

    The default-constructed spec is *null*: :attr:`enabled` is False
    and the runtime takes exactly the fault-free code path.
    """
    drop_prob: Union[float, Sequence[float]] = 0.0
    transient_prob: float = 0.0
    outages: tuple = ()
    churn: tuple = ()
    max_retries: int = 3
    backoff_base: float = 2.0        # first retry waits ~base seconds
    backoff_cap: float = 60.0        # ... doubling up to this cap
    retry_timeout: float = 300.0     # give up retrying this long after
                                     # the first attempt (0 = no limit)
    seed: int = 0

    @property
    def enabled(self) -> bool:
        return bool(np.any(np.asarray(self.drop_prob) > 0)
                    or self.transient_prob > 0
                    or self.outages or self.churn)

    def drop_prob_per_edge(self, n_edges: int) -> np.ndarray:
        p = np.asarray(self.drop_prob, np.float64)
        if p.ndim == 0:
            return np.full(n_edges, float(p))
        if p.shape != (n_edges,):
            raise ValueError(f"drop_prob must be scalar or ({n_edges},), "
                             f"got shape {p.shape}")
        return p

    @staticmethod
    def random(seed: int, n_edges: int, horizon: float) -> "FaultSpec":
        """A seeded chaos spec: random (but reproducible) dropout,
        transient-failure rate, one outage window, and one leave/join
        churn pair inside ``horizon``."""
        rng = np.random.default_rng(seed)
        edge_out = int(rng.integers(n_edges))
        edge_churn = int(rng.integers(n_edges))
        t0 = float(rng.uniform(0.1, 0.5) * horizon)
        t1 = float(rng.uniform(0.2, 0.6) * horizon)
        return FaultSpec(
            drop_prob=rng.uniform(0.0, 0.3, size=n_edges).round(3).tolist(),
            transient_prob=float(rng.uniform(0.0, 0.3)),
            outages=(Outage(edge_out, t0, float(rng.uniform(0.05, 0.25)
                                                * horizon)),),
            churn=(ChurnEvent(t1, edge_churn, "leave"),
                   ChurnEvent(min(t1 + 0.25 * horizon, 0.95 * horizon),
                              edge_churn, "join")),
            max_retries=int(rng.integers(1, 4)),
            backoff_base=float(rng.uniform(0.5, 4.0)),
            retry_timeout=float(0.3 * horizon),
            seed=seed)


# upload fates the injector can decide
OK, RETRY, DROP = "ok", "retry", "drop"

# fault event kinds injected into the clock queue (first-class events,
# alongside the runtime's "upload")
FAULT_KINDS = ("outage_start", "outage_end", "leave", "join")


class FaultInjector:
    """Runtime fault state for one episode: a dedicated generator for
    all fault randomness, per-edge outage/alive bookkeeping, and
    drop/retry statistics (surfaced in ``AsyncHFLEnv``'s observation).

    All decisions are made in the deterministic event-pop order of the
    clock, so a fixed ``spec`` fixes the whole fault trace. A null spec
    makes no draws at all (``upload_fate`` short-circuits to ``ok``).
    ``telemetry`` (a ``repro_torch.telemetry.Telemetry``, or None) is a
    pure observer: it counts each fate decision and is never drawn from.
    """

    def __init__(self, spec: Optional[FaultSpec], n_edges: int,
                 seed_offset: int = 0, telemetry=None):
        self.spec = spec or FaultSpec()
        self.n_edges = int(n_edges)
        # seed_offset folds the episode index in, so PPO training sees a
        # varied fault trace per episode while staying reproducible
        self.rng = np.random.default_rng(self.spec.seed + int(seed_offset))
        self._drop_p = self.spec.drop_prob_per_edge(n_edges)
        self.in_outage = np.zeros(n_edges, bool)
        self.alive = np.ones(n_edges, bool)
        self.n_dropped = np.zeros(n_edges, np.int64)
        self.n_retries = np.zeros(n_edges, np.int64)
        self.retry_pending = np.zeros(n_edges, np.int64)
        self.telemetry = telemetry

    # ------------------------------------------------------------------
    def schedule_initial(self, queue) -> None:
        """Inject every scheduled fault (outage boundaries, churn) as
        first-class events into the clock. Windows already past the
        queue's current time are clamped to fire immediately (the
        warmup round consumes simulated time before the async phase
        starts)."""
        if not self.spec.enabled:
            return
        now = queue.now
        for o in self.spec.outages:
            queue.schedule(max(o.start - now, 0.0), o.edge,
                           kind="outage_start")
            queue.schedule(max(o.start + o.duration - now, 0.0), o.edge,
                           kind="outage_end")
        for c in self.spec.churn:
            queue.schedule(max(c.time - now, 0.0), c.edge, kind=c.kind)

    # ------------------------------------------------------------------
    def upload_fate(self, edge: int, attempt: int, now: float,
                    first_try: float) -> str:
        """Decide what happens to an upload attempt popping now.

        Order (fixed for determinism): an outage forces a retry without
        consuming a draw; a first attempt draws permanent dropout; every
        attempt then draws transient failure. Retry budget/timeout
        exhaustion converts a would-be retry into a drop.
        """
        spec = self.spec
        if not spec.enabled:
            return OK
        fate = self._decide(edge, attempt, now, first_try)
        if self.telemetry is not None:
            self.telemetry.fault_fate(edge, fate)
        return fate

    def _decide(self, edge: int, attempt: int, now: float,
                first_try: float) -> str:
        spec = self.spec
        if self.in_outage[edge]:
            return self._retry_or_drop(edge, attempt, now, first_try)
        if attempt == 0 and self._drop_p[edge] > 0 \
                and self.rng.random() < self._drop_p[edge]:
            self.n_dropped[edge] += 1
            return DROP
        if spec.transient_prob > 0 \
                and self.rng.random() < spec.transient_prob:
            return self._retry_or_drop(edge, attempt, now, first_try)
        return OK

    def _retry_or_drop(self, edge: int, attempt: int, now: float,
                       first_try: float) -> str:
        spec = self.spec
        timed_out = (spec.retry_timeout > 0
                     and now - first_try >= spec.retry_timeout)
        if attempt >= spec.max_retries or timed_out:
            self.n_dropped[edge] += 1
            return DROP
        self.n_retries[edge] += 1
        return RETRY

    def retry_delay(self, comm, edge: int, attempt: int) -> float:
        """Seconds until the retry lands: capped exponential backoff
        plus a *fresh* edge->cloud upload drawn from the ``sim.hardware``
        comm model (the retry re-pays the link, jitter included) --
        priced from the injector's generator so the environment's
        round-cost stream is untouched."""
        spec = self.spec
        backoff = min(spec.backoff_base * (2.0 ** attempt),
                      spec.backoff_cap)
        return backoff + comm.ec_time_edge(self.rng, edge)

    # ------------------------------------------------------------------
    # crash-recovery support (repro_torch.checkpoint.store.save_runtime)
    # ------------------------------------------------------------------
    def state(self) -> dict:
        return {"rng": self.rng.bit_generator.state,
                "in_outage": self.in_outage.tolist(),
                "alive": self.alive.tolist(),
                "n_dropped": self.n_dropped.tolist(),
                "n_retries": self.n_retries.tolist(),
                "retry_pending": self.retry_pending.tolist()}

    def set_state(self, st: dict) -> None:
        self.rng.bit_generator.state = st["rng"]
        self.in_outage = np.asarray(st["in_outage"], bool)
        self.alive = np.asarray(st["alive"], bool)
        self.n_dropped = np.asarray(st["n_dropped"], np.int64)
        self.n_retries = np.asarray(st["n_retries"], np.int64)
        self.retry_pending = np.asarray(st["retry_pending"], np.int64)
