"""Per-run health monitors for the HFL envs.

The port's own copy of ``repro.telemetry.health`` (standard library
only). A training run can go wrong in ways the reward curve only shows after
the fact: the model bank picks up a NaN/Inf and every later accuracy
is garbage, accuracy collapses mid-run (divergence), or the async
cloud stops flushing because every upload drops or retries forever.
:class:`HealthMonitor` watches for exactly those three failure
families and emits structured :class:`HealthEvent` rows that

* ride ``info["health"]`` out of every ``HFLEnv`` / ``AsyncHFLEnv``
  step (the new events observed at that step);
* land in the run ledger as their own JSONL rows
  (``repro_torch.telemetry.ledger``);
* optionally **abort** the run (``HealthConfig(abort=True)`` raises
  :class:`HealthAbort` on critical events — opt-in, for long
  unattended sweeps where a NaN run is pure wasted compute).

Bitwise contract (the telemetry layer's, held in
tests/test_torch_ledger.py): the monitor only *reads* host-side values
-- it never draws RNG, never mutates runtime state -- so health-on vs
health-off trajectories are bitwise-identical unless an opt-in abort
actually fires. The bank check is the env's: with ``check_bank`` it
reads the global model on its device with ``torch.isfinite(...).all()``
and one host read per observation (``HFLEnv._observe_health``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Knobs of the per-run health monitors."""
    window: int = 8              # trailing accuracy window (divergence)
    collapse_drop: float = 0.15  # acc below trailing max by this much
                                 # => divergence event
    stall_events: int = 50       # async: this many upload events with
                                 # no applied flush => flush_stall
    check_bank: bool = True      # real mode: NaN/Inf-guard the global
                                 # model vector (host-side read only)
    abort: bool = False          # raise HealthAbort on critical events


@dataclasses.dataclass(frozen=True)
class HealthEvent:
    """One structured health finding (a ledger row / info["health"]
    entry). ``severity`` is ``"warn"`` (divergence, flush stall) or
    ``"critical"`` (non-finite accuracy or bank)."""
    kind: str                    # nan_acc | nan_bank | divergence
                                 # | flush_stall
    severity: str                # warn | critical
    step: int
    sim_time: float
    detail: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"kind": self.kind, "severity": self.severity,
                "step": self.step, "sim_time": self.sim_time,
                "detail": dict(self.detail)}


class HealthAbort(RuntimeError):
    """Raised (opt-in: ``HealthConfig(abort=True)``) when a critical
    health event fires; carries the triggering events."""

    def __init__(self, events):
        self.events = list(events)
        super().__init__("; ".join(
            f"{e.kind}@step{e.step}" for e in self.events))


class HealthMonitor:
    """Streaming health checks over one episode.

    ``observe()`` is called once per env step with host-side floats
    already computed by the simulation (no extra device work beyond
    the optional bank finiteness read the *env* performs); it returns
    the events newly raised at this step and accumulates all of them
    on :attr:`events` for the ledger. One-shot semantics: each failure
    family fires once and re-arms only after recovery (divergence:
    accuracy back above the trailing max minus half the drop; stall:
    the next applied flush), so a sick run does not spam one row per
    step.
    """

    def __init__(self, cfg: Optional[HealthConfig] = None):
        self.cfg = cfg or HealthConfig()
        self.reset()

    def reset(self) -> None:
        self.events: list = []
        self._window: list = []
        self._nan_seen = False
        self._diverged = False
        self._since_flush = 0
        self._stalled = False

    # ------------------------------------------------------------------
    def observe(self, *, step: int, sim_time: float, acc: float,
                flushed: bool = True,
                bank_finite: Optional[bool] = None) -> list:
        """One env step: returns the list of *new* :class:`HealthEvent`
        rows (usually empty). ``flushed`` is whether this step applied
        a cloud aggregation (sync rounds always do); ``bank_finite``
        is the env's optional NaN/Inf read of the global model."""
        cfg = self.cfg
        new: list = []
        # --- NaN/Inf guard (critical, once per episode) ---------------
        if not self._nan_seen:
            if not math.isfinite(acc):
                self._nan_seen = True
                new.append(HealthEvent("nan_acc", "critical", step,
                                       sim_time, {"acc": repr(acc)}))
            elif bank_finite is False:
                self._nan_seen = True
                new.append(HealthEvent("nan_bank", "critical", step,
                                       sim_time))
        # --- divergence: collapse vs the trailing window --------------
        if len(self._window) >= cfg.window and math.isfinite(acc):
            peak = max(self._window)
            if not self._diverged and acc < peak - cfg.collapse_drop:
                self._diverged = True
                new.append(HealthEvent(
                    "divergence", "warn", step, sim_time,
                    {"acc": acc, "trailing_max": peak,
                     "drop": peak - acc}))
            elif self._diverged and acc >= peak - cfg.collapse_drop / 2:
                self._diverged = False        # recovered: re-arm
        self._window.append(float(acc))
        if len(self._window) > cfg.window:
            del self._window[0]
        # --- flush stall (async: events since last applied flush) -----
        if flushed:
            self._since_flush = 0
            self._stalled = False
        else:
            self._since_flush += 1
            if (not self._stalled and cfg.stall_events > 0
                    and self._since_flush >= cfg.stall_events):
                self._stalled = True
                new.append(HealthEvent(
                    "flush_stall", "warn", step, sim_time,
                    {"events_since_flush": self._since_flush}))
        self.events.extend(new)
        if cfg.abort and any(e.severity == "critical" for e in new):
            raise HealthAbort(new)
        return new

    @property
    def critical(self) -> bool:
        return any(e.severity == "critical" for e in self.events)

    # ------------------------------------------------------------------
    # crash-recovery support (repro_torch.checkpoint.store.save_runtime)
    # ------------------------------------------------------------------
    def state(self) -> dict:
        return {"cfg": dataclasses.asdict(self.cfg),
                "events": [e.to_dict() for e in self.events],
                "window": list(self._window),
                "nan_seen": self._nan_seen,
                "diverged": self._diverged,
                "since_flush": self._since_flush,
                "stalled": self._stalled}

    def set_state(self, st: dict) -> None:
        self.cfg = HealthConfig(**st["cfg"])
        self.events = [HealthEvent(e["kind"], e["severity"], e["step"],
                                   e["sim_time"], dict(e["detail"]))
                       for e in st["events"]]
        self._window = [float(x) for x in st["window"]]
        self._nan_seen = bool(st["nan_seen"])
        self._diverged = bool(st["diverged"])
        self._since_flush = int(st["since_flush"])
        self._stalled = bool(st["stalled"])
