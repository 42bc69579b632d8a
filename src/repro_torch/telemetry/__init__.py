"""Trace + metrics telemetry for the async HFL runtime; the port of
``repro.telemetry``.

Arena's scheduler decides sync frequencies from *observed* system
signals, so the runtime's own behavior -- per-edge compute, upload
retries, buffer residency, flushes, outages, churn -- must itself be
observable. This package is that layer:

* :class:`TraceRecorder` (``recorder``) -- sim-clock spans exported as
  Chrome-trace JSON (``chrome://tracing`` / Perfetto) and JSONL;
* :class:`MetricsRegistry` (``metrics``) -- counters / gauges /
  histograms (staleness at flush, survivor coverage, retries, queue
  depth, drops, per-edge upload latency) with per-episode snapshots;
* :mod:`ktime` -- opt-in timing of the ``segment_agg`` /
  ``segment_broadcast`` kernel launches into the same registry shape
  (CUDA events on the card, the host clock on the CPU);
* :mod:`ledger` -- the persistent run ledger (:class:`RunLedger`):
  append-only JSONL experiment streams recorded by
  ``core.sync.run_scheme``;
* :mod:`health` -- per-run health monitors (:class:`HealthMonitor`):
  NaN/Inf guard, divergence and flush-stall detection, surfaced in
  ``info["health"]`` with an opt-in abort policy.

Everything but ``ktime`` is the reference's standard-library code,
copied. **The no-perturbation invariant** (tests/test_torch_telemetry.py):
telemetry enabled vs disabled reproduces trajectories **bitwise**,
faults included. Collectors observe the event stream; they never draw
RNG, never mutate runtime state, never reorder the queue. A disabled
:class:`Telemetry` is a no-op: every hook returns early, the event queue
keeps a ``None`` observer, and the kernel-timing path is one
module-global check.

Wiring: ``AsyncHFLEnv(cfg, ..., telemetry=Telemetry())`` (or
``EnvConfig(telemetry=True)``); the env installs the queue observer,
hands the buffer/injector their hooks, and plumbs
``metrics.brief()`` into ``info["telemetry"]``. Checkpoints carry
:meth:`Telemetry.state`, so a resumed run emits a seamless trace.
"""
from __future__ import annotations

from repro_torch.telemetry import ktime  # noqa: F401
from repro_torch.telemetry import ledger  # noqa: F401
from repro_torch.telemetry.health import (  # noqa: F401
    HealthAbort, HealthConfig, HealthEvent, HealthMonitor)
from repro_torch.telemetry.ktime import kernel_timing  # noqa: F401
from repro_torch.telemetry.ledger import RunLedger  # noqa: F401
from repro_torch.telemetry.metrics import MetricsRegistry  # noqa: F401
from repro_torch.telemetry.recorder import TraceRecorder  # noqa: F401


class Telemetry:
    """The facade the runtime talks to: semantic hooks that fan out to
    the trace recorder and the metrics registry. Every hook is a no-op
    when ``enabled`` is False."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self.recorder = TraceRecorder()
        self.metrics = MetricsRegistry()
        self.n_edges = 0

    @classmethod
    def disabled(cls) -> "Telemetry":
        return cls(enabled=False)

    # ------------------------------------------------------------------
    # episode lifecycle
    # ------------------------------------------------------------------
    def begin_episode(self, episode: int, now: float,
                      n_edges: int) -> None:
        """Reset both collectors for a fresh episode and lay down the
        ``chrome://tracing`` lane names (one per edge + a cloud lane)."""
        if not self.enabled:
            return
        self.recorder.reset()
        self.metrics.reset()
        self.n_edges = int(n_edges)
        for j in range(n_edges):
            self.recorder.thread_name(j, f"edge-{j}")
        self.recorder.thread_name(n_edges, "cloud")
        self.recorder.instant("episode_begin", "runtime", n_edges, now,
                              episode=episode)

    @property
    def _cloud(self) -> int:
        return self.n_edges

    # ------------------------------------------------------------------
    # event-queue observer protocol (runtime.clock.EventQueue.observer)
    # ------------------------------------------------------------------
    def on_schedule(self, ev, depth: int, now: float) -> None:
        self.metrics.inc("events_scheduled")
        self.metrics.set_gauge("queue_depth", depth)
        self.recorder.counter("queue_depth", now, depth=depth)

    def on_pop(self, ev, depth: int) -> None:
        self.metrics.inc("events_popped")
        self.metrics.set_gauge("queue_depth", depth)
        self.metrics.set_gauge("sim_time_s", ev.time)
        self.recorder.counter("queue_depth", ev.time, depth=depth)

    # ------------------------------------------------------------------
    # per-edge round / upload lifecycle (AsyncHFLEnv)
    # ------------------------------------------------------------------
    def round_launched(self, edge: int, t0: float, cost, g1: int,
                       g2: int, version: int) -> None:
        """One edge round: the compute+comm span is known at schedule
        time ([t0, t0 + cost.time] — the first upload attempt); the
        end-to-end ``upload`` span stays open until the upload lands,
        drops, or is voided (retries extend it)."""
        if not self.enabled:
            return
        self.recorder.span("round", "compute", edge, t0,
                           t0 + cost.time, g1=g1, g2=g2, version=version,
                           t_sgd=cost.t_sgd, ec=cost.ec,
                           energy=cost.energy)
        self.recorder.begin(f"up/{edge}", "upload", "comm", edge, t0,
                            g1=g1, g2=g2, version=version)

    def retry_scheduled(self, edge: int, t: float, attempt: int,
                        delay: float) -> None:
        if not self.enabled:
            return
        self.metrics.inc("retries")
        self.metrics.inc(f"retries/edge{edge}")
        self.recorder.span("backoff", "comm", edge, t, t + delay,
                           attempt=attempt, delay_s=delay)

    def upload_landed(self, edge: int, t: float, version: int,
                      staleness: int, attempt: int) -> None:
        if not self.enabled:
            return
        self.metrics.inc("uploads_landed")
        t0 = self.recorder.end(f"up/{edge}", t, landed=True,
                               attempts=attempt + 1, staleness=staleness)
        if t0 is not None:
            self.metrics.observe(f"upload_latency_s/edge{edge}", t - t0)

    def upload_dropped(self, edge: int, t: float, attempt: int) -> None:
        if not self.enabled:
            return
        self.metrics.inc("uploads_dropped")
        self.metrics.inc(f"uploads_dropped/edge{edge}")
        self.recorder.end(f"up/{edge}", t, landed=False,
                          attempts=attempt + 1)
        self.recorder.instant("drop", "fault", edge, t, attempt=attempt)

    def ghost_upload(self, edge: int, t: float) -> None:
        if not self.enabled:
            return
        self.metrics.inc("ghost_uploads")
        self.recorder.instant("ghost_upload", "fault", edge, t)

    # ------------------------------------------------------------------
    # fault events
    # ------------------------------------------------------------------
    def outage(self, edge: int, t: float, started: bool) -> None:
        if not self.enabled:
            return
        if started:
            self.metrics.inc("outages")
            self.recorder.begin(f"outage/{edge}", "outage", "fault",
                                edge, t)
        else:
            self.recorder.end(f"outage/{edge}", t)

    def churn(self, edge: int, t: float, kind: str) -> None:
        """``leave`` voids the edge's open upload span and opens a
        ``departed`` span; ``join`` closes it."""
        if not self.enabled:
            return
        self.metrics.inc(f"churn_{kind}")
        self.recorder.instant(kind, "fault", edge, t)
        if kind == "leave":
            self.recorder.discard(f"up/{edge}")
            self.recorder.begin(f"down/{edge}", "departed", "fault",
                                edge, t)
        else:
            self.recorder.end(f"down/{edge}", t)

    def fault_fate(self, edge: int, fate: str) -> None:
        """FaultInjector hook: count each upload-fate decision (drawn
        in deterministic event-pop order)."""
        if not self.enabled:
            return
        self.metrics.inc(f"fate_{fate}")

    def fleet_down(self, t: float) -> None:
        if not self.enabled:
            return
        self.recorder.instant("fleet_down", "runtime", self._cloud, t)

    # ------------------------------------------------------------------
    # staleness buffer (runtime.buffer.StalenessBuffer)
    # ------------------------------------------------------------------
    def buffer_push(self, edge: int, t: float, version: int,
                    arrival: int, fill: int, capacity: int) -> None:
        if not self.enabled:
            return
        self.recorder.begin(f"buf/{arrival}", "buffer", "buffer",
                            self._cloud, t, edge=edge, version=version)
        self.metrics.set_gauge("buffer_fill", fill)
        self.recorder.counter("buffer_fill", t, fill=fill,
                              capacity=capacity)

    def buffer_flushed(self, t: float, slots: list, dropped: list)\
            -> None:
        """Close every residency span this flush consumed; observe the
        staleness histogram of the aggregated slots. ``slots`` /
        ``dropped``: lists of ``(arrival, edge, staleness)``."""
        if not self.enabled:
            return
        for arrival, edge, tau in slots:
            self.recorder.end(f"buf/{arrival}", t, staleness=tau,
                              aggregated=True)
            self.metrics.observe("staleness_at_flush", tau)
        for arrival, edge, tau in dropped:
            self.recorder.end(f"buf/{arrival}", t, staleness=tau,
                              aggregated=False)
            self.metrics.inc("buffer_stale_drops")
        self.metrics.set_gauge("buffer_fill", 0)
        self.recorder.counter("buffer_fill", t, fill=0, capacity=0)

    # ------------------------------------------------------------------
    # cloud flushes (AsyncHFLEnv._flush)
    # ------------------------------------------------------------------
    def flush_event(self, t: float, version: int, info: dict,
                    applied: bool, degraded: bool) -> None:
        if not self.enabled:
            return
        self.metrics.inc("flushes")
        if degraded:
            self.metrics.inc("degraded_flushes")
        cov = info.get("coverage")
        if cov is not None:
            self.metrics.observe("survivor_coverage", float(cov))
        self.recorder.instant(
            "flush", "cloud", self._cloud, t, version=version,
            applied=applied, degraded=degraded,
            edges=list(info.get("edges", [])),
            staleness=list(info.get("staleness", [])),
            coverage=cov)

    # ------------------------------------------------------------------
    # export + checkpointing
    # ------------------------------------------------------------------
    def export_chrome(self, path: str, **other_data) -> None:
        self.recorder.export_chrome(path, **other_data)

    def export_jsonl(self, path: str) -> None:
        self.recorder.export_jsonl(path)

    def span_counts(self) -> dict:
        """Events per lane (``edge-<j>`` / ``cloud``), the
        ``quickstart --trace`` summary."""
        counts: dict = {}
        for ev in self.recorder.events:
            if ev.get("ph") in ("M", "C"):   # metadata + counter rows
                continue                     # are not lane activity
            tid = ev.get("tid", 0)
            lane = "cloud" if tid == self._cloud else f"edge-{tid}"
            counts[lane] = counts.get(lane, 0) + 1
        return counts

    def state(self) -> dict:
        """JSON-ready snapshot for ``checkpoint.store.save_runtime`` --
        resumed runs continue the trace seamlessly."""
        return {"n_edges": self.n_edges,
                "recorder": self.recorder.state(),
                "metrics": self.metrics.state()}

    def set_state(self, st: dict) -> None:
        self.n_edges = int(st["n_edges"])
        self.recorder.set_state(st["recorder"])
        self.metrics.set_state(st["metrics"])
