"""Deterministic event-queue simulator for asynchronous HFL.

The port's own copy of ``repro.runtime.clock`` (pure numpy; the port
imports nothing of the reference). Same classes, same draws in the same
order, so a seeded run schedules the same events bit for bit.

The synchronous env charges every cloud round ``max_j t_edge_j`` — one
straggler edge stalls the whole hierarchy. Here each edge runs its own
clock: it starts a round, trains for ``gamma2 (gamma1 t_sgd + de) + ec``
simulated seconds (the same per-round cost model the synchronous env
uses, sampled from ``repro_torch.sim.hardware``), and posts an *upload event*
when it finishes. The cloud processes uploads strictly in event-time
order; edges whose uploads are still in flight keep training.

Determinism contract: events at equal timestamps pop in scheduling
order (a monotone sequence number breaks ties), and all stochastic
round costs are drawn from the caller's ``numpy`` generator at
*schedule* time — so a fixed seed fixes the whole event trace.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import numpy as np


@dataclasses.dataclass(order=True)
class Event:
    """One scheduled occurrence. Ordering is (time, seq): the payload
    fields never participate in comparisons."""
    time: float
    seq: int
    edge: int = dataclasses.field(compare=False)
    kind: str = dataclasses.field(compare=False, default="upload")
    payload: dict = dataclasses.field(compare=False, default_factory=dict)


class EventQueue:
    """Min-heap of :class:`Event` with a monotone wall clock.

    ``pop`` advances ``now`` to the popped event's time; scheduling into
    the past raises — simulated time never runs backwards.

    ``observer`` (optional, default None) is notified *after* each
    schedule/pop with the event and the new queue depth. Observers are
    pure sinks (``repro_torch.telemetry.Telemetry``); ``AsyncHFLEnv``
    sets one only when its telemetry is enabled, so the telemetry-off
    path stays untouched.
    """

    def __init__(self):
        self._heap: list = []
        self._seq = 0
        self.now = 0.0
        self.observer = None

    def __len__(self) -> int:
        return len(self._heap)

    def schedule(self, delay: float, edge: int, kind: str = "upload",
                 **payload) -> Event:
        """Schedule ``kind`` for ``edge`` at ``now + delay`` (delay >= 0)."""
        if delay < 0:
            raise ValueError(f"cannot schedule into the past: {delay}")
        ev = Event(time=self.now + float(delay), seq=self._seq, edge=edge,
                   kind=kind, payload=payload)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        if self.observer is not None:
            self.observer.on_schedule(ev, len(self._heap), self.now)
        return ev

    def schedule_at(self, time: float, edge: int, kind: str = "upload",
                    **payload) -> Event:
        """Schedule ``kind`` at absolute simulated ``time`` (>= now) —
        the entry point for pre-declared fault windows
        (``repro_torch.runtime.faults``)."""
        return self.schedule(float(time) - self.now, edge, kind, **payload)

    def peek(self) -> Optional[Event]:
        return self._heap[0] if self._heap else None

    def pop(self) -> Event:
        """Next event in (time, seq) order; advances ``now``."""
        if not self._heap:
            raise IndexError("pop from an empty event queue")
        ev = heapq.heappop(self._heap)
        self.now = ev.time
        if self.observer is not None:
            self.observer.on_pop(ev, len(self._heap))
        return ev

    # ------------------------------------------------------------------
    # crash-recovery support (repro_torch.checkpoint.store.save_runtime)
    # ------------------------------------------------------------------
    def events(self) -> list:
        """Pending events in deterministic (time, seq) order — a copy;
        the heap is untouched."""
        return sorted(self._heap)

    def load(self, now: float, seq: int, events) -> None:
        """Rebuild the queue from a checkpoint: pending ``events``
        (each an :class:`Event`), wall clock ``now``, and the monotone
        sequence counter ``seq`` — so resumed runs keep the exact
        (time, seq) ordering and tie-breaks of the interrupted run."""
        self._heap = list(events)
        heapq.heapify(self._heap)
        self._seq = int(seq)
        self.now = float(now)


@dataclasses.dataclass
class RoundCost:
    """Simulated cost of one edge-local round (the h_edges row inputs)."""
    time: float          # gamma2 (gamma1 t_sgd + de) + ec  (seconds)
    energy: float        # sum over the edge's devices of ee*g1*g2 (mAh)
    t_sgd: float         # slowest device's per-epoch seconds
    ec: float            # edge->cloud sync seconds


def edge_round_cost(profiles, comm, edge_assign: np.ndarray, edge: int,
                    g1: int, g2: int, rng: np.random.Generator,
                    participate: Optional[np.ndarray] = None) -> RoundCost:
    """Simulated cost of one *edge-local* round of edge ``edge``:
    gamma2 edge syncs of gamma1 local epochs plus one cloud upload — the
    per-edge term of the synchronous round's cost, without the
    cross-edge max.

    Samples fresh per-epoch jitter from ``rng`` (same models the
    synchronous env uses: ``DeviceProfiles.epoch_time/epoch_energy``,
    ``CommModel.ec_time/de_time``), so async and sync runs face the same
    hardware distribution.
    """
    m = len(comm.edge_region)
    et = profiles.epoch_time(rng)
    ee = profiles.epoch_energy(rng)
    ec = float(comm.ec_time(rng)[edge])
    de = float(comm.de_time(rng, m)[edge])
    sel = np.asarray(edge_assign) == edge
    if participate is not None:
        sel = sel & np.asarray(participate, bool)
    if not sel.any():
        return RoundCost(time=ec, energy=0.0, t_sgd=0.0, ec=ec)
    t_sgd = float(et[sel].max())
    energy = float((ee[sel] * g1 * g2).sum())
    return RoundCost(time=float(g2 * (g1 * t_sgd + de) + ec),
                     energy=energy, t_sgd=t_sgd, ec=ec)
