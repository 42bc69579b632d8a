"""Structured trace recorder: sim-clock spans for the async runtime.

The port's own copy of ``repro.telemetry.recorder`` (standard library
only). Turns the event-driven runtime's activity (``repro_torch.runtime``
+ ``AsyncHFLEnv``) into a flat list of trace events in the Chrome Trace
Event Format, timed on the **simulated** clock — so an episode's
timeline opens directly in ``chrome://tracing`` / Perfetto
(``export_chrome``), or streams as JSONL (``export_jsonl``).

Event vocabulary (one ``pid`` 0; ``tid`` = edge index, ``tid`` =
``n_edges`` for the cloud lane):

* complete spans (``ph: "X"``, ``ts``/``dur`` in simulated µs):
  ``round`` (edge compute+comm, cat ``compute``), ``upload`` (launch →
  landing incl. retries, cat ``comm``), ``backoff`` (retry wait, cat
  ``comm``), ``buffer`` (residency: push → flush, cat ``buffer``),
  ``outage`` / ``departed`` (cat ``fault``);
* instants (``ph: "i"``): ``flush`` (args carry staleness, coverage,
  degraded), ``drop``, ``ghost_upload``, ``leave`` / ``join``,
  ``fleet_down``;
* counters (``ph: "C"``): ``queue_depth``, ``buffer_fill``;
* metadata (``ph: "M"``): ``thread_name`` rows per edge + cloud.

Determinism/merge contract: events append in the runtime's
deterministic execution order and carry only values derived from the
simulation, so a fixed seed fixes the byte-exact trace — and a run
resumed from a ``repro_torch.checkpoint.store.save_runtime`` snapshot
(which carries ``state()``) emits the same merged trace as an
uninterrupted run (tests/test_torch_recovery.py). The recorder never
draws RNG and never feeds back into the runtime.
"""
from __future__ import annotations

import json

PID = 0
_US = 1e6          # simulated seconds -> trace microseconds


def _num(v):
    """Coerce numpy scalars to plain Python so the event list (and the
    checkpoint meta it rides in) stays JSON-serializable."""
    if isinstance(v, bool) or v is None or isinstance(v, (int, str)):
        return v
    if isinstance(v, float):
        return v
    if hasattr(v, "item"):
        return v.item()
    if isinstance(v, (list, tuple)):
        return [_num(x) for x in v]
    if isinstance(v, dict):
        return {k: _num(x) for k, x in v.items()}
    return str(v)


class TraceRecorder:
    """Append-only event list + a table of *open* spans (begun, not yet
    ended). Open spans survive checkpoints via :meth:`state` so resumed
    runs close them at the original begin time."""

    def __init__(self):
        self.events: list = []
        self._open: dict = {}

    def __len__(self) -> int:
        return len(self.events)

    def reset(self) -> None:
        self.events = []
        self._open = {}

    # ------------------------------------------------------------------
    # emission primitives (sim-clock seconds in; trace µs out)
    # ------------------------------------------------------------------
    def span(self, name: str, cat: str, tid: int, t0: float, t1: float,
             **args) -> None:
        """One complete (``ph: "X"``) span ``[t0, t1]``."""
        self.events.append({
            "name": name, "cat": cat, "ph": "X", "pid": PID,
            "tid": int(tid), "ts": float(t0) * _US,
            "dur": max(float(t1) - float(t0), 0.0) * _US,
            "args": {k: _num(v) for k, v in args.items()}})

    def instant(self, name: str, cat: str, tid: int, t: float,
                **args) -> None:
        self.events.append({
            "name": name, "cat": cat, "ph": "i", "s": "t", "pid": PID,
            "tid": int(tid), "ts": float(t) * _US,
            "args": {k: _num(v) for k, v in args.items()}})

    def counter(self, name: str, t: float, **values) -> None:
        self.events.append({
            "name": name, "cat": "counter", "ph": "C", "pid": PID,
            "tid": 0, "ts": float(t) * _US,
            "args": {k: _num(v) for k, v in values.items()}})

    def thread_name(self, tid: int, name: str) -> None:
        self.events.append({
            "name": "thread_name", "ph": "M", "pid": PID,
            "tid": int(tid), "ts": 0.0, "args": {"name": name}})

    # ------------------------------------------------------------------
    # open-span bookkeeping (begin now, end when the runtime learns it)
    # ------------------------------------------------------------------
    def begin(self, key: str, name: str, cat: str, tid: int, t0: float,
              **args) -> None:
        self._open[key] = {"name": name, "cat": cat, "tid": int(tid),
                           "t0": float(t0),
                           "args": {k: _num(v) for k, v in args.items()}}

    def end(self, key: str, t1: float, **args):
        """Close the open span ``key`` at ``t1`` and emit it; returns
        its begin time (None when no such span is open — e.g. slots
        restored from a pre-telemetry checkpoint)."""
        sp = self._open.pop(key, None)
        if sp is None:
            return None
        merged = dict(sp["args"])
        merged.update({k: _num(v) for k, v in args.items()})
        self.span(sp["name"], sp["cat"], sp["tid"], sp["t0"], t1,
                  **merged)
        return sp["t0"]

    def discard(self, key: str) -> None:
        """Drop an open span without emitting (voided work: ghosts,
        departed edges)."""
        self._open.pop(key, None)

    def open_t0(self, key: str):
        sp = self._open.get(key)
        return None if sp is None else sp["t0"]

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def chrome_trace(self, **other_data) -> dict:
        """The Chrome Trace Event Format object (open it at
        ``chrome://tracing`` or https://ui.perfetto.dev)."""
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms",
                "otherData": {k: _num(v) for k, v in other_data.items()}}

    def export_chrome(self, path: str, **other_data) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(**other_data), f, indent=1)

    def export_jsonl(self, path: str) -> None:
        """One trace event per line — greppable / streamable."""
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev) + "\n")

    # ------------------------------------------------------------------
    # crash-recovery support (repro_torch.checkpoint.store.save_runtime)
    # ------------------------------------------------------------------
    def state(self) -> dict:
        return {"events": [dict(e) for e in self.events],
                "open": {k: dict(v) for k, v in self._open.items()}}

    def set_state(self, st: dict) -> None:
        self.events = [dict(e) for e in st["events"]]
        self._open = {k: dict(v) for k, v in st["open"].items()}
