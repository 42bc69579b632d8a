"""Metrics registry for the async HFL runtime.

The port's own copy of ``repro.telemetry.metrics`` (standard library
only; the port imports nothing of the reference). A minimal counters /
gauges / histograms registry with per-episode snapshots. Collectors only
*observe*: nothing in here draws RNG, touches a tensor, or feeds back
into the simulation -- the bitwise no-perturbation contract of the
telemetry layer.

Values live as plain Python floats/ints so the whole registry is
JSON-serializable (``state`` / ``set_state`` ride inside
``repro_torch.checkpoint.store.save_runtime`` snapshots).
"""
from __future__ import annotations


def _summary(values: list) -> dict:
    """Five-number summary of one histogram's raw observations."""
    n = len(values)
    if n == 0:
        return {"count": 0}
    ordered = sorted(values)
    return {"count": n,
            "mean": sum(values) / n,
            "min": ordered[0],
            "p50": ordered[n // 2],
            "max": ordered[-1]}


class MetricsRegistry:
    """Counters (monotone), gauges (last value), histograms (raw
    observations, summarized at snapshot time).

    Names are flat strings; per-edge series use a ``/edge<j>`` suffix
    (e.g. ``upload_latency_s/edge0``) so snapshots stay a single dict.
    """

    def __init__(self):
        self.counters: dict = {}
        self.gauges: dict = {}
        self.hists: dict = {}

    # ------------------------------------------------------------------
    def inc(self, name: str, value: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def set_gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        self.hists.setdefault(name, []).append(float(value))

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """Point-in-time, JSON-ready view: counters and gauges verbatim,
        histograms as five-number summaries."""
        return {"counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {k: _summary(v)
                               for k, v in sorted(self.hists.items())}}

    def brief(self) -> dict:
        """The compact per-step view ``AsyncHFLEnv`` plumbs into
        ``info["telemetry"]`` — counters and gauges only (histogram
        summaries are per-episode material, not per-step)."""
        return {"counters": dict(self.counters),
                "gauges": dict(self.gauges)}

    def reset(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.hists.clear()

    # ------------------------------------------------------------------
    # crash-recovery support (repro_torch.checkpoint.store.save_runtime)
    # ------------------------------------------------------------------
    def state(self) -> dict:
        return {"counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "hists": {k: list(v) for k, v in self.hists.items()}}

    def set_state(self, st: dict) -> None:
        self.counters = dict(st["counters"])
        self.gauges = dict(st["gauges"])
        self.hists = {k: list(v) for k, v in st["hists"].items()}
