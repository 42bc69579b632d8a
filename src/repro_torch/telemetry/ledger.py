"""Run ledger: persistent, append-only experiment tracking.

The port's own copy of ``repro.telemetry.ledger`` (standard library
only; the port imports nothing of the reference). Each scheme run
becomes a durable JSONL record stream under ``reports/ledger/``:

* a **header** row -- scheme name, :class:`EnvConfig` /
  ``AsyncConfig`` / ``FaultSpec`` digests, seed, aggregation context,
  package version, resolved scheme parameters;
* one **episode** row per evaluation episode -- the full
  acc/energy/time curves plus the telemetry counters and five-number
  summaries sourced from ``MetricsRegistry.snapshot()`` and
  ``core.sync._history``;
* **health** rows -- the structured
  :class:`~repro_torch.telemetry.health.HealthEvent` findings of the
  run's :class:`HealthMonitor`.

The header records the port's ``EnvConfig`` fields, ``device`` and
``deterministic`` included, so a port run id is not the reference's for
the same experiment; the episode rows are the reference's, field for
field.

**Determinism contract** (tests/test_torch_ledger.py): the ledger draws
no RNG and reads no wall clock. The run id is a content digest of the
header, so the same scheme + config + seed always lands in the same
stream (two consecutive fixed-seed runs append byte-identical episode
rows), and a *resumed* run -- ``checkpoint.store`` carries
``env._ledger_run_id`` -- appends to the original stream rather than
forking a new id. Ledger-on vs ledger-off trajectories are bitwise
identical: recording only reads host-side history/snapshot values.

Wiring: ``sync.run_scheme(name, env, ledger=...)`` records one run;
:func:`enable` installs a process-default ledger so every
``run_scheme`` call records without threading the object through.
:func:`load_run`, :func:`list_runs`, :func:`diff_runs` and
:func:`render_report` read the streams back.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional

from repro_torch.version import __version__

SCHEMA_VERSION = 1
DEFAULT_ROOT = os.path.join("reports", "ledger")


# ---------------------------------------------------------------------------
# canonical JSON + config digests
# ---------------------------------------------------------------------------

def _jsonify(v):
    """Best-effort canonical JSON value: dataclasses recurse, numpy
    scalars/arrays go native, exotic leaves fall back to ``repr``."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: _jsonify(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, (list, tuple)):
        return [_jsonify(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonify(x) for k, x in v.items()}
    if hasattr(v, "tolist"):                       # numpy array
        return _jsonify(v.tolist())
    if hasattr(v, "item"):                         # numpy scalar
        return _jsonify(v.item())
    return repr(v)


def _canon(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _digest(obj) -> str:
    return hashlib.sha256(_canon(obj).encode()).hexdigest()[:12]


def config_digest(obj, exclude: tuple = ()):
    """``(digest, summary)`` of a config dataclass: the summary is its
    JSON-ready field dict (minus ``exclude``), the digest a 12-hex
    content hash of it. ``None`` digests to ``"none"``."""
    if obj is None:
        return "none", None
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        d = {f.name: getattr(obj, f.name)
             for f in dataclasses.fields(obj) if f.name not in exclude}
    elif isinstance(obj, dict):
        d = {k: v for k, v in obj.items() if k not in exclude}
    else:
        d = {"repr": repr(obj)}
    summary = {k: _jsonify(v) for k, v in d.items()}
    return _digest(summary), summary


def mesh_desc(agg_ctx) -> object:
    """JSON-ready mesh shape of an ``hfl.AggContext`` (or ``None``):
    ``"single-chip"``, or the bank mesh's axes and shape."""
    mesh = getattr(agg_ctx, "mesh", None)
    if mesh is None:
        return "single-chip"
    return {"axes": [str(a) for a in mesh.axis_names],
            "shape": {str(k): int(v) for k, v in dict(mesh.shape).items()}}


def run_header(*, scheme: str, env, params: Optional[dict] = None) -> dict:
    """The run's identity record. Pure function of scheme + configs —
    no wall clock, no RNG — so the derived ``run_id`` is stable across
    re-runs of the same experiment."""
    cfg = env.cfg
    env_digest, env_summary = config_digest(cfg, exclude=("agg", "mesh"))
    a_digest, a_summary = config_digest(getattr(env, "acfg", None))
    f_digest, f_summary = config_digest(getattr(env, "faults", None))
    header = {"kind": "header", "schema": SCHEMA_VERSION,
              "scheme": str(scheme), "task": str(cfg.task),
              "mode": str(cfg.mode), "seed": int(cfg.seed),
              "package_version": __version__,
              "env_digest": env_digest, "async_digest": a_digest,
              "fault_digest": f_digest,
              "mesh": mesh_desc(getattr(env, "agg_ctx", None)),
              "params": {k: _jsonify(v)
                         for k, v in sorted((params or {}).items())},
              "env_cfg": env_summary, "async_cfg": a_summary,
              "fault_spec": f_summary}
    header["run_id"] = _digest(header)
    return header


# ---------------------------------------------------------------------------
# the ledger proper
# ---------------------------------------------------------------------------

class RunLedger:
    """Append-only JSONL streams, one file per run id, under ``root``."""

    def __init__(self, root: str = DEFAULT_ROOT):
        self.root = str(root)

    def path(self, run_id: str) -> str:
        return os.path.join(self.root, f"{run_id}.jsonl")

    def _append(self, run_id: str, row: dict) -> None:
        os.makedirs(self.root, exist_ok=True)
        with open(self.path(run_id), "a") as f:
            f.write(_canon(row) + "\n")

    # ------------------------------------------------------------------
    def begin_run(self, *, scheme: str, env,
                  params: Optional[dict] = None) -> str:
        """Open (or re-open) the run's stream and return its id. A
        resumed env (``checkpoint.store`` restores
        ``env._ledger_run_id``) keeps its original id — the resumed
        run appends to the same stream instead of forking a new one.
        The header row is written only when the stream is new."""
        header = run_header(scheme=scheme, env=env, params=params)
        run_id = getattr(env, "_ledger_run_id", None) or header["run_id"]
        header["run_id"] = run_id
        env._ledger_run_id = run_id
        if not os.path.exists(self.path(run_id)):
            self._append(run_id, header)
        return run_id

    def record_episode(self, run_id: str, env, history: dict) -> dict:
        """One episode row: the ``core.sync._history`` curves plus —
        when the env carries enabled telemetry — the episode's counter
        and five-number-summary material from
        ``MetricsRegistry.snapshot()``."""
        row = {"kind": "episode", "schema": SCHEMA_VERSION,
               "run_id": run_id,
               "episode": int(getattr(env, "episode", 0)),
               "rounds": int(history["rounds"]),
               "final_acc": float(history["final_acc"]),
               "total_energy": float(history["total_energy"]),
               "avg_energy": float(history["avg_energy"]),
               "sim_time_s": float(sum(history["time"])),
               "acc": [float(x) for x in history["acc"]],
               "energy": [float(x) for x in history["energy"]],
               "time": [float(x) for x in history["time"]]}
        tm = getattr(env, "telemetry", None)
        if tm is not None and getattr(tm, "enabled", False):
            snap = tm.metrics.snapshot()
            c, h = snap["counters"], snap["histograms"]
            row["flushes"] = int(c.get("flushes", 0))
            row["drops"] = int(c.get("uploads_dropped", 0))
            row["retries"] = int(c.get("retries", 0))
            row["staleness"] = h.get("staleness_at_flush", {"count": 0})
            row["coverage"] = h.get("survivor_coverage", {"count": 0})
        hm = getattr(env, "health", None)
        if hm is not None:
            row["health_events"] = len(hm.events)
            row["healthy"] = not hm.critical
        self._append(run_id, row)
        return row

    def record_health(self, run_id: str, events) -> None:
        for e in events:
            self._append(run_id, {"kind": "health",
                                  "schema": SCHEMA_VERSION,
                                  "run_id": run_id, **e.to_dict()})

    def record_run(self, *, scheme: str, env, history: dict,
                   params: Optional[dict] = None) -> str:
        """The one-call form ``sync.run_scheme`` uses: header (if new)
        + episode row + the health rows of the episode just run."""
        run_id = self.begin_run(scheme=scheme, env=env, params=params)
        self.record_episode(run_id, env, history)
        hm = getattr(env, "health", None)
        if hm is not None and hm.events:
            self.record_health(run_id, hm.events)
        return run_id


# ---------------------------------------------------------------------------
# process-default ledger
# ---------------------------------------------------------------------------

_DEFAULT: Optional[RunLedger] = None


def enable(root: str = DEFAULT_ROOT) -> RunLedger:
    """Install a process-default ledger: every ``sync.run_scheme`` call
    records to it without an explicit ``ledger=`` argument."""
    global _DEFAULT
    _DEFAULT = RunLedger(root)
    return _DEFAULT


def disable() -> None:
    global _DEFAULT
    _DEFAULT = None


def get_default() -> Optional[RunLedger]:
    return _DEFAULT


def resolve(arg) -> Optional[RunLedger]:
    """``run_scheme``'s ``ledger=`` argument: ``None`` falls through to
    the process default, ``False`` forces off, ``True`` means the
    default root, a string/path is a root, a :class:`RunLedger` is
    itself."""
    if arg is None:
        return _DEFAULT
    if arg is False:
        return None
    if arg is True:
        return RunLedger()
    if isinstance(arg, RunLedger):
        return arg
    return RunLedger(str(arg))


# ---------------------------------------------------------------------------
# analysis over recorded streams (stdlib only)
# ---------------------------------------------------------------------------

def load_run(path: str) -> dict:
    """Parse one ``<run_id>.jsonl`` stream into
    ``{"header", "episodes", "health"}``."""
    header, episodes, health = None, [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            kind = row.get("kind")
            if kind == "header" and header is None:
                header = row
            elif kind == "episode":
                episodes.append(row)
            elif kind == "health":
                health.append(row)
    if header is None:
        raise ValueError(f"{path}: no header row")
    return {"header": header, "episodes": episodes, "health": health}


def list_runs(root: str = DEFAULT_ROOT) -> list:
    """Every run under ``root``, sorted by run id (the streams carry
    no wall-clock timestamps — determinism contract), summarized for
    the CLI listing."""
    runs = []
    if not os.path.isdir(root):
        return runs
    for name in sorted(os.listdir(root)):
        if not name.endswith(".jsonl"):
            continue
        try:
            run = load_run(os.path.join(root, name))
        except (ValueError, json.JSONDecodeError):
            continue
        h, eps = run["header"], run["episodes"]
        last = eps[-1] if eps else {}
        runs.append({
            "run_id": h["run_id"], "scheme": h["scheme"],
            "task": h["task"], "mode": h["mode"], "seed": h["seed"],
            "episodes": len(eps),
            "rounds": last.get("rounds"),
            "final_acc": last.get("final_acc"),
            "total_energy": last.get("total_energy"),
            "sim_time_s": last.get("sim_time_s"),
            "health_events": len(run["health"]),
            "critical": any(e.get("severity") == "critical"
                            for e in run["health"]),
            "_run": run})
    return runs


def _flat(prefix: str, d) -> dict:
    if not isinstance(d, dict):
        return {prefix: d}
    out = {}
    for k, v in d.items():
        out.update(_flat(f"{prefix}.{k}", v))
    return out


def diff_runs(run_a: dict, run_b: dict) -> dict:
    """Config delta (flattened header keys that differ) + metric delta
    (last-episode headline metrics) between two loaded runs."""
    ha, hb = run_a["header"], run_b["header"]
    config = {}
    for section in ("scheme", "task", "mode", "seed", "mesh", "params",
                    "env_cfg", "async_cfg", "fault_spec",
                    "package_version"):
        fa = _flat(section, ha.get(section))
        fb = _flat(section, hb.get(section))
        for k in sorted(set(fa) | set(fb)):
            va, vb = fa.get(k), fb.get(k)
            if va != vb:
                config[k] = [va, vb]
    metrics = {}
    ea = run_a["episodes"][-1] if run_a["episodes"] else {}
    eb = run_b["episodes"][-1] if run_b["episodes"] else {}
    for m in ("final_acc", "total_energy", "sim_time_s", "rounds",
              "flushes", "drops", "retries"):
        va, vb = ea.get(m), eb.get(m)
        if va is None and vb is None:
            continue
        delta = (vb - va if isinstance(va, (int, float))
                 and isinstance(vb, (int, float)) else None)
        metrics[m] = {"a": va, "b": vb, "delta": delta}
    return {"a": ha["run_id"], "b": hb["run_id"],
            "config": config, "metrics": metrics}


# ---------------------------------------------------------------------------
# static HTML report (stdlib-only SVG; style per the repo's report
# conventions — fixed-order categorical palette, one axis per chart,
# recessive grid, legend + table view, light/dark via CSS variables)
# ---------------------------------------------------------------------------

# categorical slots, assigned to schemes in fixed first-seen order and
# never cycled: schemes past the 8th render in the muted ink color and
# rely on their direct label + the table view for identity
_SERIES_LIGHT = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100",
                 "#e87ba4", "#008300", "#4a3aa7", "#e34948"]
_SERIES_DARK = ["#3987e5", "#d95926", "#199e70", "#c98500",
                "#d55181", "#008300", "#9085e9", "#e66767"]
_MUTED = ("#8a8984", "#8a8984")


def _fmt(v: float) -> str:
    if v == 0:
        return "0"
    if abs(v) >= 1000:
        return f"{v / 1000:.3g}k"
    return f"{v:.3g}"


def _svg_chart(title: str, xlabel: str, series: list,
               width: int = 460, height: int = 300) -> str:
    """One line chart. ``series``: ``(name, slot, points)`` with
    ``points`` a list of (x, y) — y is accuracy in [0, 1]."""
    ml, mr, mt, mb = 46, 14, 10, 38
    pw, ph = width - ml - mr, height - mt - mb
    xs = [x for _, _, pts in series for x, _ in pts]
    ys = [y for _, _, pts in series for _, y in pts]
    xmax = max(xs) if xs else 1.0
    ymax = max(0.0001, max(ys) if ys else 1.0)
    ymax = min(1.0, ymax * 1.08)
    xmax = xmax or 1.0

    def sx(x):
        return ml + pw * (x / xmax)

    def sy(y):
        return mt + ph * (1.0 - y / ymax)

    out = [f'<svg viewBox="0 0 {width} {height}" role="img" '
           f'aria-label="{title}">']
    # recessive grid + y ticks
    for i in range(5):
        yv = ymax * i / 4
        yy = sy(yv)
        out.append(f'<line x1="{ml}" y1="{yy:.1f}" x2="{width - mr}" '
                   f'y2="{yy:.1f}" class="grid"/>')
        out.append(f'<text x="{ml - 6}" y="{yy + 3.5:.1f}" '
                   f'class="tick" text-anchor="end">{_fmt(yv)}</text>')
    for i in range(5):
        xv = xmax * i / 4
        xx = sx(xv)
        out.append(f'<text x="{xx:.1f}" y="{height - mb + 16}" '
                   f'class="tick" text-anchor="middle">{_fmt(xv)}</text>')
    out.append(f'<line x1="{ml}" y1="{mt + ph}" x2="{width - mr}" '
               f'y2="{mt + ph}" class="axis"/>')
    out.append(f'<text x="{ml + pw / 2:.0f}" y="{height - 6}" '
               f'class="label" text-anchor="middle">{xlabel}</text>')
    label_ok = len(series) <= 4
    for name, slot, pts in series:
        if not pts:
            continue
        cls = f"s{slot}" if slot < len(_SERIES_LIGHT) else "smuted"
        path = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in pts)
        out.append(f'<polyline points="{path}" class="line {cls}"/>')
        # sparse native-tooltip hover targets (stdlib report: no JS)
        step = max(1, len(pts) // 24)
        for x, y in pts[::step]:
            out.append(
                f'<circle cx="{sx(x):.1f}" cy="{sy(y):.1f}" r="7" '
                f'class="hit"><title>{name}: acc {y:.3f} @ '
                f'{_fmt(x)}</title></circle>')
        if label_ok or slot >= len(_SERIES_LIGHT):
            lx, ly = pts[-1]
            out.append(f'<text x="{min(sx(lx) + 4, width - 2):.1f}" '
                       f'y="{sy(ly) - 4:.1f}" class="dlabel">'
                       f'{name}</text>')
    out.append("</svg>")
    return "\n".join(out)


def render_report(root: str = DEFAULT_ROOT,
                  out: str = os.path.join("reports", "ledger.html"))\
        -> str:
    """Static acc-vs-sim-time-vs-energy report (the paper's Fig. 8
    view) over every recorded run, one curve per run colored by scheme
    (fixed first-seen slot order). Returns the output path."""
    runs = list_runs(root)
    slots: dict = {}
    t_series, e_series, table = [], [], []
    for r in runs:
        scheme = r["scheme"]
        if scheme not in slots:
            slots[scheme] = len(slots)
        slot = slots[scheme]
        for ep in r["_run"]["episodes"]:
            t, en = 0.0, 0.0
            tpts, epts = [], []
            for acc, dt, de in zip(ep["acc"], ep["time"], ep["energy"]):
                t += dt
                en += de
                tpts.append((t, acc))
                epts.append((en, acc))
            t_series.append((scheme, slot, tpts))
            e_series.append((scheme, slot, epts))
        table.append(r)
    css_series = "\n".join(
        f".s{i} {{ stroke: {c}; }}" for i, c in enumerate(_SERIES_LIGHT))
    css_series_dark = "\n".join(
        f".s{i} {{ stroke: {c}; }}" for i, c in enumerate(_SERIES_DARK))
    legend = "".join(
        f'<span class="key"><span class="swatch '
        f'{"s%d" % slot if slot < len(_SERIES_LIGHT) else "smuted"}">'
        f'</span>{scheme}</span>'
        for scheme, slot in slots.items())
    rows = "\n".join(
        "<tr><td class=mono>{run_id}</td><td>{scheme}</td>"
        "<td>{mode}</td><td>{seed}</td><td>{episodes}</td>"
        "<td>{acc}</td><td>{energy}</td><td>{time}</td>"
        "<td>{health}</td></tr>".format(
            run_id=r["run_id"], scheme=r["scheme"], mode=r["mode"],
            seed=r["seed"], episodes=r["episodes"],
            acc="-" if r["final_acc"] is None
                else f"{r['final_acc']:.3f}",
            energy="-" if r["total_energy"] is None
                else f"{r['total_energy']:.1f}",
            time="-" if r["sim_time_s"] is None
                else f"{r['sim_time_s']:.0f}",
            health=("critical" if r["critical"]
                    else str(r["health_events"])))
        for r in table)
    html = f"""<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<title>Arena HFL run ledger</title>
<style>
.viz-root {{
  color-scheme: light;
  --surface-1: #fcfcfb; --text-primary: #0b0b0b;
  --text-secondary: #52514e; --grid: #e6e5e1; --axis: #b5b4af;
  font: 14px/1.45 system-ui, sans-serif;
  background: var(--surface-1); color: var(--text-primary);
  max-width: 1020px; margin: 0 auto; padding: 20px;
}}
@media (prefers-color-scheme: dark) {{
  .viz-root {{
    color-scheme: dark;
    --surface-1: #1a1a19; --text-primary: #ffffff;
    --text-secondary: #c3c2b7; --grid: #32312f; --axis: #55544f;
  }}
  {css_series_dark}
}}
{css_series}
.smuted {{ stroke: {_MUTED[0]}; }}
h1 {{ font-size: 20px; }} h2 {{ font-size: 15px; margin: 18px 0 6px; }}
.charts {{ display: flex; flex-wrap: wrap; gap: 18px; }}
.chart {{ flex: 1 1 440px; }}
svg {{ width: 100%; height: auto; }}
.line {{ fill: none; stroke-width: 2; }}
.grid {{ stroke: var(--grid); stroke-width: 1; }}
.axis {{ stroke: var(--axis); stroke-width: 1; }}
.tick, .label, .dlabel {{ fill: var(--text-secondary); font-size: 10px;
  font-family: system-ui, sans-serif; }}
.dlabel {{ fill: var(--text-primary); }}
.hit {{ fill: transparent; stroke: none; }}
.legend {{ margin: 8px 0 2px; color: var(--text-secondary); }}
.key {{ margin-right: 14px; white-space: nowrap; }}
.swatch {{ display: inline-block; width: 12px; height: 3px;
  margin: 0 5px 3px 0; vertical-align: middle; stroke: none; }}
{"".join(f".swatch.s{i} {{ background: {c}; }}"
         for i, c in enumerate(_SERIES_LIGHT))}
.swatch.smuted {{ background: {_MUTED[0]}; }}
table {{ border-collapse: collapse; margin-top: 6px; width: 100%; }}
th, td {{ text-align: left; padding: 3px 10px 3px 0;
  border-bottom: 1px solid var(--grid); font-size: 13px; }}
th {{ color: var(--text-secondary); font-weight: 600; }}
.mono {{ font-family: ui-monospace, monospace; font-size: 12px; }}
</style></head>
<body class="viz-root">
<h1>Arena HFL run ledger</h1>
<p>{len(table)} run(s) under <code>{root}</code>. Curves are one line
per recorded episode, colored by scheme.</p>
<div class="legend">{legend}</div>
<div class="charts">
<div class="chart"><h2>Accuracy vs simulated time</h2>
{_svg_chart("Accuracy vs simulated time", "simulated seconds",
            t_series)}</div>
<div class="chart"><h2>Accuracy vs cumulative energy</h2>
{_svg_chart("Accuracy vs cumulative energy", "energy (mAh)",
            e_series)}</div>
</div>
<h2>Runs</h2>
<table><thead><tr><th>run id</th><th>scheme</th><th>mode</th>
<th>seed</th><th>episodes</th><th>final acc</th><th>energy (mAh)</th>
<th>sim time (s)</th><th>health</th></tr></thead>
<tbody>
{rows}
</tbody></table>
</body></html>
"""
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        f.write(html)
    return out
