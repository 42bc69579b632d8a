"""The port's observability layer (``repro_torch.telemetry``) against the
reference's (``repro.telemetry``) and its own contracts:

* the metrics registry and trace recorder units (the reference's tests,
  run on the port's copies) and their state round trips;
* an analytic ``AsyncHFLEnv`` episode with faults, telemetry and health
  on: the port's Chrome-trace event list, metric snapshot and health
  events equal the reference's exactly on equal inputs;
* **no perturbation**: telemetry (and ``ktime``) on vs off reproduce the
  trajectory bitwise, in analytic and in real mode;
* a disabled facade is inert; the Chrome-trace and JSONL exports;
* ``ktime`` on CPU tensors: host-clock readings, outputs unchanged,
  nesting (its CUDA-event path is held in ``tests/test_torch_cuda.py``);
* telemetry state rides checkpoints: a resumed run emits the same trace.
"""
import contextlib
import json

import numpy as np
import pytest
import torch

from repro.runtime import AsyncConfig as JAsyncConfig
from repro.runtime import ChurnEvent as JChurnEvent
from repro.runtime import FaultSpec as JFaultSpec
from repro.runtime import Outage as JOutage
from repro.sim import env as jenv
from repro.telemetry import MetricsRegistry as JMetricsRegistry
from repro.telemetry import TraceRecorder as JTraceRecorder
from repro_torch.checkpoint import store
from repro_torch.kernels import hier_agg, ops
from repro_torch.runtime import AsyncConfig, ChurnEvent, FaultSpec, Outage
from repro_torch.sim import AsyncHFLEnv, EnvConfig
from repro_torch.telemetry import (MetricsRegistry, Telemetry, TraceRecorder,
                                   kernel_timing, ktime)

ANALYTIC = dict(task="mnist", mode="analytic", n_devices=20, n_edges=4,
                threshold_time=400.0, seed=0)
REAL = dict(task="mnist", mode="real", n_devices=8, n_edges=2, n_local=64,
            batch_size=32, threshold_time=240.0, gamma_max=3, seed=0)
# every hook family: drops, transients, an outage window, leave/join churn
FAULTY = dict(drop_prob=0.2, transient_prob=0.25, seed=5)
OUTAGE, CHURN = (1, 50.0, 40.0), ((80.0, 2, "leave"), (160.0, 2, "join"))
ACFG = dict(buffer_k=2, flush_deadline=45.0)
ACTION = np.array([2.0, 2.0])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's torch work: the suite runs in
    several worker processes at once, and a thread pool per process over
    the same cores slows every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(port=True):
    fs, out, ch = ((FaultSpec, Outage, ChurnEvent) if port
                   else (JFaultSpec, JOutage, JChurnEvent))
    return fs(outages=(out(*OUTAGE),), churn=tuple(ch(*c) for c in CHURN),
              **FAULTY)


def _episode(cfg, spec, telemetry, max_steps=10_000, timed=False):
    """One async episode (or ``max_steps`` events): per event (reward,
    acc, edge, flushed), the final fingerprint (global vector and bank in
    real mode, the accuracy history in analytic) and the env."""
    env = AsyncHFLEnv(EnvConfig(**cfg, device="cpu", telemetry=telemetry),
                      AsyncConfig(**ACFG), faults=spec)
    reg = MetricsRegistry()
    traj = []
    with kernel_timing(reg) if timed else contextlib.nullcontext():
        env.reset()
        for _ in range(max_steps):
            _, r, done, info = env.step(ACTION)
            traj.append((float(r), float(info["acc"]), info["edge"],
                         info["flushed"]))
            if done:
                break
    if cfg["mode"] == "real":
        fp = torch.cat([env._global_vec, env._spec.flatten(env.bank)
                        .reshape(-1)]).numpy()
    else:
        fp = np.asarray(env.acc_hist, np.float64)
    return traj, fp, env, reg


# ---------------------------------------------------------------------------
# metrics registry and trace recorder units, beside the reference's
# ---------------------------------------------------------------------------

def test_metrics_registry_counters_gauges_hists_match_reference():
    """The same calls on the port's registry and the reference's give the
    same snapshot and brief view, with the reference test's values."""
    views = []
    for m in (MetricsRegistry(), JMetricsRegistry()):
        m.inc("flushes")
        m.inc("flushes")
        m.inc("retries", 3)
        m.set_gauge("queue_depth", 4)
        m.set_gauge("queue_depth", 2)    # gauges keep the last value
        for v in (1.0, 3.0, 2.0):
            m.observe("staleness_at_flush", v)
        views.append((m.snapshot(), m.brief()))
        m.reset()
        assert m.snapshot() == {"counters": {}, "gauges": {},
                                "histograms": {}}
    (snap, brief), ref = views[0], views[1]
    assert (snap, brief) == ref
    assert snap["counters"] == {"flushes": 2, "retries": 3}
    assert snap["gauges"] == {"queue_depth": 2.0}
    assert snap["histograms"]["staleness_at_flush"] == {
        "count": 3, "mean": 2.0, "min": 1.0, "p50": 2.0, "max": 3.0}
    assert "histograms" not in brief


def test_metrics_state_roundtrip():
    m = MetricsRegistry()
    m.inc("a", 2)
    m.set_gauge("g", 1.5)
    m.observe("h", 0.25)
    m2 = MetricsRegistry()
    m2.set_state(json.loads(json.dumps(m.state())))   # survives JSON
    assert m2.snapshot() == m.snapshot()
    m2.observe("h", 1.0)                              # restored lists live
    assert len(m2.hists["h"]) == 2 and len(m.hists["h"]) == 1


def _emit(r):
    r.thread_name(0, "edge-0")
    r.span("round", "compute", 0, 1.5, 2.0, g1=2)
    r.instant("flush", "cloud", 1, 3.0, degraded=False)
    r.counter("queue_depth", 4.0, depth=np.int64(7))
    r.begin("up/0", "upload", "comm", 0, 10.0, version=3)
    r.end("up/0", 14.0, landed=True)
    r.begin("up/1", "upload", "comm", 1, 0.0)
    r.discard("up/1")
    r.begin("buf/2", "buffer", "buffer", 1, 5.0, edge=1)


def test_recorder_vocabulary_and_open_spans_match_reference():
    """The same emissions give the reference's event list and open-span
    table; numpy scalars become plain ints; a restored recorder closes
    an open span at its original begin time."""
    r, jr = TraceRecorder(), JTraceRecorder()
    _emit(r)
    _emit(jr)
    assert r.events == jr.events and r.state() == jr.state()
    m, x, i, c, sp = r.events
    assert m["ph"] == "M" and x["ph"] == "X" and x["dur"] == 0.5e6
    assert i["ph"] == "i" and i["s"] == "t" and c["ph"] == "C"
    assert type(c["args"]["depth"]) is int
    assert sp["args"] == {"version": 3, "landed": True}
    assert r.end("up/0", 20.0) is None and r.open_t0("up/1") is None
    r2 = TraceRecorder()
    r2.set_state(json.loads(json.dumps(r.state())))
    assert r2.end("buf/2", 8.0) == 5.0
    assert r2.events[-1]["ts"] == 5.0e6 and r2.events[-1]["dur"] == 3.0e6


# ---------------------------------------------------------------------------
# the port's trace, metrics and health equal the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["recovery-spec", "outage-churn"])
def test_analytic_trace_metrics_health_match_reference_exactly(case):
    """Analytic ``AsyncHFLEnv``, 20 devices, 4 edges, faults (the recovery
    test's spec, or drops + transients + an outage + leave/join churn),
    telemetry and health on, a whole episode: the Chrome-trace event
    list, ``metrics.snapshot()``, every step's ``info["telemetry"]`` and
    ``info["health"]`` and the health events equal the reference's
    exactly."""
    if case == "recovery-spec":
        spec = FaultSpec(drop_prob=0.15, transient_prob=0.2, seed=9)
        jspec = JFaultSpec(drop_prob=0.15, transient_prob=0.2, seed=9)
        acfg = dict(buffer_k=2, flush_deadline=40.0)
    else:
        spec, jspec, acfg = _spec(), _spec(port=False), ACFG
    pe = AsyncHFLEnv(EnvConfig(**ANALYTIC, device="cpu", telemetry=True,
                               health=True), AsyncConfig(**acfg),
                     faults=spec)
    je = jenv.AsyncHFLEnv(jenv.EnvConfig(**ANALYTIC, telemetry=True,
                                         health=True),
                          JAsyncConfig(**acfg), faults=jspec)
    pe.reset()
    je.reset()
    acts = np.random.default_rng(3).uniform(0, 9, size=(500, 2))
    for a in acts:
        _, r, d, i = pe.step(a)
        _, jr, jd, ji = je.step(a)
        assert (r, d) == (jr, jd)
        assert i["telemetry"] == ji["telemetry"]
        assert i["health"] == ji["health"]
        if d:
            break
    assert d
    tm, jtm = pe.telemetry, je.telemetry
    assert len(tm.recorder) > 100
    assert tm.recorder.events == jtm.recorder.events
    assert tm.recorder.state() == jtm.recorder.state()
    assert tm.metrics.snapshot() == jtm.metrics.snapshot()
    assert tm.span_counts() == jtm.span_counts()
    assert [e.to_dict() for e in pe.health.events] \
        == [e.to_dict() for e in je.health.events]
    assert pe.health.state() == je.health.state()
    c = tm.metrics.counters
    assert c["flushes"] > 0 and c["retries"] > 0 and c["uploads_dropped"] > 0
    if case == "outage-churn":
        assert c["outages"] >= 1 and c["churn_leave"] == c["churn_join"] == 1


# ---------------------------------------------------------------------------
# disabled facade, enabled episode, exports
# ---------------------------------------------------------------------------

def test_disabled_telemetry_is_inert():
    env = AsyncHFLEnv(EnvConfig(**ANALYTIC, device="cpu"),
                      AsyncConfig(**ACFG), faults=_spec())
    env.reset()
    assert env.telemetry.enabled is False
    assert env.queue.observer is None and env.buffer.telemetry is None
    assert env._injector.telemetry is None
    for _ in range(5):
        _, _, _, info = env.step(ACTION)
        assert "telemetry" not in info and "health" not in info
    assert len(env.telemetry.recorder) == 0
    assert env.telemetry.metrics.snapshot()["counters"] == {}


def test_enabled_episode_records_every_hook_family():
    _, _, env, _ = _episode(ANALYTIC, _spec(), True, max_steps=60)
    tm = env.telemetry
    assert env.queue.observer is tm and env.buffer.telemetry is tm
    c = tm.metrics.counters
    assert c["events_popped"] >= 60 and c["uploads_landed"] >= 1
    assert c["churn_leave"] == 1 and c["churn_join"] == 1
    assert c["outages"] >= 1 and c["fate_ok"] >= 1
    assert "staleness_at_flush" in tm.metrics.hists
    lanes = tm.span_counts()
    assert "cloud" in lanes and any(k.startswith("edge-") for k in lanes)


_PH = {"X", "i", "C", "M"}


def test_chrome_trace_and_jsonl_exports(tmp_path):
    _, _, env, _ = _episode(ANALYTIC, _spec(), True, max_steps=60)
    path = str(tmp_path / "trace.json")
    env.telemetry.export_chrome(path, task="mnist", seed=0)
    with open(path) as f:
        doc = json.load(f)
    assert set(doc) == {"traceEvents", "displayTimeUnit", "otherData"}
    assert doc["otherData"] == {"task": "mnist", "seed": 0}
    events = doc["traceEvents"]
    assert events == env.telemetry.recorder.events
    for ev in events:
        assert isinstance(ev["name"], str) and ev["ph"] in _PH
        assert ev["pid"] == 0 and isinstance(ev["tid"], int)
        assert ev["ts"] >= 0 and isinstance(ev["args"], dict)
        if ev["ph"] == "X":
            assert ev["dur"] >= 0
        if ev["ph"] != "M":
            assert 0 <= ev["tid"] <= ANALYTIC["n_edges"]
    assert {"thread_name", "round", "upload", "flush",
            "queue_depth"} <= {ev["name"] for ev in events}
    path = str(tmp_path / "trace.jsonl")
    env.telemetry.export_jsonl(path)
    with open(path) as f:
        assert [json.loads(ln) for ln in f] == events


# ---------------------------------------------------------------------------
# THE invariant: telemetry (and ktime) on == off, bitwise
# ---------------------------------------------------------------------------

def test_no_perturbation_analytic_bitwise():
    t_on, fp_on, env, _ = _episode(ANALYTIC, _spec(), True)
    t_off, fp_off, _, _ = _episode(ANALYTIC, _spec(), False)
    assert len(env.telemetry.recorder) > 0
    assert t_on == t_off and fp_on.tobytes() == fp_off.tobytes()


def test_no_perturbation_real_mode_bitwise():
    """Real mode, MNIST, 8 devices, 2 edges, n_local 64, drops and
    transient retries: telemetry and ``ktime`` on reproduce the events,
    the global vector and the bank bitwise; ``ktime`` counted every
    aggregation call of the run."""
    spec = FaultSpec(drop_prob=0.25, transient_prob=0.2, seed=11)
    t_on, fp_on, env, reg = _episode(REAL, spec, True, max_steps=4,
                                     timed=True)
    t_off, fp_off, _, _ = _episode(REAL, spec, False, max_steps=4)
    assert len(env.telemetry.recorder) > 0 and env.n_flushes > 0
    assert t_on == t_off and fp_on.tobytes() == fp_off.tobytes()
    assert reg.counters["kernel/segment_agg_calls"] > env.n_flushes
    assert reg.counters["kernel/segment_broadcast_calls"] > 0


# ---------------------------------------------------------------------------
# ktime on CPU tensors
# ---------------------------------------------------------------------------

def _kernel_inputs():
    rng = np.random.default_rng(3)
    bank = torch.from_numpy(rng.normal(size=(8, 37)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, size=(8,)).astype(
        np.float32))
    seg = torch.from_numpy(np.repeat(np.arange(4), 2).astype(np.int32))
    return bank, w, seg


def test_kernel_timing_records_without_changing_outputs():
    bank, w, seg = _kernel_inputs()
    base_agg = ops.segment_agg(bank, w, seg, 4)
    base_bc = ops.segment_broadcast(base_agg, seg)
    reg = MetricsRegistry()
    before = dict(hier_agg.LAUNCHES)
    with kernel_timing(reg):
        timed_agg = ops.segment_agg(bank, w, seg, 4)
        timed_bc = ops.segment_broadcast(timed_agg, seg)
    assert torch.equal(timed_agg, base_agg)
    assert torch.equal(timed_bc, base_bc)
    assert timed_agg.dtype == base_agg.dtype
    assert reg.counters["kernel/segment_agg_calls"] == 1
    assert reg.counters["kernel/segment_broadcast_calls"] == 1
    assert reg.hists["kernel/segment_agg_us"][0] > 0
    assert ktime.active_registry() is None       # the sink is gone
    ops.segment_agg(bank, w, seg, 4)
    assert reg.counters["kernel/segment_agg_calls"] == 1
    assert hier_agg.LAUNCHES == before          # CPU: plain versions only


def test_kernel_timing_nests_restores_and_enable_disable():
    bank, w, seg = _kernel_inputs()
    outer, inner = MetricsRegistry(), MetricsRegistry()
    with kernel_timing(outer):
        ops.segment_agg(bank, w, seg, 4)
        with kernel_timing(inner):
            assert ktime.active_registry() is inner
            ops.segment_agg(bank, w, seg, 4)
        assert ktime.active_registry() is outer
        ops.segment_agg(bank, w, seg, 4)
    assert ktime.active_registry() is None
    assert outer.counters["kernel/segment_agg_calls"] == 2
    assert inner.counters["kernel/segment_agg_calls"] == 1
    ktime.enable(inner)
    try:
        ops.segment_broadcast(bank[:4], seg)
    finally:
        ktime.disable()
    assert inner.counters["kernel/segment_broadcast_calls"] == 1
    assert ktime.active_registry() is None


# ---------------------------------------------------------------------------
# telemetry state rides checkpoints
# ---------------------------------------------------------------------------

def test_trace_checkpoint_roundtrip_in_process(tmp_path):
    """Snapshot a traced analytic episode after 8 events, restore into a
    fresh env, run both 12 more: the resumed recorder, counters and
    histograms equal the uninterrupted run's (open spans close at their
    original begin times)."""
    def make():
        return AsyncHFLEnv(EnvConfig(**ANALYTIC, device="cpu",
                                     telemetry=True), AsyncConfig(**ACFG),
                           faults=_spec())
    env = make()
    env.reset()
    for _ in range(8):
        env.step(ACTION)
    path = str(tmp_path / "rt")
    store.save_runtime(env, path)
    mid = len(env.telemetry.recorder)
    for _ in range(12):
        env.step(ACTION)
    env2 = make()
    store.load_runtime(env2, path)
    assert len(env2.telemetry.recorder) == mid
    for _ in range(12):
        env2.step(ACTION)
    assert env2.telemetry.recorder.events == env.telemetry.recorder.events
    assert env2.telemetry.metrics.state() == env.telemetry.metrics.state()


def test_facade_state_roundtrip_and_disabled_constructor():
    tm = Telemetry()
    tm.begin_episode(1, 10.0, 3)
    tm.fault_fate(0, "ok")
    st = json.loads(json.dumps(tm.state()))
    tm2 = Telemetry()
    tm2.set_state(st)
    assert tm2.state() == tm.state() and tm2.n_edges == 3
    off = Telemetry.disabled()
    off.begin_episode(1, 0.0, 3)
    off.fault_fate(0, "ok")
    off.flush_event(1.0, 0, {}, True, False)
    assert not off.enabled and len(off.recorder) == 0
    assert off.metrics.snapshot()["counters"] == {}
