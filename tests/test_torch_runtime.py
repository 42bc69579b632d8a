"""The port's async runtime modules (``repro_torch.runtime``: clock,
buffer, faults, and the flush oracles of ``kernels/ref.py``) against the
reference's on the same inputs: the event queue and the round costs
exactly, the staleness scale and the fault injector's draws bit for bit,
and the buffer's flushes against the numpy oracles on the CPU (the
plain ``segment_agg``)."""
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.runtime import buffer as jbuffer
from repro.runtime import clock as jclock
from repro.runtime import faults as jfaults
from repro.sim import hardware as jhw
from repro_torch.core import hfl
from repro_torch.kernels import ops, ref
from repro_torch.runtime import (AsyncConfig, ChurnEvent, EventQueue,
                                 FaultInjector, FaultSpec, Outage,
                                 StalenessBuffer, buffer, clock, faults,
                                 edge_round_cost, staleness_scale)
from repro_torch.sim import hardware
from repro_torch.telemetry import Telemetry

# the flush (plain segment_agg: f32 sums times the reciprocal weight sum)
# against the numpy oracles (f32 sums divided by the weight sum)
FLUSH_TOL = 1e-6


def _event_tuple(ev):
    return (ev.time, ev.seq, ev.edge, ev.kind, sorted(ev.payload.items()))


# ---------------------------------------------------------------------------
# clock
# ---------------------------------------------------------------------------

def test_event_queue_orders_by_time_then_seq_as_reference():
    rng = np.random.default_rng(0)
    calls = [(float(rng.integers(0, 4)) * 0.5, int(rng.integers(0, 5)),
              str(rng.choice(["upload", "leave", "join"])))
             for _ in range(40)]
    queues = (EventQueue(), jclock.EventQueue())
    popped = ([], [])
    for i, (delay, edge, kind) in enumerate(calls):
        for q, out in zip(queues, popped):
            q.schedule(delay, edge, kind, i=i)
            if i % 3 == 2:
                out.append(_event_tuple(q.pop()))
    for q, out in zip(queues, popped):
        q.schedule_at(q.now + 0.25, 9, "outage_start")
        assert [_event_tuple(e) for e in q.events()] == sorted(
            _event_tuple(e) for e in q.events())
        while len(q):
            out.append(_event_tuple(q.pop()))
        assert q.peek() is None and q.observer is None
    assert popped[0] == popped[1]
    assert queues[0].now == queues[1].now and queues[0]._seq == 41
    # same-time events pop in scheduling order; now advances on pop
    q = EventQueue()
    q.schedule(5.0, edge=0)
    q.schedule(2.0, edge=1)
    q.schedule(2.0, edge=2)
    assert [q.pop().edge for _ in range(3)] == [1, 2, 0]
    assert q.now == 5.0


def test_event_queue_rejects_the_past_and_empty_pops_and_reloads():
    q = EventQueue()
    q.schedule(1.5, edge=0)
    assert isinstance(q.pop(), clock.Event) and q.now == 1.5
    with pytest.raises(ValueError):
        q.schedule(-0.1, edge=0)
    with pytest.raises(ValueError):
        q.schedule_at(1.0, edge=0)
    with pytest.raises(IndexError):
        q.pop()
    q.schedule(2.0, 3, "upload", g1=2)
    q.schedule(1.0, 4, "join")
    r = EventQueue()
    r.load(q.now, q._seq, q.events())
    assert [_event_tuple(r.pop()) for _ in range(2)] == \
        [_event_tuple(q.pop()) for _ in range(2)]
    assert r.now == q.now == 3.5


@pytest.mark.parametrize("part", ["all", "some", "none"])
def test_edge_round_cost_equals_reference(part):
    """Same profiles, same generator state: the same RoundCost and the
    same generator state after it, for every edge."""
    for task, n, regions in (("mnist", 10, ["cn", "us"]),
                             ("cifar", 23, ["cn", "cn", "us"])):
        rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
        prof = hardware.DeviceProfiles.sample(rng, n, task=task)
        jprof = jhw.DeviceProfiles.sample(jrng, n, task=task)
        comm = hardware.CommModel(regions, task=task)
        jcomm = jhw.CommModel(regions, task=task)
        assign = np.arange(n) % len(regions)
        sel = {"all": None, "some": np.arange(n) % 3 != 0,
               "none": np.zeros(n, bool)}[part]
        for edge in range(len(regions)):
            c = edge_round_cost(prof, comm, assign, edge, 3, 2, rng,
                                participate=sel)
            jc = jclock.edge_round_cost(jprof, jcomm, assign, edge, 3, 2,
                                        jrng, participate=sel)
            assert (c.time, c.energy, c.t_sgd, c.ec) == (
                jc.time, jc.energy, jc.t_sgd, jc.ec)
            assert rng.bit_generator.state == jrng.bit_generator.state
            if part == "none":
                assert c.energy == 0.0 and c.time == c.ec


# ---------------------------------------------------------------------------
# staleness scale and the buffer's flush
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decay,a", [("none", 0.5), ("poly", 0.5),
                                     ("poly", 0.7), ("exp", 0.8),
                                     ("exp", 1.0)])
def test_staleness_scale_bitwise_reference(decay, a):
    tau = np.array([0, 1, 2, 3, 7, 40])
    got = staleness_scale(tau, decay, a)
    want = jbuffer.staleness_scale(tau, decay, a)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    oracle = ref.staleness_scale_ref(tau, decay, a)
    assert oracle.tobytes() == jref.staleness_scale_ref(tau, decay,
                                                        a).tobytes()
    assert oracle.tobytes() == got.tobytes()


def test_staleness_scale_rejects_what_the_reference_rejects():
    for fn in (staleness_scale, jbuffer.staleness_scale):
        with pytest.raises(ValueError):
            fn([0, 1], "exp", 1.5)
        with pytest.raises(ValueError):
            fn([0, 1], "nope")


def test_flush_oracles_equal_reference_oracles():
    rng = np.random.default_rng(1)
    u = rng.normal(size=(4, 33)).astype(np.float32)
    w = rng.uniform(0.5, 3.0, 4).astype(np.float32)
    g = rng.normal(size=33).astype(np.float32)
    tau = [3, 0, 2, 1]
    for decay in ("none", "poly", "exp"):
        assert ref.staleness_aggregate_ref(u, w, tau, decay, 0.6).tobytes() \
            == jref.staleness_aggregate_ref(u, w, tau, decay, 0.6).tobytes()
        assert ref.coverage_aggregate_ref(u, w, tau, g, 2.5, decay,
                                          0.6).tobytes() \
            == jref.coverage_aggregate_ref(u, w, tau, g, 2.5, decay,
                                           0.6).tobytes()


def _vecs(seed, k, p):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(p,)).astype(np.float32))
            for _ in range(k)], rng


def _cpu_buffer(k, **kw):
    return StalenessBuffer(k, device="cpu", **kw)


@pytest.mark.parametrize("order", [[0, 1, 2, 3, 4], [4, 2, 0, 3, 1],
                                   [1, 0, 4, 3, 2]])
def test_buffer_flush_matches_oracle_whatever_the_arrival_order(order):
    """Poly decay, K = 5, staleness 0-3: the flush in canonical
    (edge, arrival) order against ``staleness_aggregate_ref``; every
    arrival order gives the same bits."""
    vecs, rng = _vecs(2, 5, 210)
    w = rng.uniform(0.5, 3.0, size=5)
    tau = [3, 0, 2, 1, 0]
    outs = []
    for o in (list(range(5)), order):
        buf = _cpu_buffer(5, decay="poly", decay_a=0.5)
        for j in o:
            buf.push(j, vecs[j], w[j], version=5 - tau[j])
        assert buf.ready and len(buf) == 5
        glob, info = buf.flush(version=5)
        assert len(buf) == 0 and info["edges"] == list(range(5))
        assert info["staleness"] == tau
        outs.append(glob)
    assert torch.equal(outs[0], outs[1])
    want = ref.staleness_aggregate_ref(torch.stack(vecs).numpy(), w, tau,
                                       decay="poly", a=0.5)
    np.testing.assert_allclose(outs[0].numpy(), want, atol=FLUSH_TOL,
                               rtol=FLUSH_TOL)


def test_buffer_flush_info_equals_reference():
    """The same pushes into the port's and the reference's buffers give
    the same info (edges, staleness, drops, weights, coverage)."""
    vecs, rng = _vecs(3, 4, 16)
    w = rng.uniform(1.0, 2.0, size=4)
    versions = [2, 3, 9, 10]
    anchor = vecs[0] * 0.5
    for kw in ({}, {"max_staleness": 5},
               {"anchor": anchor, "anchor_weight": 3.0}):
        buf, jbuf = _cpu_buffer(4, decay="exp", decay_a=0.8), \
            jbuffer.StalenessBuffer(4, decay="exp", decay_a=0.8)
        for j in (3, 1, 0, 2):
            buf.push(j, vecs[j], float(w[j]), version=versions[j], tag=j)
            jbuf.push(j, vecs[j].numpy(), float(w[j]), version=versions[j],
                      tag=j)
        jkw = dict(kw)
        if "anchor" in kw:
            jkw["anchor"] = anchor.numpy()
        _, info = buf.flush(version=10, **kw)
        _, jinfo = jbuf.flush(version=10, **jkw)
        assert info == jinfo


def test_buffer_max_staleness_drops_and_renormalises():
    """Slots staler than ``max_staleness`` are dropped before the
    aggregation and the survivors' weights renormalise: the flush is the
    plain flush of the survivors alone, bit for bit, and the oracle's
    within FLUSH_TOL."""
    vecs, _ = _vecs(5, 4, 96)
    w = np.float32([1.0, 2.0, 3.0, 4.0])
    versions = [2, 3, 9, 10]                   # tau at 10: [8, 7, 1, 0]
    for decay in ("none", "poly"):
        buf = _cpu_buffer(4, decay=decay)
        for j in range(4):
            buf.push(j, vecs[j], float(w[j]), version=versions[j])
        glob, info = buf.flush(version=10, max_staleness=5)
        assert info["dropped"] == [0, 1] and info["edges"] == [2, 3]
        assert info["staleness"] == [1, 0]
        alone = _cpu_buffer(2, decay=decay)
        for j in (2, 3):
            alone.push(j, vecs[j], float(w[j]), version=versions[j])
        assert torch.equal(glob, alone.flush(version=10)[0])
        want = ref.staleness_aggregate_ref(
            torch.stack(vecs[2:]).numpy(), w[2:], [1, 0], decay=decay)
        np.testing.assert_allclose(glob.numpy(), want, atol=FLUSH_TOL,
                                   rtol=FLUSH_TOL)
    # every slot dropped: no aggregate, and the buffer still empties
    buf = _cpu_buffer(1)
    buf.push(0, vecs[0], 1.0, version=0)
    glob, info = buf.flush(version=10, max_staleness=5)
    assert glob is None and len(buf) == 0 and info["dropped"] == [0]


def test_buffer_metadata_mode_never_aggregates():
    before = dict(ops.LAUNCHES)
    buf = _cpu_buffer(2)
    buf.push(0, None, 1.0, version=0, epochs=4)
    buf.push(1, None, 2.0, version=0, epochs=8)
    glob, info = buf.flush(version=1)
    assert glob is None
    assert [m["epochs"] for m in info["meta"]] == [4, 8]
    assert info["weights"] == (np.float32([1.0, 2.0])
                               * staleness_scale([1, 1])).tolist()
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError):
        _cpu_buffer(0)


def test_degraded_flush_matches_coverage_oracle_and_reduces_at_zero():
    vecs, rng = _vecs(0, 3, 57)
    anchor = torch.from_numpy(rng.normal(size=(57,)).astype(np.float32))
    w = rng.uniform(0.5, 2.0, size=3).astype(np.float32)

    def fill(k=5):
        buf = _cpu_buffer(k, decay="poly", decay_a=0.5)
        for j in range(3):
            buf.push(j, vecs[j], float(w[j]), version=8 - j)
        return buf

    glob, info = fill().flush(version=10, anchor=anchor, anchor_weight=3.0)
    want = ref.coverage_aggregate_ref(torch.stack(vecs).numpy(), w,
                                      [2, 3, 4], anchor.numpy(), 3.0,
                                      decay="poly", a=0.5)
    np.testing.assert_allclose(glob.numpy(), want, atol=FLUSH_TOL,
                               rtol=FLUSH_TOL)
    assert 0.0 < info["coverage"] < 1.0 and info["anchor_weight"] == 3.0
    plain, _ = fill().flush(version=10)
    zero, info = fill().flush(version=10, anchor=anchor, anchor_weight=0.0)
    assert torch.equal(plain, zero) and "coverage" not in info


def test_buffer_flush_is_one_segment_agg_of_the_stack():
    """The decay only reweights: the flush is bitwise the one-segment
    ``segment_agg`` of the stack on the pre-scaled weights."""
    vecs, rng = _vecs(3, 4, 130)
    w = rng.uniform(1.0, 2.0, size=4).astype(np.float32)
    buf = _cpu_buffer(4, decay="poly", decay_a=0.5)
    for j in range(4):
        buf.push(j, vecs[j], float(w[j]), version=0)
    glob, _ = buf.flush(version=2)
    scaled = torch.from_numpy(w * staleness_scale(np.full(4, 2), "poly"))
    want = ops.segment_agg(torch.stack(vecs), scaled,
                           torch.zeros(4, dtype=torch.int32), 1)[0]
    assert torch.equal(glob, want)


def test_buffer_refuses_unported_options_and_defaults_to_the_card():
    # telemetry and clock are ported observers: a push and a flush report
    # residency spans at the clock's time, and the flush is unchanged
    tm, clock = Telemetry(), EventQueue()
    tm.begin_episode(1, 0.0, 2)
    buf = StalenessBuffer(2, decay="none", telemetry=tm, clock=clock,
                          device="cpu")
    vecs, _ = _vecs(2, 2, 7)
    clock.now = 3.0
    for j in range(2):
        buf.push(j, vecs[j], 1.0, version=0)
    clock.now = 5.0
    glob, _ = buf.flush(version=1)
    plain = _cpu_buffer(2, decay="none")
    for j in range(2):
        plain.push(j, vecs[j], 1.0, version=0)
    assert torch.equal(glob, plain.flush(version=1)[0])
    spans = [e for e in tm.recorder.events if e["name"] == "buffer"]
    assert [(e["ts"], e["dur"], e["args"]["staleness"]) for e in spans] \
        == [(3.0e6, 2.0e6, 1)] * 2
    assert tm.metrics.hists["staleness_at_flush"] == [1.0, 1.0]
    with pytest.raises(TypeError):
        StalenessBuffer(2, ctx=object(), device="cpu")
    assert StalenessBuffer(2, ctx=hfl.AggContext.single_chip(),
                           device="cpu").ctx == hfl.AggContext.single_chip()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StalenessBuffer(2)
    assert AsyncConfig() == AsyncConfig(buffer_k=0, decay="poly",
                                        decay_a=0.5, max_staleness=0,
                                        flush_deadline=0.0)
    assert buffer.AsyncConfig is AsyncConfig


# ---------------------------------------------------------------------------
# faults
# ---------------------------------------------------------------------------

def test_faultspec_validation_as_reference():
    for mod in (jfaults, faults):
        with pytest.raises(ValueError):
            mod.ChurnEvent(1.0, 0, "explode")
        spec = mod.FaultSpec(drop_prob=[0.1, 0.2])
        with pytest.raises(ValueError):
            spec.drop_prob_per_edge(3)
        np.testing.assert_array_equal(spec.drop_prob_per_edge(2),
                                      [0.1, 0.2])
        assert not mod.FaultSpec().enabled
        assert mod.FaultSpec(transient_prob=0.1).enabled
        assert mod.FaultSpec(outages=(mod.Outage(0, 1.0, 2.0),)).enabled
    for seed, n, horizon in ((123, 4, 400.0), (321, 2, 240.0),
                             (7, 5, 600.0)):
        spec = FaultSpec.random(seed, n, horizon)
        jspec = jfaults.FaultSpec.random(seed, n, horizon)
        assert _spec_tuple(spec) == _spec_tuple(jspec)


def _spec_tuple(spec):
    return (spec.drop_prob, spec.transient_prob,
            [(o.edge, o.start, o.duration) for o in spec.outages],
            [(c.time, c.edge, c.kind) for c in spec.churn],
            spec.max_retries, spec.backoff_base, spec.backoff_cap,
            spec.retry_timeout, spec.seed, spec.enabled)


@pytest.mark.parametrize("spec", [None, FaultSpec(),
                                  FaultSpec(drop_prob=0.0,
                                            transient_prob=0.0)])
def test_null_spec_makes_no_draws_and_schedules_nothing(spec):
    fi = FaultInjector(spec, 3)
    q = EventQueue()
    state0 = fi.rng.bit_generator.state
    fi.schedule_initial(q)
    assert len(q) == 0 and q._seq == 0
    for att in range(3):
        assert fi.upload_fate(1, att, 10.0, 0.0) == "ok"
    assert fi.rng.bit_generator.state == state0


SEEDED = FaultSpec(drop_prob=[0.1, 0.3, 0.0, 0.2], transient_prob=0.35,
                   outages=(Outage(1, 50.0, 40.0), Outage(3, 10.0, 5.0)),
                   churn=(ChurnEvent(80.0, 2, "leave"),
                          ChurnEvent(140.0, 2, "join")),
                   max_retries=2, backoff_base=1.5, backoff_cap=10.0,
                   retry_timeout=30.0, seed=11)


def _jax_spec(spec):
    return jfaults.FaultSpec(
        drop_prob=spec.drop_prob, transient_prob=spec.transient_prob,
        outages=tuple(jfaults.Outage(o.edge, o.start, o.duration)
                      for o in spec.outages),
        churn=tuple(jfaults.ChurnEvent(c.time, c.edge, c.kind)
                    for c in spec.churn),
        max_retries=spec.max_retries, backoff_base=spec.backoff_base,
        backoff_cap=spec.backoff_cap, retry_timeout=spec.retry_timeout,
        seed=spec.seed)


@pytest.mark.parametrize("which", ["seeded", "random"])
def test_injector_sequence_equals_reference(which):
    """``schedule_initial``, then 300 fate decisions (attempts, times,
    outage toggles from one seeded driver) with a retry delay after each
    retry: the same events, fates, delays, counters and generator state
    as the reference's injector, episode offsets 0 and 3."""
    spec = SEEDED if which == "seeded" else FaultSpec.random(4, 4, 600.0)
    jspec = _jax_spec(spec)
    comm = hardware.CommModel(["cn", "cn", "us", "us"])
    jcomm = jhw.CommModel(["cn", "cn", "us", "us"])
    for offset in (0, 3):
        fi, jfi = FaultInjector(spec, 4, offset), \
            jfaults.FaultInjector(jspec, 4, offset)
        q, jq = EventQueue(), jclock.EventQueue()
        q.now = jq.now = 25.0
        fi.schedule_initial(q)
        jfi.schedule_initial(jq)
        assert [_event_tuple(e) for e in q.events()] == \
            [_event_tuple(e) for e in jq.events()]
        drv = np.random.default_rng(offset)
        for _ in range(300):
            edge = int(drv.integers(4))
            attempt = int(drv.integers(4))
            now = float(drv.uniform(0, 200))
            first = now - float(drv.uniform(0, 40))
            if drv.random() < 0.1:
                flip = not fi.in_outage[edge]
                fi.in_outage[edge] = jfi.in_outage[edge] = flip
            fate = fi.upload_fate(edge, attempt, now, first)
            assert fate == jfi.upload_fate(edge, attempt, now, first)
            if fate == "retry":
                assert fi.retry_delay(comm, edge, attempt) == \
                    jfi.retry_delay(jcomm, edge, attempt)
        st, jst = fi.state(), jfi.state()
        assert st == jst
        assert sum(st["n_dropped"]) > 0 and sum(st["n_retries"]) > 0
        again = FaultInjector(spec, 4)
        again.set_state(st)
        assert again.state() == st
