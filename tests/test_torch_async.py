"""The port's asynchronous HFL path (``hfl.make_edge_round``,
``sim.AsyncHFLEnv``, the ``async-*`` schemes, the deterministic mode)
against the reference's on the same inputs, and the port's own
contracts: an edge round is its row of the cloud round, a zero-decay
K = M flush is the cloud round's global model, and an edge round leaves
other edges' rows untouched."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (assert_close, jax_agent_draws,
                           jax_async_perm_sources, jax_round_perms)

from repro.core import flatbank as jflatbank
from repro.core import hfl as jhfl
from repro.core import sync as jsync
from repro.core.agent import networks as jnet
from repro.models import model as jmodel
from repro.runtime import AsyncConfig as JAsyncConfig
from repro.runtime import ChurnEvent as JChurnEvent
from repro.runtime import FaultSpec as JFaultSpec
from repro.runtime import Outage as JOutage
from repro.sim import env as jenv
from repro_torch import weights
from repro_torch.core import flatbank, hfl, sync
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import BankMesh
from repro_torch.models import model
from repro_torch.runtime import (AsyncConfig, ChurnEvent, FaultSpec,
                                 Outage, StalenessBuffer)
from repro_torch.sim import AsyncHFLEnv, EnvConfig, env
from repro_torch.telemetry import HealthMonitor, Telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G1, G2 = np.array([2, 1, 3]), np.array([1, 2, 2])
MAX_G1, MAX_G2 = 3, 2
# The MNIST CNN's edge round against its row of the cloud round in plain
# mode (deterministic=False) only: there the trainer takes vmap(grad) over
# the active rows only, and the conv weight gradients of a grouped
# (vmapped) convolution depend on how many rows one call holds (oneDNN
# picks its algorithm by group count). An edge round holds one edge's
# rows, the cloud round all of them in an epoch every device runs.
# Measured on these inputs (CPU): 5.96e-8 on the edge vectors and 2.98e-8
# on the flush; the bound is the measurement rounded up (ROADMAP section
# 3, fault 2). Rounds built with deterministic=True train all N rows in
# every epoch, as the reference does, and are held bitwise.
SUBSET_BOUND = 1e-7
ANALYTIC = dict(task="mnist", mode="analytic", n_devices=20, n_edges=4,
                threshold_time=400.0, seed=0)
REAL = dict(task="mnist", mode="real", n_devices=8, n_edges=2, n_local=64,
            batch_size=32, threshold_time=240.0, gamma_max=3, seed=0)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _round_inputs(kind):
    """(bank with distinct rows, x, y, sizes, edge ids, loss pair, lr,
    batch) as numpy, for the quadratic fixture of the reference's async
    tests or the MNIST CNN. The CNN's data is drawn as in the FedAvg
    parity test (``default_rng(0)``). Its max-pool has a discontinuous
    derivative: where two values of a window lie within an ulp, the
    port's and XLA's f32 forwards can pick different maxima and route a
    gradient to another pixel, which moves that device's update by about
    1e-3 (``default_rng(7)``'s device 0 has such a window in the second
    pool, gap 1.2e-7). That is no fault of either side (ROADMAP section
    3, caveats)."""
    rng = np.random.default_rng(7 if kind == "quad" else 0)
    if kind == "quad":
        n, n_local = 12, 8
        bank = {"w": rng.normal(size=(n, 4, 3)).astype(np.float32),
                "b": rng.normal(size=(n, 3)).astype(np.float32)}
        x = rng.normal(size=(n, n_local, 4)).astype(np.float32)
        y = rng.normal(size=(n, n_local)).astype(np.float32)
        seg = rng.integers(0, 3, size=(n,)).astype(np.int32)
        jloss = lambda p, b: jnp.mean((b["x"] @ p["w"][..., 0]
                                       - b["y"]) ** 2)
        loss = lambda p, b: torch.mean((b["x"] @ p["w"][..., 0]
                                        - b["y"]) ** 2)
        return bank, x, y, rng.uniform(1, 3, n).astype(np.float32), seg, \
            jloss, loss, 0.05, 4
    n, n_local = 6, 64
    x = rng.normal(size=(n, n_local, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(n, n_local)).astype(np.int32)
    w0 = _np(jmodel.mnist_cnn_init(jax.random.PRNGKey(5)))
    bank = {k: (v[None] + 0.01 * rng.normal(size=(n,) + v.shape)).astype(
        np.float32) for k, v in w0.items()}
    seg = np.array([0, 1, 2, 0, 1, 2], np.int32)
    jloss = lambda p, b: jmodel.cnn_loss(jmodel.mnist_cnn_apply, p, b)
    loss = lambda p, b: model.cnn_loss(model.mnist_cnn_apply, p, b)
    return bank, x, y, np.array([64, 32, 64, 48, 64, 16], np.float32), \
        seg, jloss, loss, 0.05, 32


@pytest.mark.parametrize("kind", ["quad", "mnist"])
def test_edge_round_matches_reference(kind):
    """Each edge's round from the same bank and snapshot, with the
    reference's shuffles injected: bank and edge vector within 1e-5 of
    the reference's (f32)."""
    bank, x, y, sizes, seg, jloss, loss, lr, bs = _round_inputs(kind)
    n, n_local = x.shape[:2]
    gvec = jflatbank.bank_spec(bank).flatten(bank)[1]
    jer = jhfl.make_edge_round(jloss, lr, bs, 3, MAX_G1, MAX_G2)
    er = hfl.make_edge_round(loss, lr, bs, 3, MAX_G1, MAX_G2)
    spec = flatbank.bank_spec(weights.bank_from_numpy(bank, "cpu"))
    for j in range(3):
        key = jax.random.PRNGKey(20 + j)
        jb, jvec = jer({k: jnp.asarray(v) for k, v in bank.items()},
                       jnp.asarray(x), jnp.asarray(y), jnp.asarray(sizes),
                       jnp.asarray(seg), jnp.int32(j), jnp.int32(G1[j]),
                       jnp.int32(G2[j]), gvec, key)
        perms = torch.from_numpy(jax_round_perms(key, MAX_G2, MAX_G1, n,
                                                 n_local))
        before = dict(ops.LAUNCHES)
        b, vec = er(weights.bank_from_numpy(bank, "cpu"),
                    torch.from_numpy(x), torch.from_numpy(y),
                    torch.from_numpy(sizes), torch.from_numpy(seg), j,
                    G1[j], G2[j], torch.from_numpy(np.array(gvec)), perms)
        assert ops.LAUNCHES == before          # CPU: plain versions only
        assert vec.shape == (spec.width,) and vec.dtype == torch.float32
        assert_close(vec, jvec, atol=1e-5)
        assert_close(spec.flatten(b),
                     jflatbank.bank_spec(jb).flatten(jb), atol=1e-5)


@pytest.mark.parametrize("kind", ["quad", "mnist", "quad-deterministic",
                                  "mnist-deterministic"])
def test_edge_rounds_are_rows_of_the_cloud_round(kind):
    """Port-internal contract, gamma1 [2, 1, 3], gamma2 [1, 2, 2], one set
    of shuffles: each edge round from a bank of distinct rows and the
    snapshot w returns row j of the cloud round's edge matrix (the cloud
    round starts every row at w), leaves the other edges' rows bitwise
    untouched, and a zero-decay K = 3 flush of the three returns the
    cloud round's global model. Bitwise for the quadratic fixture and, in
    deterministic mode (every epoch trains all N rows), for the MNIST CNN;
    within SUBSET_BOUND for the MNIST CNN in plain mode (fault 2). Against
    a cloud round in which only edge j trains, and the flush against Eq. 2
    of its inputs, bitwise for all."""
    kind, _, mode = kind.partition("-")
    det = mode == "deterministic"
    bitwise = kind == "quad" or det
    bank, x, y, sizes, seg, _, loss, lr, bs = _round_inputs(kind)
    n, n_local = x.shape[:2]
    x, y, sizes, seg = map(torch.from_numpy, (x, y, sizes, seg))
    perms = torch.from_numpy(np.stack([np.stack([np.stack([
        np.random.default_rng(100 * t2 + 10 * e + i).permutation(n_local)
        for i in range(n)]) for e in range(MAX_G1)])
        for t2 in range(MAX_G2)]))
    start = weights.bank_from_numpy(bank, "cpu")
    spec = flatbank.bank_spec(start)
    gvec = spec.flatten(start)[1].clone()
    cloud = hfl.make_cloud_round(loss, lr, bs, 3, MAX_G1, MAX_G2,
                                 deterministic=det)
    _, glob, em = cloud(hfl.broadcast_model(spec.unflatten_model(gvec), n),
                        x, y, sizes, seg, G1, G2, perms)
    em = spec.flatten(em)
    er = hfl.make_edge_round(loss, lr, bs, 3, MAX_G1, MAX_G2,
                             deterministic=det)
    edge_w = ref.segment_weight_sums(sizes, seg, 3)
    buf = StalenessBuffer(3, decay="none", device="cpu")
    vecs = []
    for j in (2, 0, 1):                      # arrival order is irrelevant
        b = weights.bank_from_numpy(bank, "cpu")
        before = spec.flatten(b).clone()
        b, vec = er(b, x, y, sizes, seg, j, G1[j], G2[j], gvec, perms)
        after = spec.flatten(b)
        other = seg != j
        assert torch.equal(after[other], before[other])
        assert not torch.equal(after[~other], before[~other])
        if bitwise:
            assert torch.equal(vec, em[j])
        else:
            assert_close(vec, em[j], atol=SUBSET_BOUND)
        # a cloud round in which only edge j trains takes vmap(grad) over
        # the same rows as the edge round: row j bitwise in both modes
        alone = np.arange(3) == j
        _, _, em_j = cloud(hfl.broadcast_model(spec.unflatten_model(gvec),
                                               n), x, y, sizes, seg,
                           np.where(alone, G1, 0), np.where(alone, G2, 0),
                           perms)
        assert torch.equal(vec, spec.flatten(em_j)[j])
        buf.push(j, vec, float(edge_w[j]), version=0)
        vecs.append((j, vec))
    flush, info = buf.flush(version=0)
    assert info["edges"] == [0, 1, 2] and info["staleness"] == [0, 0, 0]
    stack = torch.stack([v for _, v in sorted(vecs, key=lambda t: t[0])])
    eq2 = ops.segment_agg(stack, edge_w, torch.zeros(3, dtype=torch.int32),
                          1)[0]
    assert torch.equal(flush, eq2)
    want = spec.flatten_model(glob)
    if bitwise:
        assert torch.equal(flush, want)
    else:
        assert_close(flush, want, atol=SUBSET_BOUND)


@pytest.mark.parametrize("factory", ["cloud", "edge", "fedavg"])
def test_deterministic_mode_is_on_inside_each_round_only(factory,
                                                         monkeypatch):
    """``deterministic=True``: inside each call of the round PyTorch's
    deterministic algorithms are on, cuDNN deterministic and its
    benchmark off, and ``CUBLAS_WORKSPACE_CONFIG`` set (at build time,
    if unset); outside, the previous settings hold. On the CPU the round
    gives the same bits as without the mode."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", "")
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG")
    bank, x, y, sizes, seg, _, loss, lr, bs = _round_inputs("quad")
    seen = []

    def spy(p, b):
        seen.append((torch.are_deterministic_algorithms_enabled(),
                     torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark))
        return loss(p, b)

    n, n_local = x.shape[:2]
    perms = torch.stack([torch.stack([torch.stack([
        torch.randperm(n_local, generator=torch.Generator().manual_seed(
            t2 * 100 + e * 10 + i)) for i in range(n)])
        for e in range(MAX_G1)]) for t2 in range(MAX_G2)])
    x, y, sizes, seg = map(torch.from_numpy, (x, y, sizes, seg))
    outs = []
    for det in (False, True):
        if factory == "cloud":
            rnd = hfl.make_cloud_round(spy, lr, bs, 3, MAX_G1, MAX_G2,
                                       deterministic=det)
            args = (sizes, seg, G1, G2, perms)
        elif factory == "edge":
            rnd = hfl.make_edge_round(spy, lr, bs, 3, MAX_G1, MAX_G2,
                                      deterministic=det)
            start = weights.bank_from_numpy(bank, "cpu")
            gvec = flatbank.bank_spec(start).flatten(start)[0]
            args = (sizes, seg, 1, 2, 2, gvec, perms)
        else:
            rnd = hfl.make_fedavg_round(spy, lr, bs, MAX_G1,
                                        deterministic=det)
            args = (sizes, np.arange(n) % 2 == 0, G1[0], perms[0])
        assert (os.environ.get("CUBLAS_WORKSPACE_CONFIG")
                == (":4096:8" if det else None))
        seen.clear()
        out = rnd(weights.bank_from_numpy(bank, "cpu"), x, y, *args)
        assert seen and all(s == (det, det, False) for s in seen), seen
        assert not torch.are_deterministic_algorithms_enabled()
        assert not torch.backends.cudnn.deterministic
        outs.append(flatbank.bank_spec(out[0]).flatten(out[0]))
    assert torch.equal(outs[0], outs[1])
    assert EnvConfig().deterministic is False


# ---------------------------------------------------------------------------
# AsyncHFLEnv
# ---------------------------------------------------------------------------

FAULTS = {
    "none": (None, None, {}),
    "faults": (FaultSpec(drop_prob=0.2, transient_prob=0.25,
                         outages=(Outage(1, 120.0, 60.0),),
                         churn=(ChurnEvent(150.0, 2, "leave"),
                                ChurnEvent(280.0, 2, "join")), seed=7),
               JFaultSpec(drop_prob=0.2, transient_prob=0.25,
                          outages=(JOutage(1, 120.0, 60.0),),
                          churn=(JChurnEvent(150.0, 2, "leave"),
                                 JChurnEvent(280.0, 2, "join")), seed=7),
               {"flush_deadline": 50.0}),
    "fleet-down": (FaultSpec(churn=tuple(ChurnEvent(60.0, j, "leave")
                                         for j in range(4))),
                   JFaultSpec(churn=tuple(JChurnEvent(60.0, j, "leave")
                                          for j in range(4))), {}),
}


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("case", sorted(FAULTS))
def test_analytic_async_episode_matches_reference_exactly(case):
    """A whole analytic episode, 20 devices, 4 edges, buffer_k 2, poly
    decay, seeded actions: every state, reward and info entry (edge,
    time, g1, g2, flushed, version, staleness, drops), the histories,
    the queue and the fault counters exactly equal. ``faults`` has drops,
    transient retries, an outage, a leave and a join of edge 2 and a
    flush deadline, so degraded flushes happen; in ``fleet-down`` every
    edge leaves and the drained queue ends the episode."""
    spec, jspec, kw = FAULTS[case]
    pe = AsyncHFLEnv(EnvConfig(**ANALYTIC, device="cpu"),
                     AsyncConfig(buffer_k=2, decay="poly", **kw),
                     faults=spec)
    je = jenv.AsyncHFLEnv(jenv.EnvConfig(**ANALYTIC),
                          JAsyncConfig(buffer_k=2, decay="poly", **kw),
                          faults=jspec)
    _same(pe.reset(), je.reset())
    acts = np.random.default_rng(3).uniform(0, 9, size=(500, 2))
    degraded = 0
    for a in acts:
        s, r, d, i = pe.step(a)
        js, jr, jd, ji = je.step(a)
        _same(s, js)
        assert (r, d) == (jr, jd) and i.keys() == ji.keys()
        for k in ji:
            _same(i[k], ji[k])
        assert pe._flush_info == je._flush_info
        degraded += bool((pe._flush_info or {}).get("degraded"))
        if d:
            break
    assert d
    for h in ("acc_hist", "time_hist", "energy_hist"):
        assert getattr(pe, h) == getattr(je, h)
    assert (pe.queue.now, pe.queue._seq, pe.version, pe.n_flushes) == (
        je.queue.now, je.queue._seq, je.version, je.n_flushes)
    assert pe._injector.state() == je._injector.state()
    if case == "faults":
        fi = pe._injector
        assert degraded > 0 and fi.n_dropped.sum() > 0 \
            and fi.n_retries.sum() > 0 and fi.alive.all()
    if case == "fleet-down":
        assert i["fleet_down"] and not pe._injector.alive.any()


def _record_flushes(monkeypatch):
    """Wrap ``StalenessBuffer.flush`` to keep, per flush, the version,
    the buffered (edge, arrival, vector, weight, version) slots, the
    anchor and its weight, and the result."""
    flushes = []
    flush = StalenessBuffer.flush

    def recorded(self, version, max_staleness=0, anchor=None,
                 anchor_weight=0.0):
        slots = [(s.edge, s.arrival, s.vec.clone(), s.weight, s.version)
                 for s in self._slots]
        glob, info = flush(self, version, max_staleness, anchor,
                           anchor_weight)
        flushes.append((version, slots, anchor, anchor_weight, glob))
        return glob, info

    monkeypatch.setattr(StalenessBuffer, "flush", recorded)
    return flushes


def _check_flushes_against_oracles(flushes, decay="poly"):
    for version, slots, anchor, m_w, glob in flushes:
        slots = sorted(slots, key=lambda s: (s[0], s[1]))
        u = np.stack([s[2].numpy() for s in slots])
        w = np.float32([s[3] for s in slots])
        tau = [version - s[4] for s in slots]
        if m_w > 0:
            want = ref.coverage_aggregate_ref(u, w, tau, anchor.numpy(),
                                              m_w, decay=decay)
        else:
            want = ref.staleness_aggregate_ref(u, w, tau, decay=decay)
        assert_close(glob, want, atol=1e-5, rtol=1e-5)


def _real_pair(async_kw, spec=None, jspec=None):
    w0 = _np(jmodel.mnist_cnn_init(jax.random.PRNGKey(REAL["seed"] + 1000)))
    perm_source, edge_perm_source = jax_async_perm_sources(
        REAL["seed"], REAL["gamma_max"], REAL["gamma_max"],
        REAL["n_devices"], REAL["n_local"])
    pe = AsyncHFLEnv(EnvConfig(**REAL, device="cpu"),
                     AsyncConfig(**async_kw), faults=spec,
                     init_params=weights.params_from_numpy(w0, "cpu"),
                     perm_source=perm_source,
                     edge_perm_source=edge_perm_source)
    je = jenv.AsyncHFLEnv(jenv.EnvConfig(**REAL), JAsyncConfig(**async_kw),
                          faults=jspec)
    return pe, je


def _step_pair(pe, je, steps):
    """``steps`` events with action (2, 2): acc within 0.002 (4 of 2000
    test images) after every event, the event's edge, version, flushed,
    staleness and drop equal; returns the port's infos."""
    infos = []
    for _ in range(steps):
        _, _, d, i = pe.step(np.array([2.0, 2.0]))
        _, _, jd, ji = je.step(np.array([2.0, 2.0]))
        assert abs(i["acc"] - ji["acc"]) <= 0.002
        for k in ("edge", "version", "flushed", "staleness", "dropped",
                  "energy", "t_use"):
            _same(i[k], ji[k])
        assert d == jd
        infos.append(i)
        if d:
            break
    return infos


def test_real_async_env_matches_reference_and_join_resyncs_one_edge(
        monkeypatch):
    """MNIST, 8 devices, 2 edges, n_local 64, buffer_k 2, poly decay, the
    reference's w(0) and key chain injected (``jax_async_perm_sources``):
    reset plus 6 events against the reference; every flush within 1e-5 of
    ``staleness_aggregate_ref`` on its buffered vectors. Then edge 0
    leaves and rejoins: its rows and edge model become the global
    vector, the other edge's rows stay bitwise, and it relaunches."""
    flushes = _record_flushes(monkeypatch)
    pe, je = _real_pair(dict(buffer_k=2, decay="poly"))
    pe.reset()
    je.reset()
    assert abs(pe.acc - je.acc) <= 0.002
    infos = _step_pair(pe, je, 6)
    assert sum(i["flushed"] for i in infos) == 3 and pe.version == 3
    assert len(flushes) == 3
    _check_flushes_against_oracles(flushes)
    assert_close(pe._global_vec, np.asarray(je._global_vec), atol=1e-5)

    pe._handle_leave(0)
    assert not pe._injector.alive[0] and not pe._in_flight[0]
    before = pe._spec.flatten(pe.bank).clone()
    pe._handle_join(0)
    after = pe._spec.flatten(pe.bank)
    rows = torch.from_numpy(pe.edge_assign == 0)
    assert torch.equal(after[~rows], before[~rows])
    assert torch.equal(after[rows], pe._global_vec.expand(int(rows.sum()),
                                                         -1))
    assert torch.equal(pe._edge_mat[0], pe._global_vec)
    assert pe._injector.alive[0] and pe._in_flight[0]


def test_real_degraded_flushes_match_reference_and_coverage_oracle(
        monkeypatch):
    """Edge 0 drops every upload (``drop_prob`` [1, 0]) and a 10 s flush
    deadline forces degraded flushes: 8 events against the reference,
    each degraded flush within 1e-5 of ``coverage_aggregate_ref`` on its
    survivors and the anchor. A dropped upload trains nothing."""
    flushes = _record_flushes(monkeypatch)
    spec = FaultSpec(drop_prob=[1.0, 0.0], seed=5)
    pe, je = _real_pair(dict(buffer_k=2, flush_deadline=10.0), spec,
                        JFaultSpec(drop_prob=[1.0, 0.0], seed=5))
    pe.reset()
    je.reset()
    infos = _step_pair(pe, je, 8)
    assert pe._injector.n_dropped[0] > 0
    assert any(i["dropped"] for i in infos)
    assert pe._injector.state() == je._injector.state()
    degraded = [f for f in flushes if f[3] > 0]
    assert degraded and all(f[4] is not None for f in degraded)
    _check_flushes_against_oracles(flushes)
    assert_close(pe._global_vec, np.asarray(je._global_vec), atol=1e-5)


# ---------------------------------------------------------------------------
# the async schemes
# ---------------------------------------------------------------------------

def test_async_fedavg_reproduces_its_bench_learning_row():
    """``scripts/learning_gate.py``'s sweep config (without telemetry and
    health, which the reference guarantees do not perturb the run) with
    ``AsyncConfig(buffer_k=2)``: the committed ``BENCH_learning.json``
    row, to its rounding."""
    with open(os.path.join(REPO, "BENCH_learning.json")) as f:
        row = {r["scheme"]: r for r in json.load(f)}["async-fedavg"]
    cfg = EnvConfig(task="mnist", mode="analytic", n_devices=20, n_edges=4,
                    threshold_time=600.0, gamma_max=8, seed=0,
                    device="cpu")
    h = sync.run_scheme("async-fedavg",
                        AsyncHFLEnv(cfg, async_cfg=AsyncConfig(buffer_k=2)))
    t = e = 0.0
    for acc, dt, de in zip(h["acc"], h["time"], h["energy"]):
        t += dt
        e += de
        if acc >= row["target_acc"]:
            break
    assert (round(h["final_acc"], 6), h["rounds"], round(t, 3),
            round(e, 3)) == (0.797833, 56, 78.266, 91.493)
    assert (round(h["final_acc"], 6), h["rounds"], round(t, 3),
            round(e, 3)) == (row["final_acc"], row["rounds"],
                             row["time_to_target_s"],
                             row["energy_to_target_mAh"])


def test_async_arena_trains_and_runs_as_reference():
    """``train_agent`` for one episode on the analytic AsyncHFLEnv with
    the reference's init and key chain injected, then ``async-arena``:
    the same episode, histories and rewards (exactly, while no raw action
    lies within the port's error of a rounding boundary; the message
    gives the closest), params within 1e-5."""
    je = jenv.AsyncHFLEnv(jenv.EnvConfig(**ANALYTIC),
                          JAsyncConfig(buffer_k=2))
    pe = AsyncHFLEnv(EnvConfig(**ANALYTIC, device="cpu"),
                     AsyncConfig(buffer_k=2))
    raw = []
    step = je.step
    je.step = lambda a: (raw.append(np.asarray(a)), step(a))[1]
    jagent, jlog = jsync.train_agent(je, 1, seed=0)
    init = _np(jnet.init_net(jax.random.PRNGKey(0), je.state_shape,
                             je.action_dim))
    noise, shuffle = jax_agent_draws(0, je.action_dim)
    agent, log = sync.train_agent(pe, 1, seed=0, init_params=init,
                                  noise_source=noise,
                                  shuffle_seed_source=shuffle)
    frac = np.concatenate(raw) % 1.0
    msg = (f"closest raw action to a rounding boundary: "
           f"{float(np.min(np.abs(frac - 0.5))):.2e} over {len(raw)} steps")
    assert log.episode_acc == jlog.episode_acc, msg
    np.testing.assert_allclose(log.episode_rewards, jlog.episode_rewards,
                               rtol=1e-12, err_msg=msg)
    assert log.episode_energy == jlog.episode_energy, msg
    for k, v in _np(jagent.params).items():
        assert_close(agent.params[k], v, atol=1e-5)
    h = sync.run_scheme("async-arena", pe, agent=agent)
    jh = jsync.run_scheme("async-arena", je, agent=jagent)
    assert h["rounds"] > 1
    for k in ("acc", "energy", "time", "final_acc", "rounds"):
        assert h[k] == jh[k], k


def test_async_env_refuses_unported_options_and_defaults_to_the_card():
    tm, hm = Telemetry(), HealthMonitor()
    pe = AsyncHFLEnv(EnvConfig(**ANALYTIC, device="cpu"), telemetry=tm,
                     health=hm)
    assert pe.telemetry is tm and pe.health is hm
    pe = AsyncHFLEnv(EnvConfig(**ANALYTIC, device="cpu", telemetry=True,
                               health=True))
    assert pe.telemetry.enabled and isinstance(pe.health, HealthMonitor)
    mesh = BankMesh(dims=(1, 1), rank=0, device=torch.device("cpu"))
    pm = AsyncHFLEnv(EnvConfig(**ANALYTIC, device="cpu",
                               agg=hfl.AggContext.for_mesh(mesh)))
    assert pm.agg_ctx.mesh is mesh and pm.agg_ctx.sharded
    assert pm.reset().shape == pm.state_shape
    with pytest.raises(TypeError, match="AggContext"):
        AsyncHFLEnv(EnvConfig(**ANALYTIC, device="cpu", agg=mesh))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AsyncHFLEnv(EnvConfig(**ANALYTIC))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AsyncHFLEnv(EnvConfig(**REAL))
    pe = AsyncHFLEnv(EnvConfig(**ANALYTIC, device="cpu"))
    assert pe.buffer_k == 4 and pe.action_dim == 2
    assert pe.reset().shape == pe.state_shape == (5, 15)
    assert not pe.telemetry.enabled and pe.health is None
    assert pe.queue.observer is None
    assert env.AsyncHFLEnv is AsyncHFLEnv
