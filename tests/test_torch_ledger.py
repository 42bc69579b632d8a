"""The port's run ledger and health monitors (``repro_torch.telemetry.
ledger`` / ``.health``) against the reference's and their own contracts:

* health-monitor units: NaN/Inf guard (accuracy and bank, the bank read
  by the env on its device), divergence with re-arm, flush stall with
  re-arm, the opt-in abort, the JSON state round trip;
* ledger units: deterministic, config-sensitive run ids
  (``config_digest``), byte-identical episode rows on repeat, every
  ``run_scheme(ledger=...)`` form, load/list/diff/report;
* the ledger's episode rows equal the reference's field for field on
  equal inputs (analytic async, faults, telemetry and health on), the
  header aside (it records the port's ``EnvConfig``);
* **no perturbation** one layer up: ledger + health + telemetry on vs
  off reproduce trajectories bitwise, analytic (faults) and real mode;
* one history schema across every scheme of ``core.sync.SCHEMES``;
* health state and the ledger run id ride runtime checkpoints.
"""
import json
import math
import os

import numpy as np
import pytest
import torch

from repro.core import sync as jsync
from repro.runtime import AsyncConfig as JAsyncConfig
from repro.runtime import ChurnEvent as JChurnEvent
from repro.runtime import FaultSpec as JFaultSpec
from repro.runtime import Outage as JOutage
from repro.sim import env as jenv
from repro.telemetry import RunLedger as JRunLedger
from repro.telemetry import ledger as jledger
from repro_torch.checkpoint import store
from repro_torch.core import sync
from repro_torch.core.agent import PPOAgent, PPOConfig
from repro_torch.runtime import AsyncConfig, ChurnEvent, FaultSpec, Outage
from repro_torch.sim import AsyncHFLEnv, EnvConfig, HFLEnv
from repro_torch.telemetry import (HealthAbort, HealthConfig, HealthMonitor,
                                   RunLedger, ledger)

ANALYTIC = dict(task="mnist", mode="analytic", n_devices=20, n_edges=4,
                threshold_time=400.0, seed=0)
REAL = dict(task="mnist", mode="real", n_devices=8, n_edges=2, n_local=64,
            batch_size=32, threshold_time=240.0, gamma_max=3, seed=0)
TINY = dict(REAL, n_devices=4, n_local=32, batch_size=16, gamma_max=2)
FAULTY = FaultSpec(drop_prob=0.2, transient_prob=0.25,
                   outages=(Outage(1, 50.0, 40.0),),
                   churn=(ChurnEvent(80.0, 2, "leave"),
                          ChurnEvent(160.0, 2, "join")), seed=5)
JFAULTY = JFaultSpec(drop_prob=0.2, transient_prob=0.25,
                     outages=(JOutage(1, 50.0, 40.0),),
                     churn=(JChurnEvent(80.0, 2, "leave"),
                            JChurnEvent(160.0, 2, "join")), seed=5)
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


@pytest.fixture(autouse=True)
def _no_process_default():
    """No test leaks a process-default ledger into the next."""
    yield
    ledger.disable()


def _cfg(**kw):
    return EnvConfig(**{**ANALYTIC, **kw}, device="cpu")


def _episode(cfg_dict, spec, *, on, max_steps=10_000):
    """One async episode (or ``max_steps`` events) with health and
    telemetry all on or all off: (trajectory, fingerprint, env)."""
    env = AsyncHFLEnv(EnvConfig(**cfg_dict, device="cpu", telemetry=on,
                                health=on), AsyncConfig(**ACFG),
                      faults=spec)
    env.reset()
    traj = []
    for _ in range(max_steps):
        _, r, done, info = env.step(ACTION)
        traj.append((float(r), float(info["acc"]), info["edge"],
                     info["flushed"]))
        if done:
            break
    if cfg_dict["mode"] == "real":
        fp = torch.cat([env._global_vec,
                        env._spec.flatten(env.bank).reshape(-1)]).numpy()
    else:
        fp = np.asarray(env.acc_hist, np.float64)
    return traj, fp, env


# ---------------------------------------------------------------------------
# health-monitor units
# ---------------------------------------------------------------------------

def test_health_nan_acc_guard_fires_once():
    hm = HealthMonitor()
    assert hm.observe(step=0, sim_time=0.0, acc=0.2) == []
    new = hm.observe(step=1, sim_time=1.0, acc=float("nan"))
    assert [e.kind for e in new] == ["nan_acc"]
    assert new[0].severity == "critical" and hm.critical
    assert hm.observe(step=2, sim_time=2.0, acc=float("inf")) == []
    assert len(hm.events) == 1


def test_health_nan_bank_guard_reads_the_global_model():
    """The monitor's unit, then the env's read: a real-mode async env
    whose global vector holds a NaN reports ``nan_bank`` at its next
    flushed observation, and an untouched one reports nothing."""
    hm = HealthMonitor()
    new = hm.observe(step=3, sim_time=9.0, acc=0.5, bank_finite=False)
    assert [e.kind for e in new] == ["nan_bank"]
    assert hm.critical and hm.events[0].step == 3
    env = AsyncHFLEnv(EnvConfig(**TINY, device="cpu", health=True),
                      AsyncConfig(buffer_k=2))
    env.reset()
    info = {}
    env._observe_health(info, flushed=True)
    assert info["health"] == []
    env._global_vec = env._global_vec.clone()
    env._global_vec[5] = float("nan")
    env._observe_health(info, flushed=True)
    assert [e["kind"] for e in info["health"]] == ["nan_bank"]
    sync_env = HFLEnv(EnvConfig(**TINY, device="cpu", health=True))
    sync_env.reset()
    next(iter(sync_env.global_model.values())).view(-1)[0] = float("inf")
    sync_env._observe_health(info)
    assert [e["kind"] for e in info["health"]] == ["nan_bank"]


def test_health_divergence_detection_and_rearm():
    hm = HealthMonitor(HealthConfig(window=4, collapse_drop=0.1))
    for i, acc in enumerate([0.5, 0.52, 0.54, 0.56]):
        assert hm.observe(step=i, sim_time=float(i), acc=acc) == []
    new = hm.observe(step=4, sim_time=4.0, acc=0.40)
    assert [e.kind for e in new] == ["divergence"]
    assert new[0].severity == "warn" and not hm.critical
    assert new[0].detail["trailing_max"] == pytest.approx(0.56)
    assert hm.observe(step=5, sim_time=5.0, acc=0.41) == []
    hm.observe(step=6, sim_time=6.0, acc=0.55)
    hm.observe(step=7, sim_time=7.0, acc=0.56)
    new = hm.observe(step=8, sim_time=8.0, acc=0.30)
    assert [e.kind for e in new] == ["divergence"]
    assert len(hm.events) == 2


def test_health_flush_stall_and_rearm():
    hm = HealthMonitor(HealthConfig(stall_events=3))
    for i in range(2):
        assert hm.observe(step=i, sim_time=0.0, acc=0.2,
                          flushed=False) == []
    new = hm.observe(step=2, sim_time=2.0, acc=0.2, flushed=False)
    assert [e.kind for e in new] == ["flush_stall"]
    assert new[0].detail["events_since_flush"] == 3
    assert hm.observe(step=3, sim_time=3.0, acc=0.2, flushed=False) == []
    hm.observe(step=4, sim_time=4.0, acc=0.2, flushed=True)
    for i in range(5, 7):
        hm.observe(step=i, sim_time=float(i), acc=0.2, flushed=False)
    new = hm.observe(step=7, sim_time=7.0, acc=0.2, flushed=False)
    assert [e.kind for e in new] == ["flush_stall"]


def test_health_abort_policy_opt_in():
    hm = HealthMonitor(HealthConfig(abort=True))
    with pytest.raises(HealthAbort) as exc:
        hm.observe(step=5, sim_time=1.0, acc=float("nan"))
    assert exc.value.events[0].kind == "nan_acc"
    hm2 = HealthMonitor(HealthConfig(window=2, collapse_drop=0.05,
                                     abort=True))
    hm2.observe(step=0, sim_time=0.0, acc=0.5)
    hm2.observe(step=1, sim_time=1.0, acc=0.5)
    new = hm2.observe(step=2, sim_time=2.0, acc=0.1)   # warn: no abort
    assert [e.kind for e in new] == ["divergence"]


def test_health_state_roundtrip():
    hm = HealthMonitor(HealthConfig(window=3))
    hm.observe(step=0, sim_time=0.0, acc=0.3, bank_finite=False)
    hm.observe(step=1, sim_time=1.0, acc=0.31, flushed=False)
    hm2 = HealthMonitor()
    hm2.set_state(json.loads(json.dumps(hm.state())))
    assert hm2.cfg == hm.cfg
    assert [e.to_dict() for e in hm2.events] \
        == [e.to_dict() for e in hm.events]
    assert hm2.state() == hm.state()


def test_env_surfaces_health_in_info():
    env = HFLEnv(_cfg(health=True))
    env.reset()
    _, _, _, info = env.run_fixed(2, 2)
    assert info["health"] == []        # healthy run: present but empty
    env = HFLEnv(_cfg(), health=HealthConfig(window=3))
    assert isinstance(env.health, HealthMonitor)
    assert env.health.cfg.window == 3
    aenv = AsyncHFLEnv(_cfg(health=True), AsyncConfig(**ACFG))
    aenv.reset()
    _, _, _, info = aenv.step(ACTION)
    assert isinstance(info["health"], list)
    plain = HFLEnv(_cfg())
    plain.reset()
    assert "health" not in plain.run_fixed(2, 2)[3]


# ---------------------------------------------------------------------------
# ledger units
# ---------------------------------------------------------------------------

def test_config_digest_deterministic_and_exclusion():
    d1, s1 = ledger.config_digest(_cfg(), exclude=("agg", "mesh"))
    d2, _ = ledger.config_digest(_cfg(), exclude=("agg", "mesh"))
    assert d1 == d2 and "agg" not in s1 and "mesh" not in s1
    assert s1["device"] == "cpu" and s1["deterministic"] is False
    assert ledger.config_digest(_cfg(seed=7), exclude=("agg",))[0] != d1
    assert ledger.config_digest(_cfg(deterministic=True),
                                exclude=("agg", "mesh"))[0] != d1
    assert ledger.config_digest(None) == ("none", None)
    # the digest is the reference's function on the same summary
    assert jledger._digest(s1) == d1


def test_run_id_deterministic_and_config_sensitive(tmp_path):
    lg = RunLedger(str(tmp_path))
    rid = lg.begin_run(scheme="vanilla-hfl", env=HFLEnv(_cfg()),
                       params={"g1": 5, "g2": 4})
    assert lg.begin_run(scheme="vanilla-hfl", env=HFLEnv(_cfg()),
                        params={"g1": 5, "g2": 4}) == rid
    assert lg.begin_run(scheme="vanilla-hfl", env=HFLEnv(_cfg(seed=3)),
                        params={"g1": 5, "g2": 4}) != rid
    assert lg.begin_run(scheme="var-freq-a", env=HFLEnv(_cfg())) != rid
    rows = [json.loads(x) for x in open(lg.path(rid))]
    assert [r["kind"] for r in rows] == ["header"]
    h = rows[0]
    assert h["schema"] == ledger.SCHEMA_VERSION == jledger.SCHEMA_VERSION
    assert h["mesh"] == "single-chip" and h["env_cfg"]["seed"] == 0
    assert h["package_version"] == jledger.__version__


def test_repeat_runs_append_byte_identical_rows(tmp_path):
    lg = RunLedger(str(tmp_path))
    hs = [sync.run_scheme("vanilla-hfl", HFLEnv(_cfg()), ledger=lg)
          for _ in range(2)]
    assert hs[0]["ledger_run_id"] == hs[1]["ledger_run_id"]
    lines = open(lg.path(hs[0]["ledger_run_id"])).read().splitlines()
    assert len(lines) == 3             # header + two episode rows
    assert lines[1] == lines[2]        # byte-identical fixed-seed rows


def test_run_scheme_ledger_arg_forms(tmp_path, monkeypatch):
    h = sync.run_scheme("vanilla-hfl", HFLEnv(_cfg()))   # no default
    assert "ledger_run_id" not in h
    ledger.enable(str(tmp_path / "default"))             # process default
    h2 = sync.run_scheme("vanilla-hfl", HFLEnv(_cfg()))
    assert os.path.exists(os.path.join(str(tmp_path / "default"),
                                       h2["ledger_run_id"] + ".jsonl"))
    h3 = sync.run_scheme("vanilla-hfl", HFLEnv(_cfg()), ledger=False)
    assert "ledger_run_id" not in h3                     # explicit off
    ledger.disable()
    h4 = sync.run_scheme("vanilla-hfl", HFLEnv(_cfg()),
                         ledger=str(tmp_path / "path"))  # a root path
    assert os.path.exists(os.path.join(str(tmp_path / "path"),
                                       h4["ledger_run_id"] + ".jsonl"))
    monkeypatch.chdir(tmp_path)                          # True: default
    h5 = sync.run_scheme("vanilla-hfl", HFLEnv(_cfg()), ledger=True)
    assert os.path.exists(os.path.join(ledger.DEFAULT_ROOT,
                                       h5["ledger_run_id"] + ".jsonl"))
    assert h["acc"] == h2["acc"] == h3["acc"] == h4["acc"] == h5["acc"]
    assert isinstance(ledger.resolve(RunLedger("x")), RunLedger)
    assert ledger.resolve(None) is None and ledger.get_default() is None


def test_episode_rows_match_reference_header_aside(tmp_path):
    """``async-fedavg`` on the analytic env with faults, telemetry and
    health on: the port's episode row and health rows equal the
    reference's field for field but the run id; the header differs only
    where the configs do (the port's EnvConfig adds ``device`` and
    ``deterministic``)."""
    lg = RunLedger(str(tmp_path / "port"))
    jlg = JRunLedger(str(tmp_path / "ref"))
    short = dict(threshold_time=200.0)      # past the faults, no further
    pe = AsyncHFLEnv(_cfg(telemetry=True, health=True, **short),
                     AsyncConfig(**ACFG), faults=FAULTY)
    je = jenv.AsyncHFLEnv(jenv.EnvConfig(**{**ANALYTIC, **short},
                                         telemetry=True, health=True),
                          JAsyncConfig(**ACFG), faults=JFAULTY)
    h = sync.run_scheme("async-fedavg", pe, ledger=lg)
    jh = jsync.run_scheme("async-fedavg", je, ledger=jlg)
    assert h == {**jh, "ledger_run_id": h["ledger_run_id"]}
    run = ledger.load_run(lg.path(h["ledger_run_id"]))
    jrun = jledger.load_run(jlg.path(jh["ledger_run_id"]))
    strip = lambda rows: [{k: v for k, v in r.items() if k != "run_id"}
                          for r in rows]
    assert strip(run["episodes"]) == strip(jrun["episodes"])
    assert strip(run["health"]) == strip(jrun["health"])
    ep = run["episodes"][0]
    assert ep["flushes"] > 0 and ep["retries"] > 0 and ep["drops"] > 0
    assert ep["staleness"]["count"] > 0 and ep["coverage"]["count"] > 0
    hd, jhd = run["header"], jrun["header"]
    assert {k for k in hd if hd[k] != jhd[k]} \
        == {"run_id", "env_digest", "env_cfg"}
    assert set(hd["env_cfg"]) - set(jhd["env_cfg"]) \
        == {"device", "deterministic"}


def test_load_list_diff_and_report(tmp_path):
    root = str(tmp_path / "ledger")
    lg = RunLedger(root)
    small = dict(ANALYTIC, n_devices=10, n_edges=2, threshold_time=200.0)
    for seed in (0, 1):
        sync.run_scheme("vanilla-hfl", HFLEnv(EnvConfig(
            **{**small, "seed": seed}, device="cpu")), ledger=lg)
    runs = ledger.list_runs(root)
    assert len(runs) == 2 and {r["scheme"] for r in runs} \
        == {"vanilla-hfl"}
    a, b = [r["_run"] for r in runs]
    d = ledger.diff_runs(a, b)
    assert set(d["config"]) >= {"seed", "env_cfg.seed"}
    assert d["metrics"]["final_acc"]["delta"] == pytest.approx(
        b["episodes"][-1]["final_acc"] - a["episodes"][-1]["final_acc"])
    out = ledger.render_report(root, str(tmp_path / "report.html"))
    body = open(out).read()
    assert body.count("<svg") == 2 and "vanilla-hfl" in body
    (tmp_path / "bad.jsonl").write_text("\n")
    with pytest.raises(ValueError, match="no header"):
        ledger.load_run(str(tmp_path / "bad.jsonl"))
    assert ledger.list_runs(str(tmp_path / "missing")) == []


# ---------------------------------------------------------------------------
# the bitwise no-perturbation guarantee, one layer up
# ---------------------------------------------------------------------------

def test_ledger_health_bitwise_analytic_with_faults(tmp_path):
    t_off, fp_off, _ = _episode(ANALYTIC, FAULTY, on=False)
    ledger.enable(str(tmp_path))    # recording on + health + telemetry
    t_on, fp_on, env = _episode(ANALYTIC, FAULTY, on=True)
    sync.run_scheme("vanilla-hfl", HFLEnv(_cfg()))
    assert t_on == t_off
    np.testing.assert_array_equal(fp_on, fp_off)
    assert env.health is not None and env.telemetry.enabled


def test_ledger_health_bitwise_real_mode(tmp_path):
    """Real mode (MNIST, 8 devices, 2 edges, n_local 64): ``async-fedavg``
    with (2, 2) for 3 events, recorded with health and telemetry on,
    against the same run with all off: histories, global vector and bank
    bitwise equal."""
    runs = []
    for on in (False, True):
        env = AsyncHFLEnv(EnvConfig(**REAL, device="cpu", telemetry=on,
                                    health=on), AsyncConfig(buffer_k=2))
        h = sync.run_scheme("async-fedavg", env, g1=2, g2=2, max_events=3,
                            ledger=RunLedger(str(tmp_path)) if on
                            else False)
        runs.append((h, torch.cat([env._global_vec, env._spec.flatten(
            env.bank).reshape(-1)])))
    (h_off, fp_off), (h_on, fp_on) = runs
    assert h_on["acc"] == h_off["acc"] and h_on["time"] == h_off["time"]
    assert torch.equal(fp_on, fp_off)
    row = ledger.load_run(os.path.join(str(tmp_path), h_on[
        "ledger_run_id"] + ".jsonl"))["episodes"][0]
    assert row["final_acc"] == h_on["final_acc"] and row["healthy"]


# ---------------------------------------------------------------------------
# one history schema across every SchemeSpec
# ---------------------------------------------------------------------------

HISTORY_KEYS = {"acc", "energy", "time", "final_acc", "total_energy",
                "avg_energy", "rounds"}
SMOKE = dict(task="mnist", mode="analytic", n_devices=10, n_edges=2,
             threshold_time=200.0, gamma_max=3, seed=0)
SHARE = dict(task="mnist", mode="real", n_devices=6, n_edges=2, n_local=24,
             batch_size=8, threshold_time=40.0, gamma_max=2, seed=0)


@pytest.mark.parametrize("name", sorted(sync.SCHEMES))
def test_history_schema_uniform_across_schemes(name):
    """Every scheme's two-episode smoke returns the reference's history
    keys (``telemetry`` only with telemetry on) with consistent curve
    lengths: the ledger's episode-row contract."""
    spec = sync.SCHEMES[name]
    cfg = EnvConfig(**(SHARE if name == "share" else SMOKE), device="cpu")
    env = (AsyncHFLEnv(cfg, AsyncConfig(buffer_k=2)) if spec.needs_async
           else HFLEnv(cfg))
    agent = (PPOAgent(0, env.state_shape, env.action_dim, PPOConfig(),
                      device="cpu") if spec.needs_agent else None)
    for _ in range(2):
        h = sync.run_scheme(name, env, agent=agent)
        assert set(h) == HISTORY_KEYS, name
        assert len(h["acc"]) == len(h["energy"]) == len(h["time"]) \
            == h["rounds"] > 0
        assert h["final_acc"] == h["acc"][-1]
        assert h["total_energy"] == pytest.approx(sum(h["energy"]))
    if spec.needs_async:
        env = AsyncHFLEnv(EnvConfig(**SMOKE, device="cpu", telemetry=True),
                          AsyncConfig(buffer_k=2))
        h = sync.run_scheme(name, env, agent=agent)
        assert set(h) == HISTORY_KEYS | {"telemetry"}
        assert h["telemetry"] == env.telemetry.metrics.snapshot()


# ---------------------------------------------------------------------------
# checkpointing: health state and ledger identity survive a resume
# ---------------------------------------------------------------------------

def test_checkpoint_carries_health_and_ledger_id(tmp_path):
    lg = RunLedger(str(tmp_path / "ledger"))
    env = AsyncHFLEnv(_cfg(health=True), AsyncConfig(**ACFG), faults=FAULTY)
    rid = lg.begin_run(scheme="async-fedavg", env=env,
                       params={"g1": 2, "g2": 2})
    env.reset()
    for _ in range(12):
        env.step(ACTION)
    assert len(env.health._window) > 0
    path = str(tmp_path / "ck")
    store.save_runtime(env, path)
    env2 = AsyncHFLEnv(_cfg(health=True), AsyncConfig(**ACFG),
                       faults=FAULTY)
    store.load_runtime(env2, path)
    assert env2.health.state() == env.health.state()
    assert env2._ledger_run_id == rid
    assert lg.begin_run(scheme="async-fedavg", env=env2,
                        params={"g1": 2, "g2": 2}) == rid
    rows = [json.loads(x) for x in open(lg.path(rid))]
    assert [r["kind"] for r in rows] == ["header"]
    assert math.isfinite(env2.acc)
