"""Crash recovery for the port's async runtime
(``repro_torch.checkpoint.store``), against the reference's snapshots:

* in-process ``save_runtime`` / ``load_runtime`` resumes **bitwise**
  (events, global vector, bank) in both env modes, faults on;
* a run SIGKILLed mid-episode in a child process resumes from its
  snapshot to the same final model and the same merged trace as an
  uninterrupted run (``_torch_recovery_driver.py``, ``_subproc.py``'s
  plumbing);
* a reference analytic snapshot (``repro.checkpoint.store.save_runtime``)
  loaded by the port continues exactly as the reference's own
  continuation, trace included; a real-mode one continues within the
  real-mode tolerance with the reference's key chain injected, and is
  refused without it;
* ``save_pytree`` / ``load_pytree`` round trips, and the reference reads
  the port's files.
"""
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_close, jax_async_perm_sources

import _subproc
import _torch_recovery_driver
from repro.checkpoint import store as jstore
from repro.models import model as jmodel
from repro.runtime import AsyncConfig as JAsyncConfig
from repro.runtime import FaultSpec as JFaultSpec
from repro.sim import env as jenv
from repro_torch import weights
from repro_torch.checkpoint import store
from repro_torch.runtime import AsyncConfig, FaultSpec
from repro_torch.sim import AsyncHFLEnv, EnvConfig

ANALYTIC = dict(task="mnist", mode="analytic", n_devices=20, n_edges=4,
                threshold_time=400.0, seed=0)
# real mode at the smallest size that still flushes, drops and retries
REAL = dict(task="mnist", mode="real", n_devices=4, n_edges=2, n_local=32,
            batch_size=16, threshold_time=240.0, gamma_max=2, seed=0)
SPEC = dict(drop_prob=0.15, transient_prob=0.2, seed=9)
ACFG = dict(buffer_k=2, flush_deadline=40.0)
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's torch work: the suite runs in
    several worker processes at once, and a thread pool per process over
    the same cores slows every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _steps(env, n):
    out = []
    for _ in range(n):
        _, r, done, info = env.step(np.array([3.0, 2.0]))
        out.append((float(r), float(info["acc"]), info["edge"],
                    info["flushed"]))
        if done:
            break
    return out


def _env(cfg, **kw):
    return AsyncHFLEnv(EnvConfig(**cfg, device="cpu", **kw),
                       AsyncConfig(**ACFG), faults=FaultSpec(**SPEC))


@pytest.mark.parametrize("mode", ["analytic", "real"])
def test_in_process_save_restore_resumes_bitwise(mode, tmp_path):
    """Save after 4 events (analytic: 10), load into a fresh env, run
    both on: the events, the fault bookkeeping and (real mode) the
    global vector and bank bitwise equal; every restored tensor on the
    env's device."""
    cfg = REAL if mode == "real" else ANALYTIC
    n0, n1 = (4, 6) if mode == "real" else (10, 15)
    env = _env(cfg)
    env.reset()
    _steps(env, n0)
    path = str(tmp_path / "rt")
    store.save_runtime(env, path)
    tail_a = _steps(env, n1)
    env2 = _env(cfg)
    store.load_runtime(env2, path)
    if mode == "real":
        assert env2._global_vec.device == env2.device
        assert all(s.vec.device == env2.device for s in env2.buffer._slots)
    tail_b = _steps(env2, n1)
    assert tail_a == tail_b and len(tail_a) == n1
    assert env2._injector.state() == env._injector.state()
    assert env2.rng.bit_generator.state == env.rng.bit_generator.state
    if mode == "real":
        assert torch.equal(env2._global_vec, env._global_vec)
        assert torch.equal(env2._spec.flatten(env2.bank),
                           env._spec.flatten(env.bank))
        # the next episode's shuffles come from the same generator state
        assert torch.equal(env2._perm_gen.get_state(),
                           env._perm_gen.get_state())
        assert env2._edge_perm_base == env._edge_perm_base


def test_save_restore_rejects_config_mismatch(tmp_path):
    env = AsyncHFLEnv(EnvConfig(**ANALYTIC, device="cpu"),
                      AsyncConfig(buffer_k=2))
    env.reset()
    path = str(tmp_path / "rt")
    store.save_runtime(env, path)
    env2 = AsyncHFLEnv(EnvConfig(**{**ANALYTIC, "n_edges": 5},
                                 device="cpu"), AsyncConfig(buffer_k=2))
    with pytest.raises(ValueError, match="mismatch"):
        store.load_runtime(env2, path)


def _driver(*args) -> subprocess.Popen:
    """``_torch_recovery_driver.py`` started in a child process (one torch
    thread, as in this file)."""
    return subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_recovery_driver.py"),
         *map(str, args)], env=_subproc.child_env(OMP_NUM_THREADS=1),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_kill_resume_converges_to_uninterrupted_model_and_trace(tmp_path):
    """SIGKILL a traced real-mode run with faults in a child process
    after its snapshot (destroying two steps of post-snapshot work),
    resume a fresh env from the dead process's snapshot: the final
    global model, bank, histories, fault counts, health events and the
    merged trace equal the uninterrupted run's. The uninterrupted run
    (while the child runs) and the resume run here, on one torch thread
    as in the child."""
    ck_full, ck_crash = str(tmp_path / "full"), str(tmp_path / "crash")
    save_step = 3
    crashed = _driver("crash", ck_crash, save_step)
    want = _torch_recovery_driver.run("full", ck_full, save_step)
    assert want["trace_events"] > 0 and want["steps"] > save_step + 2
    _, err = crashed.communicate(timeout=600)
    assert crashed.returncode == -signal.SIGKILL, err[-2000:]  # it died
    assert os.path.exists(ck_crash + ".npz")
    got = _torch_recovery_driver.run("resume", ck_crash, save_step)
    assert json.dumps(got) == json.dumps(want), (got, want)


def test_reference_analytic_snapshot_continues_exactly(tmp_path):
    """The reference's analytic env with faults, telemetry and health on,
    snapshotted by ``repro.checkpoint.store`` after 10 events: loaded by
    the port, the next 15 events (states, rewards, infos), the fault
    state, the trace, the metrics and the health events equal the
    reference's own continuation exactly."""
    kw = dict(telemetry=True, health=True)
    je = jenv.AsyncHFLEnv(jenv.EnvConfig(**ANALYTIC, **kw),
                          JAsyncConfig(**ACFG), faults=JFaultSpec(**SPEC))
    je.reset()
    for _ in range(10):
        je.step(np.array([3.0, 2.0]))
    path = str(tmp_path / "ref")
    jstore.save_runtime(je, path)
    pe = _env(ANALYTIC, **kw)
    store.load_runtime(pe, path)
    for a in np.random.default_rng(4).uniform(0, 9, size=(15, 2)):
        s, r, d, i = pe.step(a)
        js, jr, jd, ji = je.step(a)
        assert s.tobytes() == js.tobytes() and (r, d) == (jr, jd)
        assert i.keys() == ji.keys()
        for k in ji:
            if isinstance(ji[k], (dict, list)):    # telemetry, health
                assert i[k] == ji[k], k
            else:
                assert np.asarray(i[k]).tobytes() \
                    == np.asarray(ji[k]).tobytes(), k
    assert pe._injector.state() == je._injector.state()
    assert (pe.queue.now, pe.queue._seq, pe.version) == (
        je.queue.now, je.queue._seq, je.version)
    assert pe.telemetry.recorder.events == je.telemetry.recorder.events
    assert pe.telemetry.metrics.snapshot() == je.telemetry.metrics.snapshot()
    assert pe.health.state() == je.health.state()


def test_reference_real_snapshot_needs_its_key_chain(tmp_path):
    """The reference's real-mode env (MNIST, 4 devices, 2 edges, n_local
    32) snapshotted after 2 events. Loaded by the port with the
    reference's w(0) and its saved key chain replayed
    (``jax_async_perm_sources(key=, abase=)``): the next 3 events' edges,
    versions and flushes equal, acc within 0.002 and the global vector
    within 1e-5 of the reference's continuation (the real-mode
    tolerance). Without injected sources the load raises."""
    je = jenv.AsyncHFLEnv(jenv.EnvConfig(**REAL), JAsyncConfig(buffer_k=2))
    je.reset()
    for _ in range(2):
        je.step(np.array([2.0, 2.0]))
    path = str(tmp_path / "ref")
    jstore.save_runtime(je, path)
    data = np.load(path + ".npz")
    with pytest.raises(ValueError, match="key chain"):
        store.load_runtime(AsyncHFLEnv(EnvConfig(**REAL, device="cpu"),
                                       AsyncConfig(buffer_k=2)), path)
    w0 = {k: np.asarray(v) for k, v in jmodel.mnist_cnn_init(
        jax.random.PRNGKey(REAL["seed"] + 1000)).items()}
    ps, eps = jax_async_perm_sources(
        REAL["seed"], REAL["gamma_max"], REAL["gamma_max"],
        REAL["n_devices"], REAL["n_local"], key=data["key"],
        abase=data["abase"])
    pe = AsyncHFLEnv(EnvConfig(**REAL, device="cpu"),
                     AsyncConfig(buffer_k=2),
                     init_params=weights.params_from_numpy(w0, "cpu"),
                     perm_source=ps, edge_perm_source=eps)
    store.load_runtime(pe, path)
    assert pe.version == je.version and pe.acc == je.acc
    assert_close(pe._global_vec, np.asarray(je._global_vec), atol=0.0)
    flushes = 0
    for _ in range(3):
        _, _, _, i = pe.step(np.array([2.0, 2.0]))
        _, _, _, ji = je.step(np.array([2.0, 2.0]))
        assert abs(i["acc"] - ji["acc"]) <= 0.002
        assert (i["edge"], i["version"], i["flushed"]) == (
            ji["edge"], ji["version"], ji["flushed"])
        flushes += i["flushed"]
    assert flushes > 0
    assert_close(pe._global_vec, np.asarray(je._global_vec), atol=1e-5)


def test_pytree_roundtrip_and_reference_reads_the_port(tmp_path):
    """A nested dict/list/tuple of f32, bf16 and int tensors: the port's
    ``load_pytree`` restores each leaf's values, dtype and device; the
    file holds the reference's key paths and layout, so
    ``repro.checkpoint.store.load_pytree`` reads it back (bf16 stored
    exactly as f32), and the port reads the reference's."""
    rng = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(rng.normal(size=(3, 4)).astype(
                np.float32)),
            "layers": [{"b": torch.arange(5, dtype=torch.int32)},
                       {"b": torch.from_numpy(rng.normal(size=(2,)).astype(
                           np.float32)).to(torch.bfloat16)}],
            "pair": (torch.ones(2), torch.zeros(1, 2))}
    path = str(tmp_path / "tree")
    store.save_pytree(tree, path)
    back = store.load_pytree(tree, path)
    for (p, a), (_, b) in zip(store._flatten_with_path(tree),
                              store._flatten_with_path(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    assert isinstance(back["pair"], tuple) and isinstance(back["layers"],
                                                          list)
    with open(path + ".tree.json") as f:
        meta = json.load(f)
    assert meta["keys"] == ["layers/0/b", "layers/1/b", "pair/0", "pair/1",
                            "w"]
    jtree = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()
                                               if t.dtype == torch.bfloat16
                                               else t.numpy()), tree)
    jtree["layers"][1]["b"] = jtree["layers"][1]["b"].astype(jnp.bfloat16)
    jback = jstore.load_pytree(jtree, path)
    for (p, a), (_, b) in zip(store._flatten_with_path(tree),
                              jax.tree_util.tree_flatten_with_path(
                                  jback)[0]):
        assert np.array_equal(np.asarray(b).astype(np.float32),
                              a.float().numpy()), p
    jpath = str(tmp_path / "jtree")
    jstore.save_pytree(jtree, jpath)
    back = store.load_pytree(tree, jpath)
    for (_, a), (_, b) in zip(store._flatten_with_path(tree),
                              store._flatten_with_path(back)):
        assert torch.equal(a, b)
