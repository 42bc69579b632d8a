"""Child-process driver for the port's crash-recovery test (not a pytest
file); the counterpart of ``tests/recovery_driver.py``. Imports only the
port.

Modes (argv[1]):

* ``full <ckpt> <save_step>``   -- run the episode uninterrupted; also
  snapshot at ``save_step`` (so the checkpoint exists), then print the
  final-state JSON.
* ``crash <ckpt> <save_step>``  -- run ``save_step`` steps, snapshot,
  take two more steps (work that must be lost), then SIGKILL ourselves:
  a hard crash, no teardown.
* ``resume <ckpt> <save_step>`` -- fresh env, ``load_runtime``, run to
  the episode's end, print the final-state JSON.

``full`` and ``resume`` must give identical records: the same final
global model and bank hashes, accuracy, histories, fault counts and,
with telemetry on (always here), the same merged event trace and
counters. The test runs ``crash`` in a child process and ``full`` and
``resume`` in its own (``run``), all on one torch thread.
"""
import hashlib
import json
import os
import signal
import sys

import numpy as np

from repro_torch.checkpoint import store
from repro_torch.runtime import AsyncConfig, FaultSpec
from repro_torch.sim import AsyncHFLEnv, EnvConfig

CFG = dict(task="mnist", mode="real", n_devices=4, n_edges=2, n_local=32,
           batch_size=16, threshold_time=100.0, gamma_max=2, seed=0,
           device="cpu", telemetry=True, health=True)
ACFG = AsyncConfig(buffer_k=2, flush_deadline=45.0)
# a non-null spec, so the resume also restores the fault injector
SPEC = FaultSpec(drop_prob=0.25, transient_prob=0.2, seed=11)
ACTION = np.array([2.0, 2.0])


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def make_env():
    return AsyncHFLEnv(EnvConfig(**CFG), ACFG, faults=SPEC)


def finish(env, steps_done: int) -> dict:
    """Run ``env`` to the episode's end; the final-state record."""
    done = False
    while not done:
        _, _, done, _ = env.step(ACTION)
        steps_done += 1
    events = json.dumps(env.telemetry.recorder.events, sort_keys=True)
    return {
        "acc": env.acc, "version": env.version, "steps": steps_done,
        "gvec": _sha(env._global_vec.numpy()),
        "bank": _sha(env._spec.flatten(env.bank).numpy()),
        "acc_hist_tail": env.acc_hist[-5:],
        "drops": env._injector.n_dropped.tolist(),
        "retries": env._injector.n_retries.tolist(),
        "trace_events": len(env.telemetry.recorder),
        "trace_sha": hashlib.sha256(events.encode()).hexdigest(),
        "counters": dict(sorted(env.telemetry.metrics.counters.items())),
        "health": [e.to_dict() for e in env.health.events]}


def run(mode: str, ckpt: str, save_step: int):
    """One mode; returns the final-state record (``crash`` never
    returns)."""
    env = make_env()
    if mode == "resume":
        store.load_runtime(env, ckpt)
        return finish(env, save_step)
    env.reset()
    for _ in range(save_step):
        env.step(ACTION)
    store.save_runtime(env, ckpt)
    if mode == "crash":
        env.step(ACTION)                 # post-checkpoint work ...
        env.step(ACTION)                 # ... that the crash destroys
        os.kill(os.getpid(), signal.SIGKILL)
    return finish(env, save_step)        # mode == "full"


if __name__ == "__main__":
    print(json.dumps(run(sys.argv[1], sys.argv[2], int(sys.argv[3]))))
