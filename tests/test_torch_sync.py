"""The port's synchronization schemes, FedAvg round and convergence bound
(``repro_torch.core.sync``, ``hfl.make_fedavg_round``,
``core.convergence``) against the reference's on the same inputs: the
static schemes' histories on the analytic env, the two
``BENCH_learning.json`` rows, Share's topology, the registry's errors,
the FedAvg round with the reference's shuffles injected and one
real-mode Vanilla-FL episode."""
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (assert_close, assert_tree_close,
                           jax_env_perm_source, jax_fedavg_perms, to_torch)

from repro.core import convergence as jconv
from repro.core import hfl as jhfl
from repro.core import sync as jsync
from repro.data import federated as jfed
from repro.data import synthetic as jsyn
from repro.models import model as jmodel
from repro.sim import env as jenv
from repro_torch import weights
from repro_torch.core import convergence, hfl, sync
from repro_torch.kernels import ops, ref
from repro_torch.models import model
from repro_torch.sim import env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANALYTIC = dict(task="mnist", mode="analytic", n_devices=20, n_edges=4,
                threshold_time=300.0, seed=1)
# scripts/learning_gate.py's SWEEP_CFG without telemetry/health, which
# the reference guarantees do not perturb the trajectory
SWEEP = dict(task="mnist", mode="analytic", n_devices=20, n_edges=4,
             threshold_time=600.0, gamma_max=8, seed=0)
HISTORY_KEYS = ("acc", "energy", "time", "final_acc", "total_energy",
                "avg_energy", "rounds")


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _label2_labels(n, n_local, seed=0):
    tr, te = jsyn.synth_mnist(n_train=n * n_local, n_test=10, seed=seed)
    return np.asarray(jfed.make_federated(tr, te, n, n_local,
                                          scheme="label2", seed=seed).y)


@pytest.mark.parametrize("scheme", ["vanilla-fl", "vanilla-hfl",
                                    "var-freq-a", "var-freq-b", "favor",
                                    "share"])
def test_static_scheme_history_equals_reference(scheme):
    """Exactly equal: the analytic env is numpy end to end
    (``test_analytic_episode_matches_reference_exactly_20dev_4edge``).
    Share reads only the devices' labels, so both envs get the same
    label2 labels."""
    je = jenv.HFLEnv(jenv.EnvConfig(**ANALYTIC))
    pe = env.HFLEnv(env.EnvConfig(**ANALYTIC, device="cpu"))
    if scheme == "share":
        y = _label2_labels(ANALYTIC["n_devices"], 30)
        je.fed = types.SimpleNamespace(y=y)
        pe.fed = types.SimpleNamespace(y=torch.tensor(y))
    jh = jsync.run_scheme(scheme, je)
    h = sync.run_scheme(scheme, pe)
    assert sorted(h) == sorted(jh)
    for k in HISTORY_KEYS:
        assert h[k] == jh[k], k
    np.testing.assert_array_equal(pe.edge_assign, je.edge_assign)


def _to_target(h, target):
    t = e = 0.0
    for acc, dt, de in zip(h["acc"], h["time"], h["energy"]):
        t += dt
        e += de
        if acc >= target:
            return t, e
    return None, None


@pytest.mark.parametrize("scheme", ["vanilla-hfl", "var-freq-a"])
def test_bench_learning_rows_reproduced(scheme):
    """The committed ``BENCH_learning.json`` row, to its rounding."""
    with open(os.path.join(REPO, "BENCH_learning.json")) as f:
        row = {r["scheme"]: r for r in json.load(f)}[scheme]
    h = sync.run_scheme(scheme, env.HFLEnv(env.EnvConfig(**SWEEP,
                                                         device="cpu")))
    t, e = _to_target(h, row["target_acc"])
    assert round(h["final_acc"], 6) == row["final_acc"]
    assert h["rounds"] == row["rounds"]
    assert round(t, 3) == row["time_to_target_s"]
    assert round(e, 3) == row["energy_to_target_mAh"]


def test_share_topology_equals_reference_real_label2_12dev_3edge():
    kw = dict(task="mnist", mode="real", n_devices=12, n_edges=3,
              n_local=64, threshold_time=100.0, seed=0,
              data_scheme="label2")
    jassign = jsync.share_topology(jenv.HFLEnv(jenv.EnvConfig(**kw)))
    pe = env.HFLEnv(env.EnvConfig(**kw, device="cpu"))
    assign = sync.share_topology(pe)
    assert assign.dtype == jassign.dtype
    np.testing.assert_array_equal(assign, jassign)


def test_registry_matches_reference_and_rejects_bad_calls():
    assert sorted(sync.SCHEMES) == sorted(jsync.SCHEMES)
    for name, spec in jsync.SCHEMES.items():
        got = sync.SCHEMES[name]
        assert (got.defaults, got.needs_agent, got.needs_async) == (
            spec.defaults, spec.needs_agent, spec.needs_async), name
    pe = env.HFLEnv(env.EnvConfig(**ANALYTIC, device="cpu"))
    with pytest.raises(TypeError, match="unknown parameter"):
        sync.run_scheme("vanilla-hfl", pe, g3=1)
    with pytest.raises(ValueError, match="needs a trained agent"):
        sync.run_scheme("arena", pe)
    with pytest.raises(TypeError, match="AsyncHFLEnv"):
        sync.run_scheme("async-fedavg", pe)
    with pytest.raises(KeyError, match="unknown scheme"):
        sync.run_scheme("fedprox", pe)
    with pytest.raises(KeyError, match="unknown scheme"):
        sync.run_scheme("fedprox", pe, ledger=True)   # before recording
    h = sync.run_vanilla_hfl(pe, g1=2)          # wrapper: g2 from registry
    jh = jsync.run_vanilla_hfl(jenv.HFLEnv(jenv.EnvConfig(**ANALYTIC)),
                               g1=2)
    assert h["acc"] == jh["acc"]
    pe = env.HFLEnv(env.EnvConfig(**ANALYTIC, device="cpu"))
    h = sync.run_scheme("vanilla-hfl", pe, ledger=False, g1=2)
    assert h["acc"] == jh["acc"] and "ledger_run_id" not in h


def test_fedavg_round_syncs_to_participating_mean():
    """With gamma1 = 0 (no local SGD) the round reduces to the weighted
    mean of the participating devices (atol 1e-6: the plain
    ``segment_agg`` multiplies by the reciprocal weight sum) and resyncs
    the whole bank."""
    rng = np.random.default_rng(9)
    n = 6
    bank = weights.bank_from_numpy(
        {"w": rng.normal(size=(n, 4, 2)).astype(np.float32),
         "b": rng.normal(size=(n, 3)).astype(np.float32)}, "cpu")
    x = to_torch(rng.normal(size=(n, 8, 4)).astype(np.float32))
    y = to_torch(rng.integers(0, 2, size=(n, 8)))
    sizes = to_torch(rng.uniform(1, 3, size=(n,)).astype(np.float32))
    part = np.array([True, False, True, True, False, True])

    def loss(p, batch):
        return torch.mean((batch["x"] @ p["w"][..., 0]) ** 2)

    spec = hfl.flatbank.bank_spec(bank)
    want = ref.segment_agg_ref(spec.flatten(bank).clone(),
                               sizes * torch.from_numpy(part),
                               torch.zeros(n, dtype=torch.int32), 1)[0]
    round_ = hfl.make_fedavg_round(loss, 0.1, 4, max_g1=2)
    perms = torch.stack([torch.stack([torch.randperm(8)
                                      for _ in range(n)])
                         for _ in range(2)])
    new_bank, glob = round_(bank, x, y, sizes, part, 0, perms)
    assert_close(spec.flatten_model(glob), want, atol=1e-6)
    for leaf in new_bank.values():
        assert torch.equal(leaf, leaf[:1].expand_as(leaf))


def test_fedavg_round_matches_reference_mnist_4dev():
    """gamma1 = 2 local epochs of the MNIST CNN on 3 of 4 devices, 64
    samples each, batch 32, lr 0.05, with the reference's shuffles
    injected; atol 1e-5 on the bank and the global model (observed
    3.0e-8, f32 summation order)."""
    _fedavg_round_parity(np.array([True, False, True, True]), 2)


@pytest.mark.parametrize("g1", [[1, 2, 2, 2], [2, 1, 2, 1]])
def test_fedavg_round_per_device_gamma1_matches_reference_mnist_4dev(g1):
    """The same round with all 4 devices participating and one gamma1 per
    device (an int32 vector, as the reference takes it); atol 1e-5. Before
    the port broadcast the vector, it ran every device for gamma1[0]
    epochs: 3.3e-3 and 2.4e-3 off."""
    _fedavg_round_parity(np.ones(4, bool), np.array(g1, np.int32))


def _fedavg_round_parity(part, g1):
    n, n_local, max_g1 = 4, 64, 2
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, n_local, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(n, n_local)).astype(np.int32)
    sizes = np.array([64, 32, 64, 48], np.float32)
    key = jax.random.PRNGKey(11)
    jbank = jhfl.init_bank(jmodel.mnist_cnn_init, jax.random.PRNGKey(5), n)
    bank = weights.bank_from_numpy(_np(jbank), "cpu")

    jloss = lambda p, b: jmodel.cnn_loss(jmodel.mnist_cnn_apply, p, b)
    jround = jhfl.make_fedavg_round(jloss, 0.05, 32, max_g1)
    jb, jg = jround(jbank, jnp.asarray(x), jnp.asarray(y),
                    jnp.asarray(sizes), jnp.asarray(part),
                    jnp.asarray(g1, jnp.int32), key)

    loss = lambda p, b: model.cnn_loss(model.mnist_cnn_apply, p, b)
    rnd = hfl.make_fedavg_round(loss, 0.05, 32, max_g1)
    perms = torch.from_numpy(jax_fedavg_perms(key, max_g1, n, n_local))
    before = dict(ops.LAUNCHES)
    b, g = rnd(bank, to_torch(x), to_torch(y), to_torch(sizes), part, g1,
               perms)
    assert ops.LAUNCHES == before             # CPU: plain versions only
    assert_tree_close(b, _np(jb), atol=1e-5)
    assert_tree_close(g, _np(jg), atol=1e-5)
    assert b["c1_b"].data_ptr() == bank["c1_b"].data_ptr()   # in place


def test_convergence_equals_reference_on_a_grid():
    rng = np.random.default_rng(0)
    for L in (0.5, 2.0):
        for eta in (1e-3, 0.01, 0.1):
            bp = dict(L=L, eta=eta, sigma2=0.7, M=5, N=50)
            jbp, bpp = jconv.BoundParams(**bp), convergence.BoundParams(**bp)
            for g1m in (1.0, 3.0, 8.0):
                for g2m in (1.0, 4.0):
                    assert convergence.one_round_bound(
                        bpp, g1m, g2m, 1.3) == jconv.one_round_bound(
                            jbp, g1m, g2m, 1.3)
                    assert convergence.max_feasible_eta(
                        bpp, g1m, g2m) == jconv.max_feasible_eta(
                            jbp, g1m, g2m)
            for _ in range(4):
                g1 = rng.integers(1, 9, 5)
                g2 = rng.integers(1, 9, 5)
                assert convergence.stepsize_feasible(bpp, g1, g2) == \
                    jconv.stepsize_feasible(jbp, g1, g2)


def test_vanilla_fl_real_episode_matches_reference_4dev_2edge():
    """Reset plus two Vanilla-FL rounds (T = 100 s; random participation
    gives some devices zero weight in ``segment_agg``) with the
    reference's w(0) and shuffles injected: acc within 0.002 (4 of 2000
    test images) per round; energy and time equal (numpy)."""
    kw = dict(task="mnist", mode="real", n_devices=4, n_edges=2,
              n_local=64, gamma_max=2, threshold_time=100.0, seed=0)
    je = jenv.HFLEnv(jenv.EnvConfig(**kw))
    w0 = jmodel.mnist_cnn_init(jax.random.PRNGKey(kw["seed"] + 1000))
    pe = env.HFLEnv(
        env.EnvConfig(**kw, device="cpu"),
        init_params=weights.params_from_numpy(_np(w0), "cpu"),
        perm_source=jax_env_perm_source(kw["seed"], 2, 2, 4, 64))
    jh = jsync.run_scheme("vanilla-fl", je)
    h = sync.run_scheme("vanilla-fl", pe)
    assert h["rounds"] == jh["rounds"] == 2
    assert h["energy"] == jh["energy"] and h["time"] == jh["time"]
    np.testing.assert_allclose(h["acc"], jh["acc"], atol=0.002)
