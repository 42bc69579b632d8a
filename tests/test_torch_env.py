"""The port's environment stack against the reference's: numpy-RNG
modules byte-identical per seed, an analytic episode exactly equal, and
a tiny real-mode ``HFLEnv`` equal to tolerance over reset and two steps
(with the reference's ``w(0)`` and shuffles injected)."""
import jax
import numpy as np
import pytest
from _torch_parity import jax_env_perm_source, to_numpy

from repro.core import profiling as jprofiling
from repro.data import federated as jfed
from repro.data import synthetic as jsyn
from repro.models import model as jmodel
from repro.sim import env as jenv
from repro.sim import hardware as jhw
from repro_torch import weights
from repro_torch.core import profiling
from repro_torch.data import federated, synthetic
from repro_torch.sim import env, hardware


def _same(a, b):
    a, b = to_numpy(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("task,seed", [("mnist", 0), ("cifar", 3)])
def test_synthetic_data_and_shards_byte_identical_300(task, seed):
    jfn = jsyn.synth_mnist if task == "mnist" else jsyn.synth_cifar
    fn = synthetic.synth_mnist if task == "mnist" else synthetic.synth_cifar
    jtr, jte = jfn(n_train=300, n_test=40, seed=seed)
    tr, te = fn(n_train=300, n_test=40, seed=seed, device="cpu")
    for a, b in ((tr, jtr), (te, jte)):
        _same(a["x"], b["x"])
        _same(a["y"], b["y"])
    for scheme in ("label2", "iid", "dirichlet"):
        jf = jfed.make_federated(jtr, jte, 6, 20, scheme=scheme, seed=seed)
        f = federated.make_federated(tr, te, 6, 20, scheme=scheme,
                                     seed=seed)
        _same(f.x, jf.x)
        _same(f.y, jf.y)
        _same(f.device_sizes(), jf.device_sizes())


@pytest.mark.parametrize("task,n", [("mnist", 50), ("cifar", 23)])
def test_hardware_draws_and_clusters_identical(task, n):
    jrng, rng = np.random.default_rng(5), np.random.default_rng(5)
    jp = jhw.DeviceProfiles.sample(jrng, n, task=task)
    p = hardware.DeviceProfiles.sample(rng, n, task=task)
    for f in ("cpu_usage", "freq", "flops", "profile_time",
              "profile_energy"):
        _same(getattr(p, f), getattr(jp, f))
    _same(p.epoch_time(rng), jp.epoch_time(jrng))
    _same(p.epoch_energy(rng), jp.epoch_energy(jrng))
    regions = ["cn", "cn", "us"]
    jc, c = jhw.CommModel(regions, task=task), hardware.CommModel(regions,
                                                                  task=task)
    _same(c.ec_time(rng), jc.ec_time(jrng))
    _same(c.de_time(rng, 3), jc.de_time(jrng, 3))
    _same(profiling.cluster_devices(p, 5, seed=2),
          jprofiling.cluster_devices(jp, 5, seed=2))


def test_analytic_episode_matches_reference_exactly_20dev_4edge():
    kw = dict(task="mnist", mode="analytic", n_devices=20, n_edges=4,
              threshold_time=300.0, seed=1)
    je = jenv.HFLEnv(jenv.EnvConfig(**kw))
    pe = env.HFLEnv(env.EnvConfig(**kw, device="cpu"))
    _same(pe.reset(), je.reset())
    acts = np.random.default_rng(0).uniform(0, 9, size=(6, 8))
    for a in acts:
        js, jr, jd, ji = je.step(a)
        s, r, d, i = pe.step(a)
        _same(s, js)
        assert (r, d) == (jr, jd)
        assert i.keys() == ji.keys()
        for k in ji:
            _same(np.asarray(i[k]), np.asarray(ji[k]))
    _, jr, _, ji = je.run_fixed(3, 2)
    _, r, _, i = pe.run_fixed(3, 2)
    assert r == jr and i == ji


def test_real_env_matches_reference_4dev_2edge_64local():
    """acc within 0.002 (4 of 2000 test images) and the state within
    1e-4, PCA columns up to a per-column sign (eigh fixes none)."""
    kw = dict(task="mnist", mode="real", n_devices=4, n_edges=2,
              n_local=64, gamma_max=2, threshold_time=600.0, seed=0)
    je = jenv.HFLEnv(jenv.EnvConfig(**kw))
    w0 = jmodel.mnist_cnn_init(jax.random.PRNGKey(kw["seed"] + 1000))
    pe = env.HFLEnv(
        env.EnvConfig(**kw, device="cpu"),
        init_params=weights.params_from_numpy(
            {k: np.asarray(v) for k, v in w0.items()}, "cpu"),
        perm_source=jax_env_perm_source(kw["seed"], 2, 2, 4, 64))
    n_pca = kw.get("n_pca", 6)

    def check(s, js, acc, jacc):
        assert abs(acc - jacc) <= 0.002
        assert s.shape == js.shape == (3, n_pca + 3)
        np.testing.assert_allclose(s[:, n_pca:], js[:, n_pca:], atol=1e-4)
        for c in range(n_pca):
            sign = 1.0 if np.dot(s[:, c], js[:, c]) >= 0 else -1.0
            np.testing.assert_allclose(sign * s[:, c], js[:, c], atol=1e-4)

    check(pe.reset(), je.reset(), pe.acc, je.acc)
    steps = [("raw", (np.array([2, 1]), np.array([1, 2]))),
             ("act", np.array([1.2, 2.0, 2.4, 0.6]))]
    for kind, a in steps:
        if kind == "raw":
            js, jr, jd, ji = je.step_raw(*a)
            s, r, d, i = pe.step_raw(*a)
        else:
            js, jr, jd, ji = je.step(a)
            s, r, d, i = pe.step(a)
        check(s, js, i["acc"], ji["acc"])
        assert d == jd and i["energy"] == ji["energy"]
        assert abs(r - jr) <= 0.002 * np.log(64) * 64 ** max(
            i["acc"], ji["acc"]) + 1e-9
