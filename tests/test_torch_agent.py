"""The port's optimizers and PPO agent (``repro_torch.optim``,
``repro_torch.core.agent``) against the reference's on the same numpy
inputs, with the reference's parameters and key-chain draws injected
into the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (assert_close, assert_tree_close, jax_agent_draws,
                           to_torch)

from repro.core.agent import networks as jnet
from repro.core.agent import ppo as jppo
from repro.core import sync as jsync
from repro.optim import optimizers as joptim
from repro.sim import env as jenv
from repro_torch.core import sync
from repro_torch.core.agent import networks, ppo
from repro_torch.optim import optimizers
from repro_torch.sim import env

STATE, ACT = (5, 9), 8              # 4 edges: (M + 1, n_PCA + 3), 2M


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32),
            "k": rng.normal(size=(2, 2, 1, 5)).astype(np.float32)}


def _jax_tree(t):
    return {k: jnp.asarray(v) for k, v in t.items()}


def _torch_tree(t):
    return {k: to_torch(v) for k, v in t.items()}


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(lr=0.1)),
    ("sgd_momentum", dict(lr=0.1, momentum=0.9)),
    ("adam", dict(lr=0.01)),
    ("adam", dict(lr=0.01, weight_decay=0.01)),
], ids=["sgd", "momentum", "adam", "adam-wd"])
def test_optimizer_three_steps_match_reference(name, kw):
    """Three steps on the same trees; atol 1e-6 (f32, one ulp of the
    square root and the bias-correction powers)."""
    jopt, opt = getattr(joptim, name)(**kw), getattr(optimizers, name)(**kw)
    p0 = _tree(0)
    jp, p = _jax_tree(p0), _torch_tree(p0)
    js, s = jopt.init(jp), opt.init(p)
    for i in range(3):
        g = _tree(10 + i)
        jp, js = jopt.update(jp, _jax_tree(g), js)
        p, s = opt.update(p, _torch_tree(g), s)
    assert_tree_close(p, _np(jp), atol=1e-6)
    if name == "adam":
        assert int(s["t"]) == int(js["t"]) == 3
        assert s["t"].dtype == torch.int32
        assert_tree_close(s["m"], _np(js["m"]), atol=1e-6)
        assert_tree_close(s["v"], _np(js["v"]), atol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clips", "keeps"])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(3)
    jg, jn = joptim.clip_by_global_norm(_jax_tree(g), max_norm)
    tg, n = optimizers.clip_by_global_norm(_torch_tree(g), max_norm)
    assert abs(float(n) - float(jn)) <= 1e-6
    assert_tree_close(tg, _np(jg), atol=1e-6)
    if max_norm > float(jn):
        assert_tree_close(tg, g, atol=0.0)


def _ref_params(seed=0):
    return _np(jnet.init_net(jax.random.PRNGKey(seed), STATE, ACT))


def _states(n, seed=1):
    return np.random.default_rng(seed).normal(
        size=(n,) + STATE).astype(np.float32)


def test_init_net_layout_matches_reference():
    """Same names, shapes and dtypes as the reference (conv HWIO, dense
    (in, out)); the biases' constants equal; one seed gives the same
    draws on every call."""
    want = _ref_params()
    got = networks.init_net(torch.Generator().manual_seed(0), STATE, ACT,
                            device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == torch.float32
    for k in ("c1_b", "c2_b", "f1_b", "f2_b", "mu_b", "std_b", "v_b"):
        assert_close(got[k], want[k], atol=0.0)
    again = networks.init_net(torch.Generator().manual_seed(0), STATE, ACT,
                              device="cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)


def test_actor_critic_and_logp_match_reference():
    """Reference params from ``init_net(PRNGKey(0), (5, 9), 8)`` and a
    seeded batch of 7 states; atol 1e-5 (observed 1.3e-7: f32
    conv/matmul order)."""
    jp = _ref_params()
    p = {k: to_torch(v) for k, v in jp.items()}
    s = _states(7)
    jmu, jstd, jv = jnet.actor_critic(_jax_tree(jp), jnp.asarray(s))
    mu, std, v = networks.actor_critic(p, to_torch(s))
    for got, want in ((mu, jmu), (std, jstd), (v, jv)):
        assert_close(got, want, atol=1e-5)
    a = np.random.default_rng(2).normal(size=(7, ACT)).astype(np.float32)
    assert_close(networks.gaussian_logp(mu, std, to_torch(a)),
                 jnet.gaussian_logp(jmu, jstd, jnp.asarray(a)), atol=1e-5)


def _agents(seed=0, cfg=None):
    cfg = cfg or ppo.PPOConfig()
    jcfg = jppo.PPOConfig(**vars(cfg))
    ja = jppo.PPOAgent(jax.random.PRNGKey(seed), STATE, ACT, jcfg)
    noise, shuffle = jax_agent_draws(seed, ACT)
    pa = ppo.PPOAgent(0, STATE, ACT, cfg, device="cpu",
                      init_params=_np(ja.params), noise_source=noise,
                      shuffle_seed_source=shuffle)
    return ja, pa


def test_act_matches_reference_with_injected_noise():
    """Three stochastic actions (the reference's key chain replayed as the
    port's noise) and one deterministic; atol 1e-5 on a, logp, v."""
    ja, pa = _agents()
    for i, s in enumerate(_states(4, seed=3)):
        det = i == 3
        ja_, jl, jv = ja.act(s, deterministic=det)
        a, logp, v = pa.act(s, deterministic=det)
        assert isinstance(a, np.ndarray) and a.dtype == np.float32
        assert a.shape == (ACT,) and isinstance(logp, float)
        assert_close(a, ja_, atol=1e-5)
        assert abs(logp - jl) <= 1e-5 and abs(v - jv) <= 1e-5


def _rollout(n, seed=4):
    rng = np.random.default_rng(seed)
    s = _states(n, seed=seed)
    out = []
    for t in range(n):
        done = (t + 1) % 17 == 0 or t == n - 1
        out.append((s[t], rng.normal(size=ACT).astype(np.float32),
                    float(rng.normal()), float(rng.normal()),
                    float(rng.normal()), done))
    return out


def _remember(agent, roll):
    for s, a, logp, r, v, done in roll:
        agent.remember(s, a, logp, r, v, done)


@pytest.mark.parametrize("enhancements", [True, False],
                         ids=["gae", "hwamei"])
def test_advantages_bitwise_equal(enhancements):
    cfg = ppo.PPOConfig(enhancements=enhancements)
    ja, pa = _agents(cfg=cfg)
    roll = _rollout(40)
    _remember(ja, roll)
    _remember(pa, roll)
    (jadv, jret), (adv, ret) = ja._advantages(), pa._advantages()
    assert adv.dtype == jadv.dtype == np.float32
    assert adv.tobytes() == jadv.tobytes()
    assert ret.tobytes() == jret.tobytes()


@pytest.mark.parametrize("n", [40, 100], ids=["1-minibatch", "2-minibatches"])
def test_update_matches_reference(n):
    """One end-of-episode update (6 epochs of minibatch 64, clip 0.5,
    Adam) from reference params with the reference's shuffle seed; params
    within atol 1e-5 (observed 1.0e-6 at 40 steps, 3.0e-6 at 100: f32
    gradients in other summation orders through Adam's normalisation),
    memory cleared."""
    ja, pa = _agents()
    roll = _rollout(n)
    _remember(ja, roll)
    _remember(pa, roll)
    jstd, std = ja.update(), pa.update()
    assert pa.memory == [] and ja.memory == []
    assert abs(std - jstd) <= 1e-6
    assert_tree_close(pa.params, _np(ja.params), atol=1e-5)
    assert int(pa.opt_state["t"]) == int(ja.opt_state["t"])


def test_update_with_empty_memory_is_a_noop():
    _, pa = _agents()
    before = {k: v.clone() for k, v in pa.params.items()}
    assert pa.update() == 0.0
    assert all(torch.equal(before[k], pa.params[k]) for k in before)


def test_train_agent_matches_reference_analytic_20dev_4edge():
    """Two episodes of Algorithm 1 on the analytic 20-device/4-edge env
    with the reference's init and key chain injected. The env maps each
    raw action to integers by rounding, so the episodes are exactly the
    reference's while no raw action lies within the port's error of a
    rounding boundary; the message gives the closest one (at seed 0:
    1.6e-4 over 59 steps, against params within 1e-5)."""
    kw = dict(task="mnist", mode="analytic", n_devices=20, n_edges=4,
              threshold_time=300.0, seed=1)
    je = jenv.HFLEnv(jenv.EnvConfig(**kw))
    pe = env.HFLEnv(env.EnvConfig(**kw, device="cpu"))
    raw = []
    step = je.step
    je.step = lambda a: (raw.append(np.asarray(a)), step(a))[1]
    jagent, jlog = jsync.train_agent(je, 2, seed=0)
    init = _np(jnet.init_net(jax.random.PRNGKey(0), je.state_shape,
                             je.action_dim))
    noise, shuffle = jax_agent_draws(0, je.action_dim)
    agent, log = sync.train_agent(pe, 2, seed=0, init_params=init,
                                  noise_source=noise,
                                  shuffle_seed_source=shuffle)
    frac = np.concatenate(raw) % 1.0
    margin = float(np.min(np.abs(frac - 0.5)))
    msg = (f"closest raw action to a rounding boundary: {margin:.2e} "
           f"over {len(raw)} steps")
    assert log.episode_acc == jlog.episode_acc, msg
    np.testing.assert_allclose(log.episode_rewards, jlog.episode_rewards,
                               rtol=1e-12, err_msg=msg)
    np.testing.assert_allclose(log.episode_energy, jlog.episode_energy,
                               rtol=1e-12, err_msg=msg)
    assert_tree_close(agent.params, _np(jagent.params), atol=1e-5)
