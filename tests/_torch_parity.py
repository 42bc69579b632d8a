"""Shared helpers for the port's parity tests (``tests/test_torch_*.py``).

The same numpy inputs go through the JAX reference and the PyTorch port;
these helpers move data between the two and compare the results with a
tolerance stated at each call.
"""
import jax
import numpy as np
import torch

from repro_torch import weights


def to_torch(a, device="cpu") -> torch.Tensor:
    """numpy or JAX array -> CPU tensor (bf16 carried over exactly)."""
    return weights.tensor_from_numpy(a, torch.device(device))


def to_numpy(t) -> np.ndarray:
    """Tensor or array -> float-comparable numpy array (bf16 -> f32)."""
    if torch.is_tensor(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def assert_close(got, want, *, atol: float, rtol: float = 0.0) -> float:
    """Assert ``|got - want| <= atol + rtol * |want|`` elementwise with
    the stated tolerance; returns the max abs error."""
    g, w = to_numpy(got), to_numpy(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, atol=atol, rtol=rtol)
    return float(np.max(np.abs(g.astype(np.float64) - w))) if g.size else 0.0


def rel_err(got, want) -> float:
    """Relative L2 error ``|got - want| / |want|`` over all elements."""
    g = to_numpy(got).astype(np.float64)
    w = to_numpy(want).astype(np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def assert_tree_close(got: dict, want: dict, *, atol: float,
                      rtol: float = 0.0) -> float:
    """Leafwise ``assert_close`` of a port dict against a reference dict
    (same keys); returns the max abs error over all leaves."""
    assert sorted(got) == sorted(want)
    return max(assert_close(got[k], want[k], atol=atol, rtol=rtol)
               for k in want)


def jax_fedavg_perms(key, max_g1: int, n: int,
                     n_local: int) -> np.ndarray:
    """The shuffles the reference's local trainer draws from ``key`` over
    ``max_g1`` epochs, as a ``(max_g1, n, n_local)`` int64 array: each
    epoch splits ``key`` and draws one permutation per device from
    ``split(sub, n)`` (``make_local_trainer``). ``make_fedavg_round``
    hands its key straight to the trainer."""
    out = np.empty((max_g1, n, n_local), np.int64)
    perm = jax.vmap(lambda k: jax.random.permutation(k, n_local))
    for e in range(max_g1):
        key, sub = jax.random.split(key)
        out[e] = np.asarray(perm(jax.random.split(sub, n)))
    return out


def jax_round_perms(key, max_g2: int, max_g1: int, n: int,
                    n_local: int) -> np.ndarray:
    """The shuffles one reference cloud round draws from ``key``, as a
    ``(max_g2, max_g1, n, n_local)`` int64 array indexed by (t2, epoch).

    Reproduces the key chain of ``repro.core.hfl``: each t2 step splits
    ``key`` (``make_cloud_round``'s ``t2_step``) and hands the step's key
    to the local trainer (:func:`jax_fedavg_perms`)."""
    out = np.empty((max_g2, max_g1, n, n_local), np.int64)
    for t2 in range(max_g2):
        key, sub = jax.random.split(key)
        out[t2] = jax_fedavg_perms(sub, max_g1, n, n_local)
    return out


def jax_env_perm_source(seed: int, max_g2: int, max_g1: int, n: int,
                        n_local: int):
    """A ``perm_source`` for ``repro_torch.sim.HFLEnv`` that yields, call
    by call, the shuffles the reference ``HFLEnv`` draws round by round
    from its key chain (``PRNGKey(seed)``, one ``_next_key`` per
    round)."""
    state = {"key": jax.random.PRNGKey(seed)}

    def source():
        state["key"], sub = jax.random.split(state["key"])
        return torch.from_numpy(
            jax_round_perms(sub, max_g2, max_g1, n, n_local))

    return source


def jax_agent_draws(seed: int, action_dim: int):
    """``(noise_source, shuffle_seed_source)`` for
    ``repro_torch.core.agent.PPOAgent`` that replay the reference
    ``PPOAgent(PRNGKey(seed), ...)``'s key chain: both advance one shared
    ``_next_key`` split, in call order; an action's noise is
    ``normal(sub, (action_dim,))`` and an update's shuffle seed
    ``randint(sub, (), 0, 2**31 - 1)``. The init params are
    ``repro.core.agent.networks.init_net(PRNGKey(seed), ...)``."""
    state = {"key": jax.random.PRNGKey(seed)}

    def next_key():
        state["key"], sub = jax.random.split(state["key"])
        return sub

    def noise():
        return np.asarray(jax.random.normal(next_key(), (action_dim,)))

    def shuffle_seed():
        return int(jax.random.randint(next_key(), (), 0, 2**31 - 1))

    return noise, shuffle_seed


def jax_async_perm_sources(seed: int, max_g2: int, max_g1: int, n: int,
                           n_local: int, *, key=None, abase=None):
    """``(perm_source, edge_perm_source)`` for
    ``repro_torch.sim.AsyncHFLEnv`` that replay the reference
    ``AsyncHFLEnv``'s key chain: ``PRNGKey(seed)``; per episode one
    ``_next_key`` split for the warmup round (``perm_source``), then
    ``abase`` = the next split; the edge round trained from version v
    draws from ``fold_in(abase, v)`` (``edge_perm_source(v)``,
    :func:`jax_round_perms`). ``abase`` is split at the first
    ``edge_perm_source`` call of an episode, or skipped at the next
    warmup if the episode made none, so the chain stays the reference's
    either way.

    With ``key`` and ``abase`` (the chain a reference runtime snapshot
    saved, for ``repro_torch.checkpoint.store.load_runtime``) the sources
    continue that chain instead: the first ``perm_source`` call, the
    warmup round of the load's ``reset`` (which the load overwrites),
    draws from a throwaway key; after it edge rounds draw from
    ``fold_in(abase, v)`` and the next episode's warmup splits ``key``."""
    resumed = key is not None
    state = {"key": jax.random.PRNGKey(seed) if not resumed
             else jax.numpy.asarray(key),
             "abase": None if not resumed else jax.numpy.asarray(abase),
             "pending": False, "cache": {}, "throwaway": resumed}

    def next_key():
        state["key"], sub = jax.random.split(state["key"])
        return sub

    def perm_source():
        if state["throwaway"]:
            state["throwaway"] = False
            return torch.from_numpy(jax_round_perms(
                jax.random.PRNGKey(0), max_g2, max_g1, n, n_local))
        if state["pending"]:            # the last episode's abase, unused
            next_key()
        out = jax_round_perms(next_key(), max_g2, max_g1, n, n_local)
        state["pending"] = True
        return torch.from_numpy(out)

    def edge_perm_source(version):
        if state["pending"]:
            state["abase"], state["pending"] = next_key(), False
            state["cache"] = {}
        v = int(version)
        if v not in state["cache"]:
            state["cache"][v] = torch.from_numpy(jax_round_perms(
                jax.random.fold_in(state["abase"], v), max_g2, max_g1, n,
                n_local))
        return state["cache"][v]

    return perm_source, edge_perm_source
