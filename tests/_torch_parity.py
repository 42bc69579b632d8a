"""Shared helpers for the port's parity tests (``tests/test_torch_*.py``).

The same numpy inputs go through the JAX reference and the PyTorch port;
these helpers move data between the two and compare the results with a
tolerance stated at each call.
"""
import functools

import jax
import jax.numpy as jnp
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


def numpy_model_params(jmodel, seed: int, draw):
    """A reference model's parameters drawn with numpy in its own tree
    (shapes and dtypes from ``jax.eval_shape`` of its init, so no JAX
    init is compiled): ``draw(rng, leaf_name, shape, dtype)`` per leaf,
    in the tree's sorted-key order from ``default_rng(seed)``. Returns
    (the tree as JAX arrays, the same tree as the port's CPU tensors,
    loaded with ``weights.tree_from_numpy``)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map_with_path(
        lambda path, leaf: draw(rng, path[-1].key, leaf.shape, leaf.dtype),
        shapes)
    return jax.tree.map(jnp.asarray, tree), weights.tree_from_numpy(tree,
                                                                    "cpu")


def serve_both(jm, jp, m, p, toks, s: int, steps: int, *, extras=None,
               window: int = 0):
    """One model in both packages: ``logits`` of the whole sequence
    ``toks`` (with ``extras``, numpy arrays of the stub front ends),
    ``prefill`` of its first ``s`` tokens (``max_new`` = ``steps``
    without a window) and ``steps`` teacher-forced decode steps. Returns
    per package (full logits, [prefill logits, step logits...], [cache
    after prefill, cache after the last step]); the reference's caches as
    numpy, the port's prefill cache a copy."""
    extras = extras or {}
    max_new = 0 if window else steps
    jx = {k: jnp.asarray(v) for k, v in extras.items()}
    tx = {k: torch.from_numpy(v) for k, v in extras.items()}
    jfull = jax.jit(functools.partial(jm.logits, window=window))(
        jp, {"tokens": jnp.asarray(toks), **jx})
    jl, jc = jax.jit(functools.partial(jm.prefill, window=window,
                                       max_new=max_new))(
        jp, jnp.asarray(toks[:, :s]), extras=jx)
    jcaches, jlogits = [jax.tree.map(np.asarray, jc)], [jl]
    jdecode = jax.jit(functools.partial(jm.decode_step, window=window))
    for i in range(s, s + steps):
        jl, jc = jdecode(jp, jc, jnp.asarray(toks[:, i:i + 1]))
        jlogits.append(jl)
    jcaches.append(jax.tree.map(np.asarray, jc))
    tt = torch.from_numpy(toks)
    full = m.logits(p, {"tokens": tt, **tx}, window=window)
    lg, cache = m.prefill(p, tt[:, :s], extras=tx, window=window,
                          max_new=max_new)
    caches = [{k: v.clone() if torch.is_tensor(v) else v
               for k, v in cache.items()}]
    logits = [lg]
    for i in range(s, s + steps):
        lg, cache = m.decode_step(p, cache, tt[:, i:i + 1], window=window)
        logits.append(lg)
    caches.append(cache)
    return (jfull, jlogits, jcaches), (full, logits, caches)


def flat_tree(tree: dict, prefix: str = "") -> dict:
    """A nested dict as {"a/b/c": leaf}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flat_tree(v, key) if isinstance(v, dict) else {key: v})
    return out


def nest_tree(flat: dict) -> dict:
    """``flat_tree``'s inverse."""
    out = {}
    for key, v in flat.items():
        d = out
        *head, last = key.split("/")
        for part in head:
            d = d.setdefault(part, {})
        d[last] = v
    return out


def loss_grads_both(jm, jp, m, p, batch: dict, **kw):
    """``Model.loss(**kw)`` and its gradient in every leaf, in both
    packages, on the numpy ``batch``: (reference value, {leaf path:
    reference gradient as numpy}, port value, {leaf path: port
    gradient})."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jval, jg = jax.jit(jax.value_and_grad(lambda q: jm.loss(q, jb, **kw)))(
        jp)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in flat_tree(p).items()}
    val = m.loss(nest_tree(leaves), tb, **kw)
    g = dict(zip(leaves, torch.autograd.grad(val, list(leaves.values()))))
    jg = {"/".join(k.key for k in path): np.asarray(leaf)
          for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]}
    return jval, jg, val, g


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
