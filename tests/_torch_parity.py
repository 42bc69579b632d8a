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


def jax_round_perms(key, max_g2: int, max_g1: int, n: int,
                    n_local: int) -> np.ndarray:
    """The shuffles one reference cloud round draws from ``key``, as a
    ``(max_g2, max_g1, n, n_local)`` int64 array indexed by (t2, epoch).

    Reproduces the key chain of ``repro.core.hfl``: each t2 step splits
    ``key`` (``make_cloud_round``'s ``t2_step``), and each epoch of the
    local trainer splits the step's key again and draws one permutation
    per device from ``split(sub, n)`` (``make_local_trainer``)."""
    out = np.empty((max_g2, max_g1, n, n_local), np.int64)
    perm = jax.vmap(lambda k: jax.random.permutation(k, n_local))
    for t2 in range(max_g2):
        key, sub = jax.random.split(key)
        for e in range(max_g1):
            sub, sub2 = jax.random.split(sub)
            out[t2, e] = np.asarray(perm(jax.random.split(sub2, n)))
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
