"""The port's HFL layer (``repro_torch.core.hfl``) against the
reference's: the aggregation entry points and one full cloud round from
the same bank, data and shuffles (the reference's shuffles are injected
into the port)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_tree_close, jax_round_perms, to_torch

from repro.core import hfl as jhfl
from repro.models import model as jmodel
from repro_torch import weights
from repro_torch.core import flatbank, hfl
from repro_torch.kernels import ops
from repro_torch.models import model


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def test_cloud_round_matches_reference_mnist_4dev_2edge():
    """4 devices on 2 edges, 64 samples each, batch 32, lr 0.05,
    gamma1 = (2, 1), gamma2 = (1, 2) under bounds max_g1 = 2, max_g2 = 3:
    exercises the masked epoch, the frozen edge and a skipped t2 step.
    Observed max abs error 4.5e-8 on bank, global and edge models (f32
    conv/matmul summation order); the stated tolerance is rtol 1e-4,
    atol 1e-5."""
    n, m, n_local, max_g1, max_g2 = 4, 2, 64, 2, 3
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, n_local, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(n, n_local)).astype(np.int32)
    sizes = np.array([64, 32, 64, 48], np.float32)
    ea = np.array([0, 1, 1, 0], np.int32)
    g1, g2 = np.array([2, 1]), np.array([1, 2])
    key = jax.random.PRNGKey(11)
    jbank = jhfl.init_bank(jmodel.mnist_cnn_init, jax.random.PRNGKey(5), n)
    bank = weights.bank_from_numpy(_np(jbank), "cpu")

    jloss = lambda p, b: jmodel.cnn_loss(jmodel.mnist_cnn_apply, p, b)
    jround = jhfl.make_cloud_round(jloss, 0.05, 32, m, max_g1, max_g2)
    jb, jg, je = jround(jbank, jnp.asarray(x), jnp.asarray(y),
                        jnp.asarray(sizes), jnp.asarray(ea),
                        jnp.asarray(g1), jnp.asarray(g2), key)

    loss = lambda p, b: model.cnn_loss(model.mnist_cnn_apply, p, b)
    rnd = hfl.make_cloud_round(loss, 0.05, 32, m, max_g1, max_g2)
    perms = torch.from_numpy(jax_round_perms(key, max_g2, max_g1, n,
                                             n_local))
    ops.reset_launches()
    b, g, e = rnd(bank, to_torch(x), to_torch(y), to_torch(sizes),
                  to_torch(ea), g1, g2, perms)
    tol = dict(rtol=1e-4, atol=1e-5)
    assert_tree_close(b, _np(jb), **tol)
    assert_tree_close(g, _np(jg), **tol)
    assert_tree_close(e, _np(je), **tol)
    # the round updated the bank's own storage (in-place reuse)
    assert b["c1_b"].data_ptr() == bank["c1_b"].data_ptr()
    # CPU tensors ran the plain versions: no kernel launch was counted
    assert ops.LAUNCHES == {"segment_agg": 0, "segment_broadcast": 0,
                            "flash_attention": 0, "wkv6": 0}


def test_cloud_round_syncs_bank_in_place_3dev():
    """After a round every device row holds the global model, written
    into the incoming bank's storage, and the edge models are returned
    one per edge."""
    n, n_local = 3, 8
    rng = np.random.default_rng(1)
    bank = weights.bank_from_numpy(
        {"w": rng.normal(size=(n, 4, 2)).astype(np.float32)}, "cpu")
    before = bank["w"].clone()
    loss = lambda p, b: ((b["x"] @ p["w"]) ** 2).mean()
    rnd = hfl.make_cloud_round(loss, 0.1, 4, 2, 1, 1)
    perms = torch.stack([torch.randperm(n_local) for _ in range(n)])
    b, g, e = rnd(bank, torch.randn(n, n_local, 4), torch.zeros(n, n_local),
                  torch.ones(n), torch.tensor([0, 1, 0], dtype=torch.int32),
                  np.ones(2), np.ones(2), perms[None, None])
    assert b["w"].data_ptr() == bank["w"].data_ptr()
    assert not torch.equal(b["w"], before)
    assert torch.equal(b["w"], g["w"].expand_as(b["w"]))   # synced to w
    assert e["w"].shape == (2, 4, 2)


@pytest.mark.parametrize("n,m,seed", [(11, 4, 0), (6, 6, 1)],
                         ids=["11dev-4edge", "6dev-6edge"])
def test_aggregates_match_reference(n, m, seed):
    rng = np.random.default_rng(seed)
    jbank = {"w": jnp.asarray(rng.normal(size=(n, 2, 3, 5)), jnp.float32),
             "b": jnp.asarray(rng.normal(size=(n, 74)), jnp.float32)}
    w = rng.uniform(0.1, 3.0, size=(n,)).astype(np.float32)
    seg = rng.integers(0, m, size=(n,)).astype(np.int32)
    bank = weights.bank_from_numpy(_np(jbank), "cpu")
    want = jhfl.weighted_aggregate(jbank, jnp.asarray(w), jnp.asarray(seg),
                                   m)
    got = hfl.weighted_aggregate(bank, to_torch(w), to_torch(seg), m)
    assert_tree_close(got, _np(want), atol=1e-6)
    edge = hfl.edge_aggregate(bank, to_torch(w), to_torch(seg), m)
    assert_tree_close(edge, _np(want), atol=1e-6)
    esz = np.bincount(seg, weights=w, minlength=m).astype(np.float32)
    jcloud = jhfl.cloud_aggregate(want, jnp.asarray(esz))
    cloud = hfl.cloud_aggregate(edge, to_torch(esz))
    assert_tree_close(cloud, _np(jcloud), atol=1e-6)


def test_masked_resync_matches_reference_and_all_alive_is_plain():
    rng = np.random.default_rng(3)
    e, p, n = 3, 130, 7
    edge_mat = rng.normal(size=(e, p)).astype(np.float32)
    bank_mat = rng.normal(size=(n, p)).astype(np.float32)
    ea = np.array([0, 1, 2, 0, 1, 2, 0], np.int32)
    alive = np.array([True, False, True])
    want = jhfl.masked_resync(jnp.asarray(edge_mat), jnp.asarray(bank_mat),
                              jnp.asarray(ea), jnp.asarray(alive))
    got = hfl.masked_resync(to_torch(edge_mat), to_torch(bank_mat),
                            to_torch(ea), alive)
    assert torch.equal(got, to_torch(np.asarray(want)))       # bitwise
    assert torch.equal(got[1], to_torch(bank_mat)[1])         # dead edge
    every = hfl.masked_resync(to_torch(edge_mat), to_torch(bank_mat),
                              to_torch(ea), np.ones(e, bool))
    assert torch.equal(every, ops.segment_broadcast(to_torch(edge_mat),
                                                    to_torch(ea)))


def test_bank_helpers_and_unported_context():
    gen = torch.Generator().manual_seed(0)
    bank = hfl.init_bank(model.mnist_cnn_init, gen, 3, device="cpu")
    spec = flatbank.bank_spec(bank)
    mat = spec.flatten(bank)
    assert mat.shape == (3, 21840) and mat.data_ptr() == \
        bank["c1_b"].data_ptr()
    assert torch.equal(mat[0], mat[2])                        # same w(0)
    one = hfl.bank_select(bank, 1)
    assert all(torch.equal(one[k], bank[k][1]) for k in bank)
    with pytest.raises(TypeError, match="BankMesh"):
        hfl.AggContext.for_mesh(object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            hfl.init_bank(model.mnist_cnn_init, gen, 3)      # cuda default
