"""The port's flat bank (``repro_torch.core.flatbank``) against the
reference's ``bank_spec``: leaf order, offsets, width, dtype and the
flat matrix itself, plus the port's zero-copy view layout."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import to_torch

from repro.core import flatbank as jflat
from repro.core import hfl as jhfl
from repro.models import model as jmodel
from repro_torch import weights
from repro_torch.core import flatbank, hfl


@pytest.mark.parametrize("task,n,width", [("mnist", 5, 21840),
                                          ("cifar", 3, 456906)],
                         ids=["mnist-5x21840", "cifar-3x456906"])
def test_spec_and_flatten_equal_reference(task, n, width):
    init = jmodel.mnist_cnn_init if task == "mnist" else jmodel.cifar_cnn_init
    jbank = jhfl.init_bank(init, jax.random.PRNGKey(3), n)
    jbank = jax.tree.map(lambda a: a + jnp.arange(n, dtype=a.dtype).reshape(
        (n,) + (1,) * (a.ndim - 1)), jbank)              # rows differ
    jspec = jflat.bank_spec(jbank)
    jkeys = [p[0].key for p, _ in jax.tree_util.tree_flatten_with_path(
        jbank)[0]]
    bank = weights.bank_from_numpy(
        {k: np.asarray(v) for k, v in jbank.items()}, "cpu")
    spec = flatbank.bank_spec(bank)
    assert list(spec.keys) == jkeys                     # c1_b, c1_w, ...
    assert spec.offsets == jspec.offsets
    assert spec.sizes == jspec.sizes
    assert spec.width == jspec.width == width
    assert spec.dtype == torch.float32
    mat = spec.flatten(bank)
    assert torch.equal(mat, to_torch(jspec.flatten(jbank)))  # bitwise


def test_mixed_dtypes_promote_and_round_trip_9x140():
    rng = np.random.default_rng(0)
    jbank = {"w": jnp.asarray(rng.normal(size=(9, 2, 3, 5)), jnp.float32),
             "b": jnp.asarray(rng.normal(size=(9, 74)), jnp.bfloat16),
             "h": jnp.asarray(rng.normal(size=(9, 5, 7)), jnp.bfloat16),
             "s": jnp.asarray(rng.normal(size=(9,)), jnp.float32)}
    jspec = jflat.bank_spec(jbank)
    bank = weights.params_from_numpy(
        {k: np.asarray(v) for k, v in jbank.items()}, "cpu")
    spec = flatbank.bank_spec(bank)
    assert spec.dtype == torch.float32 == to_torch(
        np.zeros(1, jspec.dtype)).dtype
    assert spec.offsets == jspec.offsets and spec.width == 140
    mat = spec.flatten(bank)
    assert torch.equal(mat, to_torch(jspec.flatten(jbank)))
    back = spec.unflatten(mat)
    for k in bank:
        assert back[k].dtype == bank[k].dtype
        assert torch.equal(back[k], bank[k])              # exact round trip


def test_view_layout_flattens_without_copy_6x21840():
    bank = hfl.broadcast_model(
        weights.params_from_numpy({k: np.asarray(v) for k, v in
                                   jmodel.mnist_cnn_init(
                                       jax.random.PRNGKey(0)).items()},
                                  "cpu"), 6)
    spec = flatbank.bank_spec(bank)
    mat = spec.flatten(bank)
    assert mat.data_ptr() == bank["c1_b"].data_ptr()       # no copy
    bank["f2_w"][4].add_(1.0)                              # in place ...
    off = spec.offsets[spec.keys.index("f2_w")]
    assert torch.all(mat[4, off:off + 500] == bank["f2_w"][4].reshape(-1))
    # ... while separately allocated leaves are concatenated
    copies = {k: v.clone() for k, v in bank.items()}
    assert torch.equal(spec.flatten(copies), mat)
    assert spec.flatten(copies).data_ptr() != mat.data_ptr()


def test_model_vector_round_trip_and_select():
    bank = weights.bank_from_numpy(
        {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
         "b": np.ones((3, 2, 2), np.float32)}, "cpu")
    spec = flatbank.bank_spec(bank)
    model = hfl.bank_select(bank, 1)
    vec = spec.flatten_model(model)
    assert vec.shape == (8,) and vec.data_ptr() == model["a"].data_ptr()
    back = spec.unflatten_model(vec)
    assert all(torch.equal(back[k], model[k]) for k in model)
