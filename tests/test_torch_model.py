"""The port's paper CNNs against the reference's on loaded reference
parameters: logits, loss and per-leaf gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_close, assert_tree_close, to_torch

from repro.models import model as jmodel
from repro_torch import weights
from repro_torch.models import model

CASES = {
    "mnist": (jmodel.mnist_cnn_init, jmodel.mnist_cnn_apply,
              model.mnist_cnn_init, model.mnist_cnn_apply, (28, 28, 1),
              21840),
    "cifar": (jmodel.cifar_cnn_init, jmodel.cifar_cnn_apply,
              model.cifar_cnn_init, model.cifar_cnn_apply, (32, 32, 3),
              456906),
}

CONV_STD = {"mnist": {"c1_w": 0.1, "c2_w": 0.1},
            "cifar": {"c1_w": 0.1, "c2_w": 0.05, "c3_w": 0.05}}

# f32 convolutions and matmuls with other summation orders
ATOL = 1e-5


@pytest.mark.parametrize("task", ["mnist", "cifar"],
                         ids=["mnist-b6", "cifar-b6"])
def test_logits_loss_grads_match_reference(task):
    jinit, japply, _, apply, hwc, _ = CASES[task]
    jparams = jinit(jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(6,) + hwc).astype(np.float32)
    y = rng.integers(0, 10, size=(6,)).astype(np.int32)
    jbatch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    params = weights.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    batch = {"x": to_torch(x), "y": to_torch(y)}

    assert_close(apply(params, batch["x"]), japply(jparams, jbatch["x"]),
                 atol=ATOL)
    jloss, jgrad = jax.value_and_grad(
        lambda p: jmodel.cnn_loss(japply, p, jbatch))(jparams)
    loss_fn = lambda p: model.cnn_loss(apply, p, batch)
    assert_close(loss_fn(params), jloss, atol=ATOL)
    grads = torch.func.grad(loss_fn)(params)
    assert_tree_close(grads, jgrad, atol=ATOL)
    assert_close(model.cnn_accuracy(apply, params, batch),
                 jmodel.cnn_accuracy(japply, jparams, jbatch), atol=0)


@pytest.mark.parametrize("task", ["mnist", "cifar"])
def test_init_shapes_and_law(task):
    jinit, _, init, _, _, n_params = CASES[task]
    gen = torch.Generator().manual_seed(0)
    params = init(gen, "cpu")
    jparams = jinit(jax.random.PRNGKey(0))
    assert sorted(params) == sorted(jparams)
    assert model.count_params(params) == jmodel.count_params(jparams) \
        == n_params
    for k, v in params.items():
        assert tuple(v.shape) == jparams[k].shape
        assert v.dtype == torch.float32 and v.device.type == "cpu"
        if k.endswith("_b"):
            assert torch.count_nonzero(v) == 0
        else:       # dense_init: N(0, 1) truncated to [-3, 3], times std
            std = CONV_STD[task].get(k, 1.0 / np.sqrt(v.shape[0]))
            assert float(v.abs().max()) <= 3 * std * (1 + 1e-6)
            if v.numel() >= 1000:     # truncated unit normal: sd 0.9866
                assert abs(float(v.std()) / std - 0.9866) < 0.1
    again = init(torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(again[k], params[k]) for k in params)
