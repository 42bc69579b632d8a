"""The port's CUDA kernels on the card, against their plain versions on
the same CUDA tensors. Marked ``cuda``: each test skips (from inside the
``cuda_dev`` fixture) where no CUDA device is available. On a GPU host:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports no JAX, so it runs on a host without it.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import hfl
from repro_torch.kernels import hier_agg, ops, ref
from repro_torch.models import model

pytestmark = pytest.mark.cuda

# segment_agg: the kernel sums rows in order with fmaf, the plain
# version with index_add_; the summation orders differ
AGG_TOL = 1e-5
SHAPES = [(50, 21840, 5), (5, 21840, 1), (50, 456906, 5), (5, 456906, 1),
          (9, 997, 4), (40, 3000, 32)]
IDS = ["mnist-eq1", "mnist-eq2", "cifar-eq1", "cifar-eq2", "ragged",
       "32-segments"]


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(dev, n, p, e, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    bank = torch.randn((n, p), generator=gen, device=dev).to(dtype)
    w = torch.rand((n,), generator=gen, device=dev) * 2.9 + 0.1
    seg = torch.randint(0, e, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    return bank, w, seg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n,p,e", SHAPES, ids=IDS)
def test_segment_agg_kernel_matches_plain(cuda_dev, n, p, e, dtype):
    bank, w, seg = _inputs(cuda_dev, n, p, e, dtype)
    hier_agg.reset_launches()
    got = ops.segment_agg(bank, w, seg, e)
    assert hier_agg.LAUNCHES["segment_agg"] == 1
    want = ref.segment_agg_ref(bank, w, seg, e)
    torch.testing.assert_close(got, want, atol=AGG_TOL, rtol=AGG_TOL)
    assert torch.equal(got, ops.segment_agg(bank, w, seg, e))  # bitwise


def test_segment_agg_zero_weight_rows_are_neutral(cuda_dev):
    """fmaf(0, x, acc) == acc: zeroing rows of other segments leaves a
    segment's sums bit-identical (the async slice's contract)."""
    bank, w, seg = _inputs(cuda_dev, 50, 21840, 5, torch.float32)
    sums, _ = ops.segment_sum_partial(bank, w, seg, 5)
    masked = torch.where(seg == 3, w, torch.zeros_like(w))
    only3, _ = ops.segment_sum_partial(bank, masked, seg, 5)
    assert torch.equal(only3[3], sums[3])
    assert int(torch.count_nonzero(only3[[0, 1, 2, 4]])) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n,p,e", SHAPES, ids=IDS)
def test_segment_broadcast_kernel_bitwise(cuda_dev, n, p, e, dtype):
    gen = torch.Generator(device=cuda_dev).manual_seed(1)
    models = torch.randn((e, p), generator=gen, device=cuda_dev)
    seg = torch.randint(0, e, (n,), generator=gen, device=cuda_dev)
    hier_agg.reset_launches()
    got = ops.segment_broadcast(models, seg, out_dtype=dtype)
    assert hier_agg.LAUNCHES["segment_broadcast"] == 1
    assert got.dtype == dtype
    assert torch.equal(got, ref.segment_broadcast_ref(models, seg, dtype))
    out = torch.empty((n, p), dtype=dtype, device=cuda_dev)
    assert ops.segment_broadcast(models, seg, out=out) is out
    assert torch.equal(out, got)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_dev):
    bank, w, seg = _inputs(cuda_dev, 8, 64, 4, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ops.segment_agg(bank.t().contiguous().t(), w, seg, 4)
    with pytest.raises(ValueError, match="segments"):
        ops.segment_agg(bank, w, seg, 33)
    with pytest.raises(TypeError):
        ops.segment_agg(bank.half(), w, seg, 4)
    with pytest.raises(TypeError):
        ops.segment_broadcast(bank.half(), seg)
    with pytest.raises(ValueError, match="devices"):
        ops.segment_agg(bank, w.cpu(), seg, 4)


def test_cloud_round_on_card_matches_cpu(cuda_dev):
    """One MNIST-CNN round (6 devices, 2 edges, 64 samples) on the card
    against the same round on the CPU, from the same bank, data and
    shuffles; TF32 off. Tolerance rtol 1e-4, atol 1e-5."""
    n, n_local = 6, 64
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(n, n_local, 28, 28, 1)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, 10, (n, n_local)).astype(np.int32))
    perms = torch.from_numpy(rng.permuted(
        np.broadcast_to(np.arange(n_local), (2, 2, n, n_local)), axis=-1))
    ea = torch.tensor([0, 1, 0, 1, 1, 0], dtype=torch.int32)
    loss = lambda p, b: model.cnn_loss(model.mnist_cnn_apply, p, b)
    rnd = hfl.make_cloud_round(loss, 0.05, 32, 2, 2, 2)
    outs = []
    for d in ("cpu", cuda_dev):
        bank = hfl.init_bank(model.mnist_cnn_init,
                             torch.Generator().manual_seed(3), n,
                             device="cpu")
        bank = {k: v.to(d) for k, v in bank.items()}
        hier_agg.reset_launches()
        outs.append(rnd(bank, x.to(d), y.to(d),
                        torch.full((n,), 64.0, device=d), ea.to(d),
                        np.array([2, 1]), np.array([1, 2]), perms.to(d)))
    assert hier_agg.LAUNCHES == {"segment_agg": 4, "segment_broadcast": 2}
    for cpu_part, gpu_part in zip(*outs):
        for k in cpu_part:
            torch.testing.assert_close(gpu_part[k].cpu(), cpu_part[k],
                                       rtol=1e-4, atol=1e-5)
