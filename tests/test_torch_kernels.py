"""The port's aggregation kernels on the CPU (their plain versions)
against the reference's Pallas kernels in interpret mode
(``repro.kernels.ops``), on the shapes of ``tests/test_flatbank.py``.
Also: a CUDA tensor never takes the plain path on a host without a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_close, to_torch

from repro.kernels import ops as jops
from repro_torch.kernels import hier_agg, ops, ref

# f32 sums of a few O(1) products: the two summation orders differ by a
# few ulp (~1e-7)
F32_ATOL = 1e-6


def _inputs(n, p, e, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    mat = rng.normal(size=(n, p)).astype(np.float32)
    w = rng.uniform(0.1, 3.0, size=(n,)).astype(np.float32)
    seg = rng.integers(0, e, size=(n,)).astype(np.int32)
    jmat = jnp.asarray(mat, dtype)
    return jmat, w, seg


@pytest.mark.parametrize("n,p,e", [(9, 997, 4), (50, 21840, 5), (3, 130, 1)],
                         ids=["9x997x4", "50x21840x5", "3x130x1"])
def test_segment_agg_matches_pallas(n, p, e):
    jmat, w, seg = _inputs(n, p, e, 6)
    want = jops.segment_agg(jmat, jnp.asarray(w), jnp.asarray(seg), e)
    got = ops.segment_agg(to_torch(jmat), to_torch(w), to_torch(seg), e)
    assert got.dtype == torch.float32 and got.shape == (e, p)
    assert_close(got, want, atol=F32_ATOL)


def test_segment_agg_bf16_bank_10x513x3():
    jmat, w, seg = _inputs(10, 513, 3, 8, jnp.bfloat16)
    want = jops.segment_agg(jmat, jnp.asarray(w), jnp.asarray(seg), 3)
    bank = to_torch(jmat)
    assert bank.dtype == torch.bfloat16
    got = ops.segment_agg(bank, to_torch(w), to_torch(seg), 3)
    assert got.dtype == torch.float32                 # f32 accumulate out
    assert_close(got, want, atol=F32_ATOL)


def test_segment_agg_empty_segment_is_zero_9x997x4():
    jmat, w, seg = _inputs(9, 997, 4, 4)
    seg = np.where(seg == 2, 0, seg).astype(np.int32)  # segment 2 empty
    want = jops.segment_agg(jmat, jnp.asarray(w), jnp.asarray(seg), 4)
    got = ops.segment_agg(to_torch(jmat), to_torch(w), to_torch(seg), 4)
    assert_close(got, want, atol=F32_ATOL)
    assert torch.count_nonzero(got[2]) == 0


def test_segment_sum_partial_matches_pallas_9x997x4():
    jmat, w, seg = _inputs(9, 997, 4, 3)
    want_s, want_w = jops.segment_sum_partial(jmat, jnp.asarray(w),
                                              jnp.asarray(seg), 4)
    sums, wsum = ops.segment_sum_partial(to_torch(jmat), to_torch(w),
                                         to_torch(seg), 4)
    # unnormalized sums of ~3 terms of size up to ~3: a few ulp of ~10
    assert_close(sums, want_s, atol=4e-6)
    assert_close(wsum, want_w, atol=F32_ATOL)


def test_hier_agg_matches_pallas_7x300():
    rng = np.random.default_rng(5)
    bank = rng.normal(size=(7, 300)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=(7,)).astype(np.float32)
    want = jops.hier_agg(jnp.asarray(bank), jnp.asarray(w))
    got = ops.hier_agg(to_torch(bank), to_torch(w))
    assert got.shape == (300,)
    assert_close(got, want, atol=F32_ATOL)
    assert_close(ref.hier_agg_ref(to_torch(bank), to_torch(w)), want,
                 atol=F32_ATOL)


def test_plain_versions_agree_with_reference_oracle_50x21840x5():
    """The division form (``segment_agg_ref``) and the kernel's
    multiply-by-reciprocal form agree to rounding."""
    jmat, w, seg = _inputs(50, 21840, 5, 9)
    a = ref.segment_agg_ref(to_torch(jmat), to_torch(w), to_torch(seg), 5)
    b = ops.segment_agg(to_torch(jmat), to_torch(w), to_torch(seg), 5)
    assert_close(a, b, atol=F32_ATOL)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_segment_broadcast_bitwise_4x997_to_13(dtype):
    rng = np.random.default_rng(7)
    models = rng.normal(size=(4, 997)).astype(np.float32)
    seg = rng.integers(0, 4, size=(13,)).astype(np.int32)
    want = jops.segment_broadcast(jnp.asarray(models), jnp.asarray(seg),
                                  out_dtype=dtype)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = ops.segment_broadcast(to_torch(models), to_torch(seg),
                                out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (13, 997)
    assert torch.equal(got, to_torch(np.asarray(want)))    # bitwise
    out = torch.empty((13, 997), dtype=tdt)
    res = ops.segment_broadcast(to_torch(models), to_torch(seg), out=out)
    assert res is out and torch.equal(out, got)


def test_cpu_calls_count_no_kernel_launch():
    hier_agg.reset_launches()
    jmat, w, seg = _inputs(9, 997, 4, 1)
    ops.segment_agg(to_torch(jmat), to_torch(w), to_torch(seg), 4)
    ops.segment_broadcast(torch.zeros(4, 5), to_torch(seg))
    assert ops.LAUNCHES == {"segment_agg": 0, "segment_broadcast": 0}


def test_cuda_tensors_raise_instead_of_running_on_cpu():
    """A CUDA tensor goes to the CUDA kernel or the call raises: on a
    host without nvcc or a card the build (or launch) raises; nothing
    falls back to the plain version. Fake CUDA tensors (no storage)
    reach the wrappers' CUDA branch without a card."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        bank = torch.empty((9, 997), device="cuda")
        w = torch.ones((9,), device="cuda")
        seg = torch.zeros((9,), dtype=torch.int32, device="cuda")
        with pytest.raises(RuntimeError):
            ops.segment_agg(bank, w, seg, 4)
        with pytest.raises(RuntimeError):
            ops.segment_broadcast(torch.empty((4, 997), device="cuda"), seg)


def test_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError):
        ops.segment_agg(torch.zeros(4, 5), torch.ones(3), torch.zeros(4,
                        dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        ops.segment_agg(torch.zeros(4, 5, device="meta"),
                        torch.ones(4, device="meta"),
                        torch.zeros(4, dtype=torch.int32, device="meta"), 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.flash_attention(None, None, None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.wkv6(None, None, None, None, None)
