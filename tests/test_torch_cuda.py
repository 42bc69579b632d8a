"""The port's CUDA kernels on the card, against their plain versions on
the same CUDA tensors, and the reduced serving path on the card against
the CPU. Marked ``cuda``: each test skips (from inside the
``cuda_dev`` fixture) where no CUDA device is available. On a GPU host:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports no JAX, so it runs on a host without it.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.core import hfl
from repro_torch.core.agent import ppo
from repro_torch.data.synthetic import token_batch
from repro_torch.device import disable_tf32
from repro_torch.kernels import _build, flash_attention, hier_agg, ops, ref
from repro_torch.models import model
from repro_torch.models.rwkv import wkv_scan
from repro_torch.runtime import AsyncConfig, FaultSpec
from repro_torch.sim import AsyncHFLEnv, EnvConfig, HFLEnv
from repro_torch.telemetry import MetricsRegistry, ktime

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


def _check_agg(bank, w, seg, e):
    """One segment_agg and one segment_sum_partial call against the plain
    versions: one launch each, sums and weight sums within AGG_TOL, and
    two runs bitwise equal."""
    hier_agg.reset_launches()
    got = ops.segment_agg(bank, w, seg, e)
    assert hier_agg.LAUNCHES["segment_agg"] == 1
    assert got.dtype == torch.float32 and got.shape == (e, bank.shape[1])
    torch.testing.assert_close(got, ref.segment_agg_ref(bank, w, seg, e),
                               atol=AGG_TOL, rtol=AGG_TOL)
    assert torch.equal(got, ops.segment_agg(bank, w, seg, e))
    sums, wsum = ops.segment_sum_partial(bank, w, seg, e)
    assert hier_agg.LAUNCHES["segment_agg"] == 3
    want_w = ref.segment_weight_sums(w, seg, e)
    torch.testing.assert_close(wsum, want_w, atol=AGG_TOL, rtol=AGG_TOL)
    torch.testing.assert_close(
        sums, ref.segment_scaled_sum_ref(bank, w, seg, torch.ones_like(
            want_w), e), atol=AGG_TOL, rtol=AGG_TOL)
    sums2, wsum2 = ops.segment_sum_partial(bank, w, seg, e)
    assert torch.equal(sums, sums2) and torch.equal(wsum, wsum2)
    return got


# every start of a bank row mod 16 bytes that a vector load could meet,
# the block-width switch (P 21,840 and 21,841) and the CIFAR bank
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("p", [1, 3, 997, 21840, 21841, 456906])
def test_segment_agg_row_alignments(cuda_dev, p, dtype):
    _check_agg(*_inputs(cuda_dev, 50, p, 5, dtype, seed=p), 5)


# E at the edges of the register slots (1, 8 | 9, 32), and banks of at
# most 8 rows (the kernel's 8-row batches)
@pytest.mark.parametrize("n,e", [(60, 1), (60, 8), (60, 9), (100, 32),
                                 (3, 4), (8, 9)],
                         ids=["e1", "e8", "e9", "e32", "n3-e4", "n8-e9"])
def test_segment_agg_segment_counts(cuda_dev, n, e):
    _check_agg(*_inputs(cuda_dev, n, 3001, e, torch.float32, seed=n + e), e)


@pytest.mark.parametrize("e", [5, 32])
def test_segment_agg_1000_rows(cuda_dev, e):
    """N = 1000 rows for the weight sums each warp takes in the kernel.
    Bank values are integers in [-8, 8] and weights multiples of 1/8, so
    every partial sum is exact in f32 and any summation order gives the
    same sums: the unnormalised sums and the weight sums must equal the
    plain version's bit for bit (with random reals, two f32 orders of
    200-term sums differ by more than AGG_TOL where they cancel)."""
    gen = torch.Generator(device=cuda_dev).manual_seed(e)
    bank = torch.randint(-8, 9, (1000, 3001), generator=gen,
                         device=cuda_dev).float()
    w = torch.randint(1, 25, (1000,), generator=gen,
                      device=cuda_dev).float() / 8
    seg = torch.randint(0, e, (1000,), generator=gen, device=cuda_dev,
                        dtype=torch.int32)
    _check_agg(bank, w, seg, e)
    sums, wsum = ops.segment_sum_partial(bank, w, seg, e)
    assert torch.equal(wsum, ref.segment_weight_sums(w, seg, e))
    assert torch.equal(sums, ref.segment_scaled_sum_ref(
        bank, w, seg, torch.ones_like(wsum), e))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("e", [5, 32])
def test_segment_agg_1000_rows_real_valued(cuda_dev, e, dtype):
    """N = 1000 rows of random reals against the same sums in f64. The
    kernel adds each segment's rows in one f32 chain of at most N fmaf
    (each product exact inside its fmaf), so with u = 2^-24 and
    g = N u / (1 - N u) the standard bound of recursive summation gives,
    per segment j and column c, with A = sum_i |w_i x_ic| and
    W = sum_i w_i (w > 0) over the segment's rows:
        |S~ - S| <= g A,   |W~ - W| <= g W,
    and the normalised output (S~ times the rounded 1 / W~, one rounding
    each) is off by at most g (A + |S|) / W + 4 u |S / W|, the last term
    with room for the reciprocal's and the product's roundings. AGG_TOL
    is not used: it covers two f32 orders at small N."""
    gen = torch.Generator(device=cuda_dev).manual_seed(100 + e)
    n = 1000
    bank = torch.randn((n, 3001), generator=gen, device=cuda_dev).to(dtype)
    w = torch.rand((n,), generator=gen, device=cuda_dev) * 2.9 + 0.1
    seg = torch.randint(0, e, (n,), generator=gen, device=cuda_dev,
                        dtype=torch.int32)
    got = ops.segment_agg(bank, w, seg, e)
    sums, wsum = ops.segment_sum_partial(bank, w, seg, e)
    onehot = torch.nn.functional.one_hot(seg.long(), e).double()   # (n, e)
    x, wd = bank.double(), w.double()
    s64 = onehot.T @ (wd[:, None] * x)                             # (e, P)
    a64 = onehot.T @ (wd[:, None] * x).abs()
    w64 = onehot.T @ wd                                            # (e,)
    u = 2.0 ** -24
    g = n * u / (1 - n * u)
    assert bool((wsum.double() - w64).abs().le(g * w64).all())
    assert bool((sums.double() - s64).abs().le(g * a64).all())
    out64 = s64 / w64[:, None]
    bound = g * (a64 + s64.abs()) / w64[:, None] + 4 * u * out64.abs()
    assert bool((got.double() - out64).abs().le(bound).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_segment_agg_empty_segment_and_ids_out_of_range(cuda_dev, dtype):
    """Segment 2 has no row, and ids -1, 6 and 40 (outside [0, 6)) add
    nothing to the sums or the weight sums."""
    bank, w, seg = _inputs(cuda_dev, 40, 997, 6, dtype, seed=5)
    seg[seg == 2] = 0
    seg[3], seg[11], seg[27] = -1, 6, 40
    got = _check_agg(bank, w, seg, 6)
    assert int(torch.count_nonzero(got[2])) == 0
    _, wsum = ops.segment_sum_partial(bank, w, seg, 6)
    assert float(wsum[2]) == 0.0


def test_segment_agg_is_one_device_kernel(cuda_dev):
    """With f32 weights and contiguous int32 ids (what the cloud round
    passes) one segment_agg call runs exactly one device kernel: the
    weight sums are inside it."""
    from torch.profiler import ProfilerActivity, profile
    bank, w, seg = _inputs(cuda_dev, 50, 21840, 5, torch.float32)
    ops.segment_agg(bank, w, seg, 5)                 # build and warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ops.segment_agg(bank, w, seg, 5)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    assert [e.name for e in kernels] == [kernels[0].name]
    assert "segment_agg_kernel" in kernels[0].name


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
    assert hier_agg.LAUNCHES == {"segment_agg": 4, "segment_broadcast": 2,
                                 "flash_attention": 0, "wkv6": 0}
    for cpu_part, gpu_part in zip(*outs):
        for k in cpu_part:
            torch.testing.assert_close(gpu_part[k].cpu(), cpu_part[k],
                                       rtol=1e-4, atol=1e-5)


def test_fedavg_round_on_card_matches_cpu(cuda_dev):
    """One FedAvg round of the MNIST CNN (6 devices, 4 participating, two
    local epochs) on the card against the same round on the CPU; one
    ``segment_agg`` launch and no ``segment_broadcast``. Tolerance rtol
    1e-4, atol 1e-5, as for the cloud round."""
    n, n_local = 6, 64
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(n, n_local, 28, 28, 1)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, 10, (n, n_local)).astype(np.int32))
    perms = torch.from_numpy(rng.permuted(
        np.broadcast_to(np.arange(n_local), (2, n, n_local)), axis=-1))
    part = np.array([True, True, False, True, False, True])
    loss = lambda p, b: model.cnn_loss(model.mnist_cnn_apply, p, b)
    rnd = hfl.make_fedavg_round(loss, 0.05, 32, 2)
    outs = []
    for d in ("cpu", cuda_dev):
        bank = hfl.init_bank(model.mnist_cnn_init,
                             torch.Generator().manual_seed(3), n,
                             device="cpu")
        bank = {k: v.to(d) for k, v in bank.items()}
        hier_agg.reset_launches()
        outs.append(rnd(bank, x.to(d), y.to(d),
                        torch.full((n,), 64.0, device=d), part, 2,
                        perms.to(d)))
    assert hier_agg.LAUNCHES == {"segment_agg": 1, "segment_broadcast": 0,
                                 "flash_attention": 0, "wkv6": 0}
    for cpu_part, gpu_part in zip(*outs):
        for k in cpu_part:
            torch.testing.assert_close(gpu_part[k].cpu(), cpu_part[k],
                                       rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("k,p", [(3, 456906), (2, 21840)],
                         ids=["cifar-flush", "mnist-flush"])
def test_segment_agg_flush_shapes_match_plain(cuda_dev, k, p):
    """The async flush's launch: one segment over K buffered updates
    (CIFAR K = 3, MNIST K = 2), and the degraded flush's K + 1 rows."""
    for rows in (k, k + 1):
        bank, w, _ = _inputs(cuda_dev, rows, p, 1, torch.float32, seed=rows)
        _check_agg(bank, w, torch.zeros(rows, dtype=torch.int32,
                                        device=cuda_dev), 1)


def _edge_inputs(dev, n=6, n_local=64, seed=2):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, n_local, 28, 28, 1)).astype(
        np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 10, (n, n_local)).astype(
        np.int32)).to(dev)
    perms = torch.from_numpy(rng.permuted(
        np.broadcast_to(np.arange(n_local), (2, 3, n, n_local)),
        axis=-1)).to(dev)
    bank = hfl.init_bank(model.mnist_cnn_init,
                         torch.Generator().manual_seed(4), n, device="cpu")
    mat = hfl.flatbank.bank_spec(bank).flatten(bank)
    mat.add_(0.01 * torch.from_numpy(rng.normal(size=mat.shape).astype(
        np.float32)))
    ea = torch.tensor([0, 1, 2, 0, 1, 2], dtype=torch.int32, device=dev)
    sizes = torch.tensor([64.0, 32.0, 64.0, 48.0, 64.0, 16.0], device=dev)
    return {k: v.to(dev) for k, v in bank.items()}, x, y, perms, ea, sizes


def test_edge_round_on_card_matches_cpu(cuda_dev):
    """One edge round of the MNIST CNN (6 devices, 3 edges, gamma (3, 2))
    on the card against the same round on the CPU: rtol 1e-4, atol 1e-5
    as for the cloud round; 1 + gamma2 ``segment_agg`` and gamma2
    ``segment_broadcast`` launches; the other edges' rows bitwise
    untouched on the card."""
    loss = lambda p, b: model.cnn_loss(model.mnist_cnn_apply, p, b)
    rnd = hfl.make_edge_round(loss, 0.05, 32, 3, 3, 2)
    outs = []
    for d in ("cpu", cuda_dev):
        bank, x, y, perms, ea, sizes = _edge_inputs(d)
        spec = hfl.flatbank.bank_spec(bank)
        before = spec.flatten(bank).clone()
        gvec = before[1].clone()
        hier_agg.reset_launches()
        bank, vec = rnd(bank, x, y, sizes, ea, 1, 3, 2, gvec, perms)
        after = spec.flatten(bank)
        assert torch.equal(after[ea != 1], before[ea != 1])
        outs.append((after.cpu(), vec.cpu()))
    assert hier_agg.LAUNCHES == {"segment_agg": 3, "segment_broadcast": 2,
                                 "flash_attention": 0, "wkv6": 0}
    for cpu_t, gpu_t in zip(*outs):
        torch.testing.assert_close(gpu_t, cpu_t, rtol=1e-4, atol=1e-5)


def test_edge_round_is_its_cloud_round_row_on_card_deterministic(cuda_dev):
    """Deterministic mode on the card, MNIST CNN, gamma1 [2, 1, 3],
    gamma2 [1, 2, 2]: two runs of each edge round bitwise equal, and its
    vector bitwise row j of one cloud round started at the snapshot with
    the same shuffles (every epoch trains all N rows, so a row's result
    depends on nothing but its own parameters and batch)."""
    loss = lambda p, b: model.cnn_loss(model.mnist_cnn_apply, p, b)
    g1, g2 = np.array([2, 1, 3]), np.array([1, 2, 2])
    bank, x, y, perms, ea, sizes = _edge_inputs(cuda_dev)
    spec = hfl.flatbank.bank_spec(bank)
    mat0 = spec.flatten(bank).clone()
    gvec = mat0[1].clone()
    cloud = hfl.make_cloud_round(loss, 0.05, 32, 3, 3, 2,
                                 deterministic=True)
    _, _, em = cloud(hfl.broadcast_model(spec.unflatten_model(gvec), 6),
                     x, y, sizes, ea, g1, g2, perms)
    em = spec.flatten(em)
    er = hfl.make_edge_round(loss, 0.05, 32, 3, 3, 2, deterministic=True)
    for j in range(3):
        vecs = [er(spec.unflatten(mat0.clone()), x, y, sizes, ea, j, g1[j],
                   g2[j], gvec, perms)[1] for _ in range(2)]
        assert torch.equal(vecs[0], vecs[1])
        assert torch.equal(vecs[0], em[j]), float(
            (vecs[0] - em[j]).abs().max())
    assert not torch.are_deterministic_algorithms_enabled()


def test_ktime_times_card_calls_and_leaves_outputs_bitwise(cuda_dev):
    """``ktime`` on CUDA tensors: inside ``kernel_timing`` each
    ``ops.segment_agg`` / ``ops.segment_broadcast`` call is counted once
    with a positive device time (CUDA events), the outputs are bitwise
    the untimed ones, the launch counts are unchanged, and calls made
    while a CUDA graph is captured are dispatched untimed."""
    bank, w, seg = _inputs(cuda_dev, 50, 456906, 5, torch.float32)
    base_agg = ops.segment_agg(bank, w, seg, 5)
    base_bc = ops.segment_broadcast(base_agg, seg)
    reg = MetricsRegistry()
    hier_agg.reset_launches()
    with ktime.kernel_timing(reg):
        agg = ops.segment_agg(bank, w, seg, 5)
        bc = ops.segment_broadcast(agg, seg)
        assert ktime.active_registry() is reg
    assert ktime.active_registry() is None
    assert torch.equal(agg, base_agg) and torch.equal(bc, base_bc)
    assert hier_agg.LAUNCHES["segment_agg"] == 1
    assert hier_agg.LAUNCHES["segment_broadcast"] == 1
    for k in ("segment_agg", "segment_broadcast"):
        assert reg.counters[f"kernel/{k}_calls"] == 1
        (us,) = reg.hists[f"kernel/{k}_us"]
        assert 0.0 < us < 1e5, (k, us)
    out = torch.empty_like(base_bc)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.segment_broadcast(base_agg, seg, out=out)      # warm up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with ktime.kernel_timing(reg), torch.cuda.graph(graph):
        ops.segment_broadcast(base_agg, seg, out=out)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, base_bc)
    assert reg.counters["kernel/segment_broadcast_calls"] == 1


# the async env at the paper's MNIST width on the card, deterministic
# mode, with faults: telemetry on vs off and a save/load resume
CARD_ASYNC = dict(task="mnist", mode="real", threshold_time=400.0,
                  deterministic=True)
CARD_FAULTS = dict(drop_prob=0.15, transient_prob=0.2, seed=9)


def _card_async_env(**kw):
    return AsyncHFLEnv(EnvConfig(**CARD_ASYNC, **kw),
                       AsyncConfig(buffer_k=2, flush_deadline=40.0),
                       faults=FaultSpec(**CARD_FAULTS))


def _card_steps(env, n):
    out = []
    for _ in range(n):
        _, r, _, info = env.step(np.array([2.0, 2.0]))
        out.append((float(r), float(info["acc"]), info["edge"],
                    info["flushed"]))
    return out


def test_async_telemetry_on_card_is_bitwise_off_deterministic(cuda_dev):
    """MNIST defaults (50 devices, 5 edges), deterministic mode, faults:
    8 events with telemetry, health and ``ktime`` on against the same
    with all off -- events, global vector and bank bitwise equal, and
    ``ktime``'s call counts equal to the launch counts."""
    runs = {}
    for on in (False, True):
        env = _card_async_env(telemetry=on, health=on)
        reg = MetricsRegistry()
        hier_agg.reset_launches()
        with (ktime.kernel_timing(reg) if on else contextlib.nullcontext()):
            env.reset()
            traj = _card_steps(env, 8)
        runs[on] = (traj, env, dict(hier_agg.LAUNCHES), reg)
    (t_off, e_off, _, _), (t_on, e_on, launches, reg) = runs[False], \
        runs[True]
    assert e_on.device == cuda_dev and len(e_on.telemetry.recorder) > 0
    assert t_on == t_off
    assert torch.equal(e_on._global_vec, e_off._global_vec)
    assert torch.equal(e_on._spec.flatten(e_on.bank),
                       e_off._spec.flatten(e_off.bank))
    for k in ("segment_agg", "segment_broadcast"):
        assert reg.counters[f"kernel/{k}_calls"] == launches[k] > 0


def test_async_save_load_resumes_on_card_bitwise_deterministic(cuda_dev,
                                                               tmp_path):
    """MNIST defaults, deterministic mode, faults, telemetry and health on:
    ``save_runtime`` after 5 events, ``load_runtime`` into a fresh env on
    the card, 5 more events bitwise the uninterrupted run's (events,
    global vector, bank, trace), every restored tensor on the card."""
    env = _card_async_env(telemetry=True, health=True)
    env.reset()
    _card_steps(env, 5)
    path = str(tmp_path / "rt")
    store.save_runtime(env, path)
    tail = _card_steps(env, 5)
    env2 = _card_async_env(telemetry=True, health=True)
    store.load_runtime(env2, path)
    assert env2._global_vec.device == cuda_dev
    assert env2._spec.flatten(env2.bank).device == cuda_dev
    assert all(s.vec is None or s.vec.device == cuda_dev
               for s in env2.buffer._slots)
    assert _card_steps(env2, 5) == tail
    assert torch.equal(env2._global_vec, env._global_vec)
    assert torch.equal(env2._spec.flatten(env2.bank),
                       env._spec.flatten(env.bank))
    assert env2.telemetry.recorder.events == env.telemetry.recorder.events


def test_agent_update_on_card_matches_cpu(cuda_dev):
    """One PPO update (a seeded 40-step rollout at the CIFAR state shape
    (6, 9), 10 actions, the same shuffle seed) on the card against the
    same update on the CPU: one seed gives the same init on both, and
    the updated params agree within atol 1e-4 (TF32 off; cuDNN's conv
    backward is not bitwise). The agent launches no kernel."""
    rng = np.random.default_rng(3)
    roll = [(rng.normal(size=(6, 9)).astype(np.float32),
             rng.normal(size=10).astype(np.float32), float(rng.normal()),
             float(rng.normal()), float(rng.normal()), t == 39)
            for t in range(40)]
    agents = [ppo.PPOAgent(0, (6, 9), 10, device=d,
                           shuffle_seed_source=lambda: 1234)
              for d in ("cpu", cuda_dev)]
    for k, v in agents[0].params.items():
        assert torch.equal(v, agents[1].params[k].cpu()), k
    hier_agg.reset_launches()
    for agent in agents:
        for r in roll:
            agent.remember(*r)
        agent.update()
    assert all(c == 0 for c in hier_agg.LAUNCHES.values())
    for k, v in agents[0].params.items():
        got = agents[1].params[k]
        assert got.device == cuda_dev
        torch.testing.assert_close(got.cpu(), v, rtol=0.0, atol=1e-4)


# ---------------------------------------------------------------------------
# flash_attention and wkv6
# ---------------------------------------------------------------------------

# flash vs plain: both compute in f32 (online vs one-pass softmax): 1e-5
# in f32; in bf16 both round that result to bf16: one ulp, 2^-8 relative
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# (B, H, Hkv, Sq, Skv, D, causal, window, q_offset); the path each takes
# (flash_attention.plan): split_kv where rep * Sq <= 16, else the tile
# path of the dtype (wgmma for bf16, f32_tile for f32)
FLASH_SHAPES = [(4, 16, 8, 1024, 1024, 128, True, 0, 0),
                (4, 16, 8, 1, 1056, 128, True, 0, 1055),
                (2, 16, 8, 1000, 1000, 128, True, 0, 0),
                (1, 4, 2, 256, 256, 64, True, 64, 0),
                (2, 8, 8, 512, 512, 128, True, 0, 0),
                (2, 4, 4, 200, 200, 64, False, 0, 0),
                (1, 4, 2, 40, 300, 64, True, 0, 260),
                (2, 8, 8, 1, 300, 128, True, 0, 299),
                (2, 16, 4, 1, 1056, 128, True, 0, 1055),
                (1, 32, 4, 1, 500, 64, True, 0, 499),
                (2, 4, 2, 1, 1, 64, True, 0, 0),
                (1, 8, 4, 1, 65, 128, True, 0, 64),
                (1, 16, 8, 1, 4097, 128, True, 0, 4096),
                (4, 16, 8, 1, 1056, 128, True, 0, 700),
                (1, 8, 4, 2, 65, 128, True, 0, 63),
                (1, 8, 2, 1, 300, 64, True, 64, 299),
                (2, 8, 4, 512, 512, 64, True, 0, 0),
                (2, 16, 8, 8, 300, 128, True, 0, 292),
                (2, 16, 8, 40, 1064, 128, True, 0, 1024),
                # D = 112 (zamba2-7b): its prefill and decode shapes (MHA),
                # ragged Sq/Skv, a window, a 20-row tile (the f32 path's
                # 16-row blocks, whose loads take a tail), non-causal
                # prefill and a non-causal decode over a wrapped ring
                (4, 32, 32, 1024, 1024, 112, True, 0, 0),
                (4, 32, 32, 1, 1056, 112, True, 0, 1055),
                (2, 8, 8, 1000, 1000, 112, True, 0, 0),
                (1, 4, 2, 256, 256, 112, True, 64, 0),
                (2, 8, 4, 20, 300, 112, True, 0, 280),
                (2, 4, 4, 200, 200, 112, False, 0, 0),
                (1, 32, 32, 1, 512, 112, False, 0, 0),
                # whisper-base (MHA, D = 64): the encoder (non-causal over
                # 1500 frames, ragged against the 64-row kv tile), the
                # cross-attention's prefill (224 decoder rows over 1500
                # encoder rows) and decode, the decoder's self decode;
                # qwen2-vl-7b (28 heads over 4: GQA rep 7, D = 128): its
                # prefill over 256 vision + 1024 text positions and decode,
                # a ragged rep-7 prefill, a non-causal Sq != Skv case that
                # takes the f32 path in f32, and a rep-7 split-KV decode
                # of 2 rows per head (14 packed rows)
                (4, 8, 8, 1500, 1500, 64, False, 0, 0),
                (4, 8, 8, 224, 1500, 64, False, 0, 0),
                (4, 8, 8, 1, 1500, 64, False, 0, 0),
                (4, 8, 8, 1, 256, 64, True, 0, 255),
                (4, 28, 4, 1280, 1280, 128, True, 0, 0),
                (4, 28, 4, 1, 1312, 128, True, 0, 1311),
                (2, 28, 4, 300, 300, 128, True, 0, 0),
                (2, 8, 8, 40, 300, 64, False, 0, 0),
                (2, 28, 4, 2, 300, 128, True, 0, 298)]
FLASH_IDS = ["qwen3-prefill", "qwen3-decode", "ragged", "window", "mha",
             "non-causal", "continuation", "decode-rep1", "decode-rep4",
             "decode-rep8", "skv-1", "skv-65", "skv-4097",
             "causal-end-mid-split", "split-emptied", "decode-window",
             "prefill-d64", "rows-16-edge", "continuation-d128",
             "zamba2-prefill", "zamba2-decode", "ragged-d112",
             "window-d112", "rows-20-d112", "non-causal-d112",
             "ring-d112", "whisper-encoder", "whisper-cross-prefill",
             "whisper-cross-decode", "whisper-self-decode",
             "qwen2vl-prefill", "qwen2vl-decode", "ragged-rep7",
             "non-causal-sq40-skv300", "split-rep7-sq2"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,hkv,sq,skv,d,causal,window,q_offset",
                         FLASH_SHAPES, ids=FLASH_IDS)
def test_flash_attention_kernel_matches_plain(cuda_dev, b, h, hkv, sq, skv,
                                              d, causal, window, q_offset,
                                              dtype):
    gen = torch.Generator(device=cuda_dev).manual_seed(0)
    mk = lambda s_, n: torch.randn((b, s_, n, d), generator=gen,
                                   device=cuda_dev).to(dtype).transpose(1, 2)
    q, k, v = mk(sq, h), mk(skv, hkv), mk(skv, hkv)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    path = flash_attention.plan(b, h, hkv, sq, skv, dtype, **kw)["path"]
    assert path == ("split_kv" if h // hkv * sq <= 16 else
                    "wgmma" if dtype == torch.bfloat16 else "f32_tile")
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.LAUNCHES["flash_attention"] == 1       # one per call
    assert got.dtype == dtype and got.shape == (b, h, sq, d)
    want = ref.flash_attention_ref(q, k, v, **kw)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(got, ops.flash_attention(q, k, v, **kw))  # bitwise


def test_flash_attention_bf16_tile_path_uses_tensor_cores(cuda_dev):
    """The SASS of the built library (cuobjdump): every instantiation of
    the bf16 tile kernel (D 64, 112 and 128) issues tensor-core
    instructions (HGMMA for wgmma, HMMA for mma.sync)."""
    counts = _build.tensor_core_ops("flash_attention")
    tile = {k: n for k, n in counts.items()
            if k.startswith("flash_wgmma_kernel")}
    assert set(tile) == {"flash_wgmma_kernel<64>", "flash_wgmma_kernel<112>",
                         "flash_wgmma_kernel<128>"}
    assert all(n > 0 for n in tile.values()), counts


# 16-token steps with running decay products against the plain chunked
# log-space version: sums in other orders; the reference's own wkv6
# tolerance, 1e-3 for hard decays as in the reference. The kernel does not
# depend on the chunk; the plain version runs at the chunk named.
WKV_SHAPES = [(4, 1024, 32, 64, 0.3, 0.999, 2e-4),
              (2, 1000, 8, 64, 0.3, 0.999, 2e-4),
              (2, 130, 3, 32, 0.3, 0.999, 2e-4),
              (1, 256, 4, 32, 1e-4, 0.1, 1e-3),
              (2, 1, 3, 64, 0.3, 0.999, 2e-4),
              (2, 15, 3, 32, 0.3, 0.999, 2e-4),
              (2, 16, 3, 64, 0.3, 0.999, 2e-4),
              (2, 17, 3, 32, 0.3, 0.999, 2e-4),
              (1, 100, 1, 64, 0.3, 0.999, 2e-4),
              (3, 77, 5, 32, 0.3, 0.999, 2e-4),
              (2, 200, 3, 64, 0.0, 0.1, 1e-3)]
WKV_IDS = ["rwkv6-prefill", "ragged", "ragged-32", "hard-decay", "s1",
           "s15", "s16", "s17", "one-head", "odd-heads-15", "w-zero"]


def _wkv_inputs(dev, b, s, nh, lo, hi, rkv_dtype):
    gen = torch.Generator(device=dev).manual_seed(1)
    r, k, v = (torch.randn((b, s, nh, 64), generator=gen,
                           device=dev).to(rkv_dtype) for _ in range(3))
    w = torch.rand((b, s, nh, 64), generator=gen, device=dev) \
        * (hi - lo) + lo
    if lo == 0.0:          # w = 0 exactly: the kernel's 1e-38 clamp
        w[..., ::7] = 0.0
    u = torch.randn((nh, 64), generator=gen, device=dev)
    return r, k, v, w, u


@pytest.mark.parametrize("rkv_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,nh,chunk,lo,hi,tol", WKV_SHAPES, ids=WKV_IDS)
def test_wkv6_kernel_matches_plain(cuda_dev, b, s, nh, chunk, lo, hi, tol,
                                   rkv_dtype):
    r, k, v, w, u = _wkv_inputs(cuda_dev, b, s, nh, lo, hi, rkv_dtype)
    ops.reset_launches()
    y, st = ops.wkv6(r, k, v, w, u, chunk=chunk)
    assert ops.LAUNCHES["wkv6"] == 1
    if lo == 0.0:
        # w = 0: the chunked plain version's exponents of clamped logs
        # (-87 per step) lose precision, so the sequential recurrence is
        # the yardstick (the kernel's 1e-38 clamp adds 1e-38 * S)
        yw, stw = wkv_scan(r, k, v, w, u)
    else:
        yw, stw = ref.wkv6_ref(r, k, v, w, u, chunk=chunk)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    torch.testing.assert_close(y, yw, atol=tol, rtol=tol)
    torch.testing.assert_close(st, stw, atol=tol, rtol=tol)
    y2, st2 = ops.wkv6(r, k, v, w, u, chunk=chunk)
    assert torch.equal(y, y2) and torch.equal(st, st2)           # bitwise


def test_wkv6_kernel_matches_its_algorithm_stated_plainly(cuda_dev):
    """The kernel against ``ref.wkv6_step_ref`` (the same 16-token steps
    and running products) on the card, f32, tolerance of the test above."""
    r, k, v, w, u = _wkv_inputs(cuda_dev, 2, 100, 3, 0.3, 0.999,
                                torch.float32)
    y, st = ops.wkv6(r, k, v, w, u)
    yw, stw = ref.wkv6_step_ref(r, k, v, w, u)
    torch.testing.assert_close(y, yw, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(st, stw, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_kernel_ragged_scores_far_below_zero(cuda_dev,
                                                             dtype):
    """Non-causal, Skv = 200 (no multiple of the 64-row kv tile), every
    score near -160: the kv rows past Skv that the kernel stages as zero
    must not enter the row max, or exp(s - 0) underflows every weight and
    the rows come out zero. Tolerance as in the kernel-vs-plain test."""
    gen = torch.Generator(device=cuda_dev).manual_seed(2)
    b, h, hkv, s, d = 2, 4, 2, 200, 64
    noise = lambda n: 0.1 * torch.randn((b, s, n, d), generator=gen,
                                        device=cuda_dev)
    q = (1.0 + noise(h)).to(dtype).transpose(1, 2)
    k = (-20.0 + noise(hkv)).to(dtype).transpose(1, 2)
    v = torch.randn((b, s, hkv, d), generator=gen,
                    device=cuda_dev).to(dtype).transpose(1, 2)
    got = ops.flash_attention(q, k, v, causal=False)
    want = ref.flash_attention_ref(q, k, v, causal=False)
    assert float(want.float().abs().max()) > 0.01
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_llm_wrappers_raise_on_what_the_kernels_do_not_take(cuda_dev):
    q = torch.zeros((1, 4, 8, 128), device=cuda_dev)
    kv = torch.zeros((1, 2, 8, 128), device=cuda_dev)
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention(q[..., :96], kv[..., :96], kv[..., :96])
    with pytest.raises(ValueError, match="contiguous"):
        qt = torch.zeros((1, 4, 128, 8), device=cuda_dev).transpose(2, 3)
        kt = torch.zeros((1, 2, 128, 8), device=cuda_dev).transpose(2, 3)
        ops.flash_attention(qt, kt, kt)
    with pytest.raises(ValueError, match="16-byte"):
        qm = torch.zeros((1, 4, 8, 129), device=cuda_dev)[..., 1:]
        ops.flash_attention(qm, kv, kv)
    with pytest.raises(ValueError, match="devices"):
        ops.flash_attention(q, kv.cpu(), kv)
    r = torch.zeros((1, 8, 2, 64), device=cuda_dev)
    u = torch.zeros((2, 64), device=cuda_dev)
    with pytest.raises(ValueError, match="chunks"):
        ops.wkv6(r, r, r, r, u, chunk=48)
    with pytest.raises(ValueError, match="head size"):
        ops.wkv6(r[..., :32], r[..., :32], r[..., :32], r[..., :32],
                 u[:, :32])
    with pytest.raises(ValueError, match="contiguous"):
        rt = torch.zeros((1, 2, 8, 64), device=cuda_dev).transpose(1, 2)
        ops.wkv6(rt, rt, rt, rt, u)
    with pytest.raises(TypeError):
        ops.wkv6(r.bfloat16(), r, r, r, u)
    with pytest.raises(TypeError, match="decay w must be f32"):
        ops.wkv6(r, r, r, r.bfloat16(), u)
    rm = torch.zeros(1 * 8 * 2 * 64 + 1, device=cuda_dev)[1:].view(1, 8, 2,
                                                                   64)
    with pytest.raises(ValueError, match="16-byte"):
        ops.wkv6(rm, r, r, r, u)
    with pytest.raises(ValueError, match="16-byte"):
        ops.wkv6(r, r, r, rm, u)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-1.6b",
                                  "olmoe-1b-7b"])
def test_reduced_serve_on_card_matches_cpu(cuda_dev, arch):
    """A reduced model with f32 activations, the same weights and tokens:
    prefill(16, max_new 4) + 4 teacher-forced decode steps on the card
    (kernels) and on the CPU (plain versions). TF32 off; tolerance 1e-4,
    the f32 parity tolerance of the CPU tests."""
    disable_tf32()
    cfg = dataclasses.replace(get_config(arch).reduce(),
                              activ_dtype="float32")
    m = model.build_model(cfg)
    params = m.init(torch.Generator().manual_seed(3), "cpu")
    toks = token_batch(2, 2, 20, cfg.vocab, "cpu")["tokens"]
    to = lambda t, d: ({k: to(v, d) for k, v in t.items()}
                       if isinstance(t, dict) else t.to(d))
    outs = []
    for d in ("cpu", cuda_dev):
        p, t = to(params, d), toks.to(d)
        ops.reset_launches()
        lg, cache = m.prefill(p, t[:, :16], max_new=4)
        steps = [lg]
        for i in range(16, 20):
            lg, cache = m.decode_step(p, cache, t[:, i:i + 1])
            steps.append(lg)
        outs.append((steps, cache, dict(ops.LAUNCHES)))
    kern = "wkv6" if cfg.family == "ssm" else "flash_attention"
    assert outs[0][2][kern] == 0
    assert outs[1][2][kern] == (5 if kern == "flash_attention" else 1) \
        * cfg.n_layers
    for a, b in zip(outs[0][0], outs[1][0]):
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4)
    for k, a in outs[0][1].items():
        if k != "t":
            torch.testing.assert_close(outs[1][1][k].cpu(), a, atol=1e-4,
                                       rtol=1e-4)


@pytest.mark.parametrize("window", [0, 8], ids=["full", "ring-8"])
def test_reduced_hybrid_serve_on_card_matches_cpu(cuda_dev, window):
    """Reduced zamba2 with 5 layers (the shared attention block applied 3
    times) at its published head dim 112, f32 activations: prefill(16)
    + 4 teacher-forced decode steps on the card (the flash kernel's D =
    112 instantiations; with window 8 a ring of 8 slots, the steps
    wrapping it) against the CPU; logits and every cache leaf within
    1e-4, TF32 off; the flash calls per path held."""
    disable_tf32()
    cfg = dataclasses.replace(get_config("zamba2-7b").reduce(), n_layers=5,
                              d_head=112, activ_dtype="float32")
    m = model.build_model(cfg)
    params = m.init(torch.Generator().manual_seed(5), "cpu")
    toks = token_batch(4, 2, 20, cfg.vocab, "cpu")["tokens"]
    outs = []
    for d in ("cpu", cuda_dev):
        p, t = _to(params, d), toks.to(d)
        flash_attention.reset_paths()
        lg, cache = m.prefill(p, t[:, :16], window=window, max_new=4)
        steps = [lg]
        for i in range(16, 20):
            lg, cache = m.decode_step(p, cache, t[:, i:i + 1], window=window)
            steps.append(lg)
        outs.append((steps, cache, dict(flash_attention.PATH_CALLS)))
    assert outs[1][2] == {"split_kv": 4 * 3, "wgmma": 0, "f32_tile": 3}
    assert outs[1][1]["ak"].shape == (3, 2, 8 if window else 20, 2, 112)
    for a, b in zip(outs[0][0], outs[1][0]):
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4)
    for k, a in outs[0][1].items():
        if k != "t":
            torch.testing.assert_close(outs[1][1][k].cpu(), a, atol=1e-4,
                                       rtol=1e-4)


@pytest.mark.parametrize("arch,kw", [
    ("whisper-base", {}), ("qwen2-vl-7b", {}),
    ("qwen2-vl-7b", {"n_heads": 28, "n_kv_heads": 4})],
    ids=["whisper", "qwen2-vl", "qwen2-vl-rep7"])
def test_reduced_audio_vlm_serve_on_card_matches_cpu(cuda_dev, arch, kw):
    """Reduced whisper (``enc_embed`` (2, 32, 256)) and qwen2-vl
    (``vision_embed`` (2, 16, 256); also at the published GQA rep 7, 28
    heads over 4), f32 activations, the same weights, stub inputs and
    tokens: prefill(16, max_new 4) + 4 teacher-forced decode steps on the
    card (the flash kernel: encoder, cross and M-RoPE attention) and on
    the CPU (plain versions); logits and every cache leaf within 1e-4,
    TF32 off; the flash calls per path held (whisper: 2 encoder + 2 x 2
    decoder prefill calls and 2 x 2 per step; qwen2-vl: 2 and 2 per
    step)."""
    disable_tf32()
    cfg = dataclasses.replace(get_config(arch).reduce(),
                              activ_dtype="float32", **kw)
    m = model.build_model(cfg)
    params = m.init(torch.Generator().manual_seed(6), "cpu")
    toks = token_batch(5, 2, 20, cfg.vocab, "cpu")["tokens"]
    name, n = (("enc_embed", cfg.enc_seq) if cfg.family == "audio"
               else ("vision_embed", cfg.vision_tokens))
    extra = torch.from_numpy(np.random.default_rng(7).normal(
        size=(2, n, cfg.d_model)).astype(np.float32))
    outs = []
    for d in ("cpu", cuda_dev):
        p, t = _to(params, d), toks.to(d)
        flash_attention.reset_paths()
        lg, cache = m.prefill(p, t[:, :16], extras={name: extra.to(d)},
                              max_new=4)
        steps = [lg]
        for i in range(16, 20):
            lg, cache = m.decode_step(p, cache, t[:, i:i + 1])
            steps.append(lg)
        outs.append((steps, cache, dict(flash_attention.PATH_CALLS)))
    per_layer = 2 if cfg.family == "audio" else 1
    assert outs[1][2] == {"split_kv": 4 * 2 * per_layer, "wgmma": 0,
                          "f32_tile": cfg.enc_layers + 2 * per_layer}
    for a, b in zip(outs[0][0], outs[1][0]):
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4)
    assert sorted(outs[1][1]) == sorted(outs[0][1])
    for k, a in outs[0][1].items():
        if torch.is_tensor(a):
            torch.testing.assert_close(outs[1][1][k].cpu(), a, atol=1e-4,
                                       rtol=1e-4)
        else:
            assert outs[1][1][k] == a


@pytest.mark.parametrize("s", [20, 6], ids=["prompt-20", "prompt-6"])
def test_ring_decode_on_card_matches_cpu(cuda_dev, s):
    """Reduced qwen3, f32 activations, window 8: prefill of an s-token
    prompt (a full ring of 8 slots, or the prompt's 6) and 10 decode
    steps that wrap it, through the kernel (windowed causal prefill, then
    non-causal split-KV over the ring) on the card against the plain path
    on the CPU; logits and the cache within 1e-4, TF32 off."""
    disable_tf32()
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduce(),
                              activ_dtype="float32")
    m = model.build_model(cfg)
    params = m.init(torch.Generator().manual_seed(4), "cpu")
    toks = token_batch(3, 2, s + 10, cfg.vocab, "cpu")["tokens"]
    outs = []
    for d in ("cpu", cuda_dev):
        p = _to(params, d)
        t = toks.to(d)
        lg, cache = m.prefill(p, t[:, :s], window=8)
        flash_attention.reset_paths()
        steps = [lg]
        for i in range(s, s + 10):
            lg, cache = m.decode_step(p, cache, t[:, i:i + 1], window=8)
            steps.append(lg)
        outs.append((steps, cache, dict(flash_attention.PATH_CALLS)))
    assert outs[1][2]["split_kv"] == 10 * cfg.n_layers
    assert outs[1][1]["k"].shape[2] == min(s, 8)
    for a, b in zip(outs[0][0], outs[1][0]):
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4)
    for k, a in outs[0][1].items():
        if k != "t":
            torch.testing.assert_close(outs[1][1][k].cpu(), a, atol=1e-4,
                                       rtol=1e-4)


def test_dropless_moe_forward_is_bitwise_on_card(cuda_dev):
    """Reduced olmoe (dropless), bf16 activations: two runs of
    ``Model.logits`` on the card are bitwise equal (no write in the
    dispatch meets another), and so are two of ``moe_ffn`` alone at the
    full olmoe widths of one layer (64 experts top 8, d 2048, f 1024)
    over 4096 tokens."""
    from repro_torch.models import moe
    cfg = get_config("olmoe-1b-7b")
    m = model.build_model(cfg.reduce())
    params = m.init(torch.Generator(device=cuda_dev).manual_seed(0),
                    cuda_dev)
    batch = token_batch(0, 2, 64, cfg.reduce().vocab, cuda_dev)
    with torch.no_grad():
        assert torch.equal(m.logits(params, batch), m.logits(params, batch))
    dl = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    lp = moe.moe_init(torch.Generator(device=cuda_dev).manual_seed(1), dl,
                      cuda_dev)
    x = torch.randn((4, 1024, 2048), device=cuda_dev,
                    generator=torch.Generator(device=cuda_dev).manual_seed(2)
                    ).bfloat16()
    with torch.no_grad():
        a, aux_a = moe.moe_ffn(lp, dl, x)
        b, aux_b = moe.moe_ffn(lp, dl, x)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    assert bool(torch.isfinite(a.float()).all())


def _to(tree, d):
    return {k: _to(v, d) if isinstance(v, dict) else v.to(d)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the sharded bank over torch.distributed (one card)
# ---------------------------------------------------------------------------

def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_sharded_nccl_one_rank_round_is_bitwise_on_card(cuda_dev):
    """NCCL, one rank in this process: a deterministic MNIST-width
    ``HFLEnv`` (8 devices, 4 edges) under ``make_bank_context(1)``, reset
    and one (2, 2) round, bitwise the one-device env: accuracy, global
    model and bank."""
    import torch.distributed as dist
    from repro_torch.core import flatbank
    from repro_torch.launch import mesh as mesh_lib
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        out = []
        for ctx in (None, mesh_lib.make_bank_context(1)):
            env = HFLEnv(EnvConfig(task="mnist", mode="real", n_devices=8,
                                   n_edges=4, n_local=64, gamma_max=2,
                                   deterministic=True, agg=ctx))
            env.reset()
            env.step_raw(np.full(4, 2), np.full(4, 2))
            spec = flatbank.model_spec(env.global_model)
            out.append((env.acc, spec.flatten_model(env.global_model),
                        flatbank.bank_spec(env.bank).flatten(env.bank),
                        env.bank["c1_b"].device))
    finally:
        dist.destroy_process_group()
    (acc0, g0, b0, d0), (acc1, g1, b1, d1) = out
    assert acc0 == acc1 and torch.equal(g0, g1) and torch.equal(b0, b1)
    assert d0.type == d1.type == "cuda"


def test_sharded_gloo_two_ranks_aggregation_on_card(cuda_dev, tmp_path):
    """Two gloo ranks spawned on the one card: the sharded Eq. 1 at MNIST
    width makes one launch per rank, the edges on one rank are bitwise
    the single launch's, the spanning edge within 1e-5, the whole within
    1e-5 of the plain version; the shard-local resync is bitwise the
    one-device resync and the plain gather."""
    import torch.multiprocessing as mp
    import _torch_dist_driver as drv
    mp.spawn(drv.card_aggregation, args=(2, _free_port(), str(tmp_path)),
             nprocs=2, join=True)
    for r in range(2):
        res = torch.load(tmp_path / f"rank{r}.pt")
        assert res["launches"]["segment_agg"] == 1
        assert res["device"].startswith("cuda")
        assert res["one_rank_edges"] == [0, 1, 3, 4]
        assert res["bitwise"] and res["span"] and res["plain"]
        assert res["resync"] and res["resync_plain"]


def test_sharded_gloo_two_ranks_cnn_round_bitwise_on_card(cuda_dev,
                                                          tmp_path):
    """Fault 3 closed on the card: a deterministic MNIST ``HFLEnv`` (10
    devices, edges of 3, 4 and 3 rows, ``_torch_dist_driver.SPAN_ASSIGN``)
    on two gloo ranks spawned on the one card, edge 1 and its 4-row
    training call spanning them: reset and one (2, 2) round bitwise the
    one-device env (accuracy, global model, bank)."""
    import torch.multiprocessing as mp
    import _torch_dist_driver as drv
    from repro_torch.core import flatbank
    mp.spawn(drv.card_round, args=(2, _free_port(), str(tmp_path)),
             nprocs=2, join=True)
    env = HFLEnv(EnvConfig(**drv.CARD_ROUND_CFG))
    env.set_topology(drv.SPAN_ASSIGN)
    env.reset()
    env.step_raw(np.full(3, 2), np.full(3, 2))
    gvec = flatbank.model_spec(env.global_model).flatten_model(
        env.global_model).cpu()
    bank = flatbank.bank_spec(env.bank).flatten(env.bank).cpu()
    res = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    assert all(r["device"].startswith("cuda") for r in res)
    assert all(r["acc"] == env.acc and torch.equal(r["gvec"], gvec)
               for r in res)
    assert torch.equal(torch.cat([r["bank"] for r in res]), bank)


def test_sharded_gloo_two_ranks_snapshot_resume_bitwise_on_card(cuda_dev,
                                                               tmp_path):
    """A sharded snapshot on the card: the deterministic faulty MNIST
    ``AsyncHFLEnv`` (``_torch_dist_driver.CARD_SNAP_CFG``) on two gloo
    ranks spawned on the one card, saved after 3 events: the resumed env
    runs the last 3 bitwise the uninterrupted run (events, global vector,
    each rank's bank rows), which is the one-device run's; the sharded
    snapshot's arrays are bitwise the one-device env's snapshot at the
    same event."""
    import torch.multiprocessing as mp
    import _torch_dist_driver as drv
    mp.spawn(drv.card_snapshot, args=(2, _free_port(), str(tmp_path)),
             nprocs=2, join=True)
    env = drv.card_snapshot_env(None)
    env.reset()
    drv._events(env, drv.SNAP_AT)
    store.save_runtime(env, str(tmp_path / "one"))
    one = drv._events(env, drv.TRAJ_RUNS["faults"] - drv.SNAP_AT)
    res = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    for r in res:
        assert r["device"].startswith("cuda")
        for run in (r["whole"], r["resumed"]):
            assert run["traj"] == one["traj"]
            assert np.array_equal(run["gvec"], one["gvec"])
            assert run["rows"] == [4]
    for run in ("whole", "resumed"):
        assert np.array_equal(np.concatenate([r[run]["bank"] for r in res]),
                              one["bank"])
    with np.load(tmp_path / "one.npz") as a, \
            np.load(tmp_path / "snap.npz") as b:
        assert a.files == b.files
        assert all(np.array_equal(a[k], b[k]) for k in a.files)


@pytest.mark.parametrize("world", [2, 4])
def test_multi_rank_train_step_bitwise_on_card(cuda_dev, tmp_path, world):
    """The reduced qwen3 (2, 2) round (f32 activations, vocab 128) on
    replicas (1, 2, 2) over gloo ranks spawned on the one card (rank grid
    (1, 1, 2) at 2 ranks, (1, 2, 2) at 4) in deterministic mode: every
    leaf of every replica bitwise the one-device card round from the same
    seed-0 weights and batch, (g2 + 1) ``segment_agg`` and
    ``segment_broadcast`` launches per leaf on each rank."""
    import torch.multiprocessing as mp
    import _torch_dist_driver as drv
    from repro_torch.device import deterministic_algorithms
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train
    mp.spawn(drv.card_train, args=(world, _free_port(), str(tmp_path)),
             nprocs=world, join=True)
    cfg, p0, batch, kw = drv.card_train_setup(cuda_dev)
    step, _, _ = train.make_hfl_train_step(
        cfg, mesh_lib.make_hfl_mesh(drv.TRAIN_REPS, device=cuda_dev), **kw)
    with deterministic_algorithms():
        want = drv._flat(step(train.lift_params(p0, *drv.TRAIN_REPS),
                              batch))
    n = len(want) * (kw["g2"] + 1)
    for r in range(world):
        res = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        assert res["device"].startswith("cuda")
        assert res["grid"] == mesh_lib.rank_grid(drv.TRAIN_REPS, world)
        assert res["launches"]["segment_agg"] == n
        assert res["launches"]["segment_broadcast"] == n
        assert sorted(res["round"]) == sorted(want)
        assert all(torch.equal(res["round"][k], v.cpu())
                   for k, v in want.items())


def test_tp_train_step_on_card(cuda_dev, tmp_path):
    """The tensor plane on the card: the reduced qwen3 (2, 2) round (f32
    activations, vocab 128) on replicas (1, 2, 2), each replica over tp
    = 2 gloo ranks spawned on the one card, in deterministic mode:
    bitwise run to run, replica (0, 0, 0) gathered whole within 1e-4 of
    the same round's on the CPU (the plain versions), the replicated
    leaves bitwise equal across the two ranks, (g2 + 1) ``segment_agg``
    and ``segment_broadcast`` launches per leaf on each rank."""
    import torch.multiprocessing as mp
    import _torch_dist_driver as drv
    mp.spawn(drv.card_tp_train, args=(2, _free_port(), str(tmp_path)),
             nprocs=2, join=True)
    res = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    _, _, _, kw = drv.card_train_setup(cuda_dev)
    for r in res:
        card, again, cpu = r["rounds"]
        n = len(card) * (kw["g2"] + 1)
        assert r["device"].startswith("cuda")
        assert r["launches"]["segment_agg"] == n
        assert r["launches"]["segment_broadcast"] == n
        assert all(torch.equal(card[k], again[k]) for k in card)
        assert all(torch.allclose(card[k], cpu[k], atol=1e-4, rtol=1e-4)
                   for k in card)
        for i in range(3):
            assert all(torch.equal(v, res[0]["replicated"][i][k])
                       for k, v in r["replicated"][i].items())


def test_serve_mesh_two_ranks_on_card(cuda_dev, tmp_path):
    """Mesh serving on the card: reduced qwen3 served over the serve mesh
    (1, 1, 2) of 2 gloo ranks spawned on the one card (a rank's 2 query
    heads over 1 kv head), prefill of 16 tokens and 4 decode steps fed
    the one-device serve's greedy tokens: every step's logits whole and
    bitwise equal on both ranks, within relative L2 0.1 of the
    one-device serve's in bf16 and 1e-4 in f32; each rank launches
    ``flash_attention`` once per layer for the prefill (the ``wgmma``
    path in bf16) and once per layer and step for the decode
    (``split_kv``)."""
    import torch.multiprocessing as mp
    import _torch_dist_driver as drv
    mp.spawn(drv.card_serve_mesh, args=(2, _free_port(), str(tmp_path)),
             nprocs=2, join=True)
    res = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    for r in res:
        assert r["device"].startswith("cuda")
        for act in ("bfloat16", "float32"):
            got = r[act]
            assert torch.equal(got["fed"], got["greedy"])
            assert got["launches"]["flash_attention"] == 2 * 5
            assert got["paths"] == {
                "wgmma": 2 if act == "bfloat16" else 0,
                "f32_tile": 0 if act == "bfloat16" else 2,
                "split_kv": 2 * 4}
            for a, b, c in zip(got["mesh"], got["one"],
                               res[0][act]["mesh"]):
                assert torch.equal(a, c)
                if act == "bfloat16":
                    rel = (a.float() - b.float()).norm() / b.float().norm()
                    assert float(rel) <= 0.1
                else:
                    assert torch.allclose(a, b, atol=1e-4, rtol=1e-4)


def test_fsdp_train_step_on_card(cuda_dev, tmp_path):
    """The fsdp axis on the card: the reduced qwen3 (2, 2) round (f32
    activations, vocab 128) on replicas (1, 2, 2), each replica over F =
    2 fsdp gloo ranks (T = 1) spawned on the one card, in deterministic
    mode: bitwise run to run, replica (0, 0, 0) gathered whole within
    1e-4 of the same round's on the CPU (the plain versions), the leaves
    no spec splits (attention, the norms) bitwise equal across the two
    ranks, (g2 + 1) ``segment_agg`` and ``segment_broadcast`` launches
    per leaf on each rank."""
    import torch.multiprocessing as mp
    import _torch_dist_driver as drv
    mp.spawn(drv.card_tp_train, args=(2, _free_port(), str(tmp_path), 2),
             nprocs=2, join=True)
    res = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    _, _, _, kw = drv.card_train_setup(cuda_dev)
    for r in res:
        card, again, cpu = r["rounds"]
        n = len(card) * (kw["g2"] + 1)
        assert r["device"].startswith("cuda")
        assert r["launches"]["segment_agg"] == n
        assert r["launches"]["segment_broadcast"] == n
        assert all(torch.equal(card[k], again[k]) for k in card)
        assert all(torch.allclose(card[k], cpu[k], atol=1e-4, rtol=1e-4)
                   for k in card)
        assert "layers/attn/wq" in r["replicated"][0]
        for i in range(3):
            assert all(torch.equal(v, res[0]["replicated"][i][k])
                       for k, v in r["replicated"][i].items())


def test_fsdp_whisper_loss_and_grads_on_card(cuda_dev, tmp_path):
    """The fsdp axis of the audio family on the card: reduced whisper-base
    (f32 activations, seed-0 weights drawn on the card, its batch with
    ``enc_embed``) split over F = 2 gloo ranks spawned on the one card,
    vocab 512 (the embedding split) and 515 (kept whole by the guard):
    on each rank ``Model.loss(ft=)`` and every gradient block within
    1e-4 of the one-device loss and gradients on the card."""
    import torch.multiprocessing as mp
    import _torch_dist_driver as drv
    mp.spawn(drv.card_fsdp_loss, args=(2, _free_port(), str(tmp_path)),
             nprocs=2, join=True)
    for r in range(2):
        res = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        assert res["device"].startswith("cuda")
        for vocab, rows in ((None, 256), (515, 515)):
            one, ft = res[vocab]["one"], res[vocab]["ft"]
            assert ft["grads"]["embed"].shape[0] == rows
            assert abs(ft["loss"] - one["loss"]) <= 1e-4 * (
                1 + abs(one["loss"]))
            assert sorted(ft["grads"]) == sorted(one["grads"])
            for k, g in one["grads"].items():
                torch.testing.assert_close(ft["grads"][k], g, atol=1e-4,
                                           rtol=1e-4)


def test_tp_rwkv6_loss_and_grads_on_card(cuda_dev, tmp_path):
    """The ssm family's tensor plane on the card: reduced rwkv6 (f32
    activations, seed-0 weights drawn on the card) split over tp = 2
    gloo ranks spawned on the one card, ``Model.loss(tp=)`` through
    ``wkv_chunked`` and ``wkv_scan``: on each rank the loss and every
    gradient block within 1e-4 of the one-device loss and gradients on
    the card."""
    import torch.multiprocessing as mp
    import _torch_dist_driver as drv
    mp.spawn(drv.card_tp_rwkv, args=(2, _free_port(), str(tmp_path)),
             nprocs=2, join=True)
    for r in range(2):
        res = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        assert res["device"].startswith("cuda")
        for route in drv.WKV_ROUTES:
            one, tp = res[route]["one"], res[route]["tp"]
            assert abs(tp["loss"] - one["loss"]) <= 1e-4 * (
                1 + abs(one["loss"]))
            assert sorted(tp["grads"]) == sorted(one["grads"])
            for k, g in one["grads"].items():
                torch.testing.assert_close(tp["grads"][k], g, atol=1e-4,
                                           rtol=1e-4)


# ---------------------------------------------------------------------------
# the LLM train step
# ---------------------------------------------------------------------------

def test_kernel_wrappers_refuse_autograd_on_card(cuda_dev):
    """On CUDA tensors too, every kernel wrapper raises RuntimeError when
    grad mode is on and an input requires a gradient, and launches under
    ``torch.no_grad()``."""
    g = torch.Generator(device=cuda_dev).manual_seed(0)
    q = torch.randn((1, 2, 8, 64), generator=g, device=cuda_dev)
    r = torch.randn((1, 16, 2, 64), generator=g, device=cuda_dev)
    w = torch.rand((1, 16, 2, 64), generator=g, device=cuda_dev)
    u = torch.zeros((2, 64), device=cuda_dev)
    bank = torch.randn((4, 1000), generator=g, device=cuda_dev)
    ones = torch.ones(4, device=cuda_dev)
    seg = torch.tensor([0, 0, 1, 1], dtype=torch.int32, device=cuda_dev)
    models = torch.randn((2, 1000), generator=g, device=cuda_dev)
    for t in (q, r, bank, models):
        t.requires_grad_(True)
    calls = {"flash_attention": lambda: ops.flash_attention(q, q, q),
             "wkv6": lambda: ops.wkv6(r, r, r, w, u),
             "segment_agg": lambda: ops.segment_agg(bank, ones, seg, 2),
             "segment_sum_partial": lambda: ops.segment_sum_partial(
                 bank, ones, seg, 2),
             "segment_broadcast": lambda: ops.segment_broadcast(models, seg)}
    for name, call in calls.items():
        ops.reset_launches()
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        assert sum(ops.LAUNCHES.values()) == 0, name
        with torch.no_grad():
            call()
        assert sum(ops.LAUNCHES.values()) == 1, name


def test_llm_edge_mean_shape_matches_plain(cuda_dev):
    """The train step's largest leaf, qwen3-1.7b's layers/mlp/w_gate over
    replicas (1, 2, 2): a (4, 352,321,536) f32 bank, 2 edges, weights 1.
    ``segment_agg`` within AGG_TOL of the plain version, the resync
    ``segment_broadcast`` bitwise, each run twice bitwise."""
    n, p, e = 4, 28 * 2048 * 6144, 2
    g = torch.Generator(device=cuda_dev).manual_seed(1)
    bank = torch.randn((n, p), generator=g, device=cuda_dev)
    w = torch.ones(n, device=cuda_dev)
    seg = torch.tensor([0, 0, 1, 1], dtype=torch.int32, device=cuda_dev)
    got = ops.segment_agg(bank, w, seg, e)
    torch.testing.assert_close(got, ref.segment_agg_ref(bank, w, seg, e),
                               atol=AGG_TOL, rtol=AGG_TOL)
    assert torch.equal(got, ops.segment_agg(bank, w, seg, e))
    out = ops.segment_broadcast(got, seg, out=bank)
    assert torch.equal(out, ref.segment_broadcast_ref(got, seg))
    assert torch.equal(out, ops.segment_broadcast(got, seg))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-1.6b",
                                  "olmoe-1b-7b"])
def test_reduced_train_step_on_card_matches_cpu(cuda_dev, arch):
    """The hierarchical train step, reduced config with f32 activations
    and vocab 128, replicas (1, 2, 2), one (2, 2) round of batch 8 x seq
    32 (KV chunks of 16; rwkv6 in one minibatch per epoch, as
    ``tests/_torch_train_ref.py`` explains), TF32 off: card against CPU
    within 1e-4 at every leaf, replicas bitwise equal, and (g2 + 1)
    launches of each aggregation kernel per leaf on the card."""
    from repro_torch.launch import mesh, train
    disable_tf32()
    cfg = dataclasses.replace(get_config(arch).reduce(),
                              activ_dtype="float32", vocab=128)
    p0 = model.build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    outs = []
    for d in ("cpu", cuda_dev):
        step, _, _ = train.make_hfl_train_step(
            cfg, mesh.make_hfl_mesh((1, 2, 2), device=d), lr=3e-3,
            mb_per_epoch=1 if arch.startswith("rwkv6") else 2, remat=False,
            g1=2, g2=2, attn_chunk=16)
        params = train.lift_params(train._map(lambda a: a.to(d), p0), 1, 2, 2)
        ops.reset_launches()
        out = step(params, token_batch(0, 8, 32, 128, device=d))
        leaves = train._leaves(out)
        for leaf in leaves:
            rows = leaf.view(4, -1)
            assert all(torch.equal(rows[i], rows[0]) for i in range(1, 4))
        outs.append(leaves)
    assert ops.LAUNCHES["segment_agg"] == ops.LAUNCHES[
        "segment_broadcast"] == 3 * len(outs[0])
    assert ops.LAUNCHES["flash_attention"] == ops.LAUNCHES["wkv6"] == 0
    for a, b in zip(*outs):
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4)
