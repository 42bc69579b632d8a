"""The port's CUDA kernels on the card, against their plain versions on
the same CUDA tensors, and the reduced serving path on the card against
the CPU. Marked ``cuda``: each test skips (from inside the
``cuda_dev`` fixture) where no CUDA device is available. On a GPU host:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports no JAX, so it runs on a host without it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import hfl
from repro_torch.data.synthetic import token_batch
from repro_torch.device import disable_tf32
from repro_torch.kernels import _build, flash_attention, hier_agg, ops, ref
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
    assert hier_agg.LAUNCHES == {"segment_agg": 4, "segment_broadcast": 2,
                                 "flash_attention": 0, "wkv6": 0}
    for cpu_part, gpu_part in zip(*outs):
        for k in cpu_part:
            torch.testing.assert_close(gpu_part[k].cpu(), cpu_part[k],
                                       rtol=1e-4, atol=1e-5)


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
                (2, 16, 8, 40, 1064, 128, True, 0, 1024)]
FLASH_IDS = ["qwen3-prefill", "qwen3-decode", "ragged", "window", "mha",
             "non-causal", "continuation", "decode-rep1", "decode-rep4",
             "decode-rep8", "skv-1", "skv-65", "skv-4097",
             "causal-end-mid-split", "split-emptied", "decode-window",
             "prefill-d64", "rows-16-edge", "continuation-d128"]


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
    """The SASS of the built library (cuobjdump): both instantiations of
    the bf16 tile kernel (D 64 and 128) issue tensor-core instructions
    (HGMMA for wgmma, HMMA for mma.sync)."""
    counts = _build.tensor_core_ops("flash_attention")
    tile = {k: n for k, n in counts.items()
            if k.startswith("flash_wgmma_kernel")}
    assert set(tile) == {"flash_wgmma_kernel<64>", "flash_wgmma_kernel<128>"}
    assert all(n > 0 for n in tile.values()), counts


# chunked sums in other orders and __expf in the kernel: the reference's
# own wkv6 tolerance; 1e-3 for hard decays, as in the reference
@pytest.mark.parametrize("rkv_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,nh,chunk,lo,hi,tol", [
    (4, 1024, 32, 64, 0.3, 0.999, 2e-4),
    (2, 1000, 8, 64, 0.3, 0.999, 2e-4),
    (2, 130, 3, 32, 0.3, 0.999, 2e-4),
    (1, 256, 4, 32, 1e-4, 0.1, 1e-3)],
    ids=["rwkv6-prefill", "ragged", "ragged-32", "hard-decay"])
def test_wkv6_kernel_matches_plain(cuda_dev, b, s, nh, chunk, lo, hi, tol,
                                   rkv_dtype):
    gen = torch.Generator(device=cuda_dev).manual_seed(1)
    r, k, v = (torch.randn((b, s, nh, 64), generator=gen,
                           device=cuda_dev).to(rkv_dtype) for _ in range(3))
    w = torch.rand((b, s, nh, 64), generator=gen, device=cuda_dev) \
        * (hi - lo) + lo
    u = torch.randn((nh, 64), generator=gen, device=cuda_dev)
    ops.reset_launches()
    y, st = ops.wkv6(r, k, v, w, u, chunk=chunk)
    assert ops.LAUNCHES["wkv6"] == 1
    yw, stw = ref.wkv6_ref(r, k, v, w, u, chunk=chunk)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    torch.testing.assert_close(y, yw, atol=tol, rtol=tol)
    torch.testing.assert_close(st, stw, atol=tol, rtol=tol)
    y2, st2 = ops.wkv6(r, k, v, w, u, chunk=chunk)
    assert torch.equal(y, y2) and torch.equal(st, st2)           # bitwise


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


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-1.6b"])
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
    kern = "flash_attention" if cfg.family == "dense" else "wkv6"
    assert outs[0][2][kern] == 0
    assert outs[1][2][kern] == (5 if kern == "flash_attention" else 1) \
        * cfg.n_layers
    for a, b in zip(outs[0][0], outs[1][0]):
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4)
    for k, a in outs[0][1].items():
        if k != "t":
            torch.testing.assert_close(outs[1][1][k].cpu(), a, atol=1e-4,
                                       rtol=1e-4)
