"""Segment-weighted model aggregation and bank resync (CUDA kernels).

The port of ``repro.kernels.hier_agg``. The two hot-path operations of
the flat-bank engine each run as one launch of a hand-written CUDA
kernel (``csrc/hier_agg.cu``, built by ``_build``):

``segment_agg``
    ``(N, P) bank x (N,) weights x (N,) segment ids -> (E, P)`` f32
    weighted segment means (Eq. 1 with E edges, Eq. 2 with E = 1).
    The kernel sums the segment weights itself and normalizes by
    multiplying with ``1 / max(sum, 1e-9)``, as the reference does.
``segment_sum_partial``
    The same launch unnormalized: the sums plus the ``(E,)`` weight sums,
    which the kernel writes too (the per-shard half of the sharded path).
``segment_agg_sharded``
    ``segment_agg`` over a bank whose rows are sharded over the ranks of
    a ``torch.distributed`` group: one ``segment_sum_partial`` launch on
    this rank's rows, ``all_reduce`` of the sums and weight sums, and the
    multiply by the reciprocal. The kernel splits no row across threads
    or blocks, so when each segment's rows lie on one rank the result is
    bitwise the single launch on the whole bank.
``segment_agg_ordered``
    The same sharded aggregation with the single launch's bits for any
    row layout: the ranks take turns, each continuing the chain of sums
    of the rank before it (one ``segment_sum_partial`` launch per rank,
    a broadcast per rank). The deterministic rounds use it.
``segment_broadcast``
    ``(E, P) models x (N,) segment ids -> (N, P)``, ``out[i] =
    models[seg_i]`` written in the bank's dtype: the bank resync.
``hier_agg``
    The single-segment legacy API.

Dispatch is by the device of the tensors: CPU tensors go to the plain
versions in ``repro_torch.kernels.ref``; CUDA tensors go to the kernel,
or the call raises. Every wrapper checks dtype, shape, contiguity and
device, allocates its outputs with ``torch.empty``, launches on
``torch.cuda.current_stream()``, raises if the launcher reports a CUDA
error, and adds one to ``LAUNCHES[<kernel>]`` for each kernel launch.
With f32 weights and contiguous int32 ids (what the cloud round passes)
a ``segment_agg`` call issues no torch operation but ``torch.empty``
before its one launch. Nothing uses atomics, so results are the same
bits on every run.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._common import (  # noqa: F401
    DTYPE_CODE,
    LAUNCHES,
    check_device,
    raise_on_error,
    reset_launches,
)

MAX_SEGMENTS = 32              # the register-accumulator cap of the kernel
MAX_BROADCAST_ROWS = 65535 * 16  # 16 bank rows per grid row (gridDim.y)


def _lib() -> ctypes.CDLL:
    lib = _build.load("hier_agg")
    if not getattr(lib, "_repro_bound", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_segment_agg.argtypes = [vp, i32, vp, vp, vp, vp, i32, i64,
                                          i32, i32, vp]
        lib.repro_segment_agg.restype = i32
        lib.repro_segment_broadcast.argtypes = [vp, vp, vp, i32, i32, i64,
                                                i32, vp]
        lib.repro_segment_broadcast.restype = i32
        lib._repro_bound = True
    return lib


def _launch_segment_agg(bank, weights, segment_ids, e: int, *,
                        normalize: bool, with_wsum: bool = False):
    """Launch the CUDA kernel: (N, P) bank x (N,) w x (N,) ids -> (E, P)
    f32 sums, scaled by ``1 / max(sum w, 1e-9)`` per segment when
    ``normalize``; returns ``(out, wsum)`` with the kernel's ``(E,)`` f32
    weight sums when ``with_wsum``, else ``(out, None)``. Weights other
    than f32 and ids other than contiguous int32 are converted first."""
    if bank.dtype not in DTYPE_CODE:
        raise TypeError(f"segment_agg: CUDA kernel takes an f32 or bf16 "
                        f"bank, got {bank.dtype}")
    if e < 1 or e > MAX_SEGMENTS:
        raise ValueError(f"segment_agg: the CUDA kernel keeps at most "
                         f"{MAX_SEGMENTS} segments in registers, got {e}")
    if not bank.is_contiguous():
        raise ValueError("segment_agg: bank must be contiguous")
    lib = _lib()
    if weights.dtype != torch.float32 or not weights.is_contiguous():
        weights = weights.to(torch.float32).contiguous()
    if segment_ids.dtype != torch.int32 or not segment_ids.is_contiguous():
        segment_ids = segment_ids.to(torch.int32).contiguous()
    n, p = bank.shape
    out = torch.empty((e, p), dtype=torch.float32, device=bank.device)
    wsum = (torch.empty((e,), dtype=torch.float32, device=bank.device)
            if with_wsum else None)
    stream = torch.cuda.current_stream(bank.device).cuda_stream
    rc = lib.repro_segment_agg(bank.data_ptr(), DTYPE_CODE[bank.dtype],
                               weights.data_ptr(), segment_ids.data_ptr(),
                               out.data_ptr(),
                               wsum.data_ptr() if with_wsum else None, n, p,
                               e, int(normalize), stream)
    raise_on_error("segment_agg", rc)
    LAUNCHES["segment_agg"] += 1
    return out, wsum


def _check_agg_inputs(bank, weights, segment_ids) -> torch.device:
    if bank.dim() != 2:
        raise ValueError(f"segment_agg: bank must be (N, P), got "
                         f"{tuple(bank.shape)}")
    n = bank.shape[0]
    if weights.shape != (n,) or segment_ids.shape != (n,):
        raise ValueError(f"segment_agg: weights {tuple(weights.shape)} and "
                         f"segment_ids {tuple(segment_ids.shape)} must be "
                         f"({n},)")
    if segment_ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"segment_agg: integer segment ids expected, got "
                        f"{segment_ids.dtype}")
    return check_device("segment_agg", bank, weights, segment_ids)


def _cpu_weight_sums(weights, segment_ids, e: int):
    """The weight sums of the CPU path: added in f64 and rounded once to
    f32. The kernel adds each segment's rows in one sequential chain, so
    a shard's rows sum to the bits of the whole bank's chain restricted
    to them; the CPU's vectorised f32 sum groups the rows by their
    position, and the exact f64 sum restores that property."""
    return ref.segment_weight_sums(weights, segment_ids, e,
                                   dtype=torch.float64).to(torch.float32)


def segment_agg(bank, weights, segment_ids, num_segments: int):
    """bank: (N, P) f32 or bf16; weights: (N,); segment_ids: (N,) int.
    Returns the per-segment weighted means (num_segments, P) f32:

        out[j] = sum_{i: seg_i=j} w_i bank[i] * (1 / max(sum w_i, 1e-9))

    Empty segments return zeros (the weight-sum clamp)."""
    e = int(num_segments)
    if _check_agg_inputs(bank, weights, segment_ids).type == "cpu":
        inv = 1.0 / _cpu_weight_sums(weights, segment_ids, e).clamp_min(1e-9)
        return ref.segment_scaled_sum_ref(bank, weights, segment_ids, inv, e)
    return _launch_segment_agg(bank, weights, segment_ids, e,
                               normalize=True)[0]


def segment_sum_partial(bank, weights, segment_ids, num_segments: int):
    """The same launch as ``segment_agg``, unnormalized. Returns

        sums: (num_segments, P) f32 -- sum_{i: seg_i=j} w_i bank[i]
        wsum: (num_segments,)   f32 -- sum_{i: seg_i=j} w_i
    """
    e = int(num_segments)
    if _check_agg_inputs(bank, weights, segment_ids).type == "cpu":
        wsum = _cpu_weight_sums(weights, segment_ids, e)
        sums = ref.segment_scaled_sum_ref(bank, weights, segment_ids,
                                          torch.ones_like(wsum), e)
        return sums, wsum
    return _launch_segment_agg(bank, weights, segment_ids, e,
                               normalize=False, with_wsum=True)


def segment_agg_sharded(bank, weights, segment_ids, num_segments: int,
                        group=None):
    """``segment_agg`` of a row-sharded bank: ``bank`` (N/k, P),
    ``weights`` and ``segment_ids`` (N/k,) are this rank's rows; every
    rank of ``group`` calls it with its own. Returns the (num_segments, P)
    f32 means over all ranks' rows, the same on every rank:

        out[j] = S_j * (1 / max(W_j, 1e-9)),
        S_j = all_reduce(sum_{local i: seg_i=j} w_i bank[i]),
        W_j = all_reduce(sum_{local i: seg_i=j} w_i)

    The local sums are one ``segment_sum_partial`` launch (the plain
    version for CPU tensors); the normalisation multiplies by the
    reciprocal, as the kernel does, never divides. Zero partials add
    nothing, so a segment whose rows lie on one rank gets the single
    launch's bits; a segment spanning ranks differs in the last bits.
    Segments empty on every rank give zeros."""
    import torch.distributed as dist
    sums, wsum = segment_sum_partial(bank, weights, segment_ids,
                                     num_segments)
    dist.all_reduce(sums, group=group)
    dist.all_reduce(wsum, group=group)
    return sums * (1.0 / wsum.clamp_min(1e-9))[:, None]


def segment_agg_ordered(bank, weights, segment_ids, num_segments: int,
                        group=None):
    """``segment_agg_sharded`` with the one-device bits for any row
    layout, an edge spanning ranks included: the ranks take turns, rank
    0 first, and each continues the chain of sums where the rank before
    it left off, so every (segment, column) is summed in one ascending
    chain over all N rows, as the single launch sums it.

    Rank r runs one ``segment_sum_partial`` launch on an (E + N/k, P + 1)
    f32 stack: E carry rows (the sums so far, weight 1: ``fmaf(1, s,
    0) == s`` starts the chain at s) over its own rows, whose extra
    column holds 1 so that column P chains the weight sums as the kernel
    adds them (``acc + w_i``); then it broadcasts the (E, P + 1) sums to
    the group, and the last rank's are the result. The CPU path sums the
    weights as the one-device CPU path does (exactly, in f64). k
    broadcasts of (E, P + 1) f32 per call, in place of two
    ``all_reduce``; the deterministic rounds use it."""
    import torch.distributed as dist
    e = int(num_segments)
    dev = _check_agg_inputs(bank, weights, segment_ids)
    n, p = bank.shape
    stack = torch.empty((e + n, p + 1), dtype=torch.float32, device=dev)
    stack[e:, :p] = bank
    stack[e:, p] = 1.0
    carry = stack[:e]
    carry.zero_()
    ids = torch.cat([torch.arange(e, dtype=torch.int32, device=dev),
                     segment_ids.to(torch.int32)])
    w = torch.cat([torch.ones((e,), dtype=torch.float32, device=dev),
                   weights.to(torch.float32)])
    rank = dist.get_rank(group)
    for r in range(dist.get_world_size(group)):
        if r == rank:
            carry.copy_(segment_sum_partial(stack, w, ids, e)[0])
        src = r if group is None else dist.get_global_rank(group, r)
        dist.broadcast(carry, src=src, group=group)
    if dev.type == "cpu":                # as the one-device CPU path
        wsum = ref.segment_weight_sums(weights, segment_ids, e,
                                       dtype=torch.float64)
        dist.all_reduce(wsum, group=group)
        wsum = wsum.to(torch.float32)
    else:
        wsum = carry[:, p]
    return carry[:, :p] * (1.0 / wsum.clamp_min(1e-9))[:, None]


def segment_broadcast(models, segment_ids, *, out_dtype=None, out=None):
    """models: (E, P) f32; segment_ids: (N,) int. Returns (N, P) with
    ``out[i] = models[segment_ids[i]]`` converted to ``out_dtype``
    (default: the models' dtype) as it is written: the bank resync.

    ``out`` (port-only): an existing contiguous (N, P) tensor to write
    into, so a round can resync its bank in place (the counterpart of
    the reference's buffer donation)."""
    if models.dim() != 2 or segment_ids.dim() != 1:
        raise ValueError(f"segment_broadcast: models (E, P) and "
                         f"segment_ids (N,) expected, got "
                         f"{tuple(models.shape)} and "
                         f"{tuple(segment_ids.shape)}")
    e, p = models.shape
    n = segment_ids.shape[0]
    out_dtype = out_dtype or (out.dtype if out is not None
                              else models.dtype)
    if out is not None and (out.shape != (n, p) or out.dtype != out_dtype):
        raise ValueError(f"segment_broadcast: out must be ({n}, {p}) "
                         f"{out_dtype}, got {tuple(out.shape)} {out.dtype}")
    tensors = (models, segment_ids) + ((out,) if out is not None else ())
    dev = check_device("segment_broadcast", *tensors)
    if dev.type == "cpu":
        res = ref.segment_broadcast_ref(models, segment_ids, out_dtype)
        return res if out is None else out.copy_(res)
    if models.dtype != torch.float32:
        raise TypeError(f"segment_broadcast: CUDA kernel takes f32 models, "
                        f"got {models.dtype}")
    if out_dtype not in DTYPE_CODE:
        raise TypeError(f"segment_broadcast: CUDA kernel writes f32 or "
                        f"bf16, got {out_dtype}")
    if n > MAX_BROADCAST_ROWS:
        raise ValueError(f"segment_broadcast: at most "
                         f"{MAX_BROADCAST_ROWS} rows, got {n}")
    if not models.is_contiguous() or (out is not None
                                      and not out.is_contiguous()):
        raise ValueError("segment_broadcast: models and out must be "
                         "contiguous")
    seg32 = segment_ids.to(torch.int32).contiguous()
    lib = _lib()
    if out is None:
        out = torch.empty((n, p), dtype=out_dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.repro_segment_broadcast(models.data_ptr(), seg32.data_ptr(),
                                     out.data_ptr(), DTYPE_CODE[out_dtype],
                                     n, p, e, stream)
    raise_on_error("segment_broadcast", rc)
    LAUNCHES["segment_broadcast"] += 1
    return out


def hier_agg(bank, weights):
    """Legacy single-segment API. bank: (R, N); weights: (R,). Returns
    the weighted mean (N,) f32 -- ``segment_agg`` with one segment."""
    r = bank.shape[0]
    seg = torch.zeros((r,), dtype=torch.int32, device=bank.device)
    return segment_agg(bank, weights, seg, 1)[0]
