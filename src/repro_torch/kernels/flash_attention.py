"""GQA flash attention (CUDA kernels); the port of
``repro.kernels.flash_attention``.

``flash_attention(q, k, v, *, causal, window, q_offset)`` runs the
hand-written kernels of ``csrc/flash_attention.cu`` for CUDA tensors and
the plain version ``ref.flash_attention_ref`` for CPU tensors; a CUDA
tensor never falls back. q: (B, H, Sq, D); k/v: (B, Hkv, Skv, D),
H % Hkv == 0, D in (64, 112, 128) (112: zamba2-7b), f32 or bf16; the
output is (B, H, Sq, D) in q's dtype. Rows must start on 16-byte boundaries (the model's tensors
do).

``plan`` picks the path from dtype and shape alone (no path gives way to
another at run time; a kernel that fails to build or launch raises):

1. ``split_kv`` when the rep = H / Hkv query heads of a kv head times Sq
   make at most 16 packed rows (decode), in either dtype: a split kernel
   (one block per batch, kv head and split of 64 visible keys, each K/V
   row read once for the whole GQA group, f32 partials into a scratch
   tensor allocated here) and a merge kernel, two device launches;
   ``flash_attention_split_ref`` states the algorithm;
2. ``wgmma`` for bf16 with more packed rows (prefill): products on the
   warpgroup tensor cores (wgmma bf16 -> f32) over K/V tiles that TMA
   copies, one launch;
3. ``f32_tile`` for f32 with more packed rows: f32 products on the CUDA
   cores, one launch (TF32 tensor cores would miss the f32 tolerance).

``LAUNCHES["flash_attention"]`` counts one per call on every path;
``PATH_CALLS`` counts the calls per path (reset with ``reset_paths``).

Unlike the Pallas kernel, Sq and Skv need not be multiples of a tile
(the kernels mask the ragged edge), and q, k and v may be strided views
as long as the head dim is contiguous: the model passes its (B, S, H, D)
projections transposed. The output's storage is (B, Sq, H, D) and the
returned tensor is its (B, H, Sq, D) transpose, so the model's
``out.transpose(1, 2).reshape(B, Sq, H * D)`` copies nothing.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._common import (
    DTYPE_CODE,
    LAUNCHES,
    check_device,
    raise_on_error,
)

HEAD_DIMS = (64, 112, 128)     # the head sizes the kernels are built for
MAX_BATCH_HEADS = 65535        # gridDim.y
MAX_PACKED_ROWS = 16           # rep * Sq up to which split_kv runs
SPLIT = 64                     # keys per split of the split_kv path
TILE_ROWS = 64                 # query rows per block of the wgmma path

# CUDA calls per path since the last reset_paths()
PATH_CALLS = {"split_kv": 0, "wgmma": 0, "f32_tile": 0}


def reset_paths() -> None:
    for k in PATH_CALLS:
        PATH_CALLS[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not getattr(lib, "_repro_bound", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        common = [vp, vp, vp, vp, i32, ctypes.POINTER(ctypes.c_longlong),
                  i32, i32, i32, i32, i32, i32, i32, i32, i32]
        lib.repro_flash_attention.argtypes = common + [ctypes.c_float, vp]
        lib.repro_flash_attention.restype = i32
        lib.repro_flash_decode.argtypes = common + [
            i32, i32, i32, ctypes.c_float, vp, vp, vp]
        lib.repro_flash_decode.restype = i32
        lib._repro_bound = True
    return lib


def plan(b: int, h: int, hkv: int, sq: int, skv: int, dtype, *,
         causal: bool = True, window: int = 0, q_offset: int = 0) -> dict:
    """The path a CUDA call takes and its launch geometry, from dtype and
    shape alone. ``path`` is "split_kv", "wgmma" or "f32_tile"; ``grid`` is
    the (x, y) grid of the first kernel. split_kv adds ``rows`` (packed
    query rows), ``kv_begin``/``kv_end`` (the visible keys), ``split``,
    ``n_splits`` (at least 1: an empty range gets one empty split) and
    ``merge_grid``; the tile paths add ``block_rows``."""
    rows = (h // hkv) * sq
    if rows <= MAX_PACKED_ROWS:
        lo, hi = ref.kv_visible_range(sq, skv, causal, window, q_offset)
        n = max(1, -(-(hi - lo) // SPLIT))
        return {"path": "split_kv", "rows": rows, "kv_begin": lo,
                "kv_end": hi, "split": SPLIT, "n_splits": n,
                "grid": (n, b * hkv), "merge_grid": (b * hkv, 1)}
    if dtype == torch.bfloat16:
        path, block = "wgmma", TILE_ROWS
    else:
        path, block = "f32_tile", 16 if sq <= 32 else 64
    return {"path": path, "block_rows": block,
            "grid": (-(-sq // block), b * h)}


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """q: (B, H, Sq, D); k/v: (B, Hkv, Skv, D). Returns (B, H, Sq, D) in
    q's dtype: online-softmax attention with query row t at position
    ``q_offset + t`` and kv row u at u, causal (u <= qpos) when
    ``causal``, and u > qpos - window when ``window`` > 0."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: 4-d q, k, v expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or hkv < 1 or h % hkv or sq < 1 or skv < 1):
        raise ValueError(f"flash_attention: q (B, H, Sq, D) and k/v "
                         f"(B, Hkv, Skv, D) with H % Hkv == 0 expected, "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention: q, k, v dtypes differ "
                        f"({q.dtype}, {k.dtype}, {v.dtype})")
    if window < 0 or q_offset < 0:
        raise ValueError(f"flash_attention: window {window} and q_offset "
                         f"{q_offset} must be >= 0")
    dev = check_device("flash_attention", q, k, v)
    if dev.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window, q_offset=q_offset)
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"flash_attention: CUDA kernel takes f32 or bf16, "
                        f"got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: CUDA kernel is built for head "
                         f"dims {HEAD_DIMS}, got {d}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim of q, k and v must "
                         "be contiguous (stride 1)")
    item = q.element_size()
    if any(t.data_ptr() % 16 or any(t.stride(i) * item % 16 for i in range(3))
           for t in (q, k, v)):
        raise ValueError("flash_attention: the kernel loads 16-byte "
                         "vectors; every row of q, k and v must start on a "
                         "16-byte boundary")
    if b * h > MAX_BATCH_HEADS:
        raise ValueError(f"flash_attention: at most {MAX_BATCH_HEADS} "
                         f"batch x heads, got {b * h}")
    p = plan(b, h, hkv, sq, skv, q.dtype, causal=causal, window=window,
             q_offset=q_offset)
    lib = _lib()
    out = torch.empty((b, sq, h, d), dtype=q.dtype,
                      device=dev).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *[t.stride(i) for t in (q, k, v, out) for i in range(3)])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPE_CODE[q.dtype], strides, b, h, hkv, sq, skv, d,
            int(causal), int(window), int(q_offset))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if p["path"] == "split_kv":
        n_ml = b * hkv * p["n_splits"] * p["rows"]
        scratch = torch.empty((n_ml * (d + 2),), dtype=torch.float32,
                              device=dev)
        rc = lib.repro_flash_decode(
            *args, p["kv_begin"], p["kv_end"], p["n_splits"],
            1.0 / math.sqrt(d), scratch.data_ptr(),
            scratch[n_ml * d:].data_ptr(), stream)
    else:
        rc = lib.repro_flash_attention(*args, 1.0 / math.sqrt(d), stream)
    raise_on_error("flash_attention", rc)
    LAUNCHES["flash_attention"] += 1
    PATH_CALLS[p["path"]] += 1
    return out
