"""GQA flash attention (CUDA kernel); the port of
``repro.kernels.flash_attention``.

``flash_attention(q, k, v, *, causal, window, q_offset)`` runs one
launch of the hand-written kernel ``csrc/flash_attention.cu`` for CUDA
tensors and the plain version ``ref.flash_attention_ref`` for CPU
tensors; a CUDA tensor never falls back. q: (B, H, Sq, D); k/v:
(B, Hkv, Skv, D), H % Hkv == 0, D in (64, 128), f32 or bf16; the output
is (B, H, Sq, D) in q's dtype. Rows must start on 16-byte boundaries
(the model's tensors do).

Unlike the Pallas kernel, Sq and Skv need not be multiples of a tile
(the kernel masks the ragged edge), and q, k and v may be strided views
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

HEAD_DIMS = (64, 128)          # the head sizes the kernel is built for
MAX_BATCH_HEADS = 65535        # gridDim.y


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not getattr(lib, "_repro_bound", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_flash_attention.argtypes = [
            vp, vp, vp, vp, i32, ctypes.POINTER(ctypes.c_longlong), i32, i32,
            i32, i32, i32, i32, i32, i32, i32, ctypes.c_float, vp]
        lib.repro_flash_attention.restype = i32
        lib._repro_bound = True
    return lib


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
    lib = _lib()
    out = torch.empty((b, sq, h, d), dtype=q.dtype,
                      device=dev).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *[t.stride(i) for t in (q, k, v, out) for i in range(3)])
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPE_CODE[q.dtype], strides, b, h, hkv, sq, skv, d, int(causal),
        int(window), int(q_offset), 1.0 / math.sqrt(d), stream)
    raise_on_error("flash_attention", rc)
    LAUNCHES["flash_attention"] += 1
    return out
