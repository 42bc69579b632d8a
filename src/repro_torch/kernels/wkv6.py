"""RWKV6 WKV recurrence (CUDA kernel); the port of ``repro.kernels.wkv6``.

``wkv6(r, k, v, w, u, *, chunk)`` runs one launch of the hand-written
kernel ``csrc/wkv6.cu`` for CUDA tensors and the plain version
``ref.wkv6_ref`` for CPU tensors; a CUDA tensor never falls back. It
starts from a zero state, as the Pallas kernel does. r/k/v: (B, S, nh,
64) f32 or bf16 (one dtype), w: the same shape in f32, the decay in
(0, 1); u: (nh, 64) bonus. Returns y (B, S, nh, 64) f32 and the final
state (B, nh, 64, 64) f32.

The function does not depend on ``chunk``: it is the chunk length (32 or
64) of the plain version and the reference, which compute the
recurrence chunk by chunk in log space. The kernel computes it in steps
of 16 tokens with running products of the decay, one block per
(batch, head) (``ref.wkv6_step_ref`` states that algorithm); the card
tests hold it to the same tolerances at both chunk lengths. S need not
be a multiple of anything: the kernel masks the ragged tail itself
(r = k = v = 0, w = 1). r, k, v and w must start at 16-byte aligned
addresses (the kernel copies whole 16-byte pieces).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._common import (
    DTYPE_CODE,
    LAUNCHES,
    check_device,
    raise_on_error,
)

HEAD_SIZE = 64                 # the head size the kernel is built for
CHUNKS = (32, 64)              # the chunk lengths callers may name


def _lib() -> ctypes.CDLL:
    lib = _build.load("wkv6")
    if not getattr(lib, "_repro_bound", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_wkv6.argtypes = [vp, vp, vp, vp, vp, vp, vp, i32, i32, i32,
                                   i32, i32, vp]
        lib.repro_wkv6.restype = i32
        lib._repro_bound = True
    return lib


def wkv6(r, k, v, w, u, *, chunk=64):
    """r/k/v/w: (B, S, nh, hd); u: (nh, hd). Returns (y (B, S, nh, hd)
    f32, final state (B, nh, hd, hd) f32), from a zero state."""
    if r.dim() != 4 or not r.shape == k.shape == v.shape == w.shape:
        raise ValueError(f"wkv6: r, k, v, w must share one (B, S, nh, hd) "
                         f"shape, got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}")
    b, s, nh, hd = r.shape
    if u.shape != (nh, hd) or s < 1:
        raise ValueError(f"wkv6: u must be ({nh}, {hd}) and S >= 1, got "
                         f"{tuple(u.shape)}, S = {s}")
    if w.dtype != torch.float32:
        raise TypeError(f"wkv6: the decay w must be f32, got {w.dtype}")
    dev = check_device("wkv6", r, k, v, w, u)
    if dev.type == "cpu":
        return ref.wkv6_ref(r, k, v, w, u, chunk=chunk)
    if not r.dtype == k.dtype == v.dtype or r.dtype not in DTYPE_CODE:
        raise TypeError(f"wkv6: CUDA kernel takes r, k, v in one of f32 or "
                        f"bf16, got {r.dtype}, {k.dtype}, {v.dtype}")
    if hd != HEAD_SIZE or chunk not in CHUNKS:
        raise ValueError(f"wkv6: CUDA kernel is built for head size "
                         f"{HEAD_SIZE} and chunks {CHUNKS}, got {hd} and "
                         f"{chunk}")
    if not all(t.is_contiguous() for t in (r, k, v, w)):
        raise ValueError("wkv6: r, k, v and w must be contiguous")
    if any(t.data_ptr() % 16 for t in (r, k, v, w)):
        raise ValueError("wkv6: r, k, v and w must start at 16-byte "
                         "aligned addresses")
    lib = _lib()
    u32 = u.to(torch.float32).contiguous()
    y = torch.empty((b, s, nh, hd), dtype=torch.float32, device=dev)
    state = torch.empty((b, nh, hd, hd), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.repro_wkv6(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                        w.data_ptr(), u32.data_ptr(), y.data_ptr(),
                        state.data_ptr(), DTYPE_CODE[r.dtype], b, s, nh, hd,
                        stream)
    raise_on_error("wkv6", rc)
    LAUNCHES["wkv6"] += 1
    return y, state
