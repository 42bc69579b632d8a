"""What every kernel wrapper of the port shares: the launch counts, the
dtype codes of the C interfaces, the device check and the error check.

``LAUNCHES`` holds one count per CUDA kernel. A wrapper adds one to its
kernel's count where it launches the kernel and nowhere else, so a run
that resets the counts, drives a path and reads them shows which kernels
the path went through. CPU calls (the plain versions) count nothing.
"""
from __future__ import annotations

import torch

# kernel launches since the last reset, per kernel
LAUNCHES = {"segment_agg": 0, "segment_broadcast": 0, "flash_attention": 0,
            "wkv6": 0}

# dtype codes of the launchers' C interfaces
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_device(name: str, *tensors) -> torch.device:
    """The one device of ``tensors``; raises if they differ or lie on a
    device other than the CPU or a CUDA card, and raises
    ``RuntimeError`` when grad mode is on and one of them requires a
    gradient: no kernel has a backward, and its output would carry no
    ``grad_fn``, so a training forward that reached it would silently
    train nothing through it. The check runs on the CPU too, where the
    plain versions would differentiate, so both devices behave alike.
    Training takes the plain tensor math (``models.attention.
    chunked_attention``, ``models.rwkv.wkv_scan``/``wkv_chunked``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward; call it "
                           f"under torch.no_grad() or on tensors that do "
                           f"not require grad")
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices "
                             f"({dev} and {t.device})")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}; the kernel "
                         f"runs on 'cuda' and its plain version on 'cpu'")
    return dev


def raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {rc}")
