"""Device and precision helpers shared by every entry point of the port.

Entry points take ``device="cuda"`` by default and resolve it here. A
request for CUDA on a host without a usable card raises; nothing falls
back to the CPU behind the caller's back. The CPU runs only when the
caller asks for it with ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` (str or ``torch.device``) -> ``torch.device``.

    Raises ``RuntimeError`` when a CUDA device is requested and
    ``torch.cuda.is_available()`` is false, and ``ValueError`` for a
    device type the port does not run on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is "
                f"available (torch {torch.__version__}); pass "
                f"device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: the port "
                         f"runs on 'cuda' or 'cpu'")
    return dev


def disable_tf32() -> None:
    """Keep f32 matmuls and convolutions in full f32 on the card.

    The JAX reference accumulates in f32. PyTorch's cuBLAS matmuls
    already default to full f32, but cuDNN convolutions default to TF32
    (``torch.backends.cudnn.allow_tf32`` is True), which keeps only
    about three decimal digits. The cloud round turns both flags off so
    its local SGD computes what the reference computes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
