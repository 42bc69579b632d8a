"""Device and precision helpers shared by every entry point of the port.

Entry points take ``device="cuda"`` by default and resolve it here. A
request for CUDA on a host without a usable card raises; nothing falls
back to the CPU behind the caller's back. The CPU runs only when the
caller asks for it with ``device="cpu"``.

``deterministic_algorithms`` is the opt-in deterministic mode the round
factories enter around each round when built with
``deterministic=True`` (``EnvConfig.deterministic``).
"""
from __future__ import annotations

import contextlib
import os

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


# cuBLAS's deterministic workspace setting; PyTorch checks for it when a
# cuBLAS call runs under torch.use_deterministic_algorithms(True)
CUBLAS_WORKSPACE = ":4096:8"


def set_cublas_workspace() -> None:
    """Set ``CUBLAS_WORKSPACE_CONFIG`` if it is unset. cuBLAS reads it
    when the process makes its first cuBLAS call, so the round factories
    call this when they are built with ``deterministic=True``."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)


@contextlib.contextmanager
def deterministic_algorithms():
    """Run the body with PyTorch's deterministic algorithms: the same
    inputs give the same bits on every run.

    Sets ``CUBLAS_WORKSPACE_CONFIG`` if unset, calls
    ``torch.use_deterministic_algorithms(True)`` (an op with no
    deterministic implementation then raises) and turns cuDNN's
    deterministic flag on and its benchmark off; the previous settings
    come back on exit, so code outside the body is unaffected."""
    set_cublas_workspace()
    cudnn = torch.backends.cudnn
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            cudnn.deterministic, cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        cudnn.deterministic, cudnn.benchmark = prev[2], prev[3]
