"""Public kernel entry points, under the names ``repro.kernels.ops`` uses.

``segment_agg``, ``segment_sum_partial``, ``segment_broadcast`` and
``hier_agg`` are the flat-bank hot path (``core/hfl.py``). They run the
CUDA kernels of ``hier_agg`` for CUDA tensors and the plain versions for
CPU tensors. ``flash_attention`` and ``wkv6`` serve only the LLM path,
which is not ported yet.
"""
from __future__ import annotations

from repro_torch.kernels.hier_agg import (  # noqa: F401
    LAUNCHES,
    hier_agg,
    reset_launches,
    segment_agg,
    segment_broadcast,
    segment_sum_partial,
)


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    raise NotImplementedError(
        "flash_attention is not ported yet: see ROADMAP.md, 'TPU kernels "
        "still to port', kernels/flash_attention.py::_flash_kernel")


def wkv6(r, k, v, w, u, *, chunk=64):
    raise NotImplementedError(
        "wkv6 is not ported yet: see ROADMAP.md, 'TPU kernels still to "
        "port', kernels/wkv6.py::_wkv_kernel")
