"""Public kernel entry points, under the names ``repro.kernels.ops`` uses.

``segment_agg``, ``segment_sum_partial``, ``segment_broadcast`` and
``hier_agg`` are the flat-bank hot path (``core/hfl.py``);
``flash_attention`` (every attention of the dense LLMs) and ``wkv6``
(every multi-token RWKV6 time-mix) serve the LLM path (``models/``,
``launch/serve.py``). Each runs its CUDA kernel for CUDA tensors and its
plain version (``kernels/ref.py``) for CPU tensors; ``LAUNCHES`` counts
the kernel launches.
"""
from __future__ import annotations

from repro_torch.kernels._common import LAUNCHES, reset_launches  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.hier_agg import (  # noqa: F401
    hier_agg,
    segment_agg,
    segment_broadcast,
    segment_sum_partial,
)
from repro_torch.kernels.wkv6 import wkv6  # noqa: F401
