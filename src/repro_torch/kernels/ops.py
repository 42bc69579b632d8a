"""Public kernel entry points, under the names ``repro.kernels.ops`` uses.

``segment_agg``, ``segment_sum_partial``, ``segment_agg_sharded`` and
``segment_agg_ordered`` (the row-sharded bank over a
``torch.distributed`` group),
``segment_broadcast`` and ``hier_agg`` are the flat-bank hot path
(``core/hfl.py``);
``flash_attention`` (every attention of the dense LLMs) and ``wkv6``
(every multi-token RWKV6 time-mix) serve the LLM path (``models/``,
``launch/serve.py``). Each runs its CUDA kernel for CUDA tensors and its
plain version (``kernels/ref.py``) for CPU tensors; ``LAUNCHES`` counts
the kernel launches.

``segment_agg``, ``segment_agg_sharded``, ``segment_agg_ordered`` and
``segment_broadcast`` go through
``repro_torch.telemetry.ktime.call_timed``, as the reference's do: with
no registry installed that is one ``None`` check in front of the
unchanged call; inside ``ktime.kernel_timing(reg)`` each call is timed
into ``reg``.
"""
from __future__ import annotations

from repro_torch.kernels import hier_agg as _ha
from repro_torch.kernels._common import LAUNCHES, reset_launches  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.hier_agg import (  # noqa: F401
    hier_agg,
    segment_sum_partial,
)
from repro_torch.kernels.wkv6 import wkv6  # noqa: F401
from repro_torch.telemetry import ktime as _ktime


def segment_agg(bank, weights, segment_ids, num_segments: int):
    """(N, P) x (N,) weights x (N,) segment ids -> (E, P) f32 means
    (``hier_agg.segment_agg``), timed by ``ktime`` when it is on."""
    return _ktime.call_timed("segment_agg", _ha.segment_agg, bank, weights,
                             segment_ids, num_segments)


def segment_agg_sharded(bank, weights, segment_ids, num_segments: int,
                        group=None):
    """This rank's (N/k, P) rows -> the (E, P) f32 means over every rank
    of ``group`` (``hier_agg.segment_agg_sharded``), timed by ``ktime``
    as ``segment_agg`` when it is on."""
    return _ktime.call_timed("segment_agg", _ha.segment_agg_sharded, bank,
                             weights, segment_ids, num_segments, group)


def segment_agg_ordered(bank, weights, segment_ids, num_segments: int,
                        group=None):
    """``segment_agg_sharded`` with the single launch's bits for any row
    layout (``hier_agg.segment_agg_ordered``), timed by ``ktime`` as
    ``segment_agg`` when it is on."""
    return _ktime.call_timed("segment_agg", _ha.segment_agg_ordered, bank,
                             weights, segment_ids, num_segments, group)


def segment_broadcast(models, segment_ids, *, out_dtype=None, out=None):
    """(E, P) x (N,) segment ids -> (N, P) bank resync
    (``hier_agg.segment_broadcast``), timed by ``ktime`` when it is on."""
    return _ktime.call_timed("segment_broadcast", _ha.segment_broadcast,
                             models, segment_ids, out_dtype=out_dtype,
                             out=out)
