"""Opt-in timing of the aggregation kernel launches; the port of
``repro.telemetry.ktime``.

``repro_torch.kernels.ops`` routes its public ``segment_agg`` /
``segment_broadcast`` entry points through :func:`call_timed`. With no
registry installed (the default) that is one module-global ``None``
check in front of the unchanged call. Inside :func:`kernel_timing` each
call lands in the active
:class:`repro_torch.telemetry.metrics.MetricsRegistry` as a
``kernel/<name>_us`` observation and one ``kernel/<name>_calls`` count,
the reference's names:

* CUDA tensors: a ``torch.cuda.Event`` pair is recorded on the current
  stream around the call and the end event is synchronised; the reading
  is the device time between the two events -- the kernel's launch
  plus whatever else the wrapper enqueued between them (an output's
  allocation enqueues nothing). A failed launch raises through, untimed.
* CPU tensors (the plain versions): the host clock around the call, as
  the reference times its dispatches.

Bitwise contract: timing only adds events and a synchronise around the
unchanged call -- values are untouched. Calls made while the current
stream captures a CUDA graph (``torch.cuda.is_current_stream_capturing``)
are dispatched untimed: an event pair inside a capture records nothing
until replay, and the synchronise would break the capture. This is the
counterpart of the reference skipping launches traced inside a jit.
"""
from __future__ import annotations

import contextlib
import time

import torch

_REGISTRY = None       # the active MetricsRegistry, or None (disabled)


def active_registry():
    return _REGISTRY


def enable(registry) -> None:
    """Install ``registry`` as the sink for kernel launch timings."""
    global _REGISTRY
    _REGISTRY = registry


def disable() -> None:
    global _REGISTRY
    _REGISTRY = None


@contextlib.contextmanager
def kernel_timing(registry):
    """``with kernel_timing(reg): ...`` -- time every kernel call made in
    the block into ``reg`` (restores the previous sink, so contexts
    nest)."""
    global _REGISTRY
    prev = _REGISTRY
    _REGISTRY = registry
    try:
        yield registry
    finally:
        _REGISTRY = prev


def _first_tensor(args, kwargs):
    for v in (*args, *kwargs.values()):
        if torch.is_tensor(v):
            return v
    return None


def call_timed(name: str, fn, *args, **kwargs):
    """Dispatch ``fn(*args, **kwargs)``; when a registry is active, time
    the call (device time between CUDA events for CUDA tensors, host
    time for CPU ones) and record it as ``kernel/<name>_us``. The first
    tensor argument decides the device."""
    reg = _REGISTRY
    if reg is None:
        return fn(*args, **kwargs)
    t = _first_tensor(args, kwargs)
    if t is not None and t.is_cuda:
        if torch.cuda.is_current_stream_capturing():
            return fn(*args, **kwargs)
        stream = torch.cuda.current_stream(t.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out = fn(*args, **kwargs)
        end.record(stream)
        end.synchronize()
        us = start.elapsed_time(end) * 1e3
    else:
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        us = (time.perf_counter() - t0) * 1e6
    reg.observe(f"kernel/{name}_us", us)
    reg.inc(f"kernel/{name}_calls")
    return out
