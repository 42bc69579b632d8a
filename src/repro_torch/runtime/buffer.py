"""FedBuff-style cloud update buffer with staleness-decayed weights.

The port of ``repro.runtime.buffer``. The cloud no longer waits for every
edge: uploads accumulate in a bounded buffer and the global model
advances as soon as ``capacity`` (K) updates have arrived. Each buffered
update ``j`` carries the model version ``v_j`` it trained from; at flush
time its aggregation weight is

    w_j * s(tau_j),   tau_j = v_flush - v_j

with ``s`` a staleness-decay function (FedBuff). The decay folds into
the weight vector, so a flush is one ``segment_agg`` kernel launch with
one segment on the stacked ``(K, P)`` update matrix: the launch the
synchronous cloud aggregation (Eq. 2) makes. The numpy oracles are
``repro_torch.kernels.ref.staleness_aggregate_ref`` and
``coverage_aggregate_ref``.

Flush order is canonical (sorted by (edge, arrival)) so that with zero
decay and ``capacity == n_edges`` the flush is the synchronous cloud
aggregation bit for bit, whatever order the uploads arrived in.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class AsyncConfig:
    """Knobs of the asynchronous runtime."""
    buffer_k: int = 0            # flush after K buffered uploads
                                 # (0 -> n_edges, the full-participation
                                 # FedAvg-equivalent setting)
    decay: str = "poly"          # none | poly | exp   (s(tau) family)
    decay_a: float = 0.5         # poly: (1+tau)^-a ; exp: a^tau
    max_staleness: int = 0       # drop updates older than this (0 = keep)
    flush_deadline: float = 0.0  # graceful degradation: if K has not
                                 # been met this many simulated seconds
                                 # after the last flush, flush the
                                 # survivors with coverage-corrected
                                 # weights (0 = wait for K forever)


def staleness_scale(tau, decay: str = "poly", a: float = 0.5):
    """s(tau) >= 0 for integer staleness tau (vectorized, numpy f32).

    ``none``: s = 1 (pure FedAvg weighting -- the parity setting);
    ``poly``: s = (1 + tau)^-a  (FedBuff's polynomial decay);
    ``exp`` : s = a^tau         (exponential forgetting, 0 < a <= 1).
    """
    tau = np.asarray(tau, np.float32)
    if decay == "none":
        return np.ones_like(tau)
    if decay == "poly":
        return (1.0 + tau) ** (-a)
    if decay == "exp":
        if not 0.0 < a <= 1.0:
            raise ValueError(f"exp decay needs 0 < a <= 1, got {a}")
        return np.power(np.float32(a), tau)
    raise ValueError(f"unknown staleness decay {decay!r}")


@dataclasses.dataclass
class _Slot:
    edge: int
    vec: object          # (P,) flat update, or None (metadata only)
    weight: float        # |D_j| (edge dataset size)
    version: int         # global-model version the update trained from
    arrival: int         # monotone arrival index (flush-order tiebreak)
    meta: dict


class StalenessBuffer:
    """Bounded buffer of flat ``(P,)`` edge updates.

    ``push`` records an update with its base version; ``ready`` when
    ``capacity`` updates are held; ``flush(version)`` aggregates them
    with staleness-decayed weights into one ``(P,)`` f32 global update
    on ``device`` and empties the buffer.

    The flush runs through ``ctx.segment_agg_small`` (an
    ``hfl.AggContext``): under a sharded context every rank holds the
    same buffered vectors and computes the plain launch, bitwise the
    one-device flush for any K. ``telemetry`` (a
    ``repro_torch.telemetry.Telemetry``) and ``clock`` (the event queue,
    which supplies timestamps) are pure observers: the buffer reports
    each push and flush as residency spans, bitwise no-perturbation.
    ``device`` defaults to the card and raises without one.
    """

    def __init__(self, capacity: int, decay: str = "poly",
                 decay_a: float = 0.5, ctx=None, telemetry=None,
                 clock=None, *, device="cuda"):
        from repro_torch.core import hfl           # local: avoid cycle
        if capacity < 1:
            raise ValueError(f"buffer capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.decay = decay
        self.decay_a = float(decay_a)
        self.ctx = hfl._resolve_ctx(ctx, "StalenessBuffer")
        self.device = resolve_device(device)
        self._slots: list[_Slot] = []
        self._arrivals = 0
        self.telemetry = telemetry
        self.clock = clock

    @property
    def _now(self) -> float:
        return float(self.clock.now) if self.clock is not None else 0.0

    def __len__(self) -> int:
        return len(self._slots)

    @property
    def ready(self) -> bool:
        return len(self._slots) >= self.capacity

    def edges(self) -> list:
        return [s.edge for s in self._slots]

    def push(self, edge: int, vec, weight: float, version: int,
             **meta) -> None:
        self._slots.append(_Slot(edge=int(edge), vec=vec,
                                 weight=float(weight), version=int(version),
                                 arrival=self._arrivals, meta=meta))
        self._arrivals += 1
        if self.telemetry is not None:
            self.telemetry.buffer_push(int(edge), self._now, int(version),
                                       self._arrivals - 1,
                                       len(self._slots), self.capacity)

    def flush(self, version: int, max_staleness: int = 0, anchor=None,
              anchor_weight: float = 0.0):
        """Aggregate the buffered updates against global ``version``.

        Returns ``(global_vec (P,) f32, info)``; ``info`` carries the
        per-slot edges, staleness values and effective weights. Updates
        staler than ``max_staleness`` (when > 0) are dropped *before*
        aggregation; if every update is dropped, returns ``(None, info)``
        and the buffer still empties.

        **Degraded (coverage-corrected) flush**: pass the current global
        vector as ``anchor`` with the missing data mass as
        ``anchor_weight``; the anchor joins the stack as one extra
        zero-movement row, so the correction folds into the weight vector
        like the decay does:

            out = (sum_j w_j s(tau_j) u_j + m g) / (sum_j w_j s(tau_j) + m)

        -- still one ``segment_agg`` launch. Numpy oracle:
        ``ref.coverage_aggregate_ref``. With ``anchor=None`` the flush is
        the fault-free one.
        """
        slots = sorted(self._slots, key=lambda s: (s.edge, s.arrival))
        self._slots = []
        tau = np.array([version - s.version for s in slots], np.int64)
        if max_staleness > 0:
            keep = tau <= max_staleness
            dropped = [s.edge for s, k in zip(slots, keep) if not k]
            stale = [(s.arrival, s.edge, int(t))
                     for s, t, k in zip(slots, tau, keep) if not k]
            slots = [s for s, k in zip(slots, keep) if k]
            tau = tau[keep]
        else:
            dropped = []
            stale = []
        if self.telemetry is not None:
            self.telemetry.buffer_flushed(
                self._now,
                [(s.arrival, s.edge, int(t)) for s, t in zip(slots, tau)],
                stale)
        info = {"edges": [s.edge for s in slots],
                "staleness": tau.tolist(), "dropped": dropped,
                "meta": [s.meta for s in slots]}
        if not slots:
            return None, info
        scale = staleness_scale(tau, self.decay, self.decay_a)
        w = np.array([s.weight for s in slots], np.float32) * scale
        info["weights"] = w.tolist()
        degraded = anchor is not None and anchor_weight > 0.0
        if degraded:
            info["anchor_weight"] = float(anchor_weight)
            info["coverage"] = float(w.sum()
                                     / (w.sum() + float(anchor_weight)))
        if any(s.vec is None for s in slots):
            # metadata-only mode (the analytic env): weights/staleness
            # bookkeeping without a model update to aggregate
            return None, info
        vecs = [torch.as_tensor(s.vec, device=self.device) for s in slots]
        if degraded:
            vecs.append(torch.as_tensor(anchor, dtype=vecs[0].dtype,
                                        device=self.device))
            w = np.concatenate([w, np.float32([anchor_weight])])
        return _aggregate(torch.stack(vecs), torch.from_numpy(w),
                          self.ctx), info


def _aggregate(stack, w, ctx):
    """One-segment staleness-weighted mean of the (K, P) update stack:
    one ``segment_agg`` launch, the one Eq. 2 makes, replicated on every
    rank under a sharded ``ctx`` (``AggContext.segment_agg_small``)."""
    k = stack.shape[0]
    seg = torch.zeros((k,), dtype=torch.int32, device=stack.device)
    return ctx.segment_agg_small(stack, w.to(stack.device), seg, 1)[0]
