"""Event-driven asynchronous HFL runtime; the port of ``repro.runtime``.

Replaces the lockstep cloud barrier (``t_use = t_edge.max()`` in
``repro_torch.sim.env.HFLEnv``) with edges that report on their own
clocks:

* ``repro_torch.runtime.clock`` -- deterministic event-queue simulator;
  per-edge upload events are scheduled from the ``repro_torch.sim.
  hardware`` time/energy models, so edges keep training while others
  sync (numpy; a copy of the reference's);
* ``repro_torch.runtime.buffer`` -- FedBuff-style cloud update buffer
  with staleness-decayed weights ``w_j * s(tau_j)``; the decay folds
  into the weight vector of one ``segment_agg`` kernel launch;
* ``repro_torch.runtime.faults`` -- deterministic fault injection: a
  seeded ``FaultSpec`` (per-edge dropout, transient upload failures,
  edge-outage windows, join/leave churn) whose events enter the same
  queue; a null spec changes nothing (numpy; a copy of the reference's).

``repro_torch.sim.env.AsyncHFLEnv`` drives them from the DRL loop (one
env step = one edge upload event); the schemes ``async-fedavg`` and
``async-arena`` of ``repro_torch.core.sync`` run on it.
"""
from repro_torch.runtime.clock import (  # noqa: F401
    Event, EventQueue, RoundCost, edge_round_cost)
from repro_torch.runtime.buffer import (  # noqa: F401
    AsyncConfig, StalenessBuffer, staleness_scale)
from repro_torch.runtime.faults import (  # noqa: F401
    ChurnEvent, FaultInjector, FaultSpec, Outage)
