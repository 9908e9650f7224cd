"""broadcast backend — batch-shaped state tensors, one `update` per step.

Port of `repro.fleet.backends.broadcast`, the reference's default backend
and the engine-level oracle: the scheduler's update math takes arbitrary
leading batch dims, so one plain `update` call advances the whole fleet in
lockstep, with the step/ptr clocks shared across packages.  The
per-package planes (heterogeneous draws, the degraded fallback, operator
pins) ride in the state and broadcast through the same update.
"""
from __future__ import annotations

from repro_torch.fleet.backends.base import FleetBackend, register


@register
class BroadcastBackend(FleetBackend):
    name = "broadcast"
