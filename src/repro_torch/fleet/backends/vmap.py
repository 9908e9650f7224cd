"""vmap backend — every lane its own scheduler, clocks included.

Port of `repro.fleet.backends.vmap`, the reference's per-package layout:
every state leaf carries the package axis, the ``step`` counter and the
filtration ``ptr`` too, so each lane advances its own clocks.  This is the
layout closest to "N independent schedulers", and under the control
plane's dynamic membership the most literal one: a lane scattered in
mid-flight restarts ITS OWN step / ptr at zero (under broadcast it joins
the fleet clock), so a mid-flight attach equals "a new scheduler born now".

The reference maps `ThermalScheduler.update` over the lanes with
``jax.vmap``.  The port's `update` takes the per-lane paths itself when the
clocks are [n] device tensors: the ring written and read at each lane's own
slot, the wraparound refresh computed for every lane and selected where
that lane wrapped, the sensor's poll flag per lane
(`core.pdu_gate.observe`, `core.scheduler._polled`).  It has no fused
window: the engine steps it one `update` at a time.
"""
from __future__ import annotations

import torch

from repro_torch.core.scheduler import SchedulerState
from repro_torch.fleet.backends.base import FleetBackend, register


@register
class VmapBackend(FleetBackend):
    name = "vmap"

    def init(self, n_packages: int, pkg=None,
             filtration_fill=None) -> SchedulerState:
        # the broadcast layout (per-package draws / fills land on their
        # packages), then the shared clocks as per-lane device counters
        st = self.sched.init(batch_shape=(n_packages,), pkg=pkg,
                             filtration_fill=filtration_fill)
        lane = lambda x: torch.full((n_packages,), int(x), dtype=torch.int32,
                                    device=self.device)
        return st._replace(
            step=lane(st.step),
            filtration=st.filtration._replace(ptr=lane(st.filtration.ptr)))
