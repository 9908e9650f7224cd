"""Distributed pieces of the port: the fleet's device mesh in one process
(`sharding`) and the fault-tolerance runtime (`fault_tolerance`, with
`reshard_state`).

The reference's `repro.distributed.multihost` (process groups, per-host
lane spans) waits for ROADMAP queue 1 step 9b, and `sharding`'s model half
(parameter, batch and cache specs) for step 9c.
"""
from repro_torch.distributed.fault_tolerance import (Heartbeat,
                                                     PreemptionGuard,
                                                     reshard_state)
from repro_torch.distributed.sharding import (FLEET_AXIS, Sharded,
                                              fleet_mesh, fleet_shard_map,
                                              fleet_trace_spec, gather, place)

__all__ = ["Heartbeat", "PreemptionGuard", "reshard_state", "FLEET_AXIS",
           "Sharded", "fleet_mesh", "fleet_shard_map", "fleet_trace_spec",
           "gather", "place"]
