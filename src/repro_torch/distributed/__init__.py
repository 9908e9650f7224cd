"""Distributed pieces of the port: the fleet's device mesh (`sharding`, in
one process or over a `ProcessMesh`), process groups and the global mesh
across them (`multihost`: `initialize`, per-rank lane spans, the flush's
one collective, `run_process_group`) and the fault-tolerance runtime
(`fault_tolerance`, with `reshard_state`).

`sharding`'s model half (parameter, batch and cache specs) waits for
ROADMAP queue 1 step 9c.
"""
from repro_torch.distributed.fault_tolerance import (Heartbeat,
                                                     PreemptionGuard,
                                                     reshard_state)
from repro_torch.distributed.multihost import (ProcessTopology, initialize,
                                               local_lane_range,
                                               run_process_group, topology)
from repro_torch.distributed.sharding import (FLEET_AXIS, ProcessMesh,
                                              Sharded, fleet_mesh,
                                              fleet_shard_map,
                                              fleet_trace_spec, gather, place)

__all__ = ["Heartbeat", "PreemptionGuard", "reshard_state", "FLEET_AXIS",
           "ProcessMesh", "Sharded", "fleet_mesh", "fleet_shard_map",
           "fleet_trace_spec", "gather", "place", "ProcessTopology",
           "initialize", "local_lane_range", "run_process_group",
           "topology"]
