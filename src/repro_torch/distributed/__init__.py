"""Distributed pieces of the port: the fleet's device mesh (`sharding`, in
one process or over a `ProcessMesh`), the model's specs on a (pod, data,
model) mesh (`sharding`'s model half: `param_specs`, `batch_spec`,
`cache_specs`, `state_specs`, `dp_axes`), process groups and the global
mesh across them (`multihost`: `initialize`, per-rank lane spans, the
flush's one collective, `run_process_group`) and the fault-tolerance
runtime (`fault_tolerance`, with `reshard_state`).
"""
from repro_torch.distributed.fault_tolerance import (Heartbeat,
                                                     PreemptionGuard,
                                                     reshard_state)
from repro_torch.distributed.multihost import (ProcessTopology, initialize,
                                               local_lane_range,
                                               run_process_group, topology)
from repro_torch.distributed.sharding import (FLEET_AXIS, ProcessMesh,
                                              Sharded, batch_spec,
                                              cache_specs, dp_axes,
                                              fleet_mesh, fleet_shard_map,
                                              fleet_trace_spec, gather,
                                              param_specs, place,
                                              state_specs)

__all__ = ["Heartbeat", "PreemptionGuard", "reshard_state", "FLEET_AXIS",
           "ProcessMesh", "Sharded", "fleet_mesh", "fleet_shard_map",
           "fleet_trace_spec", "gather", "place", "ProcessTopology",
           "initialize", "local_lane_range", "run_process_group",
           "topology", "param_specs", "batch_spec", "cache_specs",
           "state_specs", "dp_axes"]
