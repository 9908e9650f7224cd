"""Fleet-scale batched scheduler engine (thousands of packages per step).

Port of `repro.fleet`: `engine` (backend-agnostic stepping, telemetry and
the Monte-Carlo survey) over `backends` (broadcast / fused / vmap, and
sharded / sharded_fused on a device mesh, in one process or across the
ranks of a process group) under `ingest` (the streaming serving loop with
bounded look-ahead ingest), `distributed_ingest` (that loop on each rank of
a process group, fed its own lane slab), `faults` (seeded fault injection
at the ingest and engine boundaries) and `groups` (mixed-plant fleets, one
sub-fleet per plant group), with the control plane on top: `registry`
(dynamic membership in power-of-two capacity pools), `alerts` (per-tenant
stats on the device + edge-latched alert sinks) and `service` (the
resident multi-tenant serving service with its HTTP operator API;
docs/torch_serving.md).
"""
from repro_torch.fleet.alerts import (AlertEngine, JsonlSink, LogSink,
                                      TenantWindowStats, WebhookSink,
                                      tenant_window_stats)
from repro_torch.fleet.backends import (available_backends, get_backend,
                                        register)
from repro_torch.fleet.distributed_ingest import (LaneSpan,
                                                  distributed_stream,
                                                  local_chunk_source,
                                                  local_lanes)
from repro_torch.fleet.engine import FleetEngine, FleetSurvey, FleetTelemetry
from repro_torch.fleet.faults import (FaultPlan, HintOutage, HostStall,
                                      SensorFault)
from repro_torch.fleet.groups import GroupedFleetEngine
from repro_torch.fleet.ingest import (HintQueue, StreamStats, chunk_source,
                                      merge_sources, stream)
from repro_torch.fleet.registry import (CapacityPlan, FleetRegistry,
                                        LaneProfile, Tenant)
from repro_torch.fleet.service import FleetService, serve_http

__all__ = ["FleetEngine", "GroupedFleetEngine", "FleetSurvey",
           "FleetTelemetry",
           "available_backends", "get_backend", "register", "HintQueue",
           "StreamStats", "chunk_source", "merge_sources", "stream",
           "FleetRegistry", "Tenant", "CapacityPlan", "LaneProfile",
           "AlertEngine",
           "TenantWindowStats", "tenant_window_stats", "LogSink",
           "JsonlSink", "WebhookSink", "FleetService", "serve_http",
           "FaultPlan", "HintOutage", "SensorFault", "HostStall",
           "LaneSpan", "local_lanes", "local_chunk_source",
           "distributed_stream"]
