"""Fleet-scale batched scheduler engine (thousands of packages per step).

Port of `repro.fleet`: `engine` (backend-agnostic stepping, telemetry and
the Monte-Carlo survey) over `backends` (broadcast / fused) under `ingest`
(the streaming serving loop with bounded look-ahead ingest) and `faults`
(seeded fault injection at the ingest and engine boundaries).  The
control plane (`registry`, `alerts`, `service`), `groups` and the
multi-host ingest are not ported yet (ROADMAP queue 1).
"""
from repro_torch.fleet.backends import (available_backends, get_backend,
                                        register)
from repro_torch.fleet.engine import FleetEngine, FleetSurvey, FleetTelemetry
from repro_torch.fleet.faults import (FaultPlan, HintOutage, HostStall,
                                      SensorFault)
from repro_torch.fleet.ingest import (HintQueue, StreamStats, chunk_source,
                                      merge_sources, stream)

__all__ = ["FleetEngine", "FleetSurvey", "FleetTelemetry",
           "available_backends", "get_backend", "register", "HintQueue",
           "StreamStats", "chunk_source", "merge_sources", "stream",
           "FaultPlan", "HintOutage", "SensorFault", "HostStall"]
