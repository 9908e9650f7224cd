"""Fleet-scale batched scheduler engine (thousands of packages per step).

Port of `repro.fleet` for this slice: `engine` (backend-agnostic stepping +
telemetry) over `backends` (broadcast / fused) under `ingest` (the
streaming serving loop with bounded look-ahead ingest).  The control plane
(`registry`, `alerts`, `service`), `faults`, `groups` and the multi-host
ingest are not ported yet (ROADMAP queue 1).
"""
from repro_torch.fleet.backends import (available_backends, get_backend,
                                        register)
from repro_torch.fleet.engine import FleetEngine, FleetTelemetry
from repro_torch.fleet.ingest import (HintQueue, StreamStats, chunk_source,
                                      merge_sources, stream)

__all__ = ["FleetEngine", "FleetTelemetry", "available_backends",
           "get_backend", "register", "HintQueue", "StreamStats",
           "chunk_source", "merge_sources", "stream"]
