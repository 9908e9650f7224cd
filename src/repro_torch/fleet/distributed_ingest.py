"""Per-rank streaming ingest for fleets across processes.

Port of `repro.fleet.distributed_ingest`.  One process's host→device
bandwidth and one Python feeder cap `repro_torch.fleet.ingest`; this is the
scale-out: each rank of a process group (`repro_torch.distributed.
multihost.initialize`) runs the SAME streaming loop, but its `HintQueue`
carries only the [K, n_local, tiles] slab of lanes its own devices own.
The pieces compose; nothing inside `stream()` changes:

    per-rank source ──put_trace──▶ HintQueue ──run_block──▶ telemetry
    [K, n_local, t]   (local slab   (per rank)  (each rank    (one collective
                       → its own                 its own       a flush; 1 host
                       partitions)               partitions)   sync a flush
                                                               PER rank)

  * `ShardedBackend.put_trace` recognises a local-span chunk and uploads it
    onto this rank's partitions — the upload is host→local device only,
    exactly as in one process.
  * Each flush window is stepped by every rank on its own partitions (one
    `fleet_step` launch a partition on ``sharded_fused``), then ONE
    collective assembles the window's traces and every rank reduces them
    the same way (`FleetEngine`) — so each rank's one host fetch a flush
    returns the same record.
  * Every rank must take the same number of chunks with the same K per
    round — each flush makes a collective, so a rank that stops early
    leaves the others waiting until the group's timeout.
    `local_chunk_source` derives every rank's slab from one global trace
    and cannot get out of step; a per-rank source must guarantee this
    itself (the contract on `distributed_stream`).

`multihost.run_process_group` drives N fresh interpreters and a local
coordinator — the harness behind tests/test_torch_multihost.py and
`chip_smoke.py`'s Phase N.  A deployment starts one `repro_torch.launch.
serve --distributed --stream` per rank instead.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Iterator

import numpy as np

from repro_torch.core.scheduler import SchedulerState
from repro_torch.distributed import multihost
from repro_torch.fleet.engine import FleetEngine
from repro_torch.fleet.ingest import StreamStats, stream

__all__ = ["LaneSpan", "local_lanes", "local_chunk_source",
           "distributed_stream"]


@dataclasses.dataclass(frozen=True)
class LaneSpan:
    """This process's contiguous [lo, hi) span of the global package axis."""

    lo: int
    hi: int

    @property
    def n(self) -> int:
        return self.hi - self.lo


def local_lanes(engine: FleetEngine) -> LaneSpan:
    """The lane span this process's devices own under the engine's mesh.

    Needs an INITIALISED device-mesh backend (sharded/sharded_fused after
    `engine.init(n)`, which resolves the mesh and the global fleet size);
    a one-process mesh owns the whole span, so code written against this
    helper runs unchanged in one process.
    """
    be = engine.backend_impl
    mesh, n_global = getattr(be, "mesh", None), getattr(be, "n_global", None)
    if mesh is None or n_global is None:
        raise ValueError(
            f"distributed streaming needs an initialised sharded/"
            f"sharded_fused backend (got {be.name!r}, "
            f"n_global={n_global}) — call engine.init(n) first")
    lo, hi = multihost.local_lane_range(n_global, mesh)
    return LaneSpan(lo, hi)


def local_chunk_source(source: Iterable[np.ndarray], lanes: LaneSpan
                       ) -> Iterator[np.ndarray]:
    """Cut a GLOBAL [K, n_global, tiles] chunk stream down to this
    process's [K, n_local, tiles] slabs — the bridge from one logical trace
    (`ingest.chunk_source` over a replayed recording, or a seeded synthetic
    workload every rank can make) to per-rank ingest.  At fleet scale each
    rank's feeder makes only its own slab to begin with."""
    for chunk in source:
        yield np.asarray(chunk)[:, lanes.lo:lanes.hi, :]


def distributed_stream(engine: FleetEngine, state: SchedulerState,
                       source: Iterable[np.ndarray], *,
                       global_chunks: bool = False,
                       lookahead_chunks: int = 2,
                       on_flush: Callable[[int, dict], None] | None = None,
                       keep_telemetry: bool = True,
                       active: np.ndarray | None = None,
                       ) -> tuple[SchedulerState, list[dict], StreamStats]:
    """`ingest.stream` for one rank of a fleet across processes.

    ``source`` yields THIS rank's [K, n_local, tiles] slabs (or global
    [K, n_global, tiles] chunks with ``global_chunks=True``, cut here by
    `local_chunk_source`).  Returns (state, flush records, stats): the
    records are the same on every rank, and ``stats.host_syncs`` counts
    THIS rank's syncs, one a flush.

    Contract: every rank streams the same flush sequence (the same number
    of chunks, the same K each round) — each flush makes a collective, so
    a rank out of step leaves the others waiting until the group's
    timeout.  The ``active`` mask, like all control-plane state, is the
    GLOBAL [n_packages] mask, the same on every rank.
    """
    be = engine.backend_impl
    if not hasattr(be, "mesh"):
        raise ValueError(f"distributed_stream needs a device-mesh backend "
                         f"(sharded/sharded_fused), got {be.name!r}")
    if global_chunks:
        source = local_chunk_source(source, local_lanes(engine))
    return stream(engine, state, source, lookahead_chunks=lookahead_chunks,
                  on_flush=on_flush, keep_telemetry=keep_telemetry,
                  active=active)
