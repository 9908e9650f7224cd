"""Streaming fleet serving: async host→device ingest + flush-rate telemetry.

Port of `repro.fleet.ingest`.  The firmware's 20–50 ms look-ahead window
(§4.2) is, at fleet scale, a bounded queue of device-resident density
chunks — the `HintQueue` — kept full by the ingest loop while the engine
consumes from the head:

    host density source ──put_trace──▶ HintQueue ──run_block──▶ telemetry
         (numpy chunks)   (pinned, async)  (look-ahead)  (K steps)   (1 sync
                                                                      per flush)

On CUDA `put_trace` stages each chunk in pinned host memory and copies it
with ``non_blocking=True``; kernel launches are asynchronous too, so
`stream()` queues the upload of chunk i+1 behind the compute of chunk i
before it blocks on chunk i's telemetry — exactly ONE host sync per flush
(`StreamStats.host_syncs` counts them).

Ingest contract:

  * `chunk_source` never pads: a non-divisible tail is its own SHORTER chunk.
  * `HintQueue.offer` refuses past capacity (returns False) — back-pressure
    is the source's problem, never a silent drop.
  * `stream(..., active=...)` threads an [n_packages] bool lane mask to
    every flush.
  * `merge_sources` assembles full-capacity chunks from per-lane sources,
    padding free lanes at a constant idle density.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Iterable, Iterator

import numpy as np

from repro_torch.core.scheduler import SchedulerState
from repro_torch.fleet.engine import FleetEngine


@dataclasses.dataclass
class StreamStats:
    """Counters for one `stream()` run (the sync contract lives here)."""

    steps: int = 0            # scheduler steps executed
    flushes: int = 0          # telemetry flush intervals completed
    host_syncs: int = 0       # device→host telemetry fetches (== flushes)
    chunks_ingested: int = 0  # host→device uploads issued
    queue_peak: int = 0       # HintQueue high-water mark (chunks)

    @property
    def syncs_per_flush(self) -> float:
        return self.host_syncs / max(self.flushes, 1)


class HintQueue:
    """Bounded look-ahead window of device-resident density chunks.

    ``capacity`` chunks × K steps/chunk × step_ms models the paper's 20–50 ms
    hint horizon; `offer` refuses beyond capacity, `take` pops the oldest.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("HintQueue capacity must be >= 1")
        self.capacity = capacity
        self._q: deque = deque()
        self._steps: deque = deque()   # per-chunk step counts (None when a
        #                                chunk carries no leading step axis)

    def __len__(self) -> int:
        return len(self._q)

    @property
    def full(self) -> bool:
        return len(self._q) >= self.capacity

    def offer(self, chunk: Any) -> bool:
        if self.full:
            return False
        self._q.append(chunk)
        shape = getattr(chunk, "shape", None)
        self._steps.append(int(shape[0]) if shape else None)
        return True

    def take(self) -> Any:
        self._steps.popleft()
        return self._q.popleft()

    def lookahead_ms(self, flush_every: int, step_ms: float) -> float:
        """Hint horizon currently buffered, in wall-clock milliseconds,
        counting each queued chunk's ACTUAL steps (``flush_every`` stands in
        only for chunks that carry no shape)."""
        steps = sum(flush_every if s is None else s for s in self._steps)
        return steps * step_ms


def chunk_source(trace: np.ndarray, flush_every: int) -> Iterator[np.ndarray]:
    """Split a host [T, n, tiles] trace into [K, n, tiles] flush chunks; a
    non-divisible tail is a final SHORTER chunk, never dropped."""
    for i in range(0, trace.shape[0], flush_every):
        yield trace[i:i + flush_every]


def merge_sources(sources: dict[int, Iterable[np.ndarray]], capacity: int,
                  n_tiles: int, pad_rho: float = 1.0
                  ) -> Iterator[np.ndarray]:
    """Zip per-lane chunk sources into full-capacity [K, capacity, tiles]
    chunks — the multi-tenant ingest shape.

    ``sources`` maps lane index → an iterator of [K, tiles] chunks; free
    lanes idle at ``pad_rho``.  Stops at the SHORTEST source and requires
    every source to agree on K within each round.
    """
    its = {lane: iter(s) for lane, s in sources.items()}
    if not its:
        return
    while True:
        parts = {}
        for lane, it in its.items():
            chunk = next(it, None)
            if chunk is None:
                return
            parts[lane] = np.asarray(chunk, np.float32)
        ks = {p.shape[0] for p in parts.values()}
        if len(ks) != 1:
            raise ValueError(f"per-lane sources disagree on chunk length: "
                             f"{sorted(ks)}")
        out = np.full((ks.pop(), capacity, n_tiles), pad_rho, np.float32)
        for lane, p in parts.items():
            out[:, lane, :] = p
        yield out


def stream(engine: FleetEngine, state: SchedulerState,
           source: Iterable[np.ndarray], *,
           lookahead_chunks: int = 2,
           on_flush: Callable[[int, dict], None] | None = None,
           keep_telemetry: bool = True,
           active: np.ndarray | None = None,
           ) -> tuple[SchedulerState, list[dict], StreamStats]:
    """Drive the fleet through a streamed density trace.

    ``source`` yields host [K, n_packages, n_tiles] chunks (K = the flush
    interval; see `chunk_source`).  Returns (final state, one telemetry dict
    per flush, stats).  ``lookahead_chunks`` bounds the hint queue — with the
    default 2 the loop is double-buffered.  ``active`` (optional
    [n_packages] bool mask) limits every flush's telemetry to those lanes.
    """
    q = HintQueue(lookahead_chunks)
    it = iter(source)
    stats = StreamStats()
    exhausted = False

    def pump() -> None:
        """Top the hint queue up with device-resident uploads (async H2D)."""
        nonlocal exhausted
        while not exhausted and not q.full:
            chunk = next(it, None)
            if chunk is None:
                exhausted = True
                return
            q.offer(engine.backend_impl.put_trace(chunk))
            stats.chunks_ingested += 1
            stats.queue_peak = max(stats.queue_peak, len(q))

    pump()
    flushed: list[dict] = []
    while len(q):
        chunk = q.take()
        state, telem = engine.run_block(state, chunk,   # async launch
                                        active=active)
        stats.steps += int(chunk.shape[0])
        pump()              # upload the NEXT chunk(s) while this one computes
        d = telem.as_dict()                             # the ONE host sync
        stats.host_syncs += 1
        stats.flushes += 1
        if keep_telemetry:
            flushed.append(d)
        if on_flush is not None:
            on_flush(stats.flushes, d)
    return state, flushed, stats
