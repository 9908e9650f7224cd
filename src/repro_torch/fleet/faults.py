"""Deterministic fault injection for the fleet serving stack.

Port of `repro.fleet.faults` (host-side numpy, so the same plan faults the
same words in both packages).

The paper's predictive layer is *advisory*: the 20-50 ms hint window (§4)
can arrive late, corrupted, or not at all, and real firmware must degrade
to the reactive §9 baseline rather than act on stale density.  This module
is the test harness for that contract — a seeded, reproducible `FaultPlan`
that injects the failure modes the degraded-mode fallback
(`SchedulerConfig(degraded_fallback=True)`) must contain:

  * **hint outages** — whole-fleet hint starvation for a span of steps
    (a delayed or dropped `HintQueue` chunk): every density word in the
    span becomes NaN, exactly what a consumer reading an unfilled hint
    buffer sees;
  * **sensor faults** — per-package density-sensor failures: ``dropout``
    (all-NaN words), ``corrupt`` (a seeded NaN/±Inf mix), ``stuck``
    (frozen at a constant) and ``noise`` (seeded Gaussian jitter).
    Dropout/corrupt are non-finite and therefore DETECTED in-band by the
    fallback's staleness counter; stuck/noise stay finite and are
    deliberately undetectable — the harness exists to verify both sides
    of that line;
  * **host stalls** — `time.sleep` at a flush boundary, modelling an
    ingest host that falls behind (exercises the `Heartbeat` stalled-flush
    watchdog, not the in-graph fallback).

Faults compose at two boundaries with the same `apply` core:

    plan.apply(chunk, step0)              # engine boundary: one rho chunk
    plan.chunk_source(trace, flush_every) # ingest boundary: chunk iterator
    plan.wrap(source)                     # ingest boundary: any source

Everything is NumPy on the host side — fault words are injected BEFORE
`put_trace` uploads the chunk, so the device-side program never changes
and a faulted run launches exactly the same kernels as a clean one.
Determinism: every random draw is keyed by ``(seed, lane, start)`` through
`np.random.default_rng`, so two processes holding the same plan corrupt
identically — the chaos soak's faulted-vs-oracle comparisons depend on it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Iterator

import numpy as np

from repro_torch.fleet.ingest import chunk_source as _plain_chunk_source

SENSOR_KINDS = ("dropout", "corrupt", "stuck", "noise")


@dataclasses.dataclass(frozen=True)
class HintOutage:
    """Fleet-wide hint starvation: steps [start, start+steps) carry NaN."""

    start: int
    steps: int


@dataclasses.dataclass(frozen=True)
class SensorFault:
    """One package's density sensor misbehaving for a span of steps.

    ``kind``: ``dropout`` | ``corrupt`` | ``stuck`` | ``noise``;
    ``value`` is the stuck-at constant (``stuck``) or the noise sigma
    (``noise``); ignored by the non-finite kinds.
    """

    lane: int
    kind: str
    start: int
    steps: int
    value: float = 0.0

    def __post_init__(self):
        if self.kind not in SENSOR_KINDS:
            raise ValueError(f"unknown sensor-fault kind {self.kind!r}; "
                             f"expected one of {SENSOR_KINDS}")


@dataclasses.dataclass(frozen=True)
class HostStall:
    """Ingest host stall: sleep ``seconds`` before flush ``flush``."""

    flush: int
    seconds: float


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, deterministic schedule of injected faults."""

    seed: int = 0
    hint_outages: tuple[HintOutage, ...] = ()
    sensor_faults: tuple[SensorFault, ...] = ()
    host_stalls: tuple[HostStall, ...] = ()

    # -- engine boundary ---------------------------------------------------
    def apply(self, chunk: np.ndarray, step0: int) -> np.ndarray:
        """Return a faulted COPY of a [K, n, tiles] chunk whose rows cover
        global steps [step0, step0+K).  The input is never mutated — the
        oracle run can replay the same pristine trace."""
        chunk = np.array(chunk, np.float32, copy=True)
        k = chunk.shape[0]

        def span(start, steps):
            lo = max(start - step0, 0)
            hi = min(start + steps - step0, k)
            return (lo, hi) if lo < hi else None

        for o in self.hint_outages:
            s = span(o.start, o.steps)
            if s:
                chunk[s[0]:s[1]] = np.nan
        for f in self.sensor_faults:
            s = span(f.start, f.steps)
            if s is None:
                continue
            lo, hi = s
            sl = chunk[lo:hi, f.lane, :]
            if f.kind == "dropout":
                sl[...] = np.nan
            elif f.kind == "stuck":
                sl[...] = f.value
            else:
                # keyed by the fault's identity, NOT the chunk index, then
                # fast-forwarded to this chunk's offset into the fault span
                # — identical words regardless of how the trace is chunked
                rng = np.random.default_rng((self.seed, f.lane, f.start))
                off, n = lo + step0 - f.start, sl.size // (hi - lo)
                if f.kind == "corrupt":
                    words = np.where(
                        rng.random((f.steps, n)) < 0.5, np.nan, np.inf)
                    sl[...] = words[off:off + hi - lo]
                else:  # noise — finite by construction, so undetectable
                    jit = rng.normal(0.0, f.value or 0.1, (f.steps, n))
                    sl[...] = np.maximum(sl + jit[off:off + hi - lo], 0.0)
        return chunk

    # -- ingest boundary ---------------------------------------------------
    def wrap(self, source: Iterable[np.ndarray]) -> Iterator[np.ndarray]:
        """Fault an arbitrary chunk source (`chunk_source`, `merge_sources`,
        a distributed slab feed, ...): tracks the global step cursor across
        chunks, applies sensor/hint faults to each, and sleeps out host
        stalls at their flush boundaries."""
        stalls = {s.flush: s.seconds for s in self.host_stalls}
        step0 = 0
        for flush, chunk in enumerate(source):
            if flush in stalls:
                time.sleep(stalls[flush])
            chunk = np.asarray(chunk)
            yield self.apply(chunk, step0)
            step0 += chunk.shape[0]

    def chunk_source(self, trace: np.ndarray,
                     flush_every: int) -> Iterator[np.ndarray]:
        """Faulted `repro_torch.fleet.ingest.chunk_source` — same tail-chunk
        semantics, every yielded chunk a faulted copy."""
        return self.wrap(_plain_chunk_source(trace, flush_every))

    # -- constructors ------------------------------------------------------
    @classmethod
    def generate(cls, seed: int, n_packages: int, n_steps: int, *,
                 outages: int = 1, outage_steps: int = 32,
                 faults: int = 2, fault_steps: int = 64,
                 kinds: tuple[str, ...] = SENSOR_KINDS) -> "FaultPlan":
        """Seeded random plan sized to a [n_steps, n_packages, ...] run —
        the chaos soak's default schedule.  Spans are placed in the first
        ~80% of the run so every fault has room to engage AND recover
        before the final-telemetry gates."""
        rng = np.random.default_rng(seed)
        horizon = max(int(n_steps * 0.8) - max(outage_steps, fault_steps), 1)
        hint = tuple(HintOutage(int(rng.integers(1, horizon)), outage_steps)
                     for _ in range(outages))
        sens = tuple(
            SensorFault(lane=int(rng.integers(0, n_packages)),
                        kind=kinds[int(rng.integers(0, len(kinds)))],
                        start=int(rng.integers(1, horizon)),
                        steps=fault_steps,
                        value=float(rng.uniform(0.5, 2.0)))
            for _ in range(faults))
        return cls(seed=seed, hint_outages=hint, sensor_faults=sens)

    def faulted_lanes(self) -> set[int]:
        """Lanes touched by any per-lane sensor fault (hint outages hit
        every lane and are excluded) — the chaos gate's bit-match
        comparisons exclude exactly these."""
        return {f.lane for f in self.sensor_faults}

    def describe(self) -> str:
        return (f"FaultPlan(seed={self.seed}, "
                f"{len(self.hint_outages)} outage(s), "
                f"{len(self.sensor_faults)} sensor fault(s), "
                f"{len(self.host_stalls)} stall(s))")
