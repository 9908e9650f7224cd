"""FleetEngine — batched thermal scheduling for fleets of 3.5D packages.

Port of `repro.fleet.engine`.  One `ThermalScheduler` config advances a
whole fleet of packages in lockstep; HOW the package axis runs is a
pluggable backend (`repro_torch.fleet.backends`):

  * ``broadcast`` — batch-shaped state tensors, one `update` per step
    (the default, and the engine-level oracle);
  * ``fused``     — `run_block`/`run_chunked`/`stream` windows advance in
    one `fleet_step` call: on CUDA one launch of the Hopper kernel;
  * ``vmap``      — per-lane clocks, one `update` per step (the
    reference's per-package layout; a lane attached mid-flight restarts
    its own clocks);
  * ``sharded``   — the package axis partitioned over a 1-D device mesh,
    one broadcast-layout `update` per partition per step;
  * ``sharded_fused`` — fused × sharded: one `fleet_step` launch per
    partition per window, each on its partition's device.

    eng = FleetEngine(SchedulerConfig(n_tiles=4, mode="v24"),
                      backend="fused")            # device defaults to CUDA
    state = eng.init(n_packages=1024)
    state, telem = eng.run_block(state, rho)      # rho: [K, 1024, 4]
    print(telem.as_dict())   # ONE device→host copy per flush record

State contract:

  * **Rebind the returned state.**  Entry points never modify their input
    state; they return a new one.
  * **Lane independence.**  Per-package physics is elementwise over the
    package axis; only the telemetry reductions cross lanes.  (Under
    ``reactive_poll`` the sensor phase follows the fleet's shared clock.)
  * **Active masks.**  ``step``/``run``/``run_block``/``run_chunked`` take
    ``active`` — an [n_packages] bool mask — and reduce telemetry over the
    active lanes only; padded lanes still compute.
  * **Tail flushes.**  `run_chunked` (like `ingest.chunk_source`/`stream`)
    turns a trace length that does not divide ``flush_every`` into a final
    SHORTER window: ceil(T/K) records, every step counted, no padding.
  * **Devices.**  The engine runs on the device it is given and defaults to
    CUDA; without a card it raises unless the caller passes
    ``device="cpu"``.
  * **The mesh.**  The mesh backends take ``devices`` (a budget: None or 0
    for the whole pool) and ``device_pool`` (the devices the mesh may take:
    every visible card by default; entries may repeat one device).  Their
    state's per-package leaves are partitioned
    (`repro_torch.distributed.sharding.Sharded`); the step has no
    cross-lane operation, and the telemetry reductions — percentiles over
    the whole active fleet, never per partition — run on the streamed
    traces gathered onto the engine's device, still one device→host copy a
    flush.  `gather` and `lanes` give whole views of a partitioned state.
  * **Across processes.**  In a process group
    (`repro_torch.distributed.multihost`) the mesh backends span every
    rank; each rank's state holds only its own partitions, and `put_trace`
    takes a global chunk or this rank's lane slab.  Every entry point is
    then a collective program — all ranks make the same calls — and the
    record is derived from a window's streamed traces on every path (the
    kernel's, or a loop of `update` on ``sharded``), so each flush makes
    ONE collective, never one a step: `multihost.gather_spans` assembles
    the window's ρ, temperature and frequency planes of every rank in
    global lane order and layout, beside each rank's event, degraded-lane
    and prior-event counts, and every rank reduces them with the
    one-device code — the percentiles over the whole active fleet — so the
    record is the same on every rank, fetched with its one host sync, and
    equal to the one-process engine's.

`run_survey` is the §10 Monte-Carlo plane: per-(package, tile) peak
temperature, exceedance and mean frequency, reduced on the device over
``chunk``-step blocks of the fused kernel (or per step on the broadcast
backend); on a mesh its per-lane accumulators are partitioned like the
state (each rank's own across processes) and the finished survey is
gathered (across processes, in one collective).  Fleets with per-package
planes (heterogeneous draws, the degraded fallback, operator pins) report
the fallback's lanes in ``degraded_count`` and count events per lane mode,
as the kernel does.

Not ported: state donation (PyTorch allocates each window's outputs
afresh).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.density import rtok_from_rho
from repro_torch.core.fingerprint import FINGERPRINT, Fingerprint
from repro_torch.core.scheduler import (SchedulerConfig, SchedulerOutput,
                                        SchedulerState, ThermalScheduler)
from repro_torch.distributed import multihost, sharding
from repro_torch.fleet.backends import backend_class

_I32 = torch.int32


class FleetTelemetry(NamedTuple):
    """Aggregate fleet health for one step or window (0-dim tensor leaves;
    [K]-leaved when stacked per step or per flush)."""

    n_packages: torch.Tensor      # int32
    events_total: torch.Tensor    # cumulative T_crit crossings, fleet-wide
    events_step: torch.Tensor     # crossings added this step (window: summed)
    temp_p50_c: torch.Tensor      # fleet junction-temperature percentiles
    temp_p99_c: torch.Tensor
    temp_max_c: torch.Tensor
    temp_var_c2: torch.Tensor     # fleet junction-temperature variance [°C²]
    freq_mean: torch.Tensor       # mean frequency multiplier
    freq_min: torch.Tensor
    released_mtps: torch.Tensor   # Σ R_tok(ρ)·f — compute actually released
    throttled_mtps: torch.Tensor  # Σ R_tok(ρ)·(1−f) — compute held back
    at_risk_frac: torch.Tensor    # fraction of tiles under straggler threshold
    # active lanes on the reactive fallback (0 whenever it is off) — the
    # window reduce keeps the peak
    degraded_count: torch.Tensor

    def as_dict(self) -> dict[str, float]:
        """Host-side scalar dict — ONE device→host copy for the whole
        record (the fields are stacked on the device first)."""
        vals = torch.stack([v.reshape(()).to(torch.float64)
                            for v in self]).tolist()
        d = dict(zip(self._fields, vals))
        d["n_packages"] = int(d["n_packages"])
        d["degraded_count"] = int(d["degraded_count"])
        return d

    def reduce(self) -> "FleetTelemetry":
        """Reduce a [K]-leaved (stacked per-step) record to one record for
        the whole K-step window: counters take the last cumulative value or
        the sum, temperatures keep the worst tail (p99/max = max over steps,
        p50 = mean), frequency keeps mean/min, the MTPS split and at-risk
        fraction are window means — so released + throttled == ΣR_tok holds
        for the window against the window-mean offered throughput."""
        return FleetTelemetry(
            n_packages=self.n_packages[-1],
            events_total=self.events_total[-1],
            events_step=self.events_step.sum(dtype=_I32),
            temp_p50_c=self.temp_p50_c.mean(),
            temp_p99_c=self.temp_p99_c.max(),
            temp_max_c=self.temp_max_c.max(),
            temp_var_c2=self.temp_var_c2.mean(),
            freq_mean=self.freq_mean.mean(),
            freq_min=self.freq_min.min(),
            released_mtps=self.released_mtps.mean(),
            throttled_mtps=self.throttled_mtps.mean(),
            at_risk_frac=self.at_risk_frac.mean(),
            degraded_count=self.degraded_count.max(),
        )


class FleetSurvey(NamedTuple):
    """Per-(package, tile) lane reductions over a trace (the §10
    Monte-Carlo plane), accumulated on the device — `FleetEngine.run_survey`."""

    peak_t_c: torch.Tensor       # [n, tiles] max junction temp past burn-in
    exceed_frac: torch.Tensor    # [n, tiles] fraction of counted steps > T_crit
    freq_mean: torch.Tensor      # [n, tiles] mean delivered frequency (all steps)
    steps: torch.Tensor          # int32 — trace length
    counted_steps: torch.Tensor  # int32 — steps past burn-in


def _stack(records: list[FleetTelemetry]) -> FleetTelemetry:
    return FleetTelemetry(*(torch.stack(f) for f in zip(*records)))


def _masked_quantile(sorted_v: torch.Tensor, cnt, q: float) -> torch.Tensor:
    """Linear-interpolated percentile over the first ``cnt`` entries of an
    ascending-sorted last axis (inactive lanes sort to +inf past them) —
    numpy's default interpolation, v[lo]·(1 − frac) + v[hi]·frac.

    The position q/100·(cnt − 1) is taken in f64, exact for counts past
    f32's integers (a 47-tile × 4,096-package step has 192,512 values).
    ``cnt`` is a python int (dense fleet: no device round trip) or a device
    tensor (masked fleet).  ``torch.quantile`` is not used: it refuses
    inputs above ~16M elements.
    """
    if not torch.is_tensor(cnt):
        pos = (q / 100.0) * (cnt - 1.0)
        lo, hi = int(np.floor(pos)), int(np.ceil(pos))
        frac = np.float32(pos - lo)
        return (sorted_v[..., lo] * float(np.float32(1.0) - frac)
                + sorted_v[..., hi] * float(frac))
    pos = (q / 100.0) * (cnt.to(torch.float64) - 1.0)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    frac = (pos - lo).to(sorted_v.dtype)
    take = lambda i: torch.gather(
        sorted_v, -1, i.to(torch.int64).expand(sorted_v.shape[:-1])[..., None]
    )[..., 0]
    return take(lo) * (1.0 - frac) + take(hi) * frac


class FleetEngine:
    """Fleet stepper around one `ThermalScheduler` config.

    ``backend`` is a registered backend name (``broadcast``/``fused``/
    ``vmap``/``sharded``/``sharded_fused``).  ``device`` defaults to CUDA
    (see module docstring).  ``devices`` (a budget) and ``device_pool``
    are forwarded to the device-mesh backends only; any other backend
    refuses them.  ``debug_nan`` host-checks every returned state and
    telemetry record for NaN/Inf and raises with the offending lanes.
    """

    def __init__(self, cfg: SchedulerConfig | None = None,
                 fp: Fingerprint = FINGERPRINT, backend: str = "broadcast",
                 device=None, debug_nan: bool = False,
                 devices: int | None = None, device_pool=None):
        self.cfg = cfg = SchedulerConfig() if cfg is None else cfg
        self.fp = fp
        cls = backend_class(backend)
        if (devices is not None or device_pool is not None) \
                and not cls.accepts_devices:
            raise ValueError(
                f"devices={devices} / device_pool only apply to device-mesh "
                f"backends (sharded/sharded_fused), got backend={backend!r}")
        self.sched = ThermalScheduler(cfg, fp, device=device)
        kw = (dict(devices=devices, device_pool=device_pool)
              if cls.accepts_devices else {})
        self.backend_impl = cls(self.sched, **kw)
        self.device = self.sched.device
        self.backend = self.backend_impl.name
        self.debug_nan = debug_nan

    # ------------------------------------------------------------------ api
    def init(self, n_packages: int, pkg=None,
             filtration_fill=None) -> SchedulerState:
        """Fleet state with a leading [n_packages] axis on every per-package
        leaf."""
        return self.backend_impl.init(n_packages, pkg=pkg,
                                      filtration_fill=filtration_fill)

    def step(self, state: SchedulerState, rho, active=None) -> tuple[
            SchedulerState, SchedulerOutput, FleetTelemetry]:
        """Advance the whole fleet one step.

        rho: scalar, [n_packages], or [n_packages, n_tiles] density.  On a
        process-spanning mesh one step is a window of one (one collective).
        """
        state, out, telem = self._step_impl(
            state, self._rho_fleet(state, rho), self._active(state, active))
        self._debug_check_finite(state, telem)
        return state, out, telem

    def run(self, state: SchedulerState, rho_trace, active=None) -> tuple[
            SchedulerState, FleetTelemetry]:
        """Step through a [T, n_packages, n_tiles] trace; returns the final
        state and the stacked per-step telemetry ([T]-leaved)."""
        self._check_trace(rho_trace)
        rho_trace = self.backend_impl.put_trace(rho_trace)
        state, telems = self._run_impl(state, rho_trace,
                                       self._active(state, active))
        self._debug_check_finite(state, telems)
        return state, telems

    def run_chunked(self, state: SchedulerState, rho_trace,
                    flush_every: int,
                    active=None) -> tuple[SchedulerState, FleetTelemetry]:
        """Run a [T, n, tiles] trace in K-step windows, one reduced
        telemetry record per window (ceil(T/K)-leaved: a non-divisible tail
        is its own shorter window)."""
        self._check_trace(rho_trace)
        active = self._active(state, active)
        records = []
        for i in range(0, rho_trace.shape[0], flush_every):
            chunk = self.backend_impl.put_trace(rho_trace[i:i + flush_every])
            state, telem = self._run_block_impl(state, chunk, active)
            records.append(telem)
        telems = _stack(records)
        self._debug_check_finite(state, telems)
        return state, telems

    def run_block(self, state: SchedulerState, rho_trace, active=None
                  ) -> tuple[SchedulerState, FleetTelemetry]:
        """Advance one [K, n, tiles] window and return the state plus the
        window's SINGLE reduced telemetry record (the streaming loop's unit
        of work — one host sync per window when the caller fetches it)."""
        self._check_trace(rho_trace)
        state, telem = self._run_block_impl(
            state, self.backend_impl.put_trace(rho_trace),
            self._active(state, active))
        self._debug_check_finite(state, telem)
        return state, telem

    def run_survey(self, state: SchedulerState, rho_trace, burn_in: int = 0,
                   chunk: int = 1024) -> tuple[SchedulerState, FleetSurvey]:
        """Step a [T, n, tiles] trace accumulating PER-(package, tile)
        reductions on the device — the Monte-Carlo plane.

        Keeps one record per lane: the running peak junction temperature
        and the T_crit exceedance fraction over the steps past
        ``burn_in``, and the mean delivered frequency over the whole trace
        (a Kahan-compensated sum) — the §10 per-trial statistics, with O(n)
        accumulators instead of an O(T·n) trace.  A backend with a fused
        `run_block` advances ``chunk``-step blocks through its kernel (one
        launch each) and reduces the streamed traces; the others reduce
        after every `update`.  On a mesh the accumulators are partitioned
        like the state, each reduced on its partition's device, and the
        finished survey is gathered onto the engine's device — across
        processes each rank keeps its own lanes' accumulators (``rho_trace``
        global or this rank's slab) and the survey is assembled once, in
        one collective, whole on every rank.
        """
        self._check_trace(rho_trace)
        t = rho_trace.shape[0]
        if not 0 <= burn_in < t:
            raise ValueError(f"burn_in={burn_in} outside the trace [0, {t})")
        mesh = sharding.mesh_of(state)
        acc = sharding.fleet_shard_map(
            lambda f: (torch.full_like(f, -torch.inf),     # running peak T
                       torch.zeros_like(f),                # exceedance count
                       torch.zeros_like(f),                # Σ freq (Kahan)
                       torch.zeros_like(f)),               # compensation
            mesh, (0,), (0,) * 4)(state.freq)
        put = self.backend_impl.put_trace
        if self.backend_impl.run_block is None:
            state, acc = self._survey_steps(state, put(rho_trace), burn_in,
                                            acc)
        else:
            for i in range(0, t, chunk):
                state, acc = self._survey_block(
                    state, put(rho_trace[i:i + chunk]), max(burn_in - i, 0),
                    acc)
        peak, exceed, fmean = sharding.fleet_shard_map(
            lambda p, e, f: (p, e / (t - burn_in), f / t), mesh, (0,) * 3,
            (0,) * 3)(*acc[:3])
        return state, self.assemble(FleetSurvey(
            peak_t_c=peak, exceed_frac=exceed, freq_mean=fmean,
            steps=torch.tensor(t, dtype=_I32),
            counted_steps=torch.tensor(t - burn_in, dtype=_I32)))

    @staticmethod
    def _kahan(fsum, comp, x):
        """Compensated add: a 3,000-step sequential f32 Σfreq otherwise
        drifts ~1e-5 relative (peak is a max and the exceedance count small
        exact integers, so only this accumulator needs compensation)."""
        y = x - comp
        tot = fsum + y
        return tot, (tot - fsum) - y

    def _fold(self, peak, exceed, fsum, comp, temps, freqs, skip: int):
        """A block's [T, n, tiles] traces folded into the per-lane
        accumulators: steps from ``skip`` on count toward the peak and the
        exceedance, every step toward Σfreq."""
        if skip < temps.shape[0]:
            counted = temps[skip:]
            peak = torch.maximum(peak, counted.amax(0))
            exceed = exceed + (counted > self.fp.t_crit_c).sum(0).to(
                exceed.dtype)
        # the block's Σfreq in f64 is exact (f32 terms in [0.05, 1], at most
        # a few thousand), so its f32 rounding does not depend on the layout
        # or device the sum ran on
        fsum, comp = self._kahan(fsum, comp,
                                 freqs.sum(0, dtype=torch.float64).float())
        return peak, exceed, fsum, comp

    def _survey_steps(self, state: SchedulerState, rho_trace, skip: int,
                      acc):
        """Per-step survey: one `update` a step, the accumulators advanced
        after each (the first ``skip`` steps count toward Σfreq only), on
        each partition's device."""
        mesh = sharding.mesh_of(state)
        for k, rho in enumerate(rho_trace):
            state, out = self.backend_impl.update(state, rho)
            acc = sharding.fleet_shard_map(
                lambda *a: self._fold(*a[:4], a[4][None], a[5][None],
                                      0 if k >= skip else 1),
                mesh, (0,) * 6, (0,) * 4)(*acc, out.temp_c, out.freq)
        return state, acc

    def _survey_block(self, state: SchedulerState, rho_trace, skip: int,
                      acc):
        """Fused-backend survey: one kernel launch for the block (one a
        partition on a mesh), then the lane reductions over its streamed
        temp/freq traces."""
        state, temps, freqs = self.backend_impl.run_block(state, rho_trace)
        return state, sharding.fleet_shard_map(
            lambda *a: self._fold(*a, skip), sharding.mesh_of(state),
            (0, 0, 0, 0, 1, 1), (0,) * 4)(*acc, temps, freqs)

    def block_traces(self, state: SchedulerState, rho_trace):
        """(state', temps [T, n, tiles], freqs [T, n, tiles]) for one
        window — the backend's fused kernel when it has one, else a loop of
        `update` — the traces whole on the engine's device (gathered from a
        mesh's partitions; this rank's lanes on a process-spanning mesh:
        no collective)."""
        if self.backend_impl.run_block is not None:
            state, temps, freqs = self.backend_impl.run_block(state,
                                                              rho_trace)
            return state, self._local(temps), self._local(freqs)
        temps, freqs = [], []
        for rho in rho_trace:
            state, out = self.backend_impl.update(state, rho)
            temps.append(self._local(out.temp_c))
            freqs.append(self._local(out.freq))
        return state, torch.stack(temps), torch.stack(freqs)

    def window_telemetry(self, rho_trace, temps, freqs, prev_events,
                         state0: SchedulerState,
                         active=None) -> FleetTelemetry:
        """The [T]-leaved record derived from a window's temp/freq traces;
        `.reduce()` collapses it to one flush record."""
        return self._telemetry_from_traces(
            self.gather(rho_trace), self.gather(temps), self.gather(freqs),
            prev_events, self.lanes(state0), self.gather(active))

    def gather(self, tree):
        """``tree`` (a state, output, trace or mask) with every partition of
        a mesh backend concatenated onto the engine's device; whole trees
        pass through unchanged.  A tree partitioned across processes
        raises: `assemble` gathers it (a collective)."""
        return sharding.gather(tree, self.device)

    def assemble(self, tree):
        """``tree`` whole on the engine's device: `gather` in one process;
        across processes every rank's partitions in ONE collective
        (`multihost.assemble`), so every rank must call it at the same
        point."""
        if self._spans_processes():
            return multihost.assemble(tree, self.device)
        return self.gather(tree)

    def _local(self, tree):
        """`gather`, but this rank's lanes of a leaf partitioned across
        processes."""
        return sharding.gather(tree, self.device, local=True)

    def lanes(self, state: SchedulerState) -> SchedulerState:
        """The state's per-lane leaves whole on the engine's device — what
        the telemetry reductions read (events, latch, fallback and mode
        planes, draws, clocks) — with the ring and pole states left out
        (None) on a mesh (this rank's lanes across processes); a whole
        state is returned as it is."""
        if not sharding.is_sharded(state):
            return state
        return self._local(state._replace(thermal=None, filtration=None))

    # ------------------------------------------------------------- internals
    @staticmethod
    def _check_trace(rho_trace) -> None:
        """A zero-length trace would otherwise fall through to an empty
        loop or kernel call with an opaque failure mode."""
        if rho_trace.shape[0] == 0:
            raise ValueError("empty density trace")

    def _debug_check_finite(self, state: SchedulerState, telem) -> None:
        """``debug_nan``: the state (this rank's lanes across processes)
        and the record, checked on the host."""
        if not self.debug_nan:
            return
        for name in ("freq", "thermal"):
            a = self._local(getattr(state, name))
            bad = ~torch.isfinite(a)
            if bool(bad.any()):
                lanes = torch.unique(torch.nonzero(bad)[:, 0]).tolist()
                raise ValueError(f"debug_nan: non-finite state.{name} on "
                                 f"lane(s) {lanes}")
        bad = [k for k, v in telem._asdict().items()
               if not bool(torch.isfinite(v.to(torch.float64)).all())]
        if bad:
            raise ValueError(f"debug_nan: non-finite telemetry field(s) "
                             f"{bad}")

    def _active(self, state: SchedulerState, active):
        """Validate/place an optional [n_packages] bool lane mask."""
        if active is None:
            return None
        n = state.freq.shape[0]
        # placed like the state's package axis, then whole for the
        # reductions, which cross lanes (whole already across processes)
        arr = self.gather(self.backend_impl.put_mask(active))
        if tuple(arr.shape) != (n,) or arr.dtype != torch.bool:
            raise ValueError(
                f"active mask must be a [{n}] bool array (one flag per "
                f"package lane), got shape {tuple(arr.shape)} dtype "
                f"{arr.dtype}")
        return arr

    def _rho_fleet(self, state: SchedulerState, rho) -> torch.Tensor:
        n = state.freq.shape[0]
        rho = torch.as_tensor(np.asarray(rho) if not torch.is_tensor(rho)
                              else rho, dtype=torch.float32,
                              device=self.device)
        if rho.ndim == 1:            # per-package scalar density
            rho = rho[:, None]
        return rho.expand(n, self.cfg.n_tiles)

    def _degraded_count(self, state: SchedulerState, active=None):
        """Active lanes on the reactive fallback (int32; 0 without it)."""
        if state.degraded is None:
            return torch.zeros((), dtype=_I32, device=self.device)
        deg = state.degraded if active is None else state.degraded & active
        return deg.sum(dtype=_I32)

    def _masked_step_telemetry(self, rho, out, prev_events, events,
                               active, degraded_count) -> FleetTelemetry:
        """One step's telemetry reduced over the active lanes only."""
        mf = active[:, None].expand(out.temp_c.shape).reshape(-1)
        cnt = mf.sum().clamp(min=1)
        fcnt = cnt.to(out.temp_c.dtype)
        temp = out.temp_c.reshape(-1)
        freq = out.freq.reshape(-1)
        sorted_t = torch.sort(torch.where(mf, temp, torch.inf)).values
        mu = torch.where(mf, temp, 0.0).sum() / fcnt
        rtok = rtok_from_rho(rho).expand(out.temp_c.shape).reshape(-1)
        ev_total = torch.where(active, events, 0).sum(dtype=_I32)
        return FleetTelemetry(
            n_packages=active.sum(dtype=_I32),
            events_total=ev_total,
            events_step=ev_total - prev_events,
            temp_p50_c=_masked_quantile(sorted_t, cnt, 50.0),
            temp_p99_c=_masked_quantile(sorted_t, cnt, 99.0),
            temp_max_c=torch.where(mf, temp, -torch.inf).max(),
            temp_var_c2=torch.where(mf, (temp - mu) ** 2, 0.0).sum() / fcnt,
            freq_mean=torch.where(mf, freq, 0.0).sum() / fcnt,
            freq_min=torch.where(mf, freq, torch.inf).min(),
            released_mtps=torch.where(mf, rtok * freq, 0.0).sum(),
            throttled_mtps=torch.where(mf, rtok * (1.0 - freq), 0.0).sum(),
            at_risk_frac=torch.where(
                mf, freq < self.cfg.straggler_threshold, False).sum()
            / fcnt,
            degraded_count=degraded_count,
        )

    def _spans_processes(self) -> bool:
        """True when the backend's mesh spans processes (the same on every
        rank, so branching on it keeps the program the same everywhere)."""
        spans = getattr(self.backend_impl, "spans_processes", None)
        return bool(spans and spans())

    def _prev_events(self, lanes0: SchedulerState, active=None):
        """Σ events over the (active) lanes at window entry, int32."""
        if active is None:
            return lanes0.events.sum(dtype=_I32)
        return torch.where(active, lanes0.events, 0).sum(dtype=_I32)

    def _assembled_record(self, rho, temps, freqs, lanes0: SchedulerState,
                          active=None) -> FleetTelemetry:
        """The [T]-leaved record of a window on a process-spanning mesh,
        from this rank's [T, n_local, tiles] ρ, temperature and frequency
        slabs and its lanes at window entry, in ONE collective.

        Each rank replays its own lanes' event plane (events, degraded
        lanes, the sanitised ρ); `multihost.gather_spans` then assembles
        the three planes in global lane order, each in its slab's memory
        layout, and every rank's integer counts as a row of its own; the
        rows are summed in rank order and the whole window reduced by
        `_traces_record`, as one device reduces it — the same record on
        every rank.  ``active`` is the global mask."""
        be = self.backend_impl
        n = be.n_global
        lo, hi = multihost.local_lane_range(n, be.mesh)
        act = None if active is None else active[lo:hi]
        ev_step, deg_count, rho = self._event_plane(rho, temps, lanes0, act)
        t = temps.shape[0]
        counts = torch.cat([ev_step, deg_count,
                            self._prev_events(lanes0, act).reshape(1)])
        world = len(set(be.mesh.owners))
        rho, temps, freqs, counts = multihost.gather_spans(
            [(rho, 1, lo, n), (temps, 1, lo, n), (freqs, 1, lo, n),
             (counts[None], 0, be.mesh.rank, world)], self.device)
        counts = counts.sum(0, dtype=_I32)
        return self._traces_record(rho, temps, freqs, counts[2 * t],
                                   counts[:t], counts[t:2 * t], active)

    def _traces_window(self, state: SchedulerState, rho_trace, active=None):
        """(state', the window's [T]-leaved record) from its streamed
        temperature and frequency traces (the kernel's, or a loop of
        `update`); across processes, one collective."""
        lanes0 = self.lanes(state)
        state, temps, freqs = self.block_traces(state, rho_trace)
        rho = self._local(rho_trace)
        if self._spans_processes():
            return state, self._assembled_record(rho, temps, freqs, lanes0,
                                                 active)
        return state, self._telemetry_from_traces(
            rho, temps, freqs, self._prev_events(lanes0, active), lanes0,
            active)

    def _step_impl(self, state: SchedulerState, rho, active=None):
        lanes0 = self.lanes(state)
        prev_events = self._prev_events(lanes0, active)
        state, out = self.backend_impl.update(state, rho)
        if self._spans_processes():
            lo, hi = multihost.local_lane_range(self.backend_impl.n_global,
                                                self.backend_impl.mesh)
            telem = self._assembled_record(
                rho[None, lo:hi], self._local(out.temp_c)[None],
                self._local(out.freq)[None], lanes0, active)
            return state, out, FleetTelemetry(*(v[0] for v in telem))
        lanes, out, rho = self.lanes(state), self.gather(out), self.gather(rho)
        if self.cfg.degraded_fallback:
            # telemetry reduces over the SANITISED density the controller
            # acted on (this step's held ρ), never raw NaN/Inf words
            rho = lanes.rho_last
        if active is not None:
            return state, out, self._masked_step_telemetry(
                rho, out, prev_events, lanes.events, active,
                self._degraded_count(lanes, active))
        temp = out.temp_c.reshape(-1)
        sorted_t = torch.sort(temp).values
        rtok = rtok_from_rho(rho)                    # [n_packages, n_tiles]
        events_total = lanes.events.sum(dtype=_I32)
        telem = FleetTelemetry(
            n_packages=torch.full((), lanes.freq.shape[0], dtype=_I32,
                                  device=self.device),
            events_total=events_total,
            events_step=events_total - prev_events,
            temp_p50_c=_masked_quantile(sorted_t, temp.numel(), 50.0),
            temp_p99_c=_masked_quantile(sorted_t, temp.numel(), 99.0),
            temp_max_c=temp.max(),
            temp_var_c2=temp.var(unbiased=False),
            freq_mean=out.freq.mean(),
            freq_min=out.freq.min(),
            released_mtps=(rtok * out.freq).sum(),
            throttled_mtps=(rtok * (1.0 - out.freq)).sum(),
            at_risk_frac=out.at_risk.to(torch.float32).mean(),
            degraded_count=self._degraded_count(lanes),
        )
        return state, out, telem

    def _run_impl(self, state: SchedulerState, rho_trace: torch.Tensor,
                  active=None):
        if self._spans_processes():
            # never a collective a step: the window's traces path
            return self._traces_window(state, rho_trace, active)
        records = []
        for rho in rho_trace:
            state, _, telem = self._step_impl(state, rho, active)
            records.append(telem)
        return state, _stack(records)

    @staticmethod
    def _step0(state0: SchedulerState):
        """The fleet's global step at window entry: the shared host clock,
        or (vmap's per-lane clocks) lane 0's, as the reference reads it —
        a 0-dim device tensor, so no host sync."""
        s = state0.step
        return int(s) if s.ndim == 0 else s.reshape(-1)[0]

    def _poll(self, state0: SchedulerState):
        """The sensor's polling period: shared, or per package and tile."""
        return (self.sched.poll_ticks if state0.pkg is None
                else state0.pkg.poll_ticks)

    def _reactive_poll_events(self, state0: SchedulerState,
                              temps: torch.Tensor,
                              active=None) -> torch.Tensor:
        """[T] per-step fresh throttle engagements replayed from a
        temperature trace — the reactive_poll event statistic, from the
        pre-window latch and global step, so trace-derived telemetry counts
        the same events as the state counter the kernel advances."""
        c, fp = self.cfg, self.fp
        step0, poll = self._step0(state0), self._poll(state0)
        latch = state0.throttled
        ev = []
        for k, temp in enumerate(temps):
            polled = (step0 + k) % poll == 0
            trig = (temp >= fp.t_crit_c) & polled
            cool = (temp <= c.resume_below_c) & polled
            fresh = (trig & ~latch).any(dim=-1)                  # [n]
            if active is not None:
                fresh = fresh & active
            ev.append(fresh.sum(dtype=_I32))
            latch = (latch | trig) & ~cool
        return torch.stack(ev)

    def _fallback_replay(self, state0: SchedulerState, rho_trace, temps,
                         active=None):
        """Replay the degraded-fallback recurrence of
        `ThermalScheduler.update` over a window's raw density and streamed
        temperatures: ([T] event counts, [T] degraded-lane counts,
        [T, n, tiles] sanitised ρ).  From the pre-window state, so the
        trace-derived telemetry counts the same events the kernel does
        (fresh engagements on reactive lanes, T_crit crossings on the
        others) and the MTPS reductions never see a non-finite word."""
        c, fp = self.cfg, self.fp
        step0, poll = self._step0(state0), self._poll(state0)
        lim, rec = c.stale_limit_steps, c.recover_steps
        ctrl = state0.ctrl_mode
        rho_last, stale = state0.rho_last, state0.stale
        deg, thr = state0.degraded, state0.throttled
        ev, dc, safe = [], [], []
        for k in range(temps.shape[0]):
            rho, temp = rho_trace[k], temps[k]
            finite = torch.isfinite(rho)
            valid = finite.all(dim=-1)
            rho_last = torch.where(finite, rho, rho_last)
            stale = torch.where(valid, (stale - 1).clamp(min=0),
                                (stale + 1).clamp(max=lim + rec))
            deg = (deg & (stale > 0)) | (stale >= lim)
            # the reactive mask: the staleness latch OR the operator's pin
            reactive = deg if ctrl is None else deg | ctrl
            polled = (step0 + k) % poll == 0
            trig = (temp >= fp.t_crit_c) & polled
            cool = (temp <= c.resume_below_c) & polled
            deg_t = reactive[..., None]
            e = torch.where(reactive, (trig & ~thr).any(dim=-1),
                            (temp > fp.t_crit_c).any(dim=-1))
            thr = torch.where(deg_t, (thr | trig) & ~cool, False)
            vis = deg
            if active is not None:
                e, vis = e & active, deg & active
            ev.append(e.sum(dtype=_I32))
            dc.append(vis.sum(dtype=_I32))
            safe.append(rho_last)
        return torch.stack(ev), torch.stack(dc), torch.stack(safe)

    def _mixed_mode_events(self, state0: SchedulerState, temps,
                           active=None) -> torch.Tensor:
        """[T] event plane of an operator-pinned fleet without the
        fallback: pinned lanes count fresh throttle engagements (the latch
        replayed from the pre-window state), v24 lanes T_crit crossings."""
        c, fp = self.cfg, self.fp
        step0, poll = self._step0(state0), self._poll(state0)
        ctrl, latch = state0.ctrl_mode, state0.throttled
        ev = []
        for k, temp in enumerate(temps):
            polled = (step0 + k) % poll == 0
            trig = (temp >= fp.t_crit_c) & polled
            cool = (temp <= c.resume_below_c) & polled
            e = torch.where(ctrl, (trig & ~latch).any(dim=-1),
                            (temp > fp.t_crit_c).any(dim=-1))
            latch = torch.where(ctrl[..., None], (latch | trig) & ~cool,
                                False)
            if active is not None:
                e = e & active
            ev.append(e.sum(dtype=_I32))
        return torch.stack(ev)

    def _event_plane(self, rho_trace, temps, state0: SchedulerState,
                     active=None):
        """One window's ([T] event counts, [T] degraded-lane counts, ρ —
        sanitised under the degraded fallback, passed through otherwise)."""
        deg_count = torch.zeros((temps.shape[0],), dtype=_I32,
                                device=self.device)
        if self.cfg.mode == "reactive_poll":
            ev_step = self._reactive_poll_events(state0, temps, active)
        elif self.cfg.degraded_fallback:
            ev_step, deg_count, rho_trace = self._fallback_replay(
                state0, rho_trace, temps, active)
        elif self.cfg.mixed_mode:
            ev_step = self._mixed_mode_events(state0, temps, active)
        else:
            crossed = (temps > self.fp.t_crit_c).any(dim=-1)      # [T, n]
            if active is not None:
                crossed = crossed & active[None, :]
            ev_step = crossed.sum(dim=-1, dtype=_I32)
        return ev_step, deg_count, rho_trace

    def _telemetry_from_traces(self, rho_trace, temps, freqs, prev_events,
                               state0: SchedulerState,
                               active=None) -> FleetTelemetry:
        """[T]-leaved telemetry from per-step temperature/frequency traces
        — the fused backend's telemetry plane, field for field the stacked
        per-step records."""
        ev_step, deg_count, rho_trace = self._event_plane(
            rho_trace, temps, state0, active)
        return self._traces_record(rho_trace, temps, freqs, prev_events,
                                   ev_step, deg_count, active)

    def _traces_record(self, rho_trace, temps, freqs, prev_events, ev_step,
                       deg_count, active=None) -> FleetTelemetry:
        """The masked / unmasked trace reductions behind
        `_telemetry_from_traces`, from precomputed [T] event and degraded
        planes — `groups.GroupedFleetEngine` sums per-group planes and
        concatenates per-group traces before calling this once fleet-wide."""
        t, n = temps.shape[0], temps.shape[1]
        tf = temps.reshape(t, -1)
        ff = freqs.reshape(t, -1)
        rtok = rtok_from_rho(rho_trace)
        zeros = torch.zeros((t,), dtype=_I32, device=self.device)
        events_total = prev_events + torch.cumsum(ev_step, 0, dtype=_I32)
        thr = self.cfg.straggler_threshold
        if active is None:
            cnt = tf.shape[1]
            sorted_t = torch.sort(tf, dim=1).values
            return FleetTelemetry(
                n_packages=zeros + n,
                events_total=events_total,
                events_step=ev_step,
                temp_p50_c=_masked_quantile(sorted_t, cnt, 50.0),
                temp_p99_c=_masked_quantile(sorted_t, cnt, 99.0),
                temp_max_c=tf.amax(dim=1),
                temp_var_c2=tf.var(dim=1, unbiased=False),
                freq_mean=ff.mean(dim=1),
                freq_min=ff.amin(dim=1),
                released_mtps=(rtok * freqs).reshape(t, -1).sum(dim=1),
                throttled_mtps=(rtok * (1.0 - freqs)).reshape(t, -1).sum(
                    dim=1),
                at_risk_frac=(ff < thr).to(torch.float32).mean(dim=1),
                degraded_count=deg_count,
            )
        mf = active[:, None].expand(temps.shape[1:]).reshape(-1)
        cnt = mf.sum().clamp(min=1)
        fcnt = cnt.to(temps.dtype)
        sorted_t = torch.sort(torch.where(mf, tf, torch.inf), dim=1).values
        mu = torch.where(mf, tf, 0.0).sum(dim=1) / fcnt
        msum = lambda x: torch.where(mf, x, 0.0).sum(dim=1)
        return FleetTelemetry(
            n_packages=zeros + active.sum(dtype=_I32),
            events_total=events_total,
            events_step=ev_step,
            temp_p50_c=_masked_quantile(sorted_t, cnt, 50.0),
            temp_p99_c=_masked_quantile(sorted_t, cnt, 99.0),
            temp_max_c=torch.where(mf, tf, -torch.inf).amax(dim=1),
            temp_var_c2=msum((tf - mu[:, None]) ** 2) / fcnt,
            freq_mean=msum(ff) / fcnt,
            freq_min=torch.where(mf, ff, torch.inf).amin(dim=1),
            released_mtps=msum((rtok * freqs).reshape(t, -1)),
            throttled_mtps=msum((rtok * (1.0 - freqs)).reshape(t, -1)),
            at_risk_frac=msum((ff < thr).to(torch.float32)) / fcnt,
            degraded_count=deg_count,
        )

    def _run_block_impl(self, state: SchedulerState, rho_trace: torch.Tensor,
                        active=None):
        if (active is not None or self.backend_impl.run_block is not None
                or self._spans_processes()):
            # whole-window traces path: advance the window (fused kernel
            # when the backend has one), then reduce telemetry from the
            # streamed temp/freq traces (gathered from a mesh).  A mesh
            # spanning processes takes it even without a kernel: the
            # per-step records would make a collective every step
            state, telems = self._traces_window(state, rho_trace, active)
        else:
            state, telems = self._run_impl(state, rho_trace)
        return state, telems.reduce()


def sequential_step(sched: ThermalScheduler, states: list[SchedulerState],
                    rho) -> tuple[list[SchedulerState],
                                  list[SchedulerOutput]]:
    """Per-package Python-loop reference: one `update` call per package.

    This is the baseline the fleet engine is benchmarked and verified
    against.  rho: [n_packages, n_tiles].
    """
    nxt, outs = [], []
    for i, st in enumerate(states):
        st, out = sched.update(st, rho[i])
        nxt.append(st)
        outs.append(out)
    return nxt, outs
