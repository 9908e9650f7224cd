"""Profile-group dispatch — one fleet running a fidelity MIX.

Port of `repro.fleet.groups`.  `FleetEngine` is one scheduler config per
fleet: one plant fidelity, stepped under one backend path.
`GroupedFleetEngine` lets a fleet mix plant fidelities per lane: lanes are
grouped by plant family into sub-fleets, each stepped under its own
backend path — pole / ROM groups keep the fused whole-window kernel
(`fleet_step`, one launch a window on a card), grid groups take the
per-step path (`FusedBackend` drops `run_block` for a non-pole family) —
with telemetry merged back into ONE flush record.

Lane order is GROUP-BLOCKED and stable: global lane ``i`` is
``offset(group) + local_lane``, groups keep their construction order and
offsets are the running sum of the group sizes.  Per-lane trajectories
equal running each group as its own homogeneous fleet (lanes are
independent; only the telemetry reductions cross them), so the mixed fleet
is gated per lane against per-group oracles (tests/test_torch_groups.py).

The telemetry merge reuses the engine's split reduction: each group derives
its per-step event / degraded planes under ITS config
(`FleetEngine._event_plane`), the planes are summed, the traces are
concatenated in group order, and `FleetEngine._traces_record` reduces the
whole fleet once — percentiles, MTPS splits and event counters cover the
mix as one fleet, and an ``active`` mask spans the global lane axis.

State is a plain ``{group: SchedulerState}`` dict.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.fingerprint import FINGERPRINT, Fingerprint
from repro_torch.core.scheduler import SchedulerConfig, SchedulerState
from repro_torch.fleet.engine import FleetEngine, _stack

__all__ = ["GroupedFleetEngine"]

_I32 = torch.int32


class GroupedFleetEngine:
    """Sub-fleet-per-plant-group dispatch behind the FleetEngine surface.

    ``groups`` is an ordered tuple of plant names (see
    `repro_torch.core.plant.available_plants`); each gets its own
    `FleetEngine` over ``cfg`` with that plant substituted, on ``device``
    (CUDA unless asked otherwise).  Heterogeneous per-package draws
    (`PackageParams`, node banks) apply to the ``pole`` group only — the
    scheduler's heterogeneous path is pole-exact — so grid / ROM groups run
    their group-homogeneous physics.

    State is ``{group: SchedulerState}``; traces and masks span the
    group-blocked global lane axis (group order = construction order).
    """

    def __init__(self, cfg: SchedulerConfig | None = None,
                 fp: Fingerprint = FINGERPRINT,
                 backend: str = "broadcast",
                 groups: tuple[str, ...] = ("pole",), device=None):
        if not groups or len(set(groups)) != len(groups):
            raise ValueError(f"groups must be a non-empty tuple of unique "
                             f"plant names, got {groups!r}")
        self.cfg = cfg = SchedulerConfig() if cfg is None else cfg
        self.fp = fp
        self.groups = tuple(groups)
        self.engines: dict[str, FleetEngine] = {}
        for g in self.groups:
            gcfg = dataclasses.replace(
                cfg, plant=g,
                heterogeneous=cfg.heterogeneous and g == "pole")
            self.engines[g] = FleetEngine(gcfg, fp, backend=backend,
                                          device=device)
        lead = self.engines[self.groups[0]]
        self.backend = lead.backend
        self.device = lead.device

    # ------------------------------------------------------------------ api
    def init(self, counts, pkg=None) -> dict[str, SchedulerState]:
        """Per-group fleet states.  ``counts``: ``{group: n_lanes}`` (or an
        int, replicated to every group); ``pkg``: optional
        ``{group: PackageParams}`` heterogeneous rows (pole groups only)."""
        if isinstance(counts, int):
            counts = {g: counts for g in self.groups}
        if set(counts) != set(self.groups):
            raise ValueError(f"counts must cover exactly the groups "
                             f"{self.groups}, got {tuple(counts)}")
        pkg = pkg or {}
        return {g: self.engines[g].init(int(counts[g]), pkg=pkg.get(g))
                for g in self.groups}

    def lane_slices(self, states) -> dict[str, slice]:
        """Global-lane slice per group (group-blocked order)."""
        out, off = {}, 0
        for g in self.groups:
            n = states[g].freq.shape[0]
            out[g] = slice(off, off + n)
            off += n
        return out

    def n_lanes(self, states) -> int:
        return sum(states[g].freq.shape[0] for g in self.groups)

    def step(self, states, rho, active=None):
        """One fleet step: rho scalar, [n_total] or [n_total, tiles]
        spanning the group-blocked lane axis; returns (states,
        SchedulerOutput, FleetTelemetry) — outputs merged into one record."""
        self._guard(states, None)
        n = self.n_lanes(states)
        rho = torch.as_tensor(rho, dtype=torch.float32, device=self.device)
        if rho.ndim == 1:
            rho = rho[:, None]
        rho = rho.expand(n, self.cfg.n_tiles)
        return self._step_impl(states, rho, self._active(states, active))

    def run_block(self, states, rho_trace, active=None):
        """Advance a [T, n_total, tiles] window; one merged flush record."""
        self._guard(states, rho_trace.shape[1])
        return self._run_block_impl(states, self._put(rho_trace),
                                    self._active(states, active))

    def run_chunked(self, states, rho_trace, flush_every: int, active=None):
        """ceil(T/K) merged flush records over a [T, n_total, tiles] trace
        (tail windows shorten, nothing dropped), stacked into one record
        with [n_flush]-leaved fields, like `FleetEngine.run_chunked`."""
        self._guard(states, rho_trace.shape[1])
        active = self._active(states, active)
        recs = []
        for i in range(0, rho_trace.shape[0], flush_every):
            states, rec = self._run_block_impl(
                states, self._put(rho_trace[i:i + flush_every]), active)
            recs.append(rec)
        return states, _stack(recs)

    def block_traces(self, states, rho_trace):
        """(states', temps [T, n_total, tiles], freqs [T, n_total, tiles])
        concatenated in group order."""
        sl = self.lane_slices(states)
        rho_trace = self._put(rho_trace)
        new, temps, freqs = {}, [], []
        for g in self.groups:
            st, tg, fg = self.engines[g].block_traces(states[g],
                                                      rho_trace[:, sl[g]])
            new[g] = st
            temps.append(tg)
            freqs.append(fg)
        return new, torch.cat(temps, 1), torch.cat(freqs, 1)

    def describe(self) -> str:
        return f"groups[{','.join(self.groups)}]@{self.backend}"

    # ------------------------------------------------------------ internals
    def _put(self, rho_trace) -> torch.Tensor:
        return self.engines[self.groups[0]].backend_impl.put_trace(rho_trace)

    def _active(self, states, active):
        if active is None:
            return None
        n = self.n_lanes(states)
        arr = self.engines[self.groups[0]].backend_impl.put_mask(active)
        if tuple(arr.shape) != (n,) or arr.dtype != torch.bool:
            raise ValueError(f"active mask must be a [{n}] bool array, got "
                             f"shape {tuple(arr.shape)} dtype {arr.dtype}")
        return arr

    def _guard(self, states, n_lanes) -> None:
        if set(states) != set(self.groups):
            raise ValueError(f"state dict must cover exactly the groups "
                             f"{self.groups}, got {tuple(states)}")
        if n_lanes is not None and n_lanes != self.n_lanes(states):
            raise ValueError(
                f"trace lane axis ({n_lanes}) must span the group-blocked "
                f"fleet ({self.n_lanes(states)} lanes: "
                + ", ".join(f"{g}={states[g].freq.shape[0]}"
                            for g in self.groups) + ")")

    def _split_mask(self, states, active):
        if active is None:
            return {g: None for g in self.groups}
        sl = self.lane_slices(states)
        return {g: active[sl[g]] for g in self.groups}

    def _prev_events(self, states, act):
        tot = torch.zeros((), dtype=_I32, device=self.device)
        for g in self.groups:
            ev = states[g].events
            tot = tot + (ev.sum(dtype=_I32) if act[g] is None
                         else torch.where(act[g], ev, 0).sum(dtype=_I32))
        return tot

    def _run_block_impl(self, states, rho_trace, active=None):
        """One merged flush record: per-group traces and event planes under
        each group's OWN config, reduced once fleet-wide."""
        sl = self.lane_slices(states)
        act = self._split_mask(states, active)
        prev_events = self._prev_events(states, act)
        new, temps_l, freqs_l, rho_l = {}, [], [], []
        ev_step = deg_count = 0
        for g in self.groups:
            eng, st0 = self.engines[g], states[g]
            rho_g = rho_trace[:, sl[g]]
            st, temps, freqs = eng.block_traces(st0, rho_g)
            ev_g, deg_g, rho_g = eng._event_plane(rho_g, temps, st0, act[g])
            new[g] = st
            temps_l.append(temps)
            freqs_l.append(freqs)
            rho_l.append(rho_g)
            ev_step = ev_step + ev_g
            deg_count = deg_count + deg_g
        lead = self.engines[self.groups[0]]
        telem = lead._traces_record(
            torch.cat(rho_l, 1), torch.cat(temps_l, 1),
            torch.cat(freqs_l, 1), prev_events, ev_step, deg_count, active)
        return new, telem.reduce()

    def _step_impl(self, states, rho, active=None):
        """One merged per-step record: per-group backend updates, outputs
        concatenated, the lead engine's masked reduction covering the mix
        (a full-true mask when no mask is given — the same interpolated
        percentiles as the trace path)."""
        sl = self.lane_slices(states)
        act = self._split_mask(states, active)
        prev_events = self._prev_events(states, act)
        new, outs = {}, []
        deg = torch.zeros((), dtype=_I32, device=self.device)
        rho = rho.clone()
        for g in self.groups:
            eng = self.engines[g]
            st, out = eng.backend_impl.update(states[g], rho[sl[g]])
            if eng.cfg.degraded_fallback:
                rho[sl[g]] = st.rho_last
            new[g] = st
            outs.append(out)
            deg = deg + eng._degraded_count(st, act[g])
        cat = lambda field: torch.cat([getattr(o, field) for o in outs], 0)
        out = outs[0]._replace(
            freq=cat("freq"), temp_c=cat("temp_c"), hint_w=cat("hint_w"),
            at_risk=cat("at_risk"), balance=cat("balance"))
        events = torch.cat([new[g].events for g in self.groups])
        mask = (torch.ones(self.n_lanes(states), dtype=torch.bool,
                           device=self.device)
                if active is None else active)
        lead = self.engines[self.groups[0]]
        telem = lead._masked_step_telemetry(rho, out, prev_events, events,
                                            mask, deg)
        return new, out, telem
