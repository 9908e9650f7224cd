"""ThermalScheduler — the paper's firmware layer, one closed-loop step at a time.

Port of `repro.core.scheduler` (homogeneous fleets).  One `update` call is
one serving step: density → filtration → PDU-gate hint → control law →
pole-bank plant → event count.

State contract:

  * `SchedulerState` is a NamedTuple of tensors; `update` returns a NEW
    state and leaves its input untouched — rebind the returned state.
  * Batching is by LEADING axes: `init(batch_shape=(n,))` gives every
    per-tile leaf a leading [n] axis.  The scalar leaves (``step`` and the
    filtration ``ptr``) are fleet-wide clocks, not per-package state: they
    live on the host as 0-dim int32 tensors, so every branch taken on them
    (the wraparound refresh, the reactive_poll sensor phase) is a host
    decision.

Modes ported: ``v24``, ``reactive``, ``reactive_poll`` and ``off``, with
both ``filtration_impl`` values, on every plant rung (``pole``, ``grid``,
``rom``; the plant supplies the state, its step and η/ΣG).
``heterogeneous``, ``degraded_fallback`` and ``mixed_mode`` raise until they
are ported (ROADMAP queue 1 step 5).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import fma_f32, pow_f32, resolve_device
from repro_torch.core import pdu_gate
from repro_torch.core import plant as plant_mod
from repro_torch.core.coupling import (apply_coupling, coupling_matrix,
                                       row_normalise)
from repro_torch.core.density import power_from_rho
from repro_torch.core.fingerprint import FINGERPRINT, Fingerprint


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    n_tiles: int = 1
    # v24 | reactive | reactive_poll | off.  ``reactive_poll`` is the §9/§10
    # baseline row ("reactive DVFS + temperature polling"): the sensor loop
    # only observes the junction every poll interval, with throttle
    # hysteresis.
    mode: str = "v24"
    two_pole: bool = True          # V7.0 kernel (V24 single-pole if False)
    use_coupling: bool = True      # V7.0 N×N Γ (identity if False)
    step_ms: float = 10.0          # wall-time of one step
    lookahead_steps: int = 3       # hint horizon in steps (≈ 20–50 ms)
    filtration_window: int = 16    # Ft depth in steps
    # "incremental" (O(1)/step sliding statistics — the serving fast path)
    # or "ring" (O(W)/step gather + refit — the oracle)
    filtration_impl: str = "incremental"
    t_safe_margin_c: float = 1.0
    power_exponent: float = 3.0
    straggler_threshold: float = 0.9   # f below this ⇒ tile flagged at-risk
    heterogeneous: bool = False    # per-package physics — not ported yet
    # ``reactive_poll`` baseline knobs
    throttle_level: float = 0.55   # emergency floor while throttled
    resume_below_c: float = 66.0   # hysteresis: throttled until T ≤ this
    recover_ms: float = 100.0      # ramp-back time constant
    poll_interval_ms: float = 25.0 # homogeneous polling period
    degraded_fallback: bool = False  # in-graph stale-hint fallback — not ported
    mixed_mode: bool = False       # operator per-lane mode pins — not ported
    # thermal-plant fidelity rung (`repro_torch.core.plant`): "pole" is the
    # paper's bank, "grid" the spatial RC-grid ground truth, "rom" the
    # reduced-order bank fit from it
    plant: str = "pole"
    grid_cells: int = 8            # cells per tile edge (gy = gx patches)
    grid_kappa: float = 0.35       # lateral / vertical conductance ratio
    grid_contrast: float = 0.5     # bridge-shadow g_v reduction (§5.2 EMIB)
    grid_substeps: int = 1         # Euler substeps per scheduler step
    rom_poles: int = 3             # fitted ROM bank size
    rom_fit_steps: int = 2048      # step-response window the fit regresses

    @property
    def lookahead_ms(self) -> float:
        return self.lookahead_steps * self.step_ms


class SchedulerState(NamedTuple):
    """Leaves carry leading batch dims ([*batch, ...]); ``step`` and the
    filtration ``ptr`` are shared host clocks."""

    thermal: torch.Tensor           # [..., n_tiles, n_poles]
    filtration: "pdu_gate.FiltrationStats | pdu_gate.Filtration"
    freq: torch.Tensor              # [..., n_tiles]
    step: torch.Tensor              # host 0-dim int32
    events: torch.Tensor            # [...] int32 — T_crit crossings (want 0)
    pkg: None = None                # per-package draws (not ported)
    # reactive_poll hysteresis latch [..., n_tiles] bool (None otherwise)
    throttled: "torch.Tensor | None" = None
    rho_last: None = None           # degraded-fallback plane (not ported)
    stale: None = None
    degraded: None = None
    ctrl_mode: None = None          # operator mode plane (not ported)


class SchedulerOutput(NamedTuple):
    freq: torch.Tensor              # [..., n_tiles] frequency multiplier this step
    temp_c: torch.Tensor            # [..., n_tiles] junction temperature
    hint_w: torch.Tensor            # [..., n_tiles] H(t) pre-position hint [W]
    eta: torch.Tensor               # scalar preposition fraction
    at_risk: torch.Tensor           # [..., n_tiles] bool straggler-risk flags
    balance: torch.Tensor           # [..., n_tiles] work-rebalance weights (sum=1)


def _not_ported(what: str, step: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: ROADMAP queue 1 step {step}")


class ThermalScheduler:
    """Pure-functional scheduler: `state = init(); state, out = update(state, ρ)`."""

    def __init__(self, cfg: SchedulerConfig | None = None,
                 fp: Fingerprint = FINGERPRINT, device=None):
        cfg = SchedulerConfig() if cfg is None else cfg
        if cfg.filtration_impl not in ("incremental", "ring"):
            raise ValueError(f"unknown filtration_impl "
                             f"{cfg.filtration_impl!r} (incremental|ring)")
        if cfg.mode not in ("v24", "reactive", "reactive_poll", "off"):
            raise ValueError(f"unknown mode {cfg.mode!r} "
                             f"(v24|reactive|reactive_poll|off)")
        for flag in ("heterogeneous", "degraded_fallback", "mixed_mode"):
            if getattr(cfg, flag):
                raise _not_ported(f"SchedulerConfig({flag}=True)", 5)
        self.cfg = cfg
        self.fp = fp
        self.device = resolve_device(device)
        self.plant = plant_mod.make_plant(cfg, fp, device=self.device)
        self.poles = self.plant.poles
        self.gamma = None
        if cfg.use_coupling and cfg.n_tiles > 1:
            # per-tile Γ row-sum normalisation keeps multi-tile steady state
            # in the single-tile °C/W fingerprint frame
            self.gamma = row_normalise(
                coupling_matrix(cfg.n_tiles)).to(self.device)
        self.eta = self.plant.eta
        # the control law's f32 constants: −(1 − η), 1/(η·ΣG) (an f32
        # product and quotient as in the reference; per tile for a fitted
        # ROM, whose ΣG is [n_tiles]) and the 1/exponent power
        self.neg_one_m_eta = float(-np.float32(1.0 - self.eta))
        self.inv_exp = float(np.float32(1.0 / cfg.power_exponent))
        inv = np.float32(1.0) / (np.float32(self.eta) * np.asarray(
            self.plant.gain_sum, np.float32))
        self.inv_eta_gain = (float(inv) if inv.ndim == 0 else
                             torch.as_tensor(inv, device=self.device))
        # reactive_poll ramp-back per step
        self.ramp = (1.0 - cfg.throttle_level) / max(
            int(cfg.recover_ms / cfg.step_ms), 1)
        self.poll_ticks = max(int(cfg.poll_interval_ms / cfg.step_ms), 1)

    # ------------------------------------------------------------------ api
    def init(self, batch_shape: tuple[int, ...] = (), pkg=None,
             filtration_fill=None) -> SchedulerState:
        """Fresh state; ``batch_shape`` prepends fleet/package dimensions.

        ``filtration_fill`` overrides the ring's seed value (scalar or
        [*batch, n_tiles]-broadcastable).
        """
        if pkg is not None:
            raise _not_ported("per-package PackageParams", 5)
        c, dev = self.cfg, self.device
        fill = self.fp.rho_min if filtration_fill is None else filtration_fill
        init_ft = (pdu_gate.init_filtration_stats
                   if c.filtration_impl == "incremental"
                   else pdu_gate.init_filtration)
        return SchedulerState(
            thermal=self.plant.init_state(batch_shape),
            filtration=init_ft(c.filtration_window, c.n_tiles, fill=fill,
                               batch_shape=batch_shape, device=dev),
            freq=torch.ones(batch_shape + (c.n_tiles,), device=dev),
            step=torch.tensor(0, dtype=torch.int32),
            events=torch.zeros(batch_shape, dtype=torch.int32, device=dev),
            throttled=(torch.zeros(batch_shape + (c.n_tiles,),
                                   dtype=torch.bool, device=dev)
                       if c.mode == "reactive_poll" else None),
        )

    def _couple(self, p: torch.Tensor) -> torch.Tensor:
        return p if self.gamma is None else apply_coupling(self.gamma, p)

    def update(self, st: SchedulerState,
               rho) -> tuple[SchedulerState, SchedulerOutput]:
        """Advance one step.  rho: [..., n_tiles] density of the work just
        scheduled; leading dims (if any) must match the state's batch shape."""
        c, fp = self.cfg, self.fp
        rho = torch.as_tensor(rho, dtype=torch.float32,
                              device=self.device).expand(st.freq.shape)

        ft = pdu_gate.observe(st.filtration, rho)
        # instantaneous tile power, computed ONCE: it floors the hint below
        # and (scaled by the chosen frequency) drives the plant at the end
        p_now = power_from_rho(rho)

        if c.mode == "reactive_poll":
            return self._update_reactive_poll(st, ft, p_now)

        dt_now = self.plant.delta_t(st.thermal)
        t_allow = fp.t_crit_c - c.t_safe_margin_c - fp.t_ambient_c

        if c.mode == "v24":
            hint = pdu_gate.hint(ft, self.gamma, c.lookahead_ms, c.step_ms)
            # instantaneous load floors the hint: prediction buys lead time,
            # never permission to exceed budget on a mispredicted onset
            hint = torch.maximum(hint, self._couple(p_now))
            budget = fma_f32(self.neg_one_m_eta, dt_now,
                             t_allow) * self.inv_eta_gain
            f_uni = torch.clamp(
                pow_f32(budget / hint.clamp(min=1e-3), self.inv_exp),
                0.05, 1.0)
            if self.gamma is None:
                freq = f_uni
            else:
                # coupled control, two bounding laws (both must hold): the
                # uniform law and the coupled law (only the self term is
                # controllable, the neighbour heat at last step's f is
                # subtracted); upward moves are slew-limited
                gd = torch.diagonal(self.gamma)
                p_prev = p_now * st.freq ** c.power_exponent
                neigh = apply_coupling(self.gamma, p_prev) - gd * p_prev
                f_cpl = torch.clamp(pow_f32(
                    (budget - neigh).clamp(min=1e-6)
                    / (gd * p_now).clamp(min=1e-3), self.inv_exp), 0.05, 1.0)
                freq = torch.minimum(f_uni, f_cpl)
                freq = torch.minimum(freq, st.freq + 0.05)   # slew limit up
        elif c.mode == "reactive":
            hot = (fp.t_ambient_c + dt_now) >= fp.t_crit_c
            freq = torch.where(hot, fp.throttle_floor,
                               torch.clamp(st.freq + 0.1, max=1.0))
        else:  # off — uncontrolled
            freq = torch.ones_like(st.freq)

        if c.mode != "v24":
            # the reported hint falls back to the instantaneous load floor
            hint = self._couple(p_now)

        p_eff = self._couple(p_now * freq ** c.power_exponent)
        thermal_next = self.plant.step(st.thermal, p_eff)
        temp = fp.t_ambient_c + self.plant.delta_t(thermal_next)
        events = st.events + (temp > fp.t_crit_c).any(dim=-1).to(torch.int32)
        return (st._replace(thermal=thermal_next, filtration=ft, freq=freq,
                            step=st.step + 1, events=events),
                self._output(freq, temp, hint))

    def _output(self, freq, temp, hint) -> SchedulerOutput:
        c = self.cfg
        balance = freq / freq.sum(dim=-1, keepdim=True).clamp(min=1e-6)
        return SchedulerOutput(freq=freq, temp_c=temp, hint_w=hint,
                               eta=torch.tensor(self.eta, dtype=torch.float32),
                               at_risk=freq < c.straggler_threshold,
                               balance=balance)

    def _update_reactive_poll(self, st: SchedulerState, ft, p_now
                              ) -> tuple[SchedulerState, SchedulerOutput]:
        """§9 baseline: reactive DVFS + temperature polling with hysteresis.

        The plant runs at the frequency DECIDED LAST STEP (`st.freq`), the
        sensor only observes the post-step junction every ``poll_ticks``
        (phase = the fleet's global step), and the throttle latch releases
        only once the junction cools below ``resume_below_c``.  ``events``
        counts fresh throttle engagements, not T_crit crossings.
        """
        c, fp = self.cfg, self.fp
        p_eff = self._couple(p_now * st.freq ** c.power_exponent)
        thermal_next = self.plant.step(st.thermal, p_eff)
        temp = fp.t_ambient_c + self.plant.delta_t(thermal_next)

        polled = int(st.step) % self.poll_ticks == 0
        trig = (temp >= fp.t_crit_c) & polled
        cool = (temp <= c.resume_below_c) & polled
        events = st.events + (trig & ~st.throttled).any(dim=-1).to(
            torch.int32)
        throttled = (st.throttled | trig) & ~cool
        freq = torch.where(throttled, c.throttle_level,
                           torch.clamp(st.freq + self.ramp, max=1.0))
        return (st._replace(thermal=thermal_next, filtration=ft, freq=freq,
                            step=st.step + 1, events=events,
                            throttled=throttled),
                self._output(freq, temp, p_eff))
