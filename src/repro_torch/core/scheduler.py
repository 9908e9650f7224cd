"""ThermalScheduler — the paper's firmware layer, one closed-loop step at a time.

Port of `repro.core.scheduler`.  One `update` call is one serving step:
density → filtration → PDU-gate hint → control law → pole-bank plant →
event count.

State contract:

  * `SchedulerState` is a NamedTuple of tensors; `update` returns a NEW
    state and leaves its input untouched — rebind the returned state.
  * Batching is by LEADING axes: `init(batch_shape=(n,))` gives every
    per-tile leaf a leading [n] axis.  The scalar leaves (``step`` and the
    filtration ``ptr``) are fleet-wide clocks, not per-package state: they
    live on the host as 0-dim int32 tensors, so every branch taken on them
    (the wraparound refresh, the reactive_poll sensor phase) is a host
    decision.

  * `PackageParams` rows (per-package process variation, §10) batch the
    same way and ride in the state; their η is derived eagerly with the
    plant's own f32 ops (`plant._eta_f32`), and the budget multiplies by
    the explicit reciprocal of η·ΣG, so a heterogeneous fleet whose draws
    all equal the fingerprint bit-matches the homogeneous one.

Modes: ``v24``, ``reactive``, ``reactive_poll`` and ``off``, with both
``filtration_impl`` values, on every plant rung (``pole``, ``grid``,
``rom``; the plant supplies the state, its step and η/ΣG).  Per-package
planes: ``heterogeneous`` (pole plant only), ``degraded_fallback`` (the
staleness counter and hysteresis latch on non-finite density) and
``mixed_mode`` (the operator's per-lane reactive pin), the last two on v24.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import fma_f32, pow_f32, resolve_device
from repro_torch.core import pdu_gate, thermal
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
    # per-package process variation: the state carries `PackageParams`
    # (pole decay/gain, preposition fraction, polling period) and every
    # batch lane runs ITS OWN physics — the §10 Monte-Carlo object
    heterogeneous: bool = False
    # ``reactive_poll`` baseline knobs
    throttle_level: float = 0.55   # emergency floor while throttled
    resume_below_c: float = 66.0   # hysteresis: throttled until T ≤ this
    recover_ms: float = 100.0      # ramp-back time constant
    poll_interval_ms: float = 25.0 # homogeneous polling period
    # graceful degradation (v24 only): a package whose density words go
    # non-finite (a late, dropped or corrupted hint chunk) holds its last
    # finite ρ and, after ``stale_limit_steps`` stale steps, falls back to
    # the reactive_poll floor; it recovers after ``recover_steps`` fresh ones
    degraded_fallback: bool = False
    stale_limit_steps: int = 5     # consecutive stale steps before fallback
    recover_steps: int = 10        # consecutive fresh steps before recovery
    # operator-settable per-lane controller mode (v24 only): the state's
    # ``ctrl_mode`` [*batch] bool plane pins a lane to reactive_poll; it ORs
    # with the staleness latch when both are on
    mixed_mode: bool = False
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


class PackageParams(NamedTuple):
    """Per-package process/deployment draws riding IN the state (§10.1).

    Leaves broadcast against the state's [*batch, n_tiles, ...] layout: the
    tile axis is 1 (one draw per package) or n_tiles (one draw per tile —
    how the Monte-Carlo harness packs trials onto tile lanes).  ``eta`` and
    ``gain_sum`` are derived eagerly (`ThermalScheduler.package_params`).
    """

    decay: torch.Tensor      # [*batch, n_tiles | 1, n_poles]  a = exp(−dt/τ)
    gain: torch.Tensor       # [*batch, n_tiles | 1, n_poles]  G [°C/W]
    eta: torch.Tensor        # [*batch, n_tiles | 1]  1 − a_slow^(Δt_la/dt)
    gain_sum: torch.Tensor   # [*batch, n_tiles | 1]  Σ G (= Rth)
    poll_ticks: torch.Tensor # [*batch, n_tiles | 1] int32 — OEM poll period


class SchedulerState(NamedTuple):
    """Leaves carry leading batch dims ([*batch, ...]); ``step`` and the
    filtration ``ptr`` are shared host clocks."""

    thermal: torch.Tensor           # [..., n_tiles, n_poles]
    filtration: "pdu_gate.FiltrationStats | pdu_gate.Filtration"
    freq: torch.Tensor              # [..., n_tiles]
    step: torch.Tensor              # host 0-dim int32
    events: torch.Tensor            # [...] int32 — T_crit crossings (want 0)
    # per-package physics (heterogeneous) — None: every package on the
    # scheduler's fingerprint poles
    pkg: "PackageParams | None" = None
    # hysteresis latch [..., n_tiles] bool — reactive_poll, the degraded
    # fallback and mixed mode (None otherwise)
    throttled: "torch.Tensor | None" = None
    # degraded-fallback plane (per PACKAGE: one hint stream per package)
    rho_last: "torch.Tensor | None" = None   # [..., n_tiles] last finite ρ
    stale: "torch.Tensor | None" = None      # [...] int32 staleness counter
    degraded: "torch.Tensor | None" = None   # [...] bool — on reactive floor
    # operator controller-mode plane (mixed_mode): True pins reactive_poll
    ctrl_mode: "torch.Tensor | None" = None  # [...] bool


class SchedulerOutput(NamedTuple):
    freq: torch.Tensor              # [..., n_tiles] frequency multiplier this step
    temp_c: torch.Tensor            # [..., n_tiles] junction temperature
    hint_w: torch.Tensor            # [..., n_tiles] H(t) pre-position hint [W]
    eta: torch.Tensor               # scalar preposition fraction
    at_risk: torch.Tensor           # [..., n_tiles] bool straggler-risk flags
    balance: torch.Tensor           # [..., n_tiles] work-rebalance weights (sum=1)


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
        if cfg.degraded_fallback and cfg.mode != "v24":
            raise ValueError(
                f"degraded_fallback=True requires mode='v24' (the fallback "
                f"IS reactive_poll — mode {cfg.mode!r} has no predictive "
                f"layer to degrade from)")
        if cfg.degraded_fallback and (cfg.stale_limit_steps < 1
                                      or cfg.recover_steps < 1):
            raise ValueError("stale_limit_steps and recover_steps must be "
                             ">= 1")
        if cfg.mixed_mode and cfg.mode != "v24":
            raise ValueError(
                f"mixed_mode=True requires mode='v24' (per-lane pins shift "
                f"lanes v24 <-> reactive_poll — mode {cfg.mode!r} has no "
                f"predictive layer to pin away from)")
        if cfg.plant not in plant_mod.available_plants():
            raise ValueError(
                f"unknown plant {cfg.plant!r} (available: "
                f"{', '.join(plant_mod.available_plants())})")
        if cfg.heterogeneous and cfg.plant != "pole":
            raise ValueError(
                "heterogeneous=True requires plant='pole' — per-package "
                "PackageParams draws override the fingerprint pole bank; "
                f"plant {cfg.plant!r} has no per-package override")
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
    def package_params(self, poles: thermal.PoleParams | None = None,
                       poll_ticks=None,
                       batch_shape: tuple[int, ...] = ()) -> PackageParams:
        """Per-package draws for a heterogeneous fleet.

        ``poles``: a `thermal.PoleParams` bank with decay/gain shaped
        [*batch, n_tiles | 1, n_poles] (an [*batch, n_poles] bank gains a
        tile axis).  ``None`` replicates the scheduler's fingerprint poles
        — identical draws that bit-match the homogeneous path.
        ``poll_ticks``: [*batch, n_tiles | 1]-broadcastable integer polling
        periods (default: the config's).  η and ΣG are derived here,
        eagerly, in f32, on the host: the draws are experiment inputs.
        """
        c, dev = self.cfg, self.device
        if self.poles is None:
            raise ValueError(
                f"package_params requires a pole-family plant "
                f"(plant={c.plant!r} carries no pole bank)")
        if poles is None:
            shape = lambda x: batch_shape + (1,) + tuple(np.shape(x))
            poles = thermal.PoleParams(
                decay=np.broadcast_to(self.poles.decay,
                                      shape(self.poles.decay)),
                gain=np.broadcast_to(self.poles.gain, shape(self.poles.gain)))
        host = lambda x: (x.detach().cpu().numpy() if torch.is_tensor(x)
                          else np.asarray(x)).astype(np.float32)
        decay, gain = host(poles.decay), host(poles.gain)
        if decay.ndim == len(batch_shape) + 1:     # [*batch, n_poles]
            decay, gain = decay[..., None, :], gain[..., None, :]
        n_poles = np.shape(self.poles.decay)[0]
        if decay.shape[-1] != n_poles or gain.shape != decay.shape:
            raise ValueError(
                f"per-package poles must carry decay/gain "
                f"[*batch, n_tiles|1, {n_poles}], got {decay.shape} / "
                f"{gain.shape}")
        if poll_ticks is None:
            poll_ticks = np.full(decay.shape[:-1], self.poll_ticks, np.int32)
        poll = (poll_ticks.detach().cpu().numpy() if torch.is_tensor(poll_ticks)
                else np.asarray(poll_ticks)).astype(np.int32)
        eta = plant_mod._eta_f32(decay[..., -1], c.lookahead_ms / c.step_ms)
        put = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)
        return PackageParams(decay=put(decay), gain=put(gain), eta=put(eta),
                             gain_sum=put(gain).sum(-1), poll_ticks=put(poll))

    def init(self, batch_shape: tuple[int, ...] = (),
             pkg: PackageParams | None = None,
             filtration_fill=None) -> SchedulerState:
        """Fresh state; ``batch_shape`` prepends fleet/package dimensions.

        With ``heterogeneous`` the state carries ``pkg`` (default:
        fingerprint replicas, see `package_params`).  ``filtration_fill``
        overrides the ring's seed value (scalar or [*batch, n_tiles]-
        broadcastable; the Monte-Carlo harness seeds each trial with its
        trace's opening density), and seeds the fallback's held ρ.
        """
        c, dev = self.cfg, self.device
        if pkg is not None and not c.heterogeneous:
            raise ValueError("per-package draws require "
                             "SchedulerConfig(heterogeneous=True)")
        if c.heterogeneous and pkg is None:
            pkg = self.package_params(batch_shape=batch_shape)
        if pkg is not None and (
                pkg.decay.ndim != len(batch_shape) + 2
                or tuple(pkg.decay.shape[:len(batch_shape)]) != batch_shape
                or pkg.decay.shape[-2] not in (1, c.n_tiles)):
            raise ValueError(
                f"PackageParams.decay must be "
                f"[*{batch_shape}, {c.n_tiles}|1, n_poles], got "
                f"{tuple(pkg.decay.shape)} (build it with "
                f"package_params(..., batch_shape=...))")
        fill = self.fp.rho_min if filtration_fill is None else filtration_fill
        init_ft = (pdu_gate.init_filtration_stats
                   if c.filtration_impl == "incremental"
                   else pdu_gate.init_filtration)
        fb = c.degraded_fallback
        tiles = batch_shape + (c.n_tiles,)
        zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)
        return SchedulerState(
            thermal=self.plant.init_state(batch_shape),
            filtration=init_ft(c.filtration_window, c.n_tiles, fill=fill,
                               batch_shape=batch_shape, device=dev),
            freq=torch.ones(tiles, device=dev),
            step=torch.tensor(0, dtype=torch.int32),
            events=zeros(batch_shape, torch.int32),
            pkg=pkg,
            throttled=(zeros(tiles, torch.bool)
                       if c.mode == "reactive_poll" or fb or c.mixed_mode
                       else None),
            # the held ρ starts at the filtration seed: a lane faulted from
            # its first chunk holds the density its ring was primed with
            rho_last=(torch.as_tensor(fill, dtype=torch.float32, device=dev
                                      ).expand(tiles).clone() if fb else None),
            stale=zeros(batch_shape, torch.int32) if fb else None,
            degraded=zeros(batch_shape, torch.bool) if fb else None,
            ctrl_mode=zeros(batch_shape, torch.bool) if c.mixed_mode else None,
        )

    def _couple(self, p: torch.Tensor) -> torch.Tensor:
        return p if self.gamma is None else apply_coupling(self.gamma, p)

    def _physics(self, st: SchedulerState):
        """(poles, −(1 − η), 1/(η·ΣG), poll) — the plant's constants
        (``poles=None``: the plant steps its own bank), or the state's
        per-package draws, with the same f32 ops on both."""
        if st.pkg is None:
            return (None, self.neg_one_m_eta, self.inv_eta_gain,
                    self.poll_ticks)
        pk = st.pkg
        return (thermal.PoleParams(decay=pk.decay, gain=pk.gain),
                -(1.0 - pk.eta), 1.0 / (pk.eta * pk.gain_sum), pk.poll_ticks)

    def update(self, st: SchedulerState,
               rho) -> tuple[SchedulerState, SchedulerOutput]:
        """Advance one step.  rho: [..., n_tiles] density of the work just
        scheduled; leading dims (if any) must match the state's batch shape."""
        c, fp = self.cfg, self.fp
        rho = torch.as_tensor(rho, dtype=torch.float32,
                              device=self.device).expand(st.freq.shape)

        degraded = stale = None
        if c.degraded_fallback:
            # staleness plane: non-finite density words mark a package whose
            # hint stream is late, dropped or corrupted.  Hold the last
            # finite value (the filtration stays warm) and run the
            # per-package counter with hysteresis; fault-free lanes take
            # the else-branches, so a clean run bit-matches no fallback
            finite = torch.isfinite(rho)
            valid = finite.all(dim=-1)
            rho = torch.where(finite, rho, st.rho_last)
            stale = torch.where(
                valid, (st.stale - 1).clamp(min=0),
                (st.stale + 1).clamp(max=c.stale_limit_steps
                                     + c.recover_steps)).to(torch.int32)
            degraded = ((st.degraded & (stale > 0))
                        | (stale >= c.stale_limit_steps))
        # the effective per-lane reactive mask: staleness latch OR pin
        reactive = degraded
        if st.ctrl_mode is not None:
            reactive = (st.ctrl_mode if reactive is None
                        else reactive | st.ctrl_mode)

        ft = pdu_gate.observe(st.filtration, rho)
        # instantaneous tile power, computed ONCE: it floors the hint below
        # and (scaled by the chosen frequency) drives the plant at the end
        p_now = power_from_rho(rho)
        poles, neg_one_m_eta, inv_eta_gain, poll = self._physics(st)

        if c.mode == "reactive_poll":
            return self._update_reactive_poll(st, ft, p_now, poles, poll)

        dt_now = self.plant.delta_t(st.thermal)
        t_allow = fp.t_crit_c - c.t_safe_margin_c - fp.t_ambient_c

        if c.mode == "v24":
            hint = pdu_gate.hint(ft, self.gamma, c.lookahead_ms, c.step_ms)
            # instantaneous load floors the hint: prediction buys lead time,
            # never permission to exceed budget on a mispredicted onset
            hint = torch.maximum(hint, self._couple(p_now))
            budget = fma_f32(neg_one_m_eta, dt_now, t_allow) * inv_eta_gain
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

        throttled = st.throttled
        if reactive is None:
            p_eff = self._couple(p_now * freq ** c.power_exponent)
            thermal_next = self.plant.step(st.thermal, p_eff, poles=poles)
            temp = fp.t_ambient_c + self.plant.delta_t(thermal_next)
            events = st.events + (temp > fp.t_crit_c).any(dim=-1).to(
                torch.int32)
        else:
            # merged plant: reactive lanes (degraded or pinned) run
            # reactive_poll semantics — the plant at LAST step's frequency,
            # the sensor polling the post-step junction, the latch carrying
            # the hysteresis — v24 lanes take the predictive law; the plant
            # steps ONCE at the per-lane blended frequency
            deg_t = reactive[..., None]
            f_used = torch.where(deg_t, st.freq, freq)
            p_eff = self._couple(p_now * f_used ** c.power_exponent)
            thermal_next = self.plant.step(st.thermal, p_eff, poles=poles)
            temp = fp.t_ambient_c + self.plant.delta_t(thermal_next)
            polled = (int(st.step) % poll) == 0
            trig = (temp >= fp.t_crit_c) & polled
            cool = (temp <= c.resume_below_c) & polled
            throttled = torch.where(deg_t, (st.throttled | trig) & ~cool,
                                    False)
            freq = torch.where(
                deg_t,
                torch.where(throttled, c.throttle_level,
                            torch.clamp(st.freq + self.ramp, max=1.0)),
                freq)
            # reactive lanes count fresh throttle engagements, v24 lanes
            # T_crit crossings
            events = st.events + torch.where(
                reactive, (trig & ~st.throttled).any(dim=-1),
                (temp > fp.t_crit_c).any(dim=-1)).to(torch.int32)
            hint = torch.where(deg_t, p_eff, hint)

        return (st._replace(thermal=thermal_next, filtration=ft, freq=freq,
                            step=st.step + 1, events=events,
                            throttled=throttled,
                            rho_last=rho if degraded is not None
                            else st.rho_last,
                            stale=stale if stale is not None else st.stale,
                            degraded=degraded if degraded is not None
                            else st.degraded),
                self._output(freq, temp, hint))

    def _output(self, freq, temp, hint) -> SchedulerOutput:
        c = self.cfg
        balance = freq / freq.sum(dim=-1, keepdim=True).clamp(min=1e-6)
        return SchedulerOutput(freq=freq, temp_c=temp, hint_w=hint,
                               eta=torch.tensor(self.eta, dtype=torch.float32),
                               at_risk=freq < c.straggler_threshold,
                               balance=balance)

    def _update_reactive_poll(self, st: SchedulerState, ft, p_now, poles,
                              poll) -> tuple[SchedulerState, SchedulerOutput]:
        """§9 baseline: reactive DVFS + temperature polling with hysteresis.

        The plant runs at the frequency DECIDED LAST STEP (`st.freq`), the
        sensor only observes the post-step junction every ``poll`` steps
        (per package under heterogeneity; phase = the fleet's global step),
        and the throttle latch releases only once the junction cools below
        ``resume_below_c``.  ``events`` counts fresh throttle engagements,
        not T_crit crossings.
        """
        c, fp = self.cfg, self.fp
        p_eff = self._couple(p_now * st.freq ** c.power_exponent)
        thermal_next = self.plant.step(st.thermal, p_eff, poles=poles)
        temp = fp.t_ambient_c + self.plant.delta_t(thermal_next)

        polled = (int(st.step) % poll) == 0
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
