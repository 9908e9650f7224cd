"""Effect ① — DVFS sawtooth baseline vs V24 pre-emptive voltage pre-positioning.

Port of `repro.core.dvfs`.  Paper §3.1: LLM token-generation spikes drive the
junction to the critical threshold within milliseconds; reactive DVFS
throttles to 55–70 % of peak, a sawtooth.  V24 issues H(t) =
P_EIC(t + Δt_la | Ft) 20–50 ms ahead, so pre-positioned headroom absorbs the
surge.  Both controllers are loops over a 1 kHz density trace sharing one
thermal plant (`core.thermal`); power model P(ρ, f) = P(ρ)·f³.

  * released compute = perf_V24 / perf_baseline − 1 (paper: +20–30 %);
  * peak temperature ≤ 85 °C under V24, no frequency-reduction events.

Rounding follows the reference's compiled loop: the plant update
a·s + (1 − a)·G·P is one FMA over the rounded drive term (`_plant_step`),
the budget t_allow − (1 − η)·ΔT one FMA times the f32 reciprocal of η·ΣG,
and the control law's fractional power is correctly rounded (`pow_f32`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import fma_f32, pow_f32
from repro_torch.core import pdu_gate, thermal
from repro_torch.core.coupling import apply_coupling
from repro_torch.core.density import power_from_rho
from repro_torch.core.fingerprint import FINGERPRINT, Fingerprint


@dataclasses.dataclass(frozen=True)
class DVFSConfig:
    dt_ms: float = 1.0
    lookahead_ms: float = 35.0         # mid of the 20–50 ms window
    filtration_window: int = 64        # Ft depth (64 ms of 1 kHz history)
    t_safe_margin_c: float = 0.5       # controller aims at T_crit − margin
    throttle_level: float = 0.55       # reactive emergency floor (55–70 % band)
    resume_below_c: float = 66.0       # hysteresis: stay throttled until T ≤ this
    recover_ms: float = 100.0          # reactive ramp-back
    power_exponent: float = 3.0        # P ∝ f³ (V tracks f)
    poll_interval_ms: float = 25.0     # baseline temperature-polling period


class SimResult(NamedTuple):
    freq: torch.Tensor         # [T, n_tiles] frequency multiplier (relative perf)
    temp: torch.Tensor         # [T, n_tiles] junction temperature [°C]
    events: torch.Tensor       # [] reactive throttle trigger events
    perf: torch.Tensor         # [] mean delivered performance (mean f)
    p99_latency: torch.Tensor  # [] 99th-percentile relative token latency (1/f)


def _finish(freqs, temps, events) -> SimResult:
    lat = 1.0 / torch.clamp(freqs, min=1e-6)
    return SimResult(freq=freqs, temp=temps, events=events,
                     perf=freqs.mean(),
                     p99_latency=torch.quantile(lat.flatten(), 0.99))


def _trace2d(rho_trace) -> torch.Tensor:
    rho = torch.as_tensor(rho_trace, dtype=torch.float32)
    return rho[:, None] if rho.ndim == 1 else rho


def _couple(gamma, p):
    return p if gamma is None else apply_coupling(gamma, p)


def _plant_step(poles: thermal.PoleParams, state: torch.Tensor,
                p_eff: torch.Tensor) -> torch.Tensor:
    """`thermal.step` with a·s + drive fused into one FMA, as the reference's
    compiled DVFS loop computes it."""
    decay = torch.as_tensor(poles.decay, dtype=torch.float32,
                            device=state.device)
    gain = torch.as_tensor(poles.gain, dtype=torch.float32,
                           device=state.device)
    return fma_f32(decay, state, (1.0 - decay) * gain * p_eff[..., None])


def simulate_reactive(rho_trace, cfg: DVFSConfig | None = None,
                      fp: Fingerprint = FINGERPRINT, gamma=None,
                      poles: thermal.PoleParams | None = None,
                      poll_ticks: int | None = None) -> SimResult:
    """Baseline: reactive DVFS with temperature polling and hysteresis — the
    sawtooth (paper §3.1).  rho_trace [T] or [T, n_tiles] on the device the
    run should use; ``gamma`` optional [n_tiles, n_tiles]."""
    cfg = DVFSConfig() if cfg is None else cfg
    rho = _trace2d(rho_trace)
    dev, n_tiles = rho.device, rho.shape[1]
    poles = poles if poles is not None else thermal.single_pole(fp, cfg.dt_ms)
    if poll_ticks is None:
        poll_ticks = max(int(cfg.poll_interval_ms / cfg.dt_ms), 1)
    ramp = (1.0 - cfg.throttle_level) / max(int(cfg.recover_ms / cfg.dt_ms), 1)

    st = thermal.init_state(poles, n_tiles, device=dev)
    f = torch.ones((n_tiles,), device=dev)
    throttled = torch.zeros((n_tiles,), dtype=torch.bool, device=dev)
    events = torch.zeros((), dtype=torch.int32, device=dev)
    freqs, temps = [], []
    for k in range(rho.shape[0]):
        p = power_from_rho(rho[k]) * f ** cfg.power_exponent
        st = _plant_step(poles, st, _couple(gamma, p))
        t = fp.t_ambient_c + thermal.delta_t(st)
        polled = k % poll_ticks == 0
        trig = (t >= fp.t_crit_c) & polled
        cool = (t <= cfg.resume_below_c) & polled
        events = events + (trig & ~throttled).any().to(torch.int32)
        throttled = (throttled | trig) & ~cool
        f = torch.where(throttled, cfg.throttle_level,
                        torch.clamp(f + ramp, max=1.0))
        freqs.append(f)
        temps.append(t)
    return _finish(torch.stack(freqs), torch.stack(temps), events)


def simulate_v24(rho_trace, cfg: DVFSConfig | None = None,
                 fp: Fingerprint = FINGERPRINT, gamma=None,
                 poles: thermal.PoleParams | None = None) -> SimResult:
    """V24/V7.0: PDU-Gate hints + pre-positioned headroom — smooth envelope.

    With look-ahead Δt_la the predicted junction rise is
    ΔT(t+Δt_la) ≈ (1−η)·ΔT(t) + η·Rth·Γ·P(ρ̂, f), η = 1 − a_slow^(Δt_la/dt);
    the gate picks the largest f keeping it ≤ T_safe − T_amb, bounded with
    Γ also by the coupled law (self term controllable, neighbour heat at
    last step's f subtracted).
    """
    cfg = DVFSConfig() if cfg is None else cfg
    rho = _trace2d(rho_trace)
    dev, n_tiles = rho.device, rho.shape[1]
    poles = poles if poles is not None else thermal.single_pole(fp, cfg.dt_ms)
    decay = np.asarray(torch.as_tensor(poles.decay).cpu(), np.float32)
    gain = np.asarray(torch.as_tensor(poles.gain).cpu(), np.float32)
    eta = np.float32(1.0) - decay[-1] ** np.float32(cfg.lookahead_ms
                                                     / cfg.dt_ms)
    t_allow = fp.t_crit_c - cfg.t_safe_margin_c - fp.t_ambient_c
    neg_one_m_eta = float(-(np.float32(1.0) - eta))
    inv_eta_gain = float(np.float32(1.0) / (eta * gain.sum()))
    inv_exp = float(np.float32(1.0 / cfg.power_exponent))
    gd = None if gamma is None else torch.diagonal(gamma)

    st = thermal.init_state(poles, n_tiles, device=dev)
    ft = pdu_gate.init_filtration(cfg.filtration_window, n_tiles,
                                  fill=rho[0].mean(), device=dev)
    f_prev = torch.full((n_tiles,), 0.5, device=dev)
    events = torch.zeros((), dtype=torch.int32, device=dev)
    freqs, temps = [], []
    for k in range(rho.shape[0]):
        ft = pdu_gate.observe(ft, rho[k])
        h = pdu_gate.hint(ft, gamma, cfg.lookahead_ms, cfg.dt_ms)
        p_hat = power_from_rho(rho[k])
        h = torch.maximum(h, _couple(gamma, p_hat))
        budget = fma_f32(neg_one_m_eta, thermal.delta_t(st),
                         t_allow) * inv_eta_gain
        f = torch.clamp(pow_f32(budget / h.clamp(min=1e-3), inv_exp),
                        0.05, 1.0)
        if gamma is not None:
            p_prev = p_hat * f_prev ** cfg.power_exponent
            neigh = apply_coupling(gamma, p_prev) - gd * p_prev
            f_cpl = torch.clamp(pow_f32(
                (budget - neigh).clamp(min=1e-6)
                / (gd * p_hat).clamp(min=1e-3), inv_exp), 0.05, 1.0)
            f = torch.minimum(f, f_cpl)
        p = p_hat * f ** cfg.power_exponent
        st = _plant_step(poles, st, _couple(gamma, p))
        t = fp.t_ambient_c + thermal.delta_t(st)
        events = events + (t >= fp.t_crit_c).any().to(torch.int32)
        f_prev = f
        freqs.append(f)
        temps.append(t)
    return _finish(torch.stack(freqs), torch.stack(temps), events)


def released_compute(base: SimResult, v24: SimResult) -> torch.Tensor:
    """Effect ① headline: fraction of throttle-locked performance released."""
    return v24.perf / base.perf - 1.0
