"""Thermal convolution model (paper §4.2) and V7.0 two-pole kernel (§5.2).

Port of `repro.core.thermal`.  Both models are LTI IIR systems, so the exact
zero-order-hold discretisation at sample interval dt is one recurrence per
pole:

    x[k+1] = a·x[k] + (1−a)·G·P[k],     a = exp(−dt/τ),  G = pole gain

with ΔT = Σ_poles x.  The discretised constants are numpy f32 (derived with
the reference's numpy ops, so bit-identical to it); `step` moves them to the
state's device.  `simulate` is the plain whole-trace scan (the oracle the
`thermal_conv` kernel is held against); `direct_convolution` the O(T²)
literal convolution that checks the recurrence.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.coupling import apply_coupling
from repro_torch.core.fingerprint import FINGERPRINT, Fingerprint


class PoleParams(NamedTuple):
    """Discretised pole bank: ΔT(t) = Σ_i state_i, one IIR state per pole."""

    decay: np.ndarray | torch.Tensor   # [n_poles]  a_i = exp(-dt/τ_i)
    gain: np.ndarray | torch.Tensor    # [n_poles]  G_i (°C/W); Σ G_i = Rth


def single_pole(fp: Fingerprint = FINGERPRINT, dt_ms: float = 1.0) -> PoleParams:
    """V24 single-pole discretisation (τ = 80 ms, gain = Rth)."""
    a = np.exp(np.float32(-dt_ms / fp.tau_ms))
    return PoleParams(decay=np.asarray([a], np.float32),
                      gain=np.asarray([fp.rth_c_per_w], np.float32))


def two_pole(fp: Fingerprint = FINGERPRINT, dt_ms: float = 1.0,
             emib: bool = False) -> PoleParams:
    """V7.0 two-pole discretisation (τ₁ ≈ 5 ms Foveros, τ₂ ≈ 80 ms package).

    With ``emib=True`` the slow pole moves to the EMIB lateral value
    (τ₂ ≈ 200–500 ms, organic substrate dominated — paper §5.2).
    """
    tau2 = fp.tau2_emib_ms if emib else fp.tau2_ms
    a = np.exp(np.asarray([-dt_ms / fp.tau1_ms, -dt_ms / tau2], np.float32))
    return PoleParams(decay=a, gain=np.asarray([fp.a1, fp.a2], np.float32))


def pole_bank(rth, tau_ms, dt_ms: float = 1.0) -> PoleParams:
    """Batched single-pole banks from per-package process draws (§10.1):
    decay/gain [*batch, 1], discretised like `single_pole`."""
    rth = torch.as_tensor(rth, dtype=torch.float32)
    tau = torch.as_tensor(tau_ms, dtype=torch.float32)
    return PoleParams(decay=torch.exp(-dt_ms / tau)[..., None],
                      gain=rth[..., None])


def init_state(poles: PoleParams, n_tiles: int = 1,
               batch_shape: tuple[int, ...] = (), device=None) -> torch.Tensor:
    """Zero thermal state: [*batch, n_tiles, n_poles] pole temperatures (ΔT °C)."""
    return torch.zeros(batch_shape + (n_tiles, poles.decay.shape[0]),
                       dtype=torch.float32, device=device)


def step(poles: PoleParams, state: torch.Tensor,
         power_w: torch.Tensor) -> torch.Tensor:
    """One dt tick of the pole bank.

    power_w: [..., n_tiles] effective (Γ-coupled) power; state
    [..., n_tiles, n_poles]; any leading batch dims ride through.
    """
    decay = torch.as_tensor(poles.decay, dtype=torch.float32,
                            device=state.device)
    gain = torch.as_tensor(poles.gain, dtype=torch.float32,
                           device=state.device)
    return decay * state + (1.0 - decay) * gain * power_w[..., None]


def step_fused(poles: PoleParams, state: torch.Tensor,
               power_w: torch.Tensor) -> torch.Tensor:
    """`step` with a·s + (1 − a)·G·P as one FMA over the rounded drive
    term — how the reference's compiled fleet and DVFS loops round it (the
    scheduler's pole plants and the `fleet_step` kernel do the same)."""
    from repro_torch import fma_f32

    decay = torch.as_tensor(poles.decay, dtype=torch.float32,
                            device=state.device)
    gain = torch.as_tensor(poles.gain, dtype=torch.float32,
                           device=state.device)
    return fma_f32(decay, state, (1.0 - decay) * gain * power_w[..., None])


def delta_t(state: torch.Tensor) -> torch.Tensor:
    """ΔT per tile = sum over poles.  [..., n_tiles]"""
    return state.sum(dim=-1)


def steady_state_dt(poles: PoleParams, power_w) -> torch.Tensor:
    """Analytic steady state: ΔT_ss = Rth · P (all poles fully charged)."""
    return torch.as_tensor(poles.gain, dtype=torch.float32).sum() * power_w


def simulate(poles: PoleParams, power_trace, gamma: torch.Tensor | None = None,
             state0: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the thermal convolution over a power trace.

    power_trace: [T, n_tiles] (or [T]) dissipated power per tile per tick
    [W]; ``gamma``: optional [n_tiles, n_tiles] coupling matrix (effective
    power = Γ·P, identity if None); ``state0``: optional initial pole
    state.  Returns (ΔT trace [T, n_tiles], final state [n_tiles, n_poles]).
    """
    power_trace = torch.as_tensor(power_trace, dtype=torch.float32)
    if power_trace.ndim == 1:
        power_trace = power_trace[:, None]
    if state0 is None:
        state0 = init_state(poles, power_trace.shape[1],
                            device=power_trace.device)
    if gamma is not None:
        power_trace = apply_coupling(gamma, power_trace)
    state, dts = state0, []
    for p in power_trace:
        state = step(poles, state, p)
        dts.append(delta_t(state))
    return torch.stack(dts), state


def direct_convolution(poles: PoleParams, power_trace,
                       dt_ms: float = 1.0) -> torch.Tensor:
    """O(T²) literal evaluation of the convolution integral — oracle only.

    ΔT[k] sums the ZOH-exact per-interval weights G·(1−a)·a^(k−u) over
    u ≤ k; tests use it to verify the scan recurrence.
    """
    power_trace = torch.as_tensor(power_trace, dtype=torch.float32)
    if power_trace.ndim == 1:
        power_trace = power_trace[:, None]
    k = torch.arange(power_trace.shape[0], device=power_trace.device)
    lag = k[:, None] - k[None, :]                       # [T, T]
    out = torch.zeros_like(power_trace)
    for a, g in zip(torch.as_tensor(poles.decay, dtype=torch.float32),
                    torch.as_tensor(poles.gain, dtype=torch.float32)):
        w = torch.where(lag >= 0, g * (1 - a) * a ** lag.clamp(min=0), 0.0)
        out = out + w @ power_trace
    return out


def step_response(poles: PoleParams, n_steps: int,
                  power_w: float = 1.0) -> torch.Tensor:
    """ΔT trace for a unit power step — τ validation: 63.2 % at t = τ (§4.1)."""
    dts, _ = simulate(poles, torch.full((n_steps, 1), power_w))
    return dts[:, 0]
