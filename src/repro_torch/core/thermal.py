"""Thermal convolution model (paper §4.2) and V7.0 two-pole kernel (§5.2).

Port of `repro.core.thermal`.  Both models are LTI IIR systems, so the exact
zero-order-hold discretisation at sample interval dt is one recurrence per
pole:

    x[k+1] = a·x[k] + (1−a)·G·P[k],     a = exp(−dt/τ),  G = pole gain

with ΔT = Σ_poles x.  The discretised constants are numpy f32 (derived with
the reference's numpy ops, so bit-identical to it); `step` moves them to the
state's device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

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


def delta_t(state: torch.Tensor) -> torch.Tensor:
    """ΔT per tile = sum over poles.  [..., n_tiles]"""
    return state.sum(dim=-1)


def steady_state_dt(poles: PoleParams, power_w) -> torch.Tensor:
    """Analytic steady state: ΔT_ss = Rth · P (all poles fully charged)."""
    return torch.as_tensor(poles.gain, dtype=torch.float32).sum() * power_w
