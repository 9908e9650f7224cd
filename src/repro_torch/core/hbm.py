"""Effect ③ — HBM memory-wall breakdown via predictive thermal clamping (§3.3).

Port of `repro.core.hbm`.  Thermal cross-talk at the base-die ↔ HBM stitching
interface drives leakage: baseline scheduling 12 MB/hr (idle) → 166 MB/hr
(peak); V24 clamps the interface excursion below the leakage-activation
threshold (ΔT ≤ 4.15 °C) ⇒ < 1 MB/hr in every load state.  Model:
Arrhenius-style activation above a ΔT threshold, calibrated to the paper's
idle/peak endpoints.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.fingerprint import FINGERPRINT, Fingerprint

# Five canonical load states (paper Fig. 2③) → steady ΔT at the HBM interface
# under baseline scheduling.
LOAD_STATES = ("idle", "low", "medium", "high", "peak")
_BASELINE_IF_DT = {"idle": 6.0, "low": 12.0, "medium": 20.0,
                   "high": 28.0, "peak": 36.0}


def _calibrate(fp: Fingerprint) -> tuple[float, float]:
    """Solve L(ΔT) = L0·exp(k·(ΔT−ΔT_th)) through the published endpoints."""
    dt_lo, dt_hi = _BASELINE_IF_DT["idle"], _BASELINE_IF_DT["peak"]
    k = math.log(fp.leakage_peak_mb_hr / fp.leakage_idle_mb_hr) / (dt_hi - dt_lo)
    l0 = fp.leakage_idle_mb_hr / math.exp(k * (dt_lo - fp.leakage_dt_threshold_c))
    return l0, k


def leakage_mb_per_hr(dt_interface_c,
                      fp: Fingerprint = FINGERPRINT) -> torch.Tensor:
    """Leakage rate vs HBM-interface ΔT; hard floor below the activation
    threshold (leakage current un-activated ⇒ below measurable, < 1 MB/hr)."""
    l0, k = _calibrate(fp)
    dt = torch.as_tensor(dt_interface_c, dtype=torch.float32)
    active = l0 * torch.exp(k * (dt - fp.leakage_dt_threshold_c))
    return torch.where(dt <= fp.leakage_dt_threshold_c,
                       torch.clamp(active, max=0.5), active)


def baseline_by_state(fp: Fingerprint = FINGERPRINT) -> dict[str, float]:
    return {s: float(leakage_mb_per_hr(_BASELINE_IF_DT[s], fp))
            for s in LOAD_STATES}


def v24_by_state(fp: Fingerprint = FINGERPRINT) -> dict[str, float]:
    """Under V24 the interface excursion is clamped ≤ threshold in all states."""
    return {s: float(leakage_mb_per_hr(
        min(_BASELINE_IF_DT[s], fp.leakage_dt_threshold_c), fp))
        for s in LOAD_STATES}


def refresh_overhead_frac(leak_mb_hr, fp: Fingerprint = FINGERPRINT):
    """Bandwidth fraction burnt on leak-compensating refresh (monotone in
    leakage; 0 at the clamped floor) — the 'memory wall' term of §3.3/§8.3."""
    leak = torch.as_tensor(leak_mb_hr, dtype=torch.float32)
    return torch.clamp(0.12 * torch.log1p(leak / fp.leakage_clamped_mb_hr)
                       / math.log1p(fp.leakage_peak_mb_hr), 0.0, 0.15)


def max_stack_layers(leak_mb_hr, fp: Fingerprint = FINGERPRINT) -> int:
    """Stacking-height implication (§3.3): the leakage budget caps layers —
    baseline peak ⇒ 8L (today's limit), clamped ⇒ ≥ 24L."""
    leak = float(leak_mb_hr)
    if leak <= fp.leakage_clamped_mb_hr:
        return 24
    if leak <= 20.0:
        return 16
    if leak <= 60.0:
        return 12
    return 8
