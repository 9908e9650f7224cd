"""§6 — SerDes clock conditioning via the two indirect paths.

Port of `repro.core.serdes`.  Path A (§6.1): substrate thermal
stabilisation — VCO TCF ∈ [−300, −100] ppm/°C; ΔT = 40 °C open loop ⇒
0.44–1.36 GHz drift at 112 GHz, V24's ΔT ≤ 4.15 °C ⇒ 44–136 MHz (≈10×).
Path B (§6.2): CDR warm-start — the outer loop predicts lane saturation
20–50 ms ahead and pre-loads equaliser coefficients; adaptation shrinks from
10⁴–10⁶ symbols to < 10², modelled as LMS convergence from a
prediction-accurate initial point.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.fingerprint import FINGERPRINT, Fingerprint


class VCODrift(NamedTuple):
    dt_c: float
    drift_mhz_low: float
    drift_mhz_high: float


def vco_drift(dt_c: float, fp: Fingerprint = FINGERPRINT) -> VCODrift:
    """Δf = TCF · ΔT · f_carrier over the published TCF band."""
    f_mhz = fp.serdes_carrier_ghz * 1e3
    return VCODrift(dt_c=dt_c,
                    drift_mhz_low=fp.vco_tcf_ppm_low * 1e-6 * dt_c * f_mhz,
                    drift_mhz_high=fp.vco_tcf_ppm_high * 1e-6 * dt_c * f_mhz)


def path_a_improvement(fp: Fingerprint = FINGERPRINT) -> dict:
    open_loop = vco_drift(40.0, fp)
    v24 = vco_drift(fp.dt_pic_clamp_c, fp)
    return {
        "open_loop_mhz": (open_loop.drift_mhz_low, open_loop.drift_mhz_high),
        "v24_mhz": (v24.drift_mhz_low, v24.drift_mhz_high),
        "improvement_x": open_loop.drift_mhz_low / v24.drift_mhz_low,
    }


def lms_convergence_symbols(initial_error: float, mu: float = 0.05,
                            tol: float = 1e-3, max_syms: int = 2_000_000) -> int:
    """Symbols until |e| < tol for a geometric LMS error decay
    e_k = e₀(1−µ)^k (f32, as in the reference)."""
    e = torch.as_tensor(initial_error, dtype=torch.float32)
    k = torch.log(tol / torch.clamp(e, min=tol)) / torch.log(
        torch.tensor(1 - mu, dtype=torch.float32))
    return int(torch.clamp(torch.ceil(k), 0, max_syms))


def path_b_warm_start(prediction_error: float = 0.02,
                      cold_error: float = 1.0) -> dict:
    """Cold adaptation starts from O(1) coefficient error; warm start begins
    at the outer-loop prediction residual (~2 %).  §6.2: 10⁴–10⁶ → < 10²."""
    cold_fast = lms_convergence_symbols(cold_error, mu=6.5e-4)
    cold_slow = lms_convergence_symbols(cold_error, mu=6.5e-6)
    warm = lms_convergence_symbols(prediction_error, mu=0.05)
    return {"cold_symbols": (cold_fast, cold_slow), "warm_symbols": warm}


def lane_saturation_predictor(traffic_ma: torch.Tensor, threshold: float,
                              lookahead_ms: float = 35.0,
                              dt_ms: float = 1.0) -> torch.Tensor:
    """Outer-loop lane hint: which lanes saturate within the window.

    traffic_ma: [T, lanes] smoothed lane utilisation; linear extrapolation,
    the PDU gate's predictor family (§6.2 'outer loop').
    """
    (d,) = torch.gradient(traffic_ma, dim=0)
    return traffic_ma + d * (lookahead_ms / dt_ms) >= threshold
