"""Appendix-B 90,000-step telemetry dataset — generator, statistics, R² fit.

Port of `repro.core.dataset90k`.  The paper's primary validation artifact is
a 90,000-step, 1 kHz inference telemetry dataset with the published summary
(Appendix B.2) and the ΔT = α·R_tok + β regression (α = 63.0 °C/MTPS,
β = −1256.6 °C, R² = 0.9911, §4.1).  `generate` regenerates it from the
published moments; `fit_affine` reproduces the regression.

As in the reference, the paper's own B.2 "ΔT junction" row (mean 12.8 °C)
is inconsistent with its regression constants over the published R_tok
domain; the regression chain (the R² headline) is what is reproduced.
Draws come from a `torch.Generator`, so the dataset is not the reference's
sample for a seed — its statistics are.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core.density import dt_from_rtok, rtok_from_rho
from repro_torch.core.fingerprint import FINGERPRINT
from repro_torch.core.pdu_gate import eta as eta_fn
from repro_torch.core.workload import ar1_scan


class Telemetry(NamedTuple):
    """One row per step (Appendix B.1: 1 ms sampling, 90,000 steps)."""

    rho: torch.Tensor          # workload density, normalised units
    rtok: torch.Tensor         # token throughput [MTPS]
    dt_junction: torch.Tensor  # junction ΔT [°C] (regression target)
    eta: torch.Tensor          # preposition fraction per step
    rth: torch.Tensor          # per-step measured Rth [°C/W]
    drift_nm: torch.Tensor     # compensated spectral drift [nm]


def generate(seed: int = 90_000, n_steps: int | None = None,
             device=None) -> Telemetry:
    """Regenerate the 90k-step dataset from the published moments.

    Noise is scaled so the α-slope fit lands at R² = 0.9911:
    σ_ε² = var(α·R_tok)·(1 − R²)/R², from the sample variance of the
    generated throughput.  Draws come from a `torch.Generator` on
    ``device`` (CUDA unless asked otherwise) seeded with ``seed``, and the
    whole dataset is built there — the ρ recurrence as a log-depth scan
    (`workload.ar1_scan`) where the reference runs `lax.scan`.
    """
    fp = FINGERPRINT
    n = fp.dataset_steps if n_steps is None else n_steps
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    draw = lambda: torch.randn((n,), generator=gen, device=dev)

    # ρ: OU process matching mean 1.80 / std 0.43, clipped to [0.9, 2.7]
    theta = 0.004
    kick = 0.43 * math.sqrt(2 * theta) * draw()
    rho = ar1_scan(1.80, 1.0 - theta, theta * 1.80 + kick)
    rho = torch.clamp(rho, fp.rho_min, fp.rho_max)

    # throughput affine mapping (§4.2) + regression-calibrated noise
    rtok = rtok_from_rho(rho)
    sig_var = torch.var(fp.alpha_c_per_mtps * rtok, correction=0)
    noise_sd = torch.sqrt(sig_var * (1 - fp.r2_published) / fp.r2_published)
    dt = dt_from_rtok(rtok) + noise_sd * draw()

    # per-step look-ahead uniform in [20, 50] ms ⇒ η ∈ [22.1 %, 46.5 %]
    la = fp.lookahead_min_ms + (fp.lookahead_max_ms - fp.lookahead_min_ms) \
        * torch.rand((n,), generator=gen, device=dev)
    et = eta_fn(la)

    # measured Rth: manufacturing spread N(0.451, 0.009) (B.2 row 5)
    rth = 0.451 + 0.009 * draw()

    # compensated drift: Δλ = κ_TO·ΔT_PIC residual, clamped < 0.36 nm
    dt_pic = torch.clamp(3.40 + 0.47 * draw(),
                         0.18 / fp.kappa_to_nm_per_c, fp.dt_pic_clamp_c)
    return Telemetry(rho=rho, rtok=rtok, dt_junction=dt, eta=et, rth=rth,
                     drift_nm=fp.kappa_to_nm_per_c * dt_pic)


def fit_affine(x: torch.Tensor, y: torch.Tensor) -> tuple[float, float, float]:
    """Least-squares y = a·x + b; returns (a, b, R²) — the §4.1 fit."""
    xm, ym = x.mean(), y.mean()
    a = ((x - xm) * (y - ym)).sum() / ((x - xm) ** 2).sum()
    b = ym - a * xm
    resid = y - (a * x + b)
    r2 = 1.0 - (resid ** 2).sum() / ((y - ym) ** 2).sum()
    return float(a), float(b), float(r2)


def summary(t: Telemetry) -> dict[str, dict[str, float]]:
    """Appendix-B.2 statistical summary table (population std)."""
    def row(v):
        return {"mean": float(v.mean()), "std": float(v.std(correction=0)),
                "min": float(v.min()), "max": float(v.max())}
    return {
        "rtok_mtps": row(t.rtok),
        "rho": row(t.rho),
        "dt_junction_c": row(t.dt_junction),
        "eta_pct": row(t.eta * 100.0),
        "rth": row(t.rth),
        "drift_nm": row(t.drift_nm),
    }
