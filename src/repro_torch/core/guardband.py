"""Effect ④ — EDA guard-band liberation (paper §3.4).

Port of `repro.core.guardband` (host-side arithmetic on the Monte-Carlo
statistics).

Traditional EDA reserves 15–30 % worst-case margins (timing / power / thermal /
placement density).  V24's claim: moving thermal behaviour from *physical
uncertainty* to *deterministic control* shrinks the required margin to the
residual uncertainty of the controlled system.

We derive the reduction from first principles instead of asserting it: the
required margin scales with the k·σ excursion of the quantity being guarded,
so   margin_new / margin_old = σ_controlled / σ_uncontrolled,
with the σ ratio taken from the Monte-Carlo peak-temperature distributions
(§10: σ 6.0 °C → 2.1 °C ⇒ ratio 0.35 ⇒ ~65 % reduction — matching the
paper's 65–68 % across all four categories).
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.core.fingerprint import FINGERPRINT, Fingerprint

CATEGORIES = ("timing", "power", "thermal", "density")


class GuardBandReport(NamedTuple):
    category: str
    margin_before: float
    margin_after: float
    reduction_pct: float


def published(fp: Fingerprint = FINGERPRINT) -> list[GuardBandReport]:
    """The paper's §3.4 before/after table."""
    table = {"timing": fp.margin_timing, "power": fp.margin_power,
             "thermal": fp.margin_thermal, "density": fp.margin_density}
    out = []
    for cat in CATEGORIES:
        before, after = table[cat]
        out.append(GuardBandReport(cat, before, after,
                                   100.0 * (1 - after / before)))
    return out


def derived(sigma_uncontrolled: float, sigma_controlled: float,
            fp: Fingerprint = FINGERPRINT) -> list[GuardBandReport]:
    """Margins recomputed from the measured σ ratio (Monte-Carlo §10)."""
    ratio = sigma_controlled / sigma_uncontrolled
    table = {"timing": fp.margin_timing, "power": fp.margin_power,
             "thermal": fp.margin_thermal, "density": fp.margin_density}
    out = []
    for cat in CATEGORIES:
        before, _ = table[cat]
        after = before * ratio
        out.append(GuardBandReport(cat, before, after,
                                   100.0 * (1 - ratio)))
    return out


def from_montecarlo(stats: dict,
                    fp: Fingerprint = FINGERPRINT) -> list[GuardBandReport]:
    """Margins derived straight from a fleet Monte-Carlo run.

    ``stats`` is `repro_torch.core.montecarlo.MCResult.stats()` — the
    uncontrolled/controlled peak-temperature σs come from the per-trial
    survey reductions of the heterogeneous fleet, closing the loop from
    process-variation draws to EDA guard-band liberation (§3.4 ← §10).
    """
    return derived(stats["baseline_std_c"], stats["v24_std_c"], fp)


def wafer_roi_gain(reduction_pct: float) -> float:
    """§8.4: guard-band liberation → reticle-area utilisation gain.

    A placement-density margin m reserves 1/(1−m) area per unit function and
    the power guard reserves 1/(1−g) power envelope per block; shrinking both
    by the measured reduction compounds to the paper's ~15 % wafer-ROI figure:
    (0.95/0.85)·(0.93/0.... ) ≈ 1.15.
    """
    m_old = FINGERPRINT.margin_density[0]
    m_new = m_old * (1 - reduction_pct / 100.0)
    area_gain = (1 - m_new) / (1 - m_old) - 1            # ≈ 11.8 %
    # shoreline/routing relief from the timing-margin reduction contributes
    # the remainder; we attribute a conservative quarter of it to area
    t_old = FINGERPRINT.margin_timing[0]
    t_new = t_old * (1 - reduction_pct / 100.0)
    freq_gain = ((1 - t_new) / (1 - t_old) - 1) * 0.25
    return area_gain + freq_gain
