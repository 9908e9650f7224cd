"""Thermal-resistance fingerprint constants (paper §4.1, Table 'Fingerprint Constants').

Every physical constant used anywhere in the framework lives here, with the
paper-published value as the default.  A copy of `repro.core.fingerprint`
(the port imports nothing of the JAX package); `eta` evaluates in torch.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Fingerprint:
    """XRM-SSD V24 thermal fingerprint (paper §4.1)."""

    # --- primary thermal constants -------------------------------------
    rth_c_per_w: float = 0.45          # junction-to-substrate Rth [°C/W]
    tau_ms: float = 80.0               # single-pole thermal time constant [ms]
    kappa_to_nm_per_c: float = 0.0852  # thermo-optic coefficient [nm/°C]

    # --- rho/throughput affine coupling (R² = 0.9911 fit) ---------------
    alpha_c_per_mtps: float = 63.0     # ΔT/R_tok slope [°C/MTPS]
    beta_c: float = -1256.6            # intercept [°C], calibrated to load domain
    r2_published: float = 0.9911

    # --- drift budget ---------------------------------------------------
    drift_open_loop_nm: float = 3.4            # @ ΔT = 40 °C stress
    drift_compensated_max_nm: float = 0.36     # < 21 % of TSMC ±1.7 nm
    drift_channel_spec_nm: float = 0.5         # ±0.5 nm per-channel operational spec
    tsmc_ber_budget_nm: float = 1.7            # ±1.7 nm BER degradation threshold
    dt_pic_clamp_c: float = 4.15               # V24 max ΔT_PIC under closed loop

    # --- look-ahead window ----------------------------------------------
    lookahead_min_ms: float = 20.0
    lookahead_max_ms: float = 50.0
    eta_min: float = 0.2212            # 1 - exp(-20/80)
    eta_max: float = 0.4647            # 1 - exp(-50/80)

    # --- series thermal boundaries ---------------------------------------
    rth_jxn_case: float = 0.812        # [°C/W]
    rth_case_sink: float = 1.407       # [°C/W]
    rth_total: float = 1.995           # junction-to-ambient [°C/W]

    # --- V7.0 two-pole kernel (§5.2) -------------------------------------
    tau1_ms: float = 5.0               # Foveros Direct Cu-Cu fast pole
    tau2_ms: float = 80.0              # package-level RC slow pole
    a1_frac: float = 0.35              # A1 / Rth split (Foveros geometry)
    tau2_emib_ms: float = 350.0        # EMIB lateral path slow pole (200-500 ms)

    # --- operating limits -------------------------------------------------
    t_crit_c: float = 85.0             # DVFS trigger / safe peak temperature
    t_ambient_c: float = 45.0          # idle junction baseline in-package

    # --- DVFS throttle behaviour (Effect ① baseline) ----------------------
    throttle_floor: float = 0.55       # reactive DVFS drops to 55-70 % of peak
    throttle_ceiling: float = 0.70

    # --- HBM leakage model (Effect ③) -------------------------------------
    leakage_idle_mb_hr: float = 12.0
    leakage_peak_mb_hr: float = 166.0
    leakage_clamped_mb_hr: float = 1.0          # below measurable threshold
    leakage_dt_threshold_c: float = 4.15        # activation threshold on ΔT at HBM i/f

    # --- CPO microheater economics (Effect ②) -----------------------------
    heater_power_mw_per_channel: float = 15.0   # 10-20 mW/channel
    optical_baseline_pj_bit: float = 5.0
    optical_saving_pj_bit: float = 0.85         # 17 % optical I/O power reduction

    # --- guard-band margins (Effect ④), fractional -------------------------
    margin_timing: tuple = (0.18, 0.06)
    margin_power: tuple = (0.22, 0.07)
    margin_thermal: tuple = (0.30, 0.10)
    margin_density: tuple = (0.15, 0.05)

    # --- SerDes (§6) --------------------------------------------------------
    vco_tcf_ppm_low: float = 100.0      # |TCF| range [ppm/°C]
    vco_tcf_ppm_high: float = 300.0
    serdes_carrier_ghz: float = 112.0
    cdr_cold_symbols_low: float = 1e4
    cdr_cold_symbols_high: float = 1e6
    cdr_warm_symbols: float = 1e2

    # --- UCIe sideband telemetry (§5.3) --------------------------------------
    telemetry_packet_bytes: int = 64
    telemetry_link_mbps: float = 1.0

    # --- dataset domain (Appendix B) ------------------------------------------
    rtok_min_mtps: float = 20.20
    rtok_max_mtps: float = 20.85
    rho_min: float = 0.9
    rho_max: float = 2.7
    dataset_steps: int = 90_000
    sample_interval_ms: float = 1.0

    @property
    def a2_frac(self) -> float:
        return 1.0 - self.a1_frac

    @property
    def a1(self) -> float:
        """Two-pole gain A1 [°C/W]; A1 + A2 = Rth (paper §5.2)."""
        return self.a1_frac * self.rth_c_per_w

    @property
    def a2(self) -> float:
        return self.a2_frac * self.rth_c_per_w

    def eta(self, lookahead_ms) -> torch.Tensor:
        """Preposition fraction η = 1 − exp(−Δt_la/τ) (paper §4.2), f32."""
        la = torch.as_tensor(lookahead_ms, dtype=torch.float32)
        return 1.0 - torch.exp(-la / self.tau_ms)


FINGERPRINT = Fingerprint()
