"""Workload density metric ρv24 (paper §4.2) and the ρ → R_tok → ΔT → P chain.

Port of `repro.core.density`.  ρv24(t) = Σᵢ Attn(i)·ω(i)·F(i) over the
layer stack of one of the ten assigned architectures (`repro_torch.configs`),
affinely normalised onto the paper's published domain ρ ∈ [0.9, 2.7]
(Appendix B) with the assigned fleet as the calibration set.  The affine
chain below maps a density tensor to tile power in f32 with the reference's
op chain (ρ → R_tok → ΔT → P), rounded as its compiled fleet loop rounds.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import fma_f32
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.fingerprint import FINGERPRINT


def _attn_footprint(cfg: ArchConfig, seq: int, decode: bool) -> float:
    """Attn(i): per-token normalised attention/state footprint of one layer."""
    if cfg.attn_kind == "none" or cfg.family == "ssm":
        # recurrent state bytes, amortised over the sequence
        state = max(cfg.ssm_heads, 1) * max(cfg.ssm_state, 1) * max(cfg.head_dim, 64)
        return state / 1e4
    eff_seq = min(seq, cfg.window) if cfg.attn_kind == "swa" and cfg.window else seq
    if cfg.mla_kv_lora:
        per_tok = cfg.mla_kv_lora + cfg.mla_rope_dim
    else:
        per_tok = 2 * cfg.n_kv_heads * cfg.head_dim
    # decode touches the whole cache once per token; train/prefill amortise seq²/2
    scale = eff_seq if decode else eff_seq / 2.0
    return per_tok * scale / 1e7


def _geometric_f(cfg: ArchConfig) -> float:
    """F(i): geometric routing coefficient = normalised MLP fan-out."""
    dff = cfg.moe_d_ff or cfg.d_ff
    return (dff * (cfg.top_k + cfg.n_shared_experts or 1)
            if cfg.is_moe else cfg.d_ff) / max(cfg.d_model, 1) / 8.0


def rho_raw(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Unnormalised Σᵢ Attn·ω·F over the layer stack."""
    attn = _attn_footprint(cfg, shape.seq_len, shape.is_decode)
    per_layer = attn * cfg.expert_activation * _geometric_f(cfg)
    return per_layer * cfg.n_layers * math.log1p(shape.global_batch) / 10.0


def _calibration() -> tuple[float, float]:
    """(lo, hi) of log1p(ρ_raw) over every live (arch, shape) cell."""
    from repro_torch.configs import ALL_ARCHS, SHAPES
    vals = [math.log1p(rho_raw(cfg, sh))
            for cfg in ALL_ARCHS.values() for sh in SHAPES.values()
            if not (sh.name == "long_500k" and not cfg.sub_quadratic)]
    return min(vals), max(vals)


def rho_v24(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """ρv24 in paper units (∈ [0.9, 2.7] across the assigned fleet)."""
    lo, hi = _calibration()
    x = math.log1p(rho_raw(cfg, shape))
    t = 0.0 if hi == lo else (x - lo) / (hi - lo)
    return FINGERPRINT.rho_min + t * (FINGERPRINT.rho_max - FINGERPRINT.rho_min)


# ----------------------------------------------------------------------------
# ρ ↔ R_tok ↔ ΔT affine chain (paper §4.2 "Throughput Affine Mapping")
# ----------------------------------------------------------------------------
# ΔT = α·R_tok + β (α = 63.0 °C/MTPS, β = −1256.6 °C, R² = 0.9911) over the
# Appendix-B domains R_tok ∈ [20.20, 20.85] MTPS, ρ ∈ [0.9, 2.7]; the
# ρ→R_tok affine is calibrated from those domain ends.
_RTOK_SLOPE = (FINGERPRINT.rtok_max_mtps - FINGERPRINT.rtok_min_mtps) / (
    FINGERPRINT.rho_max - FINGERPRINT.rho_min)          # 0.3611 MTPS per ρ unit
_RTOK_INTERCEPT = FINGERPRINT.rtok_min_mtps - _RTOK_SLOPE * FINGERPRINT.rho_min
# The reference fleet loop always runs as a compiled XLA program, which
# fuses each multiply-add below into one FMA (`repro_torch.fma_f32`: ΔT
# cancels ~37× between α·R_tok and β) and folds the division P = ΔT / Rth
# into a multiply by the f32 reciprocal; the port writes both out, so eager
# PyTorch on either device rounds as the reference's fleet loop does.
_f32c = lambda x: float(np.float32(x))
_RTOK_SLOPE_F32, _RTOK_ICEPT_F32 = _f32c(_RTOK_SLOPE), _f32c(_RTOK_INTERCEPT)
_ALPHA_F32, _BETA_F32 = (_f32c(FINGERPRINT.alpha_c_per_mtps),
                         _f32c(FINGERPRINT.beta_c))
_INV_RTH = float(np.float32(1.0) / np.float32(FINGERPRINT.rth_c_per_w))


def _f32(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(x, dtype=torch.float32)


def rtok_from_rho(rho) -> torch.Tensor:
    """R_tok(ρ): throughput affine mapping onto the Appendix-B MTPS domain."""
    return fma_f32(_RTOK_SLOPE_F32, _f32(rho), _RTOK_ICEPT_F32)


def dt_from_rtok(rtok) -> torch.Tensor:
    """ΔT(R_tok) = α·R_tok + β — the published R²=0.9911 regression line."""
    return fma_f32(_ALPHA_F32, _f32(rtok), _BETA_F32)


def dt_from_rho(rho) -> torch.Tensor:
    """Composite ρ → ΔT steady-state map (the ρv24-as-proxy-for-P_EIC claim)."""
    return dt_from_rtok(rtok_from_rho(rho))


def power_from_rho(rho) -> torch.Tensor:
    """Implied tile power: P = ΔT_ss / Rth (steady-state inversion of §4.2)."""
    return dt_from_rho(rho) * _INV_RTH
