"""N×N thermal coupling matrix Γ (paper §5.1, Fig. 4).

Port of `repro.core.coupling`.  For a multi-tile Foveros package:

  * diagonal       γ_ii = 1.0                        (self-heating)
  * vertical pairs γ ≈ 0.70–0.90  (Foveros Direct Cu-Cu, dist = 1)
  * lateral pairs  γ ≈ 0.15–0.40  (EMIB bridge + organic, dist = 2–3)
  * distant pairs  γ ≈ 0.02–0.12  (dist > 4 — "effectively zero")

Γ is sparse: 5–8 significant neighbours per tile (Ponte Vecchio's 47 tiles
⇒ ~350 of 2 209 entries non-zero).  Every product with Γ goes through
`apply_coupling`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import fma_f32

# Paper's distance bands → coupling coefficient (midpoints of published ranges).
GAMMA_SELF = 1.0
GAMMA_VERTICAL = 0.80      # dist = 1   (0.70–0.90)
GAMMA_LATERAL = 0.275      # dist = 2–3 (0.15–0.40)
GAMMA_DISTANT = 0.07       # dist = 4   (0.02–0.12)
# dist > 4 ⇒ exactly 0 (paper: "effectively zero for thermal budgeting")


def grid_coords(n_tiles: int, cols: int | None = None) -> np.ndarray:
    """Lay n_tiles out on a near-square 2-D grid; returns [n_tiles, 2] coords."""
    if cols is None:
        cols = int(np.ceil(np.sqrt(n_tiles)))
    idx = np.arange(n_tiles)
    return np.stack([idx // cols, idx % cols], axis=1)


def coupling_matrix(n_tiles: int, cols: int | None = None,
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """Dense Γ [n_tiles, n_tiles] with the paper's distance-banded coefficients.

    Face-adjacent tiles (Manhattan 1) are the "vertical" Foveros pairs, the
    diagonals the "lateral" EMIB pairs, a weak band beyond, zero past it —
    the paper's 5–8 significant neighbours per tile (§5.1).
    """
    xy = grid_coords(n_tiles, cols)
    d = np.abs(xy[:, None, :] - xy[None, :, :])
    man = d.sum(-1)
    cheb = d.max(-1)
    g = np.zeros((n_tiles, n_tiles), dtype=np.float64)
    g[(man >= 2) & (man <= 3)] = GAMMA_DISTANT
    g[(cheb == 1) & (man == 2)] = GAMMA_LATERAL      # diagonal
    g[man == 1] = GAMMA_VERTICAL
    g[man == 0] = GAMMA_SELF
    return torch.as_tensor(g, dtype=dtype, device=device)


def row_normalise(gamma: torch.Tensor) -> torch.Tensor:
    """Γ with every row divided by its row sum (`ThermalScheduler`'s frame).

    Keeps multi-tile steady state in the single-tile °C/W fingerprint frame.
    The row sums are accumulated in the order of the reference's compiled
    f32 reduction (sequential up to 32 tiles; beyond that, windows of 32
    with the padding split across both ends, then the window sums), so the
    normalised Γ is bit-identical to the reference's.
    """
    return gamma / _xla_order_row_sum(gamma)[:, None]


def _xla_order_row_sum(x: torch.Tensor, window: int = 32) -> torch.Tensor:
    m = x.shape[1]
    if m <= window:
        acc = torch.zeros_like(x[:, 0])
        for j in range(m):
            acc = acc + x[:, j]
        return acc
    k = -(-m // window)
    left = (k * window - m) // 2
    parts = []
    for c in range(k):
        lo, hi = max(c * window - left, 0), min((c + 1) * window - left, m)
        acc = torch.zeros_like(x[:, 0])
        for j in range(lo, hi):
            acc = acc + x[:, j]
        parts.append(acc)
    return _xla_order_row_sum(torch.stack(parts, dim=1), window)


def apply_coupling(gamma: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Γ @ p over the trailing tile axis, tolerating leading batch dims.

    p: [..., n_tiles] → [..., n_tiles].  Accumulated source tile by source
    tile, j = 0 … n−1, each step one fused multiply-add in f32 — the order
    the CUDA `fleet_step` kernel uses, so the kernel, its plain version and
    the per-step engine share one rounding and event counts agree exactly
    on the card.  (A GEMM would pick its own blocking and order per device;
    Γ never goes through one, so TF32 cannot touch it.)  On a card each
    step is one launch of the FMA kernel (`fma_f32`).
    """
    acc = torch.zeros_like(p)
    for j in range(gamma.shape[1]):
        acc = fma_f32(gamma[:, j], p[..., j:j + 1], acc)
    return acc


def sparsity_stats(gamma, threshold: float = 0.0) -> dict:
    """Non-zero census, reproducing the paper's Ponte-Vecchio sparsity claim."""
    g = (gamma.detach().cpu().numpy() if torch.is_tensor(gamma)
         else np.asarray(gamma))
    nz = (np.abs(g) > threshold).sum()
    n = g.shape[0]
    per_tile = (np.abs(g) > threshold).sum(axis=1) - 1  # exclude self
    return {
        "n_tiles": n,
        "entries": n * n,
        "nonzero": int(nz),
        "nonzero_frac": float(nz) / (n * n),
        "neighbours_min": int(per_tile.min()),
        "neighbours_max": int(per_tile.max()),
        "neighbours_mean": float(per_tile.mean()),
    }


def ponte_vecchio_gamma(device=None) -> torch.Tensor:
    """47-tile Γ (paper's Ponte Vecchio equivalent, §5.1)."""
    return coupling_matrix(47, cols=7, device=device)
