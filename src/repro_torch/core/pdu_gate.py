"""PDU Gate — causal predictive hint H(t) = Γ·P_EIC(t + Δt_la | Ft)  (paper §4.2, §5.1).

Port of `repro.core.pdu_gate`.  Ft is the historical filtration: a ring of
recent density samples.  Two representations coexist, picked by
`SchedulerConfig.filtration_impl`:

  * `Filtration` — the ring alone; `predict_rho` gathers and refits the
    whole window every step (O(W), the oracle);
  * `FiltrationStats` — the ring plus closed-form sliding sufficient
    statistics, updated in O(1) per step and refreshed exactly from the ring
    at pointer wraparound (the serving fast path).

The write pointer ``ptr`` is a fleet-wide clock, not per-package state: it
lives on the host as a 0-dim int32 tensor, so the wraparound refresh is a
host decision and no step waits on the device to take it.  The ``vmap``
fleet backend gives every lane its own clock instead: ``ptr`` is then an
[*batch] int32 tensor on the device, the ring is written and read at each
lane's own slot, and the wraparound refresh is computed for every lane and
selected where that lane wrapped (as the reference's vmapped ``lax.cond``).

Preposition fraction: η = 1 − exp(−Δt_la/τ) → 22.12 % @ 20 ms, 46.47 % @ 50 ms.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import fma_f32
from repro_torch.core.coupling import apply_coupling
from repro_torch.core.density import power_from_rho
from repro_torch.core.fingerprint import FINGERPRINT


def eta(lookahead_ms, tau_ms: float | None = None) -> torch.Tensor:
    """Preposition fraction η = 1 − exp(−Δt_la/τ)."""
    tau = FINGERPRINT.tau_ms if tau_ms is None else tau_ms
    la = torch.as_tensor(lookahead_ms, dtype=torch.float32)
    return 1.0 - torch.exp(-la / tau)


class Filtration(NamedTuple):
    """Ring buffer Ft of per-tile density history. buf: [*batch, window, n_tiles].

    The window axis is always ``-2``; ``ptr`` (host, 0-dim int32) is the
    next write slot shared by the whole batch (per lane under vmap).
    """

    buf: torch.Tensor
    ptr: torch.Tensor


class FiltrationStats(NamedTuple):
    """Ft as closed-form sliding sufficient statistics — O(1) per step.

    The ring is kept only as the eviction source (two O(1) reads per step);
    `predict_rho` reads three per-tile running sums over the window:

      * ``wsum``  Σ ρ                       (window level)
      * ``csum``  Σ (k − t̄)·ρ, k = age      (centered first moment)
      * ``rsum``  Σ over the newest ⌈W/4⌉    (recent-level estimate)

    All three are recomputed from the ring (`exact_stats`) whenever the
    write pointer wraps, bounding f32 drift to one window of updates.
    """

    buf: torch.Tensor    # [*batch, window, n_tiles] — eviction source only
    ptr: torch.Tensor    # host 0-dim int32 — next write slot
    wsum: torch.Tensor   # [*batch, n_tiles]
    csum: torch.Tensor   # [*batch, n_tiles]
    rsum: torch.Tensor   # [*batch, n_tiles]


def _ptr(p: int) -> torch.Tensor:
    return torch.tensor(p, dtype=torch.int32)


def recent_len(window: int) -> int:
    """Depth of the newest-quarter level window (matches `predict_rho`)."""
    return max(window // 4, 1)


def slope_denom(window: int) -> float:
    """Σ (k − t̄)² over the window = W(W² − 1)/12 (least-squares denominator)."""
    return window * (window * window - 1) / 12.0


def _f32_recip(x: float) -> float:
    """The f32 reciprocal XLA multiplies by when it folds ``a / x``."""
    return float(np.float32(1.0) / np.float32(x))


def _fill_buf(fill, batch_shape: tuple[int, ...], window: int, n_tiles: int,
              device) -> torch.Tensor:
    """[*batch, window, n_tiles] ring at ``fill`` (scalar or [*batch, n_tiles])."""
    fill = torch.as_tensor(fill, dtype=torch.float32, device=device)
    shape = batch_shape + (window, n_tiles)
    if fill.ndim == 0:
        return torch.full(shape, float(fill), dtype=torch.float32,
                          device=device)
    return fill[..., None, :].expand(shape).clone()


def init_filtration(window: int, n_tiles: int, fill=0.0,
                    batch_shape: tuple[int, ...] = (),
                    device=None) -> Filtration:
    return Filtration(buf=_fill_buf(fill, batch_shape, window, n_tiles,
                                    device), ptr=_ptr(0))


def init_filtration_stats(window: int, n_tiles: int, fill=0.0,
                          batch_shape: tuple[int, ...] = (),
                          device=None) -> FiltrationStats:
    """Stats state for a ring uniformly at ``fill`` (closed-form sums)."""
    shape = batch_shape + (n_tiles,)
    fill_t = torch.as_tensor(fill, dtype=torch.float32, device=device)
    tile = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                     device=device).expand(shape).clone()
    return FiltrationStats(
        buf=_fill_buf(fill, batch_shape, window, n_tiles, device),
        ptr=_ptr(0),
        wsum=tile(window * fill_t),
        csum=torch.zeros(shape, dtype=torch.float32, device=device),
        rsum=tile(recent_len(window) * fill_t))


def exact_stats(buf: torch.Tensor, ptr,
                axis: int = -2) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(wsum, csum, rsum) recomputed exactly from a ring buffer.

    ``ptr`` is the next-write slot: ring slot j holds the sample of age
    k = (j − ptr) mod W.  Each sum is accumulated slot by slot, j = 0 … W−1,
    in f32 (``csum`` with fused multiply-adds, `repro_torch.fma_f32`) — the one
    summation order the wraparound refresh, the fused backend's chunk
    boundaries and the CUDA kernel's in-kernel refresh all share, so a
    refresh equals this recompute bit for bit.  ``axis`` names the window
    axis (−2 in the state layout, 0 in the kernel's layout).
    """
    w = buf.shape[axis]
    q = recent_len(w)
    tm = (w - 1) / 2.0
    p = int(ptr)
    wsum = csum = rsum = torch.zeros_like(buf.select(axis, 0))
    for j in range(w):
        x = buf.select(axis, j)
        k = (j - p) % w
        wsum = wsum + x
        csum = fma_f32(k - tm, x, csum)
        if k >= w - q:
            rsum = rsum + x
    return wsum, csum, rsum


def _lane_slot(ptr: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
    """Per-lane ring indices [*batch] as a gather/scatter index
    [*batch, 1, n_tiles] into ``buf`` [*batch, W, n_tiles]."""
    return ptr.long()[..., None, None].expand(*buf.shape[:-2], 1,
                                               buf.shape[-1])


def _lane_read(buf: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """The ring row at each lane's own slot: [*batch, n_tiles]."""
    return torch.gather(buf, -2, _lane_slot(ptr, buf)).squeeze(-2)


def _lane_write(buf: torch.Tensor, ptr: torch.Tensor,
                rho: torch.Tensor) -> torch.Tensor:
    """A new ring with ``rho`` written at each lane's own slot."""
    return buf.scatter(-2, _lane_slot(ptr, buf), rho[..., None, :])


def _observe_stats(ft: FiltrationStats, rho: torch.Tensor) -> FiltrationStats:
    """O(1) sliding update: evict-read, three multiply-adds, one write
    (``csum``'s two multiply-adds fused, `repro_torch.fma_f32`).  With
    per-lane pointers (the vmap layout) the ring is read and written at
    each lane's own slot and the wraparound refresh is selected per lane."""
    w = ft.buf.shape[-2]
    q = recent_len(w)
    tm = (w - 1) / 2.0
    lanes = ft.ptr.ndim > 0
    if lanes:
        x_old = _lane_read(ft.buf, ft.ptr)
        x_rec = _lane_read(ft.buf, (ft.ptr + w - q) % w)
    else:
        p = int(ft.ptr)
        x_old = ft.buf[..., p, :]
        x_rec = ft.buf[..., (p + w - q) % w, :]
    wsum = ft.wsum - x_old + rho
    csum = fma_f32(tm, rho, fma_f32(tm + 1.0, x_old, ft.csum - ft.wsum))
    rsum = ft.rsum - x_rec + rho
    if lanes:
        buf = _lane_write(ft.buf, ft.ptr, rho)
        nxt = ((ft.ptr + 1) % w).to(torch.int32)
        wrap = (nxt == 0)[..., None]
        wsum, csum, rsum = (torch.where(wrap, e, x) for e, x in
                            zip(exact_stats(buf, 0), (wsum, csum, rsum)))
        return FiltrationStats(buf=buf, ptr=nxt, wsum=wsum, csum=csum,
                               rsum=rsum)
    buf = ft.buf.clone()            # states are values: callers may keep ft
    buf[..., p, :] = rho
    nxt = (p + 1) % w
    if nxt == 0:
        # exact refresh at wraparound (the ring is age-ordered at ptr 0):
        # bounds float drift to <= W steps of accumulation for ANY length
        wsum, csum, rsum = exact_stats(buf, 0)
    return FiltrationStats(buf=buf, ptr=_ptr(nxt), wsum=wsum, csum=csum,
                           rsum=rsum)


def observe(ft, rho: torch.Tensor):
    """Push one density sample ([..., n_tiles]) into either representation."""
    if isinstance(ft, FiltrationStats):
        return _observe_stats(ft, rho)
    w = ft.buf.shape[-2]
    if ft.ptr.ndim:
        return Filtration(buf=_lane_write(ft.buf, ft.ptr, rho),
                          ptr=((ft.ptr + 1) % w).to(torch.int32))
    p = int(ft.ptr)
    buf = ft.buf.clone()
    buf[..., p, :] = rho
    return Filtration(buf=buf, ptr=_ptr((p + 1) % w))


def _ordered(ft: Filtration) -> torch.Tensor:
    """History oldest→newest along the window axis (-2)."""
    if ft.ptr.ndim:
        w = ft.buf.shape[-2]
        idx = (torch.arange(w, device=ft.buf.device)
               + ft.ptr.long()[..., None]) % w              # [*batch, W]
        return torch.gather(ft.buf, -2, idx[..., None].expand(ft.buf.shape))
    return torch.roll(ft.buf, -int(ft.ptr), dims=-2)


def predict_rho(ft, lookahead_ms: float, dt_ms: float = 1.0) -> torch.Tensor:
    """ρ̂(t + Δt_la | Ft): smoothed level + dρ/dt ramp extrapolation.

    Level = mean of the newest quarter of the window; slope = least squares
    over the full window.  Clipped to the paper's density domain.  With
    `FiltrationStats` the estimator is the closed form over the sliding
    sums (divisions by the window constants written as the f32 reciprocal
    multiplies the reference's compiled program performs).
    """
    ahead = lookahead_ms / dt_ms
    hi = 1.5 * FINGERPRINT.rho_max
    if isinstance(ft, FiltrationStats):
        w = ft.buf.shape[-2]
        slope = ft.csum * _f32_recip(slope_denom(w))
        recent = ft.rsum * _f32_recip(recent_len(w))
        return torch.clamp(recent + slope * ahead, 0.0, hi)
    hist = _ordered(ft)                       # [..., W, n_tiles]
    w = hist.shape[-2]
    t = torch.arange(w, dtype=hist.dtype, device=hist.device)
    tm, hm = t.mean(), hist.mean(dim=-2, keepdim=True)
    tc = (t - tm)[:, None]
    slope = (tc * (hist - hm)).sum(-2) / ((t - tm) ** 2).sum()
    recent = hist[..., -recent_len(w):, :].mean(dim=-2)
    return torch.clamp(recent + slope * ahead, 0.0, hi)


def hint(ft, gamma: torch.Tensor | None, lookahead_ms: float,
         dt_ms: float = 1.0) -> torch.Tensor:
    """H(t) = Γ · P_EIC(t + Δt_la | Ft)   [per-tile W] (paper §5.1).

    The scalar-Γ V24 form is the ``gamma=None`` case.
    """
    p_ahead = power_from_rho(predict_rho(ft, lookahead_ms, dt_ms))
    return p_ahead if gamma is None else apply_coupling(gamma, p_ahead)
