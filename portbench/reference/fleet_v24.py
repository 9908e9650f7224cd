"""Plain reference of the paper's closed firmware loop: the v24 scheduler on
the two-pole plant with Γ coupling (§4.2, §5.1, §5.2), batched over
packages, in float32 with the roundings the loop is specified with.

A frozen copy, in plain PyTorch, of the loop's plain step as the fused
window runs it; it imports nothing of the program under test.  The coupled
47-tile law sits on a knife edge: where the budget and the neighbours' heat
nearly cancel, one ulp grows into different frequencies within a few tens
of steps.  So the loop is specified to the rounding, and this reference
keeps it: each multiply-add whose result cancels is one fused multiply-add
(rounded once), each Γ product accumulates source tile by source tile in
that fused form, divisions by constants are products with their float32
reciprocals, the fractional power is correctly rounded, and the sliding
statistics are rederived from the ring at each window's start (the fused
window's convention) and at each wrap.

One step, for density ρ [n, tiles]:

    P(ρ)   = (α·(s·ρ + i) + β) · (1/Rth)                 tile power
    ρ̂      = clip(r/q + (c/D)·ahead, 0, 1.5·ρ_max)       sliding fit
    H      = max(Γ·P(ρ̂), Γ·P(ρ))                         the hint
    B      = (T_allow − (1 − η)·ΔT) · 1/(η·ΣG)           the budget
    f_uni  = clip((B / max(H, 1e-3))^(1/3), 0.05, 1)
    f_cpl  = clip((max(B − (Γ·P·f³ − diag Γ·P·f³), 1e-6)
                   / max(diag Γ·P, 1e-3))^(1/3), 0.05, 1)
    f      = min(f_uni, f_cpl, f_prev + 0.05)            (coupled)
    s_k    ← a_k·s_k + (1 − a_k)·G_k·(Γ·P·f³)            each pole
    T      = T_amb + Σ_k s_k,  events += any(T > T_crit)

A single tile has no Γ: f = f_uni.  The control (``tf32``) rounds both
inputs of every Γ product to TF32's 10-bit mantissa, as a TF32 matrix
product would.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

F32 = torch.float32


def f32(x: float) -> float:
    return float(np.float32(x))


def fma(a, b: torch.Tensor, c) -> torch.Tensor:
    """a·b + c rounded once to float32 (a, c float32 tensors broadcasting
    against ``b`` or float32-valued numbers).  a·b is exact in float64; its
    sum with c, rounded to float64 and then float32, differs from one
    rounding only where the float64 sum lies exactly halfway between two
    float32 values while the exact sum does not: there it moves one float64
    step toward the exact value first."""
    x = (a.double() if torch.is_tensor(a) else a) * b.double()
    cd = c.double() if torch.is_tensor(c) else c
    s = x + cd
    mid = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    t = s - x
    err = (x - (s - t)) + (cd - t)
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    return torch.where(mid & (err != 0), torch.nextafter(s, toward),
                       s).float()


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to nearest (ties to even) at 10 mantissa
    bits."""
    i = x.contiguous().view(torch.int32)
    i = (i + (((i >> 13) & 1) + 0xFFF)) & ~0x1FFF
    return i.view(F32)


class FleetState(NamedTuple):
    ring: torch.Tensor      # [n, W, tiles] density history, oldest first
    thermal: torch.Tensor   # [n, tiles, poles] pole temperatures (°C)
    freq: torch.Tensor      # [n, tiles]
    events: torch.Tensor    # [n] float32 (exact counts)


class Params(NamedTuple):
    k: dict                 # float32 constants
    decay: list
    coef: list              # (1 − a_k)·G_k
    gamma: torch.Tensor | None
    plan: tuple | None      # Γ's non-zeros, row by row, in column order
    window: int
    recent: int
    tf32: bool
    graphs: dict            # CUDA graphs of a W-step block, by shape


def coupling_matrix(n_tiles: int, cols: int, bands: dict) -> np.ndarray:
    """Γ [n, n] (float64) with the paper's distance bands on a
    ``cols``-wide grid: self, face neighbours the vertical band, diagonal
    neighbours the lateral band, Manhattan 2–3 otherwise the distant band,
    zero beyond."""
    idx = np.arange(n_tiles)
    xy = np.stack([idx // cols, idx % cols], axis=1)
    d = np.abs(xy[:, None, :] - xy[None, :, :])
    man, cheb = d.sum(-1), d.max(-1)
    g = np.zeros((n_tiles, n_tiles))
    g[(man >= 2) & (man <= 3)] = bands["distant"]
    g[(cheb == 1) & (man == 2)] = bands["lateral"]
    g[man == 1] = bands["vertical"]
    g[man == 0] = bands["self"]
    return g


def _row_sums(x: torch.Tensor, window: int = 32) -> torch.Tensor:
    """float32 row sums in the loop's specified order: sequential up to 32
    columns; beyond, windows of 32 with the padding split over both ends,
    then the windows' sums the same way."""
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
    return _row_sums(torch.stack(parts, dim=1), window)


def params(sched: dict, fp: dict, device="cpu", tf32: bool = False
           ) -> Params:
    """The loop's float32 constants from a configuration's ``scheduler``
    and ``fingerprint`` groups."""
    dt = sched["step_ms"]
    decay = np.exp(np.asarray([-dt / fp["tau1_ms"], -dt / fp["tau2_ms"]],
                              np.float32))
    gain = np.asarray([fp["a1_frac"] * fp["rth_c_per_w"],
                       (1.0 - fp["a1_frac"]) * fp["rth_c_per_w"]],
                      np.float32)
    ahead = sched["lookahead_steps"]          # lookahead_ms / step_ms
    eta = np.float32(1.0) - decay[-1] ** np.float32(ahead)
    gain_sum = gain.sum()
    w = sched["filtration_window"]
    q = max(w // 4, 1)
    slope = ((fp["rtok_max_mtps"] - fp["rtok_min_mtps"])
             / (fp["rho_max"] - fp["rho_min"]))
    k = dict(
        tm=f32((w - 1) / 2.0), tm1=f32((w - 1) / 2.0 + 1.0),
        inv_q=float(np.float32(1.0) / np.float32(q)),
        inv_denom=float(np.float32(1.0) / np.float32(w * (w * w - 1) / 12.0)),
        ahead=f32(ahead), rho_hi=f32(1.5 * fp["rho_max"]),
        rtok_slope=f32(slope),
        rtok_icept=f32(fp["rtok_min_mtps"] - slope * fp["rho_min"]),
        alpha=f32(fp["alpha_c_per_mtps"]), beta=f32(fp["beta_c"]),
        inv_rth=float(np.float32(1.0) / np.float32(fp["rth_c_per_w"])),
        t_allow=f32(fp["t_crit_c"] - sched["t_safe_margin_c"]
                    - fp["t_ambient_c"]),
        one_m_eta=f32(1.0 - float(eta)),
        inv_eta_gain=float(np.float32(1.0) / (eta * gain_sum)),
        power_exponent=f32(sched["power_exponent"]),
        inv_exp=f32(1.0 / sched["power_exponent"]),
        t_crit=f32(fp["t_crit_c"]), t_ambient=f32(fp["t_ambient_c"]),
        straggler=sched["straggler_threshold"], rho_fill=f32(fp["rho_min"]),
        rtok_slope64=slope,
        rtok_icept64=fp["rtok_min_mtps"] - slope * fp["rho_min"])
    n = sched["n_tiles"]
    gamma = plan = None
    if sched["use_coupling"] and n > 1:
        g = torch.as_tensor(coupling_matrix(n, sched["coupling_cols"],
                                            sched["coupling_bands"]),
                            dtype=F32)
        g = g / _row_sums(g)[:, None]
        if tf32:
            g = to_tf32(g)
        nz = [torch.nonzero(g[i]).flatten().tolist() for i in range(n)]
        r = max(len(z) for z in nz)
        idx = torch.zeros((r, n), dtype=torch.int64)
        cf = torch.zeros((r, n), dtype=F32)
        for i, z in enumerate(nz):
            for rank, j in enumerate(z):
                idx[rank, i], cf[rank, i] = j, g[i, j]
        gamma = g.to(device)
        plan = (idx.to(device), cf.to(device))
    coef = (np.float32(1.0) - decay) * gain
    return Params(k=k, decay=[float(d) for d in decay],
                  coef=[float(c) for c in coef], gamma=gamma, plan=plan,
                  window=w, recent=q, tf32=tf32, graphs={})


def couple(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Γ·x over the tile axis of x [..., tiles]: for each output tile, its
    row's non-zero terms added in column order, each a fused multiply-add
    (a zero term leaves the sum as it is)."""
    if p.gamma is None:
        return x
    idx, cf = p.plan
    if p.tf32:
        x = to_tf32(x)
    acc = torch.zeros_like(x)
    for r in range(idx.shape[0]):
        acc = fma(cf[r], x[..., idx[r]], acc)
    return acc


def power(p: Params, rho: torch.Tensor) -> torch.Tensor:
    k = p.k
    return fma(k["alpha"], fma(k["rtok_slope"], rho, k["rtok_icept"]),
               k["beta"]) * k["inv_rth"]


def exact_stats(ring: torch.Tensor, k: dict, q: int):
    """(Σρ, Σ(age − t̄)·ρ, Σ newest q) of an oldest-first ring, slot by
    slot."""
    w = ring.shape[1]
    wsum = csum = rsum = torch.zeros_like(ring[:, 0])
    for j in range(w):
        x = ring[:, j]
        wsum = wsum + x
        csum = fma(f32(j - (w - 1) / 2.0), x, csum)
        if j >= w - q:
            rsum = rsum + x
    return wsum, csum, rsum


def pow_f32(x: torch.Tensor, y: float) -> torch.Tensor:
    """x^y correctly rounded to float32 (pow in float64, one rounding)."""
    return (x.double() ** y).float()


def init(p: Params, n: int, n_tiles: int, device="cpu") -> FleetState:
    """A fresh fleet: the ring at ρ_min, the plant cold, f = 1, no events."""
    return FleetState(
        ring=torch.full((n, p.window, n_tiles), p.k["rho_fill"], dtype=F32,
                        device=device),
        thermal=torch.zeros((n, n_tiles, len(p.decay)), dtype=F32,
                            device=device),
        freq=torch.ones((n, n_tiles), dtype=F32, device=device),
        events=torch.zeros((n,), dtype=F32, device=device))


def _advance(p: Params, ring, wsum, csum, rsum, th, f, ev, rho_block):
    """Steps over ``rho_block`` [K, n, tiles] from slot 0 of an oldest-first
    ring (K ≤ W); returns the carried tensors and the block's temperature
    and frequency traces."""
    k, w, q = p.k, p.window, p.recent
    ring = ring.clone()
    th = [th[j] for j in range(th.shape[0])]
    gd = None if p.gamma is None else torch.diagonal(p.gamma)
    pe = k["power_exponent"]
    temps, freqs = [], []
    for t in range(rho_block.shape[0]):
        r = rho_block[t]
        x_old, x_rec = ring[:, t], ring[:, (t + w - q) % w]
        wsum_n = wsum - x_old + r
        csum_n = fma(k["tm"], r, fma(k["tm1"], x_old, csum - wsum))
        rsum_n = rsum - x_rec + r
        ring[:, t] = r
        if t + 1 == w:
            wsum_n, csum_n, rsum_n = exact_stats(ring, k, q)
        wsum, csum, rsum = wsum_n, csum_n, rsum_n

        p_now = power(p, r)
        dt_now = th[0]
        for j in range(1, len(th)):
            dt_now = dt_now + th[j]
        pred = torch.clamp(rsum * k["inv_q"]
                           + (csum * k["inv_denom"]) * k["ahead"],
                           0.0, k["rho_hi"])
        p_prev = p_now * f ** pe
        # the hint's two products and the neighbours' heat: one chain
        ahead_, now_, prev_ = couple(p, torch.stack(
            [power(p, pred), p_now, p_prev]))
        hint = torch.maximum(ahead_, now_)
        budget = fma(-k["one_m_eta"], dt_now, k["t_allow"]) \
            * k["inv_eta_gain"]
        f_new = torch.clamp(pow_f32(budget / hint.clamp(min=1e-3),
                                    k["inv_exp"]), 0.05, 1.0)
        if gd is not None:
            neigh = prev_ - gd * p_prev
            f_cpl = torch.clamp(pow_f32(
                (budget - neigh).clamp(min=1e-6)
                / (gd * p_now).clamp(min=1e-3), k["inv_exp"]), 0.05, 1.0)
            f_new = torch.minimum(torch.minimum(f_new, f_cpl), f + 0.05)
        p_eff = couple(p, p_now * f_new ** pe)
        dt = None
        for j in range(len(th)):
            th[j] = fma(p.decay[j], th[j], p.coef[j] * p_eff)
            dt = th[j] if dt is None else dt + th[j]
        temp = k["t_ambient"] + dt
        ev = ev + (temp > k["t_crit"]).any(dim=-1).float()
        f = f_new
        temps.append(temp)
        freqs.append(f)
    return (ring, wsum, csum, rsum, torch.stack(th), f, ev,
            torch.stack(temps), torch.stack(freqs))


def _graphed(p: Params, carry: list, w: int):
    """(graph, its static state, density block, temperature and frequency
    traces): a CUDA graph of `_advance` over one W-step block that writes
    the carried state back into its static tensors.  Its kernels and their
    order are those of the eager steps."""
    key = (tuple(carry[0].shape), str(carry[0].device))
    if key not in p.graphs:
        dev = carry[0].device
        state = [x.clone() for x in carry]
        n, _, nt = carry[0].shape
        rho = torch.zeros((w, n, nt), dtype=F32, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _advance(p, *state, rho)                  # warm the allocator
        torch.cuda.current_stream(dev).wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = _advance(p, *state, rho)
            for dst, src in zip(state, out[:7]):
                dst.copy_(src)
        p.graphs[key] = (g, state, rho, out[7], out[8])
    return p.graphs[key]


def run(p: Params, s: FleetState, rho_trace: torch.Tensor):
    """Step a [T, n, tiles] window from ``s``; returns (state', temps
    [T, n, tiles], freqs [T, n, tiles]).  On a card each W-step block
    replays a CUDA graph of the same steps."""
    k, w, q = p.k, p.window, p.recent
    carry = [s.ring.clone(), *exact_stats(s.ring, k, q),
             s.thermal.permute(2, 0, 1).contiguous(), s.freq.clone(),
             s.events.clone()]
    t_all = rho_trace.shape[0]
    temps, freqs = [], []
    if rho_trace.is_cuda and t_all % w == 0:
        g, state, rho, tt, ff = _graphed(p, carry, w)
        for dst, src in zip(state, carry):
            dst.copy_(src)
        for b in range(0, t_all, w):
            rho.copy_(rho_trace[b:b + w])
            g.replay()
            temps.append(tt.clone())
            freqs.append(ff.clone())
        carry = [x.clone() for x in state]
    else:
        for b in range(0, t_all, w):
            out = _advance(p, *carry, rho_trace[b:b + w])
            carry = list(out[:7])
            temps.append(out[7])
            freqs.append(out[8])
            if out[7].shape[0] < w:      # a short tail: ring oldest first
                carry[0] = torch.roll(carry[0], -out[7].shape[0], dims=1)
    ring, _, _, _, th, f, ev = carry
    return (FleetState(ring=ring, thermal=th.permute(1, 2, 0).contiguous(),
                       freq=f, events=ev),
            torch.cat(temps), torch.cat(freqs))


def _percentile(sorted_v: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolated percentile of each row of an ascending [T, m]
    tensor (numpy's default rule), in float64."""
    m = sorted_v.shape[1]
    pos = q / 100.0 * (m - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    return sorted_v[:, lo] * (1.0 - (pos - lo)) + sorted_v[:, hi] * (pos - lo)


def record(p: Params, s0: FleetState, s1: FleetState, rho_trace, temps,
           freqs) -> dict:
    """The window's flush record from its traces, reduced in float64: the
    events, the per-step temperature percentiles (p50 averaged, p99 and
    max the worst step), the frequency mean and minimum, the compute
    released and held back (Σ R_tok·f, Σ R_tok·(1 − f), averaged), the
    share of tiles below the straggler threshold."""
    k = p.k
    t = temps.shape[0]
    tt = temps.reshape(t, -1).double()
    ff = freqs.reshape(t, -1).double()
    rt = (k["rtok_slope64"] * rho_trace.double()
          + k["rtok_icept64"]).reshape(t, -1)
    st = torch.sort(tt, dim=1).values
    return {
        "n_packages": s1.freq.shape[0],
        "events_total": float(s1.events.double().sum()),
        "events_step": float((s1.events - s0.events).double().sum()),
        "temp_p50_c": float(_percentile(st, 50.0).mean()),
        "temp_p99_c": float(_percentile(st, 99.0).max()),
        "temp_max_c": float(tt.max()),
        "freq_mean": float(ff.mean(1).mean()),
        "freq_min": float(ff.min()),
        "released_mtps": float((rt * ff).sum(1).mean()),
        "throttled_mtps": float((rt * (1.0 - ff)).sum(1).mean()),
        "at_risk_frac": float((ff < k["straggler"]).double().mean(1).mean()),
    }


def window(p: Params, s: FleetState, rho_trace) -> tuple[FleetState, dict]:
    """Run a [T, n, tiles] window; returns (state', its flush record)."""
    s1, temps, freqs = run(p, s, rho_trace)
    return s1, record(p, s, s1, rho_trace, temps, freqs)


def step(p: Params, s: FleetState, rho) -> tuple[FleetState, torch.Tensor,
                                                 torch.Tensor]:
    """One step from ``s`` (its sliding statistics rederived from the
    ring); returns (state', temperature, frequency)."""
    s1, temps, freqs = run(p, s, rho[None])
    return s1, temps[0], freqs[0]
