"""The whole fleet scheduler step, fused over a T-step flush window.

Port of the TPU kernel `repro.kernels.fleet_step.fleet_step` (Pallas body
`_kernel`).  One call advances a [packages × tiles] fleet over a density
window `[T, n_tiles, n]`: per step the O(1) sliding filtration with its
exact refresh every W steps, the Γ-coupled PDU-gate hint, the v24 /
reactive / reactive_poll / off control law with the +0.05 slew cap, the
n-pole plant, and the event count over the package's tiles.

  * `fleet_step` — the wrapper.  On CUDA tensors it launches the hand-written
    Hopper kernel (``csrc/fleet_step.cu``, one launch per window, the state
    in registers for the whole window) or raises; on CPU tensors it runs
    `fleet_step_reference`.  ``fleet_step.launches`` counts kernel launches.
  * `fleet_step_reference` — the plain PyTorch version: a Python loop over T
    in the kernel's op order and layout, the CPU twin the tests hold to the
    reference and the yardstick the kernel is checked against on the card.

Layout (packages last, as in the reference kernel's interface):
rho/temps/freqs [T, tiles, n], ring [W, tiles, n] (ptr = 0 on entry, the
caller rolls it), poles [n_poles, tiles, n], stats [3, tiles, n],
freq [tiles, n], events [1, n] (f32 counts).

Every mode and plane of the reference kernel: ``step0`` (the global step of
the window's first row, for the polled sensor's phase), the heterogeneous
rows ``het`` [2·n_poles + 3, tiles | 1, n] (decay and gain per pole, η, ΣG,
poll), the degraded-fallback plane ``fb0`` (held ρ, staleness counter and
latch, all f32) and the operator mode plane ``mode0`` [n], at any tile
count (the CUDA kernel takes a second layout above 128 tiles).
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch import fma_f32, pow_f32

_MODES = {"v24": 0, "reactive": 1, "reactive_poll": 2, "off": 3}
_MAX_POLES = 4


@dataclasses.dataclass(frozen=True)
class FleetStepParams:
    """Scheduler constants of one fleet (same fields as the reference's)."""

    window: int            # filtration depth W
    recent: int            # newest-quarter depth Q
    n_poles: int
    mode: str              # v24 | reactive | reactive_poll | off
    use_gamma: bool
    power_exponent: float
    eta: float
    t_allow: float         # t_crit − margin − t_ambient
    gain_sum: float | None  # Σ pole gains (None: per-tile, het rows only)
    ahead: float           # lookahead_ms / step_ms
    # power_from_rho's affine chain ρ → R_tok → ΔT → P
    rtok_slope: float
    rtok_icept: float
    alpha: float
    beta: float
    rth: float
    rho_hi: float          # predict_rho clip ceiling (1.5·ρ_max)
    t_crit_c: float
    t_ambient_c: float
    throttle_floor: float
    decay: tuple           # per-pole a_i = exp(−dt/τ_i)
    gain: tuple | None     # per-pole G_i [°C/W] (None: as gain_sum)
    throttle_level: float = 0.55
    resume_below_c: float = 66.0
    ramp: float = 0.045    # per-step frequency ramp-back
    poll_ticks: int = 25   # sensor polling period [steps]
    # degraded fallback (v24 + SchedulerConfig.degraded_fallback): lanes
    # with stale hints run the reactive_poll law; fb0 carries the plane
    fallback: bool = False
    stale_limit: int = 5   # consecutive stale steps before fallback
    recover: int = 10      # hysteresis: fresh steps before recovery
    # operator-pinned controller mode (v24 + SchedulerConfig.mixed_mode):
    # mode0 pins lanes to reactive_poll through the same merged branch
    mixed: bool = False


def _f32(x) -> float:
    """``x`` rounded to f32, as a python float (exact in every f32 op)."""
    return float(np.float32(x))


class _Consts(ctypes.Structure):
    """Mirrors ``struct FleetStepConsts`` in csrc/fleet_step.cu."""

    _fields_ = ([(k, ctypes.c_int) for k in (
        "T", "n_tiles", "n", "window", "recent", "n_poles", "mode",
        "use_gamma", "poll_ticks", "step0", "exp_kind", "het", "fallback",
        "mixed", "stale_limit", "recover")]
        + [(k, ctypes.c_float) for k in (
            "power_exponent", "inv_exp", "tm", "tm1", "inv_q", "inv_denom",
            "ahead", "rho_hi", "rtok_slope", "rtok_icept", "alpha", "beta",
            "inv_rth", "t_allow", "one_m_eta", "inv_eta_gain", "t_crit",
            "t_ambient", "throttle_floor", "throttle_level", "resume_below",
            "ramp")]
        + [("decay", ctypes.c_float * _MAX_POLES),
           ("coef", ctypes.c_float * _MAX_POLES)])


def _consts(p: FleetStepParams) -> dict:
    """The f32 constants both versions compute with, derived once.

    Each is the value the reference's compiled program multiplies by:
    divisions by a window constant or by Rth become f32 reciprocal
    multiplies, ``1 − η`` rounds once from double, ``1/(η·ΣG)`` is an f32
    product and quotient, and each pole's (1 − a)·G is an f32 product (the
    scheduler's derivation, shared with the per-step engine).
    """
    w, q = p.window, p.recent
    decay = np.asarray(p.decay, np.float32)
    # a bank without fleet-wide gains (a per-tile ROM) computes with its
    # het rows only: these constants are NaN and never read
    gain = (np.full(decay.shape, np.nan, np.float32) if p.gain is None
            else np.asarray(p.gain, np.float32))
    gain_sum = np.float32(np.nan if p.gain_sum is None else p.gain_sum)
    coef = (np.float32(1.0) - decay) * gain
    return dict(
        power_exponent=_f32(p.power_exponent),
        inv_exp=_f32(1.0 / p.power_exponent),
        tm=_f32((w - 1) / 2.0), tm1=_f32((w - 1) / 2.0 + 1.0),
        inv_q=float(np.float32(1.0) / np.float32(q)),
        inv_denom=float(np.float32(1.0) / np.float32(w * (w * w - 1) / 12.0)),
        ahead=_f32(p.ahead), rho_hi=_f32(p.rho_hi),
        rtok_slope=_f32(p.rtok_slope), rtok_icept=_f32(p.rtok_icept),
        alpha=_f32(p.alpha), beta=_f32(p.beta),
        inv_rth=float(np.float32(1.0) / np.float32(p.rth)),
        t_allow=_f32(p.t_allow), one_m_eta=_f32(1.0 - p.eta),
        inv_eta_gain=float(np.float32(1.0) / (np.float32(p.eta)
                                              * gain_sum)),
        t_crit=_f32(p.t_crit_c), t_ambient=_f32(p.t_ambient_c),
        throttle_floor=_f32(p.throttle_floor),
        throttle_level=_f32(p.throttle_level),
        resume_below=_f32(p.resume_below_c), ramp=_f32(p.ramp),
        decay=[float(d) for d in decay], coef=[float(x) for x in coef])


def fleet_step_cost(rho, gamma, params: FleetStepParams, *,
                    het=None) -> tuple[int, int]:
    """(bytes, f32 operations) the fused step must spend on these inputs.

    Bytes: every input read once and every output written once (the het
    rows as given, a [1, n] row broadcasting over tiles counted once; the
    fallback's and the pins' planes from ``params``).
    Operations, per (package, tile, step), counted from the kernel's code:
    adds, multiplies, divisions, compares, min/max and pow count 1, an FMA
    2; each Γ mat-vec counts 2 per NONZERO of Γ (the work this Γ needs — Γ
    is sparse), four per step for coupled v24 (hint, load floor, neighbour
    heat, plant) and one for the other coupled modes (plant).  The fallback
    adds its finite test, hold and counter, the merged branch its polled
    sensor and blend.
    """
    p = params
    t, nt, n = rho.shape
    w, q, np_ = p.window, p.recent, p.n_poles
    ew = 9 + (3 * w + q) / w + 5 + (np_ - 1) + 3 + 4 * np_ + 1 + 1
    ew += {"v24": 6 + 5 + 3 + 1 + 3 + 5 + (13 if p.use_gamma else 0),
           "reactive": 4, "off": 0, "reactive_poll": 4}[p.mode]
    merged = p.fallback or p.mixed
    ew += (4 if p.fallback else 0) + (12 if merged else 0)
    ops = ew * t * nt * n + (8 * t * n if p.fallback else 0)
    if p.use_gamma:
        nnz = int((gamma != 0).sum())
        ops += (4 if p.mode == "v24" else 1) * 2 * nnz * t * n
    latch = p.mode == "reactive_poll" or merged
    plane = nt * n
    floats = (t * plane + w * plane + np_ * plane + 3 * plane + plane + n
              + (plane if latch else 0) + (nt * nt if p.use_gamma else 0)
              + 2 * t * plane + w * plane + np_ * plane + n
              + (plane if latch else 0))
    if het is not None:
        floats += het.numel()
    if p.fallback:
        floats += 2 * (plane + 2 * n)
    if p.mixed:
        floats += n
    return 4 * floats, int(ops)


def _check(rho, buf0, th0, stats0, freq0, ev0, gamma, p: FleetStepParams,
           het, thr0, fb0, mode0) -> None:
    if p.mode not in _MODES:
        raise ValueError(f"unknown mode {p.mode!r}")
    if (p.fallback or p.mixed) and p.mode != "v24":
        raise ValueError("FleetStepParams.fallback / mixed require mode "
                         f"'v24', got {p.mode!r}")
    if p.fallback and (p.stale_limit < 1 or p.recover < 1):
        raise ValueError("stale_limit and recover must be >= 1")
    if p.fallback != (fb0 is not None):
        raise ValueError("the fb0 (rho_last, stale, degraded) plane goes "
                         "with FleetStepParams.fallback, and only with it")
    if p.mixed != (mode0 is not None):
        raise ValueError("the mode0 controller-mode plane goes with "
                         "FleetStepParams.mixed, and only with it")
    if het is None and (p.gain is None or p.gain_sum is None):
        raise ValueError("fleet_step: params without gain / gain_sum (a "
                         "per-tile bank) need the bank's het rows")
    if rho.ndim != 3:
        raise ValueError(f"rho must be [T, n_tiles, n], got {tuple(rho.shape)}")
    t, nt, n = rho.shape
    w, np_ = p.window, p.n_poles
    want = {"buf0": (buf0, (w, nt, n)), "th0": (th0, (np_, nt, n)),
            "stats0": (stats0, (3, nt, n)), "freq0": (freq0, (nt, n)),
            "ev0": (ev0, (1, n))}
    if p.use_gamma:
        want["gamma"] = (gamma, (nt, nt))
    elif gamma is not None:
        raise ValueError("gamma given but params.use_gamma is False")
    if p.mode == "reactive_poll" or p.fallback or p.mixed:
        want["thr0"] = (thr0, (nt, n))
    elif thr0 is not None:
        raise ValueError("thr0 is the hysteresis latch of reactive_poll, "
                         f"the fallback and mixed mode; mode is {p.mode!r}")
    if het is not None:
        rows = 2 * np_ + 3
        if het.ndim != 3 or het.shape[0] != rows or het.shape[2] != n \
                or het.shape[1] not in (1, nt):
            raise ValueError(f"fleet_step: het must be [{rows}, {nt}|1, {n}],"
                             f" got {tuple(het.shape)}")
        want["het"] = (het, tuple(het.shape))
    if fb0 is not None:
        rl0, st0, dg0 = fb0
        want.update(rho_last=(rl0, (nt, n)), stale=(st0, (n,)),
                    degraded=(dg0, (n,)))
    if mode0 is not None:
        want["mode0"] = (mode0, (n,))
    for name, (x, shape) in {"rho": (rho, (t, nt, n)), **want}.items():
        if x is None:
            raise ValueError(f"fleet_step: {name} is required")
        if tuple(x.shape) != shape:
            raise ValueError(f"fleet_step: {name} must be {shape}, got "
                             f"{tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise TypeError(f"fleet_step: {name} must be float32, got "
                            f"{x.dtype}")
        if x.device != rho.device:
            raise ValueError(f"fleet_step: {name} is on {x.device}, rho on "
                             f"{rho.device}")
        if not x.is_contiguous():
            raise ValueError(f"fleet_step: {name} must be contiguous")
    if not 1 <= np_ <= _MAX_POLES:
        raise ValueError(f"fleet_step supports 1..{_MAX_POLES} poles")
    if t == 0:
        raise ValueError("fleet_step: empty window (T = 0)")


def fleet_step(rho, buf0, th0, stats0, freq0, ev0, gamma,
               params: FleetStepParams, *, het=None, thr0=None, step0=0,
               fb0=None, mode0=None, rows=None):
    """Fused T-step fleet advance (layout in the module docstring).

    Returns (temps [T, n_tiles, n], freqs [T, n_tiles, n],
             buf [W, n_tiles, n] (ring, ptr = T mod W),
             th [n_poles, n_tiles, n], ev [1, n],
             thr [n_tiles, n] f32 latch or None,
             fb (rho_last [n_tiles, n], stale [n], degraded [n]) f32 or None).

    ``rows`` = `compact_rows(gamma)`, the Γ rows the CUDA kernel's wide
    layout walks: a caller that runs many windows over one Γ builds them
    once and passes them; left None, a wide launch builds them itself.
    The reference's TPU grid knobs (``block_packages``, ``time_chunk``,
    ``interpret``) have no counterpart: the CUDA kernel runs the whole
    window in one launch.
    """
    _check(rho, buf0, th0, stats0, freq0, ev0, gamma, params, het, thr0,
           fb0, mode0)
    kw = dict(het=het, thr0=thr0, step0=step0, fb0=fb0, mode0=mode0)
    if rho.device.type == "cpu":
        return fleet_step_reference(rho, buf0, th0, stats0, freq0, ev0,
                                    gamma, params, **kw)
    if rho.device.type != "cuda":
        raise ValueError(f"fleet_step runs on cuda or cpu, got {rho.device}")
    return _launch(rho, buf0, th0, stats0, freq0, ev0, gamma, params,
                   rows=rows, **kw)


fleet_step.launches = 0


def layout(n_tiles: int, p: FleetStepParams) -> str:
    """The CUDA kernel's layout for a fleet, as its launcher decides it
    (`fleet_step_layout` in csrc/fleet_step.cu; needs the built library):
    "packed" (32 packages a block, up to 128 tiles) or "wide" (one package
    a block) — past 128 tiles, and for a coupled fleet with a reactive lane
    plane."""
    from repro_torch.kernels import _build

    fn = _build.load("fleet_step").fleet_step_layout
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4
    return {1: "packed", 2: "wide"}[fn(n_tiles, int(p.use_gamma),
                                       int(p.fallback), int(p.mixed))]


def compact_rows(gamma: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Γ's rows as the wide layout walks them: (cols, vals), each
    [L, n_tiles] with L the most non-zeros of any row; entry e of row r
    is its e-th non-zero column (ascending) and value, zero past the row's
    non-zeros (a NaN entry counts as non-zero)."""
    nz = gamma != 0
    count = nz.sum(dim=1, keepdim=True)
    order = torch.argsort((~nz).to(torch.int8), dim=1, stable=True)
    length = int(count.max())
    cols = order[:, :length]
    keep = torch.arange(length, device=gamma.device)[None, :] < count
    vals = torch.where(keep, gamma.gather(1, cols), 0.0)
    cols = torch.where(keep, cols, 0)
    return cols.mT.contiguous().to(torch.int32), vals.mT.contiguous()


def _launch(rho, buf0, th0, stats0, freq0, ev0, gamma, p, *, het, thr0,
            step0, fb0, mode0, rows):
    from repro_torch.kernels import _build

    lib = _build.load("fleet_step")
    fn = lib.fleet_step_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.POINTER(_Consts)] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] + [ctypes.c_void_p] * 22)
    t, nt, n = rho.shape
    k = _consts(p)
    c = _Consts(T=t, n_tiles=nt, n=n, window=p.window, recent=p.recent,
                n_poles=p.n_poles, mode=_MODES[p.mode],
                use_gamma=int(p.use_gamma), poll_ticks=int(p.poll_ticks),
                step0=int(step0),
                exp_kind={3.0: 3, 2.0: 2}.get(float(p.power_exponent), 0),
                het=int(het is not None), fallback=int(p.fallback),
                mixed=int(p.mixed), stale_limit=int(p.stale_limit),
                recover=int(p.recover),
                **{f: v for f, v in k.items() if f not in ("decay", "coef")})
    for j in range(p.n_poles):
        c.decay[j], c.coef[j] = k["decay"][j], k["coef"][j]
    out = lambda *s: torch.empty(s, dtype=torch.float32, device=rho.device)
    temps, freqs = out(t, nt, n), out(t, nt, n)
    buf, th, ev = out(p.window, nt, n), out(p.n_poles, nt, n), out(1, n)
    thr = out(nt, n) if thr0 is not None else None
    if het is not None:            # one row per tile: the kernel's layout
        het = het.expand(het.shape[0], nt, n).contiguous()
    fb = rho_s = None
    if fb0 is not None:
        # the held ρ, counter and latch out, and the window's sanitised ρ:
        # the ring the fallback's filtration reads is that, not raw ρ
        fb = (out(nt, n), out(n), out(n))
        rho_s = out(t, nt, n)
    # the wide layout walks Γ's compact rows
    if p.use_gamma and rows is None and layout(nt, p) == "wide":
        rows = compact_rows(gamma)
    cols, vals = rows if p.use_gamma and rows is not None else (None, None)
    if cols is not None and (cols.shape[1:] != (nt,) or vals.shape != cols.shape
                             or cols.dtype != torch.int32
                             or cols.device != rho.device):
        raise ValueError("fleet_step: rows must be compact_rows(gamma) on "
                         "rho's device")
    ptr = lambda x: None if x is None else x.data_ptr()
    fi, fo = fb0 or (None,) * 3, fb or (None,) * 3
    err = fn(ctypes.byref(c), ptr(rho), ptr(gamma), ptr(cols), ptr(vals),
             0 if cols is None else cols.shape[0], ptr(buf0), ptr(th0),
             ptr(stats0), ptr(freq0), ptr(ev0), ptr(thr0), ptr(het),
             ptr(fi[0]), ptr(fi[1]), ptr(fi[2]), ptr(mode0), ptr(temps),
             ptr(freqs), ptr(buf), ptr(th), ptr(ev), ptr(thr), ptr(fo[0]),
             ptr(fo[1]), ptr(fo[2]), ptr(rho_s),
             torch.cuda.current_stream(rho.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fleet_step kernel launch failed: cudaError_t "
                           f"{err}")
    fleet_step.launches += 1
    return temps, freqs, buf, th, ev, thr, fb


def fleet_step_reference(rho, buf0, th0, stats0, freq0, ev0, gamma,
                         params: FleetStepParams, *, het=None, thr0=None,
                         step0=0, fb0=None, mode0=None, rows=None):
    """Plain PyTorch version of `fleet_step`: same signature and outputs.

    A Python loop over T on [tiles, n] planes in the kernel's op order, Γ
    products through `apply_coupling` (so ``rows``, the CUDA kernel's
    copy of Γ, is not read).  Runs on any device; nothing on the main path
    calls it when a card is present.
    """
    _check(rho, buf0, th0, stats0, freq0, ev0, gamma, params, het, thr0,
           fb0, mode0)
    from repro_torch.core.coupling import apply_coupling
    from repro_torch.core.pdu_gate import exact_stats

    p, k = params, _consts(params)
    t, nt, n = rho.shape
    w, q, np_ = p.window, p.recent, p.n_poles
    ring, th = buf0.clone(), th0.clone()
    wsum, csum, rsum = stats0[0], stats0[1], stats0[2]
    f, ev = freq0, ev0.clone()
    latch = None if thr0 is None else thr0 > 0.5
    if p.use_gamma:
        gd = torch.diagonal(gamma)[:, None]
        couple = lambda x: apply_coupling(gamma, x.mT).mT   # [tiles, n]
    else:
        couple = lambda x: x
    pe = k["power_exponent"]
    power = lambda r: fma_f32(k["alpha"], fma_f32(
        k["rtok_slope"], r, k["rtok_icept"]), k["beta"]) * k["inv_rth"]
    if het is None:
        decay, coef, poll = k["decay"], k["coef"], p.poll_ticks
        neg_one_m_eta, inv_eta_gain = -k["one_m_eta"], k["inv_eta_gain"]
    else:
        # per-package planes with the same f32 ops as the baked constants
        h = het.expand(het.shape[0], nt, n)
        decay = [h[j] for j in range(np_)]
        coef = [(1.0 - h[j]) * h[np_ + j] for j in range(np_)]
        eta_l, gsum_l = h[2 * np_], h[2 * np_ + 1]
        neg_one_m_eta, inv_eta_gain = -(1.0 - eta_l), 1.0 / (eta_l * gsum_l)
        poll = h[2 * np_ + 2].to(torch.int64)
    merged = p.fallback or p.mixed
    if p.fallback:
        rho_last, stale, deg_prev = (x.clone() for x in fb0)
        lim, cap = float(p.stale_limit), float(p.stale_limit + p.recover)
    temps = torch.empty_like(rho)
    freqs = torch.empty_like(rho)

    for s in range(t):
        r = rho[s]
        if p.fallback:
            # non-finite words: hold the last finite ρ, count staleness per
            # package, latch with hysteresis (f32 counters, exact here)
            finite = torch.isfinite(r)
            r = torch.where(finite, r, rho_last)
            valid = finite.all(dim=0)
            stale = torch.where(valid, (stale - 1.0).clamp(min=0.0),
                                (stale + 1.0).clamp(max=cap))
            deg_prev = ((deg_prev > 0.5) & (stale > 0.5)
                        | (stale >= lim)).float()
            rho_last = r
        if merged:
            deg = (deg_prev if not p.mixed else mode0 if not p.fallback
                   else torch.maximum(deg_prev, mode0)) > 0.5
        ptr = s % w
        x_old, x_rec = ring[ptr], ring[(ptr + w - q) % w]
        wsum_n = wsum - x_old + r
        csum_n = fma_f32(k["tm"], r, fma_f32(k["tm1"], x_old, csum - wsum))
        rsum_n = rsum - x_rec + r
        ring[ptr] = r
        if (s + 1) % w == 0:
            wsum_n, csum_n, rsum_n = exact_stats(ring, 0, axis=0)
        wsum, csum, rsum = wsum_n, csum_n, rsum_n

        p_now = power(r)
        dt_now = th[0]
        for j in range(1, np_):
            dt_now = dt_now + th[j]
        if p.mode == "v24":
            pred = torch.clamp(rsum * k["inv_q"]
                               + (csum * k["inv_denom"]) * k["ahead"],
                               0.0, k["rho_hi"])
            p_ahead = power(pred)
            p_prev = p_now * f ** pe
            hint = torch.maximum(couple(p_ahead), couple(p_now))
            budget = fma_f32(neg_one_m_eta, dt_now, k["t_allow"]) \
                * inv_eta_gain
            f_uni = torch.clamp(
                pow_f32(budget / hint.clamp(min=1e-3), k["inv_exp"]),
                0.05, 1.0)
            if p.use_gamma:
                neigh = couple(p_prev) - gd * p_prev
                f_cpl = torch.clamp(pow_f32(
                    (budget - neigh).clamp(min=1e-6)
                    / (gd * p_now).clamp(min=1e-3), k["inv_exp"]), 0.05, 1.0)
                f_new = torch.minimum(torch.minimum(f_uni, f_cpl), f + 0.05)
            else:
                f_new = f_uni
            f_used = torch.where(deg, f, f_new) if merged else f_new
        elif p.mode == "reactive":
            hot = (k["t_ambient"] + dt_now) >= k["t_crit"]
            f_new = torch.where(hot, k["throttle_floor"],
                                torch.clamp(f + 0.1, max=1.0))
            f_used = f_new
        elif p.mode == "off":
            f_new = f_used = torch.ones_like(f)
        else:                       # reactive_poll: plant at LAST step's f
            f_used = f

        p_eff = couple(p_now * f_used ** pe)
        dt = None
        for j in range(np_):
            th[j] = fma_f32(decay[j], th[j], coef[j] * p_eff)
            dt = th[j] if dt is None else dt + th[j]
        temp = k["t_ambient"] + dt

        if p.mode == "reactive_poll" or merged:
            # the polled sensor, on the GLOBAL step (step0 + s)
            polled = (int(step0) + s) % poll == 0
            trig = (temp >= k["t_crit"]) & polled
            cool = (temp <= k["resume_below"]) & polled
            fresh = (trig & ~latch).any(dim=0, keepdim=True)
            latch_n = (latch | trig) & ~cool
            f_rp = torch.where(latch_n, k["throttle_level"],
                               torch.clamp(f + k["ramp"], max=1.0))
            if merged:
                crossed = (temp > k["t_crit"]).any(dim=0, keepdim=True)
                ev = ev + torch.where(deg, fresh, crossed).float()
                latch = latch_n & deg
                f_new = torch.where(deg, f_rp, f_new)
            else:
                ev = ev + fresh.float()
                latch, f_new = latch_n, f_rp
        else:
            ev = ev + (temp > k["t_crit"]).any(dim=0, keepdim=True).float()
        f = f_new
        temps[s] = temp
        freqs[s] = f_new

    fb = (rho_last, stale, deg_prev) if p.fallback else None
    return (temps, freqs, ring, th, ev,
            None if latch is None else latch.float(), fb)
