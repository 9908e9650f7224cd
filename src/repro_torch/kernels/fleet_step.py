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

Ported: homogeneous fleets in every mode, ``step0`` for the reactive_poll
sensor phase.  The heterogeneous rows (``het``), the degraded-fallback
plane (``fb0``) and the operator mode plane (``mode0``) raise until
ROADMAP queue 1 step 5.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch import fma_f32, pow_f32

_MODES = {"v24": 0, "reactive": 1, "reactive_poll": 2, "off": 3}
_MAX_POLES = 4
_MAX_TILES = 128     # the kernel's 8 tiles a thread × 16 warps


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
    gain_sum: float        # Σ pole gains
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
    gain: tuple            # per-pole G_i [°C/W]
    throttle_level: float = 0.55
    resume_below_c: float = 66.0
    ramp: float = 0.045    # per-step frequency ramp-back
    poll_ticks: int = 25   # sensor polling period [steps]
    fallback: bool = False     # degraded-fallback plane (not ported)
    mixed: bool = False        # operator mode plane (not ported)


def _f32(x) -> float:
    """``x`` rounded to f32, as a python float (exact in every f32 op)."""
    return float(np.float32(x))


class _Consts(ctypes.Structure):
    """Mirrors ``struct FleetStepConsts`` in csrc/fleet_step.cu."""

    _fields_ = ([(k, ctypes.c_int) for k in (
        "T", "n_tiles", "n", "window", "recent", "n_poles", "mode",
        "use_gamma", "poll_ticks", "step0", "exp_kind")]
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
    coef = (np.float32(1.0) - decay) * np.asarray(p.gain, np.float32)
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
                                              * np.float32(p.gain_sum))),
        t_crit=_f32(p.t_crit_c), t_ambient=_f32(p.t_ambient_c),
        throttle_floor=_f32(p.throttle_floor),
        throttle_level=_f32(p.throttle_level),
        resume_below=_f32(p.resume_below_c), ramp=_f32(p.ramp),
        decay=[float(d) for d in decay], coef=[float(x) for x in coef])


def fleet_step_cost(rho, gamma, params: FleetStepParams) -> tuple[int, int]:
    """(bytes, f32 operations) the fused step must spend on these inputs.

    Bytes: every input read once and every output written once.
    Operations, per (package, tile, step), counted from the kernel's code:
    adds, multiplies, divisions, compares, min/max and pow count 1, an FMA
    2; each Γ mat-vec counts 2 per NONZERO of Γ (the work this Γ needs — Γ
    is sparse), four per step for coupled v24 (hint, load floor, neighbour
    heat, plant) and one for the other coupled modes (plant).
    """
    p = params
    t, nt, n = rho.shape
    w, q, np_ = p.window, p.recent, p.n_poles
    ew = 9 + (3 * w + q) / w + 5 + (np_ - 1) + 3 + 4 * np_ + 1 + 1
    ew += {"v24": 6 + 5 + 3 + 1 + 3 + 5 + (13 if p.use_gamma else 0),
           "reactive": 4, "off": 0, "reactive_poll": 4}[p.mode]
    ops = ew * t * nt * n
    if p.use_gamma:
        nnz = int((gamma != 0).sum())
        ops += (4 if p.mode == "v24" else 1) * 2 * nnz * t * n
    rp = p.mode == "reactive_poll"
    plane = nt * n
    floats = (t * plane + w * plane + np_ * plane + 3 * plane + plane + n
              + (plane if rp else 0) + (nt * nt if p.use_gamma else 0)
              + 2 * t * plane + w * plane + np_ * plane + n
              + (plane if rp else 0))
    return 4 * floats, int(ops)


def _check(rho, buf0, th0, stats0, freq0, ev0, gamma, p: FleetStepParams,
           het, thr0, fb0, mode0) -> None:
    if het is not None or fb0 is not None or mode0 is not None \
            or p.fallback or p.mixed:
        raise NotImplementedError(
            "fleet_step: heterogeneous rows, the degraded-fallback plane and "
            "the operator mode plane are not ported yet: ROADMAP queue 1 "
            "step 5")
    if p.mode not in _MODES:
        raise ValueError(f"unknown mode {p.mode!r}")
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
    if p.mode == "reactive_poll":
        want["thr0"] = (thr0, (nt, n))
    elif thr0 is not None:
        raise ValueError("thr0 is the reactive_poll latch; mode is "
                         f"{p.mode!r}")
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
    if nt > _MAX_TILES:
        raise ValueError(f"fleet_step supports up to {_MAX_TILES} tiles")
    if t == 0:
        raise ValueError("fleet_step: empty window (T = 0)")


def fleet_step(rho, buf0, th0, stats0, freq0, ev0, gamma,
               params: FleetStepParams, *, het=None, thr0=None, step0=0,
               fb0=None, mode0=None):
    """Fused T-step fleet advance (layout in the module docstring).

    Returns (temps [T, n_tiles, n], freqs [T, n_tiles, n],
             buf [W, n_tiles, n] (ring, ptr = T mod W),
             th [n_poles, n_tiles, n], ev [1, n],
             thr [n_tiles, n] f32 latch (reactive_poll) or None, None).

    The reference's TPU grid knobs (``block_packages``, ``time_chunk``,
    ``interpret``) have no counterpart: the CUDA kernel runs the whole
    window in one launch.
    """
    _check(rho, buf0, th0, stats0, freq0, ev0, gamma, params, het, thr0,
           fb0, mode0)
    if rho.device.type == "cpu":
        return fleet_step_reference(rho, buf0, th0, stats0, freq0, ev0,
                                    gamma, params, thr0=thr0, step0=step0)
    if rho.device.type != "cuda":
        raise ValueError(f"fleet_step runs on cuda or cpu, got {rho.device}")
    return _launch(rho, buf0, th0, stats0, freq0, ev0, gamma, params,
                   thr0, int(step0))


fleet_step.launches = 0


def _launch(rho, buf0, th0, stats0, freq0, ev0, gamma, p, thr0, step0):
    from repro_torch.kernels import _build

    lib = _build.load("fleet_step")
    fn = lib.fleet_step_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_Consts)] + [ctypes.c_void_p] * 15
    t, nt, n = rho.shape
    k = _consts(p)
    c = _Consts(T=t, n_tiles=nt, n=n, window=p.window, recent=p.recent,
                n_poles=p.n_poles, mode=_MODES[p.mode],
                use_gamma=int(p.use_gamma), poll_ticks=int(p.poll_ticks),
                step0=step0,
                exp_kind={3.0: 3, 2.0: 2}.get(float(p.power_exponent), 0),
                **{f: v for f, v in k.items() if f not in ("decay", "coef")})
    for j in range(p.n_poles):
        c.decay[j], c.coef[j] = k["decay"][j], k["coef"][j]
    out = lambda *s: torch.empty(s, dtype=torch.float32, device=rho.device)
    temps, freqs = out(t, nt, n), out(t, nt, n)
    buf, th, ev = out(p.window, nt, n), out(p.n_poles, nt, n), out(1, n)
    thr = out(nt, n) if thr0 is not None else None
    ptr = lambda x: None if x is None else x.data_ptr()
    err = fn(ctypes.byref(c), ptr(rho), ptr(gamma), ptr(buf0), ptr(th0),
             ptr(stats0), ptr(freq0), ptr(ev0), ptr(thr0), ptr(temps),
             ptr(freqs), ptr(buf), ptr(th), ptr(ev), ptr(thr),
             torch.cuda.current_stream(rho.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fleet_step kernel launch failed: cudaError_t "
                           f"{err}")
    fleet_step.launches += 1
    return temps, freqs, buf, th, ev, thr, None


def fleet_step_reference(rho, buf0, th0, stats0, freq0, ev0, gamma,
                         params: FleetStepParams, *, het=None, thr0=None,
                         step0=0, fb0=None, mode0=None):
    """Plain PyTorch version of `fleet_step`: same signature and outputs.

    A Python loop over T on [tiles, n] planes in the kernel's op order, Γ
    products through `apply_coupling`.  Runs on any device; nothing on the
    main path calls it when a card is present.
    """
    _check(rho, buf0, th0, stats0, freq0, ev0, gamma, params, het, thr0,
           fb0, mode0)
    from repro_torch.core.coupling import apply_coupling
    from repro_torch.core.pdu_gate import exact_stats

    p, k = params, _consts(params)
    t = rho.shape[0]
    w, q = p.window, p.recent
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
    temps = torch.empty_like(rho)
    freqs = torch.empty_like(rho)

    for s in range(t):
        r = rho[s]
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
        for j in range(1, p.n_poles):
            dt_now = dt_now + th[j]
        if p.mode == "v24":
            pred = torch.clamp(rsum * k["inv_q"]
                               + (csum * k["inv_denom"]) * k["ahead"],
                               0.0, k["rho_hi"])
            p_ahead = power(pred)
            p_prev = p_now * f ** pe
            hint = torch.maximum(couple(p_ahead), couple(p_now))
            budget = fma_f32(-k["one_m_eta"], dt_now, k["t_allow"]) \
                * k["inv_eta_gain"]
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
            f_used = f_new
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
        for j in range(p.n_poles):
            th[j] = k["decay"][j] * th[j] + k["coef"][j] * p_eff
            dt = th[j] if dt is None else dt + th[j]
        temp = k["t_ambient"] + dt

        if p.mode == "reactive_poll":
            polled = (int(step0) + s) % p.poll_ticks == 0
            trig = (temp >= k["t_crit"]) & polled
            cool = (temp <= k["resume_below"]) & polled
            ev = ev + (trig & ~latch).any(dim=0, keepdim=True).float()
            latch = (latch | trig) & ~cool
            f_new = torch.where(latch, k["throttle_level"],
                                torch.clamp(f + k["ramp"], max=1.0))
        else:
            ev = ev + (temp > k["t_crit"]).any(dim=0, keepdim=True).float()
        f = f_new
        temps[s] = temp
        freqs[s] = f_new

    return (temps, freqs, ring, th, ev,
            None if latch is None else latch.float(), None)
