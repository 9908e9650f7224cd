"""§10 — Monte-Carlo thermal simulation under parameter uncertainty.

Port of `repro.core.montecarlo`.  N = 2 000 trials varying thermal
resistance (Rth ± 8 % Gaussian — Intel 18A process variation), time
constant (τ ± 12 % — assembly/TIM1 tolerance) and workload density (ρ ± 15 %
— production workload diversity), per §10.1; each trial also draws its own
workload trace and its OEM temperature-polling period (the §9 baseline is
"reactive DVFS + temperature polling").

`run` drives the population through the FLEET ENGINE: one trial = one
(package, tile) lane of a heterogeneous fleet whose per-trial Rth/τ pole
banks, preposition fractions and polling periods ride in the state
(`core.scheduler.PackageParams`), so the fused backend advances it in the
hand-written `fleet_step` kernel, one launch per ``chunk``-step survey block.
Trials are packed onto the tile axis in groups of up to `_TILE_PACK`: with
Γ off, tiles are independent lanes, so [N/8, 8] is the same population as
[N, 1].  The per-trial peak-T / exceedance / delivered-perf statistics
reduce on the device (`FleetEngine.run_survey`).

`run_reference` is the independent oracle: the `core.dvfs` simulators'
recurrences with the trials on a batch axis (per-trial poles and polling
periods as tensors), the ring-buffer filtration, no fleet engine.

Draws come from a `torch.Generator` on the run's device (`sample_trials`),
whose streams cannot reproduce the reference's `jax.random` draws; both
`run` and `run_reference` therefore also take the draws themselves
(``draws=(rth, tau, util, poll, traces)``), which is how the tests feed the
reference's numbers through both packages.

Published findings (§10): baseline peak-T mean ≈ 91 °C, σ ≈ 6 °C, ≈ 23 % of
the time above the 85 °C limit; V24 mean ≈ 82.5 °C, σ ≈ 2.1 °C (3.5×
tighter), exceedance < 1 %; performance uplift +19–31 % across workloads.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import fma_f32, pow_f32, resolve_device
from repro_torch.core import dvfs, pdu_gate, thermal, workload
from repro_torch.core.density import power_from_rho
from repro_torch.core.fingerprint import FINGERPRINT, Fingerprint
from repro_torch.core.plant import _eta_f32
from repro_torch.core.scheduler import SchedulerConfig

_TILE_PACK = 8      # trials packed per fleet package (one tile each)


class MCResult(NamedTuple):
    peak_t_baseline: torch.Tensor      # [N] per-trial peak junction temp [°C]
    peak_t_v24: torch.Tensor           # [N]
    time_above_baseline: torch.Tensor  # [N] fraction of time T > 85 °C
    time_above_v24: torch.Tensor       # [N]
    perf_baseline: torch.Tensor        # [N] mean delivered perf
    perf_v24: torch.Tensor             # [N]

    def stats(self) -> dict:
        """The §10 statistics (population σ, linear-interpolated
        percentiles, as the reference computes them)."""
        b, v = self.peak_t_baseline, self.peak_t_v24
        sb, sv = b.std(correction=0), v.std(correction=0)
        rel = self.perf_v24 / self.perf_baseline - 1
        return {
            "baseline_mean_c": float(b.mean()),
            "baseline_std_c": float(sb),
            "baseline_time_above_frac": float(self.time_above_baseline.mean()),
            "v24_mean_c": float(v.mean()),
            "v24_std_c": float(sv),
            "v24_time_above_frac": float(self.time_above_v24.mean()),
            "sigma_ratio": float(sv / sb),
            "sigma_tighter_x": float(sb / sv),
            "uplift_mean": float((self.perf_v24 / self.perf_baseline).mean()
                                 - 1),
            "uplift_p5": float(torch.quantile(rel, 0.05)),
            "uplift_p95": float(torch.quantile(rel, 0.95)),
        }


def _ar1(z: torch.Tensor, corr: float) -> torch.Tensor:
    """AR(1) chain over i.i.d. standard normals, unit marginal variance:
    z'_i = corr·z'_{i−1} + √(1−corr²)·z_i, so neighbouring trials correlate
    by ``corr`` while each marginal stays N(0, 1).  Sequential in f32 on
    the host (one pass over N scalars)."""
    x = z.detach().cpu().numpy().astype(np.float32)
    c = np.float32(corr)
    root = np.sqrt(np.float32(1.0) - c * c)
    out = np.empty_like(x)
    prev = out[0] = x[0]
    for i in range(1, x.shape[0]):
        prev = out[i] = c * prev + root * x[i]
    return torch.from_numpy(out).to(z.device)


def sample_params(gen: torch.Generator, n_trials: int,
                  fp: Fingerprint = FINGERPRINT, *, corr: float = 0.0):
    """(rth, tau, util, poll_ticks) draws per §10.1 (+ OEM polling spread),
    from ``gen`` on its device.

    ``corr`` > 0 makes the Rth/τ draws reticle-neighbour correlated (an
    AR(1) chain over the underlying normals, `_ar1`: marginals unchanged);
    utilisation and polling stay i.i.d."""
    if not -1.0 < corr < 1.0:
        raise ValueError(f"corr must be in (-1, 1), got {corr}")
    dev = gen.device
    normal = lambda: torch.randn((n_trials,), generator=gen, device=dev)
    z_rth, z_tau = normal(), normal()
    if corr:
        z_rth, z_tau = _ar1(z_rth, corr), _ar1(z_tau, corr)
    rth = fp.rth_c_per_w * (1 + 0.08 * z_rth)
    tau = fp.tau_ms * (1 + 0.12 * z_tau)
    util = 1.02 + 0.15 * normal()
    poll = torch.randint(15, 76, (n_trials,), generator=gen, device=dev,
                         dtype=torch.int32)                  # ms, OEM spread
    return (torch.clamp(rth, 0.25, 0.70), torch.clamp(tau, 30.0, 160.0),
            torch.clamp(util, 0.5, 1.35), poll)


def sample_trials(seed: int, n_trials: int, n_steps: int,
                  kind: str = "inference", fp: Fingerprint = FINGERPRINT, *,
                  corr: float = 0.0, device=None):
    """One population's draws ``(rth, tau, util, poll, traces [N, T])`` on
    ``device``, from ``seed``: the parameters (`sample_params`) and each
    trial's density trace scaled by its utilisation and clipped to
    [0.4·ρ_min, 1.3·ρ_max], made in one `workload.make_trace` call with
    the trials on its tile axis."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rth, tau, util, poll = sample_params(gen, n_trials, fp, corr=corr)
    tr = workload.make_trace(seed + 1, n_steps, kind, n_tiles=n_trials,
                             device=dev) * util
    traces = torch.clamp(tr, 0.4 * fp.rho_min, 1.3 * fp.rho_max).mT
    return rth, tau, util, poll, traces.contiguous()


def _draws(draws, seed, n_trials, n_steps, kind, fp, corr, device):
    """The population's draws on ``device``: the caller's, or sampled."""
    dev = resolve_device(device)
    if draws is None:
        return sample_trials(seed, n_trials, n_steps, kind, fp, corr=corr,
                             device=dev)
    put = lambda x, dt: torch.as_tensor(np.array(x) if not torch.is_tensor(x)
                                        else x, device=dev).to(dt)
    rth, tau, util, poll, traces = draws
    return (put(rth, torch.float32), put(tau, torch.float32),
            put(util, torch.float32), put(poll, torch.int32),
            put(traces, torch.float32).contiguous())


def _decay(tau: torch.Tensor, dt_ms: float) -> torch.Tensor:
    """a = exp(−dt/τ) per trial: the f32 quotient, its exp in f64 rounded
    once to f32 — the same bits on the host and on the card."""
    return torch.exp((-dt_ms / tau).double()).float()


def _pack(n_trials: int) -> int:
    """Trials per package: the largest divisor of N up to `_TILE_PACK`."""
    return max(d for d in range(1, _TILE_PACK + 1) if n_trials % d == 0)


def _scheduler_cfg(cfg: dvfs.DVFSConfig, lanes: int, mode: str,
                   filtration_impl: str,
                   plant: str = "pole") -> SchedulerConfig:
    """The DVFS simulator's knobs as an equivalent fleet scheduler config.
    Per-trial draws ride `PackageParams`, which needs the pole plant; the
    grid / rom rungs run the fleet homogeneous (workload draws only)."""
    return SchedulerConfig(
        n_tiles=lanes, mode=mode, two_pole=False, use_coupling=False,
        step_ms=cfg.dt_ms,
        lookahead_steps=cfg.lookahead_ms / cfg.dt_ms,
        filtration_window=cfg.filtration_window,
        filtration_impl=filtration_impl,
        t_safe_margin_c=cfg.t_safe_margin_c,
        power_exponent=cfg.power_exponent,
        heterogeneous=plant == "pole",
        plant=plant,
        throttle_level=cfg.throttle_level,
        resume_below_c=cfg.resume_below_c,
        recover_ms=cfg.recover_ms,
        poll_interval_ms=cfg.poll_interval_ms)


@functools.lru_cache(maxsize=16)
def _engine(scfg: SchedulerConfig, fp: Fingerprint, backend: str,
            device: torch.device, devices: int | None = None,
            device_pool: tuple | None = None):
    """One engine per distinct configuration (a fitted plant or the
    kernel's constants are built once, not per experiment); ``devices`` /
    ``device_pool`` go to the device-mesh backends only."""
    from repro_torch.fleet import FleetEngine
    return FleetEngine(scfg, fp=fp, backend=backend, device=device,
                       devices=devices, device_pool=device_pool)


def run(seed: int = 2_000, n_trials: int = 2_000, n_steps: int = 3_000,
        kind: str = "inference", burn_in: int = 400,
        cfg: dvfs.DVFSConfig | None = None,
        fp: Fingerprint = FINGERPRINT, *,
        backend: str = "broadcast", filtration_impl: str = "incremental",
        plant: str = "pole", corr: float = 0.0,
        draws=None, device=None, devices: int | None = None,
        device_pool=None) -> MCResult:
    """The paired (baseline, V24) Monte-Carlo experiment at fleet scale.

    One trial = one lane of a heterogeneous `FleetEngine` fleet; baseline
    (``reactive_poll``) and V24 run as two fleets over the same traces and
    draws, each surveyed in `FleetEngine.run_survey`'s 1,024-step blocks
    (on ``fused``: one `fleet_step` launch a block).  ``draws`` = (rth, tau, util, poll,
    traces [N, T]) replaces the sampled population (``n_trials`` /
    ``n_steps`` then follow it).  Under ``plant`` "grid" / "rom" the fleet
    runs homogeneous physics and the trials differ by workload only.
    ``devices`` / ``device_pool`` place a ``sharded`` / ``sharded_fused``
    fleet on a device mesh (`FleetEngine`).
    """
    cfg = dvfs.DVFSConfig() if cfg is None else cfg
    dev = resolve_device(device)
    rth, tau, _, poll, traces = _draws(draws, seed, n_trials, n_steps, kind,
                                       fp, corr, dev)
    n_trials, n_steps = traces.shape
    lanes = _pack(n_trials)
    n_pkg = n_trials // lanes
    fleet_trace = traces.mT.reshape(n_steps, n_pkg, lanes)
    lane_shape = (n_pkg, lanes)
    banks = thermal.PoleParams(
        decay=_decay(tau, cfg.dt_ms).reshape(lane_shape)[..., None],
        gain=rth.reshape(lane_shape)[..., None])

    def survey(mode: str):
        eng = _engine(_scheduler_cfg(cfg, lanes, mode, filtration_impl,
                                     plant), fp, backend, dev, devices,
                      None if device_pool is None else tuple(device_pool))
        pkg = None
        if plant == "pole":
            pkg = eng.sched.package_params(
                banks, poll_ticks=poll.reshape(lane_shape),
                batch_shape=(n_pkg,))
        # the oracle seeds each trial's ring with its opening density
        state = eng.init(n_pkg, pkg=pkg, filtration_fill=fleet_trace[0])
        _, sv = eng.run_survey(state, fleet_trace, burn_in=burn_in)
        return sv

    sb = survey("reactive_poll")
    sv = survey("v24")
    flat = lambda x: x.reshape(n_trials)
    return MCResult(peak_t_baseline=flat(sb.peak_t_c),
                    peak_t_v24=flat(sv.peak_t_c),
                    time_above_baseline=flat(sb.exceed_frac),
                    time_above_v24=flat(sv.exceed_frac),
                    perf_baseline=flat(sb.freq_mean),
                    perf_v24=flat(sv.freq_mean))


class _Trials:
    """Running per-trial statistics of one simulator: peak T and time above
    T_crit past burn-in, mean frequency (an f64 sum) over all steps."""

    def __init__(self, n: int, burn_in: int, t_crit: float, device):
        self.burn_in, self.t_crit, self.k = burn_in, t_crit, 0
        self.peak = torch.full((n,), -torch.inf, device=device)
        self.above = torch.zeros((n,), dtype=torch.float64, device=device)
        self.fsum = torch.zeros((n,), dtype=torch.float64, device=device)

    def add(self, freq: torch.Tensor, temp: torch.Tensor) -> None:
        if self.k >= self.burn_in:
            self.peak = torch.maximum(self.peak, temp)
            self.above += temp > self.t_crit
        self.fsum += freq
        self.k += 1

    def result(self):
        return (self.peak, (self.above / (self.k - self.burn_in)).float(),
                (self.fsum / self.k).float())


def _reactive_trials(rho, decay, gain, poll, cfg, fp, burn_in):
    """`dvfs.simulate_reactive` over trials on the batch axis: per-trial
    single-pole banks and polling periods, the same recurrence and
    rounding (the plant's multiply-add fused, `thermal.step_fused`)."""
    ramp = (1.0 - cfg.throttle_level) / max(int(cfg.recover_ms / cfg.dt_ms),
                                            1)
    poles = thermal.PoleParams(decay=decay[:, None], gain=gain[:, None])
    n, dev = rho.shape[1], rho.device
    st = torch.zeros((n, 1), device=dev)
    f = torch.ones((n,), device=dev)
    throttled = torch.zeros((n,), dtype=torch.bool, device=dev)
    acc = _Trials(n, burn_in, fp.t_crit_c, dev)
    for k in range(rho.shape[0]):
        p = power_from_rho(rho[k]) * f ** cfg.power_exponent
        st = thermal.step_fused(poles, st, p)
        t = fp.t_ambient_c + thermal.delta_t(st)
        polled = k % poll == 0
        trig = (t >= fp.t_crit_c) & polled
        cool = (t <= cfg.resume_below_c) & polled
        throttled = (throttled | trig) & ~cool
        f = torch.where(throttled, cfg.throttle_level,
                        torch.clamp(f + ramp, max=1.0))
        acc.add(f, t)
    return acc.result()


def _v24_trials(rho, decay, gain, cfg, fp, burn_in):
    """`dvfs.simulate_v24` (uncoupled) over trials on the batch axis: each
    trial's own η, budget reciprocal and ring filtration seeded with its
    opening density."""
    dev, n = rho.device, rho.shape[1]
    a = decay.detach().cpu().numpy()
    g = gain.detach().cpu().numpy().astype(np.float32)
    eta = _eta_f32(a, cfg.lookahead_ms / cfg.dt_ms)
    neg_one_m_eta = torch.from_numpy(-(np.float32(1.0) - eta)).to(dev)
    inv_eta_gain = torch.from_numpy(np.float32(1.0) / (eta * g)).to(dev)
    t_allow = fp.t_crit_c - cfg.t_safe_margin_c - fp.t_ambient_c
    inv_exp = float(np.float32(1.0 / cfg.power_exponent))
    poles = thermal.PoleParams(decay=decay[:, None], gain=gain[:, None])
    st = torch.zeros((n, 1), device=dev)
    ft = pdu_gate.init_filtration(cfg.filtration_window, n, fill=rho[0],
                                  device=dev)
    acc = _Trials(n, burn_in, fp.t_crit_c, dev)
    for k in range(rho.shape[0]):
        ft = pdu_gate.observe(ft, rho[k])
        p_hat = power_from_rho(rho[k])
        h = torch.maximum(pdu_gate.hint(ft, None, cfg.lookahead_ms,
                                        cfg.dt_ms), p_hat)
        budget = fma_f32(neg_one_m_eta, thermal.delta_t(st),
                         t_allow) * inv_eta_gain
        f = torch.clamp(pow_f32(budget / h.clamp(min=1e-3), inv_exp),
                        0.05, 1.0)
        st = thermal.step_fused(poles, st, p_hat * f ** cfg.power_exponent)
        acc.add(f, fp.t_ambient_c + thermal.delta_t(st))
    return acc.result()


def run_reference(seed: int = 2_000, n_trials: int = 2_000,
                  n_steps: int = 3_000, kind: str = "inference",
                  burn_in: int = 400, cfg: dvfs.DVFSConfig | None = None,
                  fp: Fingerprint = FINGERPRINT, *,
                  draws=None, device=None) -> MCResult:
    """The per-trial oracle: the DVFS simulators' recurrences with the
    trials on a batch axis, bypassing the fleet engine (ring filtration,
    O(W) refit per step).  Same draws as `run` (``corr`` 0) for the same
    arguments."""
    cfg = dvfs.DVFSConfig() if cfg is None else cfg
    dev = resolve_device(device)
    rth, tau, _, poll, traces = _draws(draws, seed, n_trials, n_steps, kind,
                                       fp, 0.0, dev)
    rho = traces.mT                                          # [T, N]
    decay = _decay(tau, cfg.dt_ms)
    pb, ab, fb = _reactive_trials(rho, decay, rth, poll, cfg, fp, burn_in)
    pv, av, fv = _v24_trials(rho, decay, rth, cfg, fp, burn_in)
    return MCResult(peak_t_baseline=pb, peak_t_v24=pv,
                    time_above_baseline=ab, time_above_v24=av,
                    perf_baseline=fb, perf_v24=fv)


def uplift_by_workload(seed: int = 6, n_steps: int = 4_000,
                       cfg: dvfs.DVFSConfig | None = None,
                       fp: Fingerprint = FINGERPRINT,
                       device=None) -> dict[str, float]:
    """Fig. 6 (right): V24 performance uplift per workload type."""
    cfg = dvfs.DVFSConfig() if cfg is None else cfg
    dev = resolve_device(device)
    out = {}
    for kind in workload.KINDS:
        tr = workload.make_trace(seed, n_steps, kind, device=dev)
        base = dvfs.simulate_reactive(tr, cfg, fp)
        v24 = dvfs.simulate_v24(tr, cfg, fp)
        out[kind] = float(dvfs.released_compute(base, v24))
    return out
