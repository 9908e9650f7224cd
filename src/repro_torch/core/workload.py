"""Synthetic workload-density traces at the 1 kHz telemetry rate.

Port of `repro.core.workload`.  The paper's Monte-Carlo section (§10,
Fig. 6) evaluates four workload types — LLM training, LLM inference,
vision and batch transformer.  Each generator produces ρ(t) ∈ [ρ_min,
ρ_max] per tile; inference is bursty (token-generation spikes, §3.1),
training periodic ramps (tau-law trajectories, §5.4).

Random draws come from a `torch.Generator` on the trace's device, so a
trace is not the reference's trace for the same seed — only its statistics
agree; tests that compare the two packages feed both the reference's
traces.  The whole trace is made on that device: the OU recurrence runs as
a log-depth scan (`ar1_scan`) instead of the reference's `lax.scan`.
"""
from __future__ import annotations

import math

import torch

from repro_torch import resolve_device
from repro_torch.core.fingerprint import FINGERPRINT

KINDS = ("inference", "training", "vision", "batch")


def ar1_scan(x0, decay: float, drive: torch.Tensor) -> torch.Tensor:
    """x_t = decay·x_{t−1} + drive_t along dim 0, from x_{−1} = ``x0``.

    A log-depth doubling scan on ``drive``'s device: after the pass with
    stride d, x_t holds Σ_{k<2d} decay^k·drive_{t−k}, so ⌈log₂ T⌉ passes of
    whole-tensor operations replace a T-step loop.  Rounding differs from
    the sequential loop in the last bits.
    """
    x = drive.clone()
    x[0] = x[0] + decay * x0
    d = 1
    while d < x.shape[0]:
        x = torch.cat([x[:d], x[d:] + decay ** d * x[:-d]])
        d *= 2
    return x


def _ou(gen: torch.Generator, n_steps: int, n_tiles: int, mean: float,
        std: float, theta: float = 0.01) -> torch.Tensor:
    """Ornstein-Uhlenbeck base load, [n_steps, n_tiles], started at its
    mean: x_t = x_{t−1} + θ·(mean − x_{t−1}) + kick_t."""
    eps = torch.randn((n_steps, n_tiles), generator=gen, device=gen.device)
    kick = std * math.sqrt(2 * theta) * eps
    return ar1_scan(mean, 1.0 - theta, theta * mean + kick)


def _bursts(gen: torch.Generator, n_steps: int, n_tiles: int,
            rate_per_ms: float, dur_ms: int, amp: float) -> torch.Tensor:
    """Box-filtered Bernoulli arrivals → burst envelope ∈ [0, amp].

    The box filter is a running count of the spikes in the trailing
    ``dur_ms`` window, as a cumulative-sum difference (small integer
    counts, exact in f32).
    """
    dev = gen.device
    spikes = torch.rand((n_steps, n_tiles), generator=gen,
                        device=dev) < rate_per_ms
    csum = torch.cumsum(spikes.float(), dim=0)
    lagged = torch.cat([torch.zeros((min(dur_ms, n_steps), n_tiles),
                                    device=dev), csum])[:n_steps]
    jitter = 0.75 + 0.5 * torch.rand((n_steps, n_tiles), generator=gen,
                                     device=dev)
    return torch.clamp(csum - lagged, max=1.0) * amp * jitter


def make_trace(seed: int, n_steps: int, kind: str = "inference",
               n_tiles: int = 1, device=None) -> torch.Tensor:
    """ρ(t) trace, [n_steps, n_tiles] f32, in the paper's density domain.

    ``seed`` seeds a `torch.Generator` on ``device`` (CUDA unless asked
    otherwise) together with the kind's index (stable across processes,
    unlike ``hash(kind)``); the trace is drawn and built there.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown workload kind {kind!r}; want one of {KINDS}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(
        seed * len(KINDS) + KINDS.index(kind))
    if kind == "inference":
        trace = _ou(gen, n_steps, n_tiles, mean=1.55, std=0.18) + _bursts(
            gen, n_steps, n_tiles, rate_per_ms=0.011, dur_ms=260, amp=1.3)
    elif kind == "training":
        # tau-law ramp cycles: step-synchronised square ramps (§5.4)
        period, duty = 500, 0.7
        phase = (torch.arange(n_steps, device=dev) % period) / period
        wave = torch.where(phase < duty, 2.65, 1.55)[:, None]
        trace = wave + _ou(gen, n_steps, n_tiles, mean=0.0, std=0.08)
    elif kind == "vision":
        trace = _ou(gen, n_steps, n_tiles, mean=2.0, std=0.15) + _bursts(
            gen, n_steps, n_tiles, rate_per_ms=0.008, dur_ms=140, amp=1.0)
    else:                        # "batch" — membership checked above
        trace = _ou(gen, n_steps, n_tiles, mean=2.5, std=0.25, theta=0.004)
    return torch.clamp(trace, FINGERPRINT.rho_min,
                       FINGERPRINT.rho_max).float()


def stress_step(n_steps: int, n_tiles: int = 1, t_on: int | None = None,
                device=None) -> torch.Tensor:
    """ΔT = 40 °C open-loop stress profile (§3.2 characterisation extreme):
    idle → max-density step, for the 3.4 nm open-loop drift bound."""
    t_on = n_steps // 4 if t_on is None else t_on
    t = torch.arange(n_steps, device=resolve_device(device))[:, None]
    return torch.where(t < t_on, FINGERPRINT.rho_min,
                       FINGERPRINT.rho_max) * torch.ones((1, n_tiles),
                                                         device=t.device)
