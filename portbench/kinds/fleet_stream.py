"""Traffic kind ``fleet_stream``: a fleet's density trace streamed through
the port's ingest loop, the paper's closed firmware loop at fleet scale.

The traffic file gives the fleet (``packages``), the flush (``flush``
steps a chunk), the look-ahead (``lookahead_chunks``), and the density: a
diurnal swell from ``swell.lo`` to ``swell.hi`` and back over
``swell.period`` steps plus ``jitter_sd``·N(0, 1) per (package, tile)
drawn from the seed, clipped to ``clip``.  Set-up draws ``ring_chunks``
numpy chunks of it (a numpy source is what the ingest loop stages through
pinned memory) and the window cycles them.  The configuration gives the
scheduler and the package.

The window drives `repro_torch.fleet.ingest.stream` from a fresh fleet
until ``--seconds`` have passed.  ``pkg_steps_per_s`` is the package-steps
of every completed flush over the window's whole time.

Correctness: flush 0, from the reference's own fresh fleet, and a sample
of later flushes drawn from the seed, each from the program's state before
it, are run again through `portbench.reference.fleet_v24`; the flush
record and the state after the flush are compared.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench.reference import fleet_v24 as ref

# a flush's program state is kept for the check with this chance (drawn
# from the seed), at most KEEP flushes
KEEP_EVERY, KEEP = 64, 4


def chunks(traffic: dict, n_tiles: int, seed: int) -> list[np.ndarray]:
    """The ring of host density chunks [flush, packages, tiles] (f32)."""
    sw = traffic["swell"]
    k, n = traffic["flush"], traffic["packages"]
    steps = k * traffic["ring_chunks"]
    phase = np.linspace(0.0, np.pi, sw["period"], dtype=np.float32)
    swell = sw["lo"] + (sw["hi"] - sw["lo"]) * np.sin(phase) ** 2
    swell = np.resize(swell, steps).astype(np.float32)
    rng = np.random.default_rng(seed)
    jitter = (traffic["jitter_sd"]
              * rng.standard_normal((n, n_tiles))).astype(np.float32)
    lo, hi = traffic["clip"]
    return [np.clip(swell[i * k:(i + 1) * k, None, None] + jitter, lo, hi
                    ).astype(np.float32)
            for i in range(traffic["ring_chunks"])]


def scheduler_config(sched: dict):
    from repro_torch.core.scheduler import SchedulerConfig
    keys = ("n_tiles", "mode", "two_pole", "use_coupling", "step_ms",
            "lookahead_steps", "filtration_window", "filtration_impl",
            "t_safe_margin_c", "power_exponent", "straggler_threshold",
            "plant")
    return SchedulerConfig(**{k: sched[k] for k in keys})


def setup(ctx) -> None:
    from repro_torch.fleet import ingest
    from repro_torch.fleet.engine import FleetEngine

    sched = ctx.config["scheduler"]
    ctx.ring = chunks(ctx.traffic, sched["n_tiles"], ctx.seed)
    eng = FleetEngine(scheduler_config(sched), backend=sched["backend"],
                      device=ctx.device)
    n = ctx.traffic["packages"]
    # warm: every shape of the window, the kernel built and loaded, the
    # pinned staging and the allocator's blocks
    ingest.stream(eng, eng.init(n), iter(ctx.ring[:3]),
                  lookahead_chunks=ctx.traffic["lookahead_chunks"])
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    ctx.engine, ctx.state0 = eng, eng.init(n)
    rng = np.random.default_rng([ctx.seed, 1])
    ctx.keep_mask = rng.random(1 << 20) < 1.0 / KEEP_EVERY


def window(ctx) -> None:
    from repro_torch.fleet import ingest

    eng, tr = ctx.engine, ctx.tracer
    kept: dict[int, tuple] = {0: None}
    records: dict[int, dict] = {}
    flush_t: list[float] = []
    run_block = eng.run_block
    calls = [0]

    def keep_states(state, chunk, active=None):
        """`FleetEngine.run_block`, keeping the state before and after the
        flushes the check will hold to the reference (the program returns
        a new state each window and never writes the old one)."""
        i = calls[0]
        calls[0] += 1
        with tr.span("run_block"):
            new, telem = run_block(state, chunk, active=active)
        if i in kept or (ctx.keep_mask[i % ctx.keep_mask.size]
                         and len(kept) <= KEEP):
            kept[i] = (state, new)
        return new, telem

    eng.run_block = keep_states
    ring, nring = ctx.ring, len(ctx.ring)
    trace_flushes = ctx.traffic["trace_flushes"]

    def on_flush(i, d):
        flush_t.append(time.perf_counter())
        if i - 1 in kept:
            records[i - 1] = d
        if tr.active and i >= trace_flushes:
            tr.end()

    tr.begin()
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds

    def source():
        i = 0
        while time.perf_counter() < deadline:
            with tr.span("source"):
                chunk = ring[i % nring]
            yield chunk
            i += 1

    _, _, stats = ingest.stream(
        eng, ctx.state0, source(),
        lookahead_chunks=ctx.traffic["lookahead_chunks"],
        on_flush=on_flush, keep_telemetry=False)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng.run_block = run_block

    n = ctx.traffic["packages"]
    ctx.e2e["pkg_steps_per_s"] = stats.steps * n / (t1 - t0)
    ctx.attempted = stats.flushes
    ctx.failed = stats.flushes - stats.host_syncs
    gaps = np.diff([t0] + flush_t) * 1e3
    traced = trace_flushes if tr.on else 0
    ctx.counters.update(flushes=stats.flushes, steps=stats.steps,
                        window_s=t1 - t0,
                        flush_ms_untraced=gaps[traced:].tolist())
    ctx.kept = {i: s for i, s in kept.items() if s is not None
                and i in records}
    ctx.records = records
    del ctx.state0


def _as_ref(state) -> ref.FleetState:
    """The program's scheduler state as the reference's fleet state (the
    ring oldest first)."""
    ft = state.filtration
    return ref.FleetState(ring=torch.roll(ft.buf, -int(ft.ptr), dims=-2),
                          thermal=state.thermal, freq=state.freq,
                          events=state.events.float())


TEMPS = ("temp_p50_c", "temp_p99_c", "temp_max_c")
UNIT = ("freq_mean", "freq_min", "at_risk_frac")
MTPS = ("released_mtps", "throttled_mtps")


def record_gap(got: dict, want: dict) -> float:
    """The widest gap of a flush record from the reference's: temperatures
    relative to the reference's value, the frequency fields and the at-risk
    share absolute, the two MTPS fields relative to the offered total,
    the event count relative to the fleet's packages."""
    offered = want["released_mtps"] + want["throttled_mtps"]
    g = [abs(got[k] - want[k]) / abs(want[k]) for k in TEMPS]
    g += [abs(got[k] - want[k]) for k in UNIT]
    g += [abs(got[k] - want[k]) / offered for k in MTPS]
    g.append(abs(got["events_total"] - want["events_total"])
             / want["n_packages"])
    return max(g)


def state_gap(got, want) -> float:
    """The state after a flush: the mean pole-temperature gap over the mean
    pole temperature, and the mean frequency gap, whichever is wider."""
    th = ((got.thermal.double() - want.thermal.double()).abs().mean()
          / want.thermal.double().abs().mean())
    fq = (got.freq.double() - want.freq.double()).abs().mean()
    return float(max(th, fq))


def readings(ctx, control: bool = False) -> dict[str, float]:
    """The comparison's readings over every checked flush: ``record_gap``
    and ``state_gap`` (the widest), ``events_gap`` (the widest gap in the
    fleet's event count), against the reference.  With ``control`` the
    reference with its Γ products in TF32 takes the program's place, from
    the same states."""
    sched, fp = ctx.config["scheduler"], ctx.config["fingerprint"]
    p = ref.params(sched, fp, device=ctx.device)
    pc = ref.params(sched, fp, device=ctx.device, tf32=True)
    n = ctx.traffic["packages"]
    worst = {"record_gap": 0.0, "state_gap": 0.0, "events_gap": 0.0}
    for i in sorted(ctx.records):
        before, after = ctx.kept[i]
        rho = torch.as_tensor(ctx.ring[i % len(ctx.ring)], device=ctx.device)
        start = (ref.init(p, n, sched["n_tiles"], ctx.device) if i == 0
                 else _as_ref(before))
        want_s, want = ref.window(p, start, rho)
        if control:
            got_s, got = ref.window(pc, start, rho)
        else:
            got_s, got = _as_ref(after), ctx.records[i]
        worst["record_gap"] = max(worst["record_gap"], record_gap(got, want))
        worst["events_gap"] = max(worst["events_gap"], float(
            abs(got["events_total"] - want["events_total"])))
        worst["state_gap"] = max(worst["state_gap"], state_gap(got_s, want_s))
    return worst


def release(ctx) -> None:
    """Free the program's state before the reference runs (the states kept
    for the checked flushes stay)."""
    del ctx.engine
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def check(ctx) -> list[tuple[str, float, float]]:
    release(ctx)
    got = readings(ctx)
    return [(k, got[k], lim) for k, lim in ctx.traffic["limits"].items()]
