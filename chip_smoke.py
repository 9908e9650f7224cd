#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0  prints the card's name and power limit (nvidia-smi) and builds the
         `fleet_step` kernel from the checkout's source.
Phase A  the `fleet_step` CUDA kernel against its plain PyTorch version
         (`fleet_step_reference`) on the card at 1 tile × 4,096 packages
         (serve --stream's shape: no Γ, 32-package blocks), 4 tiles × 200
         and 47 tiles × 64, T = 512, in each of the four control modes —
         traces and state within rtol = atol = 1e-5, event counts and the
         reactive_poll latch exact.
Phase B  the main path: `FleetEngine(SchedulerConfig(n_tiles=47, mode="v24"),
         backend="fused")` on the card (the 47-tile Ponte-Vecchio package),
         4,096 packages, a 2,048-step diurnal swell of ρ from 0.9 to 2.7 and
         back streamed through `ingest.stream` in 8 flushes of 256 — exactly
         8 kernel launches, finite telemetry, released + throttled = ΣR_tok
         per window, the controller throttling in the middle flushes.  Then,
         on the peak window from its warm state, the kernel held against
         the plain version, its time beside its bound and the plain
         version's time, and a per-stage breakdown of one flush.
Phase C  `repro_torch.launch.serve --stream --fleet 4096 --fleet-backend fused
         --waves 4 --gen 256`, in process: 4 flushes, 4 launches; then the
         kernel held against the plain version on serve's first window
         [256, 1 tile, 4,096].
Phase D  the `thermal_conv` CUDA kernel against its plain version
         (`thermal_conv_reference`): 8 tiles × 4,000 steps with the 8-tile
         Γ of examples/multi_tile_sim.py, 47 tiles with the Ponte-Vecchio Γ,
         ragged 100 tiles × 777, 512 × 1,000 (bench_multitile's shape), and
         two chained halves against one run.  Then its main path at full
         width: `kernels.ops.thermal_conv` over 512 tiles × 90,000 steps
         (the paper's dataset length at the kernel's datacenter width),
         power 80 + 40·U(0,1) W — held against the plain version, timed
         beside its bound and the plain version.
Phase E  the `grid_conv` CUDA kernel against its plain version
         (`grid_conv_reference`, the reference's adjacency operands) at 1, 2
         and 47 tiles × grid_substeps 1, 2 × grid_contrast 0, 0.5, and at
         every patch edge it compiles (grid_cells 2..16, 5 tiles).  Then its
         main path at full width: `GridPlant(n_tiles=47).simulate` over
         90,000 steps (state [8, 376]) — held against the plain version,
         timed beside its roofline bound and its dependence floor — and the
         ROM_PEAK_TOL gate there: the fitted ROM's peak ΔT (through
         `thermal_conv`) within 0.02 of the grid's.
Phase F  the plant ladder in the fleet (per-step path): 47-tile v24 fleets
         of 4,096 packages with plant="grid" on the fused backend and
         plant="rom" on broadcast over Phase B's peak window; serve --stream
         --plant rom --fleet-backend broadcast --fleet 4096; the 8-tile
         reactive vs V7.0 DVFS comparison (released compute) and the
         Appendix-B dataset's R², both made and run on the card.

The line before the last is one JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without CUDA, or outside a checkout of the repository, it exits non-zero and
prints no result.  It catches nothing: any failed check ends the run.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# NVIDIA H100 SXM data sheet: HBM3 bandwidth and f32 rate outside the
# tensor cores (the rates assume the full 700 W power limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# dependent-issue latencies ASSUMED (not measured) for the estimate of the
# grid recurrence's dependence floor, printed beside its times but not in
# the kernels line: an f32 add or multiply, and a warp shuffle, in SM cycles
FP32_LATENCY_CYCLES = 4
SHFL_LATENCY_CYCLES = 24
TOL = dict(rtol=1e-5, atol=1e-5)
KERNELS = ("fleet_step", "thermal_conv", "grid_conv")
# full-width (tiles, steps) of the thermal kernels' main paths: the paper's
# 90k-step dataset length at thermal_conv's datacenter width (N = 512, the
# reference kernel's stated O(512)) and at the 47-tile Ponte-Vecchio grid
THERMAL_FULL = (512, 90_000)
GRID_FULL = (47, 90_000)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def event_ms(fn, reps: int) -> float:
    """Median over ``reps`` runs of ``fn``'s device time (CUDA events)."""
    import numpy as np
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms the card could take, what sets it) at the data-sheet peaks."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(out, ref, where: str) -> float:
    """Kernel outputs vs plain outputs, each within rtol = atol = 1e-5."""
    import torch

    err = 0.0
    for i, (a, b) in enumerate(zip(out, ref)):
        check(bool(torch.isfinite(a).all()), f"{where}: output {i} not finite")
        d = float((a - b).abs().max())
        check(torch.allclose(a, b, **TOL),
              f"{where}: output {i} differs from the plain version by {d:.3e}")
        err = max(err, d)
    return err


def main() -> None:
    kernel_src = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    if not (kernel_src / "fleet_step.cu").is_file():
        fail(f"no kernel sources under {kernel_src}: run from a checkout "
             f"of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    dev = torch.device("cuda")

    from repro_torch.core.density import rtok_from_rho
    from repro_torch.core.scheduler import SchedulerConfig, ThermalScheduler
    from repro_torch.fleet import FleetEngine, chunk_source, stream
    from repro_torch.fleet.backends.fused import FusedBackend
    from repro_torch.kernels import _build
    from repro_torch.kernels import fleet_step as fs
    from repro_torch.launch import serve

    # ---------------------------------------------------------------- phase 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[phase0] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; card 0: {card}")
    # one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = list(pool.map(_build.build, KERNELS))
    print(f"[phase0] built {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.2f} s")

    def compare(out, ref, where: str) -> float:
        """Kernel outputs vs plain outputs: max abs error of the float
        planes (rtol = atol = 1e-5), events and latch exact."""
        err = 0.0
        for name, a, b in zip(("temps", "freqs", "ring", "poles"), out[:4],
                              ref[:4]):
            check(bool(torch.isfinite(a).all()), f"{where}: {name} not finite")
            check(torch.allclose(a, b, **TOL),
                  f"{where}: {name} differs from the plain version by "
                  f"{float((a - b).abs().max()):.3e}")
            err = max(err, float((a - b).abs().max()))
        check(torch.equal(out[4], ref[4]), f"{where}: event counts differ "
              f"({float(out[4].sum())} vs {float(ref[4].sum())})")
        if ref[5] is not None:
            check(torch.equal(out[5], ref[5]), f"{where}: latch differs")
        return err

    def throttled_share(d: dict) -> float:
        return d["throttled_mtps"] / (d["released_mtps"]
                                      + d["throttled_mtps"])

    def window(mode: str, n_tiles: int, n: int, t: int, seed: int):
        """(backend, kernel args, kwargs) for one window from a fresh fleet
        state and a seeded uniform density trace over the paper's domain."""
        sched = ThermalScheduler(SchedulerConfig(n_tiles=n_tiles, mode=mode),
                                 device=dev)
        backend = FusedBackend(sched)
        state = backend.init(n)._replace(step=torch.tensor(5, dtype=torch.int32))
        g = torch.Generator().manual_seed(seed)
        rho = (0.9 + 1.8 * torch.rand((t, n, n_tiles), generator=g)).to(dev)
        args, kwargs = backend.kernel_inputs(state, rho)
        return backend, args, kwargs

    # ---------------------------------------------------------------- phase A
    max_err = 0.0
    for n_tiles, n in ((1, 4096), (4, 200), (47, 64)):
        for mode in ("v24", "reactive", "reactive_poll", "off"):
            _, args, kwargs = window(mode, n_tiles, n, 512, seed=n_tiles)
            out = fs.fleet_step(*args, **kwargs)
            torch.cuda.synchronize()
            ref = fs.fleet_step_reference(*args, **kwargs)
            where = f"phase A {mode} {n_tiles} tiles x {n} pkgs"
            err = compare(out, ref, where)
            max_err = max(max_err, err)
            print(f"[phaseA] {mode:13s} {n_tiles:2d} tiles x {n:4d} pkgs "
                  f"T=512: max_abs_err {err:.3e}, events "
                  f"{int(out[4].sum())} == plain {int(ref[4].sum())}")

    # ---------------------------------------------------------------- phase B
    # the reference's fleet trace (examples/fleet_sim.py): a diurnal swell
    # over the paper's density domain plus per-(package, tile) process
    # jitter — cool at both ends, throttling for part of the fleet mid-way
    n_tiles, n, steps, flush = 47, 4096, 2048, 256
    rng = np.random.default_rng(0)
    swell = 0.9 + 1.8 * np.sin(
        np.linspace(0.0, np.pi, steps, dtype=np.float32)) ** 2
    jitter = 0.2 * rng.standard_normal((n, n_tiles)).astype(np.float32)
    trace = np.clip(swell[:, None, None] + jitter, 0.9, 2.7).astype(
        np.float32)                                       # [T, n, tiles]
    eng = FleetEngine(SchedulerConfig(n_tiles=n_tiles, mode="v24"),
                      backend="fused")
    check(eng.device.type == "cuda", f"engine on {eng.device}, not cuda")
    print(f"[phaseB] {n} packages x {n_tiles} tiles, {steps} steps in "
          f"{steps // flush} flushes of {flush}; rho 0.9 -> 2.7 -> 0.9 + "
          f"jitter 0.2, trace {trace.nbytes / 1e9:.2f} GB")

    flush_times = []

    def on_flush(i, d):
        flush_times.append(time.perf_counter())
        print(f"[phaseB] flush {i}: throttled share "
              f"{throttled_share(d):.6f} " + json.dumps(d))

    state0 = eng.init(n)
    torch.cuda.synchronize()
    fs.fleet_step.launches = 0
    t0 = time.perf_counter()
    state, flushed, stats = stream(eng, state0, chunk_source(trace, flush),
                                   on_flush=on_flush)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fs.fleet_step.launches
    check(launches == steps // flush,
          f"main path launched fleet_step {launches} times, want "
          f"{steps // flush}")
    check(stats.flushes == stats.host_syncs == steps // flush,
          f"{stats.flushes} flushes / {stats.host_syncs} host syncs")
    for i, d in enumerate(flushed):
        check(all(np.isfinite(v) for v in d.values()),
              f"flush {i + 1} has non-finite telemetry: {d}")
        window_rtok = rtok_from_rho(torch.from_numpy(
            trace[i * flush:(i + 1) * flush])).double().sum(dim=(1, 2))
        offered = float(window_rtok.mean())
        got = d["released_mtps"] + d["throttled_mtps"]
        check(abs(got - offered) <= 1e-5 * offered,
              f"flush {i + 1}: released + throttled {got} != sum R_tok "
              f"{offered}")
    check(all(bool(torch.isfinite(x).all())
              for x in (state.thermal, state.freq)), "final state not finite")
    check(max(d["throttled_mtps"] for d in flushed) > 0.0,
          "the controller never throttled: the trace leaves the law idle")
    print(f"[phaseB] done: {steps} steps x {n} pkgs in {wall * 1e3:.1f} ms "
          f"= {steps * n / wall:.4g} pkg-steps/s, "
          f"{wall * 1e3 / stats.flushes:.2f} ms per flush (host clock, "
          f"after torch.cuda.synchronize), {launches} kernel launches, "
          f"{stats.host_syncs} host syncs")
    print("[phaseB] host ms from the start of the stream to each flush's "
          "telemetry, per flush: " + json.dumps(
              [round((b - a) * 1e3, 3)
               for a, b in zip([t0] + flush_times, flush_times)]))

    # the kernel at the main path's shapes on its peak window (flush 4),
    # from the warm state the stream reached there: held against the plain
    # version's output on the same inputs, timed with CUDA events beside
    # its bound and the plain version (no yardstick: it repeats the
    # kernel's arithmetic op by op)
    backend = eng.backend_impl
    peak = 3
    warm = state0
    for i in range(peak):
        warm = backend.run_block(
            warm, backend.put_trace(trace[i * flush:(i + 1) * flush]))[0]
    chunk = backend.put_trace(trace[peak * flush:(peak + 1) * flush])
    args, kwargs = backend.kernel_inputs(warm, chunk)

    out = fs.fleet_step(*args, **kwargs)                 # warm
    kernel_ms = event_ms(lambda: fs.fleet_step(*args, **kwargs), 10)
    plain_ms = event_ms(lambda: fs.fleet_step_reference(*args, **kwargs), 2)
    ref = fs.fleet_step_reference(*args, **kwargs)
    err = compare(out, ref, "main-path window")
    max_err = max(max_err, err)
    throttled = float((ref[1] < 1.0).float().mean())
    check(throttled > 0.0, "main-path window: the law never throttled")
    nbytes, ops = fs.fleet_step_cost(args[0], args[6], args[7])
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[phaseB] fleet_step [{flush}, {n_tiles}, {n}]: kernel "
          f"{kernel_ms:.3f} ms (median of 10, CUDA events), plain "
          f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms by {bound_by} "
          f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP), "
          f"max_abs_err vs plain {err:.3e} on flush {peak + 1} from its "
          f"warm state, f < 1 in {throttled:.4f} of (step, tile, package)")

    # where one flush's time goes (host clock around each stage, ending in
    # a synchronize; median of 3)
    def host_ms(fn, reps: int = 3) -> float:
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times))

    _, temps, freqs = backend.run_block(warm, chunk)
    prev = warm.events.sum(dtype=torch.int32)
    breakdown = {
        "upload_ms": host_ms(lambda: backend.put_trace(
            trace[peak * flush:(peak + 1) * flush])),
        "kernel_inputs_ms": host_ms(
            lambda: backend.kernel_inputs(warm, chunk)),
        "kernel_ms": kernel_ms,
        "run_block_ms": host_ms(lambda: backend.run_block(warm, chunk)),
        "telemetry_ms": host_ms(lambda: eng.window_telemetry(
            chunk, temps, freqs, prev, warm).reduce().as_dict()),
        "flush_ms": host_ms(lambda: eng.run_block(warm, chunk)[1].as_dict()),
    }
    print("[phaseB] breakdown of one flush: " + json.dumps(breakdown))

    # ---------------------------------------------------------------- phase C
    fs.fleet_step.launches = 0
    res = serve.main(["--stream", "--fleet", "4096", "--fleet-backend",
                      "fused", "--waves", "4", "--gen", "256"])
    torch.cuda.synchronize()
    check(fs.fleet_step.launches == 4,
          f"serve --stream launched fleet_step {fs.fleet_step.launches} "
          f"times, want 4")
    check(res["flushes"] == res["host_syncs"] == 4,
          f"serve --stream: {res['flushes']} flushes, {res['host_syncs']} "
          f"host syncs")
    check(all(np.isfinite(v) for d in res["stream"] for v in d.values()),
          "serve --stream telemetry not finite")
    print(f"[phaseC] serve --stream: {res['flushes']} flushes, "
          f"{res['pkg_steps_per_s']:.4g} pkg-steps/s, 4 kernel launches, "
          f"throttled share per flush "
          + json.dumps([throttled_share(d) for d in res["stream"]]))
    # serve's own shape on the card: 1 tile, no Γ (hint = max(P_ahead,
    # P_now), no slew cap), 32-package blocks — its first window from a
    # fresh fleet, kernel against the plain version
    c_backend = FusedBackend(ThermalScheduler(
        SchedulerConfig(n_tiles=1, mode="v24", step_ms=5.0), device=dev))
    c_trace = res["trace"]
    check(c_trace.shape == (1024, 4096, 1),
          f"serve --stream trace has shape {c_trace.shape}")
    args, kwargs = c_backend.kernel_inputs(
        c_backend.init(4096), c_backend.put_trace(c_trace[:256]))
    out = fs.fleet_step(*args, **kwargs)
    torch.cuda.synchronize()
    ref = fs.fleet_step_reference(*args, **kwargs)
    err = compare(out, ref, "serve --stream window")
    max_err = max(max_err, err)
    print(f"[phaseC] fleet_step [256, 1, 4096] on serve's first window: "
          f"max_abs_err vs plain {err:.3e}, events {int(out[4].sum())} == "
          f"plain {int(ref[4].sum())}")

    tc_entry = phase_d(dev)
    gc_entry = phase_e(dev)
    phase_f(dev, trace[peak * flush:(peak + 1) * flush])

    print(json.dumps({"kernels": [{
        "name": "fleet_step",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fleet_step.cu",
        "replaces": "src/repro/kernels/fleet_step.py:518",
        "launches": launches,
        "max_abs_err": max_err,
        "max_err_vs_plain": max_err,
        "ms": kernel_ms,
        "ms_per_flush": wall * 1e3 / stats.flushes,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, tc_entry, gc_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def timed(fn) -> tuple[object, float]:
    """(fn(), its device time in ms) for one run, by CUDA events."""
    out = []
    ms = event_ms(lambda: out.append(fn()), 1)
    return out[0], ms


def phase_d(dev) -> dict:
    """`thermal_conv`: kernel vs plain version, then the full-width path."""
    import torch

    from repro_torch.core.coupling import (coupling_matrix,
                                           ponte_vecchio_gamma,
                                           row_normalise)
    from repro_torch.core.thermal import two_pole
    from repro_torch.kernels import ops
    from repro_torch.kernels.thermal_conv import (thermal_conv_cost,
                                                  thermal_conv_reference)

    poles = two_pole()
    gen = torch.Generator(device=dev).manual_seed(3)

    def power(t, n):              # bench_multitile's load: 80 + 40·U(0,1) W
        return 80.0 + 40.0 * torch.rand((t, n), generator=gen, device=dev)

    def gamma(g):
        return row_normalise(g).to(dev).contiguous()

    conv = lambda p, g, s0=None: ops.thermal_conv(p, g, poles.decay,
                                                  poles.gain, s0)
    err = 0.0
    for where, t, g in (
            ("8 tiles x 4,000 (multi_tile_sim Γ)", 4000,
             gamma(coupling_matrix(8, cols=4))),
            ("47 tiles x 4,000 (Ponte-Vecchio Γ)", 4000,
             gamma(ponte_vecchio_gamma())),
            ("ragged 100 tiles x 777", 777, gamma(coupling_matrix(100))),
            ("512 tiles x 1,000 (bench_multitile)", 1000,
             gamma(coupling_matrix(512)))):
        p = power(t, g.shape[0])
        out = conv(p, g)
        torch.cuda.synchronize()
        ref = thermal_conv_reference(p, g, poles.decay, poles.gain)
        e = max_err(out, ref, f"phase D {where}")
        err = max(err, e)
        print(f"[phaseD] {where}: max_abs_err vs plain {e:.3e}, bit-exact "
              f"{all(torch.equal(a, b) for a, b in zip(out, ref))}")
    g47 = gamma(ponte_vecchio_gamma())
    p = power(2000, 47)
    full = conv(p, g47)
    first = conv(p[:977].contiguous(), g47)
    second = conv(p[977:].contiguous(), g47, first[1])
    e = max_err((torch.cat([first[0], second[0]]), second[1]), full,
                "phase D chained halves")
    err = max(err, e)
    print(f"[phaseD] two chained halves (977 + 1,023 steps) vs one run: "
          f"max_abs_err {e:.3e}")

    # the main path at full width, through the public entry point
    n, t = THERMAL_FULL
    g, p = gamma(coupling_matrix(n)), power(t, n)
    torch.cuda.synchronize()
    ops.thermal_conv.launches = 0
    dts, state = conv(p, g)
    torch.cuda.synchronize()
    launches = ops.thermal_conv.launches
    check(launches >= 1, "the thermal_conv main path launched no kernel")
    check(tuple(dts.shape) == (t, n) and bool(torch.isfinite(dts).all()),
          f"thermal_conv main path: dts {tuple(dts.shape)} not finite")
    ref, plain_ms = timed(lambda: thermal_conv_reference(
        p, g, poles.decay, poles.gain))
    e = max_err((dts, state), ref, "phase D main path")
    err = max(err, e)
    kernel_ms = event_ms(lambda: conv(p, g), 10)
    matmul_ms = event_ms(lambda: torch.matmul(p, g.T), 10)
    cost = thermal_conv_cost(p, g, 2)
    bound_ms, bound_by = bound(cost["bytes"], cost["ops_nnz"])
    dense_ms, dense_by = bound(cost["bytes"], cost["ops_dense"])
    print(f"[phaseD] thermal_conv [{t}, {n}] main path (ops.thermal_conv): "
          f"{launches} launch(es), max_abs_err vs plain {e:.3e}, bit-exact "
          f"{all(torch.equal(a, b) for a, b in zip((dts, state), ref))}; "
          f"kernel {kernel_ms:.3f} ms (median of 10, CUDA events), plain "
          f"{plain_ms:.1f} ms (one run); bound {bound_ms:.4f} ms by "
          f"{bound_by} ({cost['bytes'] / 1e6:.1f} MB, "
          f"{cost['ops_nnz'] / 1e9:.3f} GFLOP counting Γ's "
          f"{int((g != 0).sum())} non-zeros; dense "
          f"{cost['ops_dense'] / 1e9:.3f} GFLOP, {dense_ms:.4f} ms by "
          f"{dense_by}); for information, torch.matmul of Γ·P alone "
          f"{matmul_ms:.3f} ms (allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32})")
    return {"name": "thermal_conv", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/thermal_conv.cu",
            "replaces": "src/repro/kernels/thermal_conv.py:208",
            "launches": launches, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "matmul_gamma_p_ms": matmul_ms}


def phase_e(dev) -> dict:
    """`grid_conv`: kernel vs plain version, the full-width path, the ROM
    gate."""
    import numpy as np
    import torch

    from repro_torch.core.density import power_from_rho
    from repro_torch.core.fingerprint import FINGERPRINT
    from repro_torch.core.plant import ROM_PEAK_TOL, FittedROMPlant, GridPlant
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels import thermal_conv as tc

    gen = torch.Generator(device=dev).manual_seed(9)

    def power(t, nt):             # the fleet's density domain, ρ ∈ [0.9, 2.7]
        return power_from_rho(0.9 + 1.8 * torch.rand((t, nt), generator=gen,
                                                     device=dev))

    def plain(plant, p, s0):
        return tc.grid_conv_reference(
            p, plant.adj_h, plant.adj_v, plant.deg, plant.ghat, plant.inject,
            plant.readout, s0, r=float(plant.r), kappa=float(plant.kappa),
            substeps=plant.substeps)

    err = 0.0
    for nt in (1, 2, 47):
        for sub in (1, 2):
            for contrast in (0.0, 0.5):
                plant = GridPlant(SchedulerConfig(
                    n_tiles=nt, plant="grid", grid_substeps=sub,
                    grid_contrast=contrast), FINGERPRINT, device=dev)
                p = power(2000, nt)
                s0 = plant.init_state(())
                out = plant.simulate(p, s0)
                torch.cuda.synchronize()
                ref = plain(plant, p, s0)
                where = (f"{nt} tiles, substeps {sub}, contrast {contrast}")
                e = max_err(out, ref, f"phase E {where}")
                err = max(err, e)
                print(f"[phaseE] {where}, T=2000: max_abs_err vs plain "
                      f"{e:.3e}, state bit-exact "
                      f"{torch.equal(out[1], ref[1])}")

    # every patch edge grid_conv.cu compiles (2..16) at 5 tiles: 32 // edge
    # tiles share a warp, so most edges leave masked lanes or a partly
    # filled last warp; from a warm random state
    for cells in range(2, 17):
        plant = GridPlant(SchedulerConfig(n_tiles=5, plant="grid",
                                          grid_cells=cells), FINGERPRINT,
                          device=dev)
        p = power(300, 5)
        s0 = 10.0 * torch.rand((plant.gy, plant.W), generator=gen,
                               device=dev)
        out = plant.simulate(p, s0)
        torch.cuda.synchronize()
        ref = plain(plant, p, s0)
        e = max_err(out, ref, f"phase E grid_cells {cells}")
        err = max(err, e)
        print(f"[phaseE] grid_cells {cells} (5 tiles, T=300): max_abs_err "
              f"vs plain {e:.3e}, state bit-exact "
              f"{torch.equal(out[1], ref[1])}")

    # the main path at full width, through the plant's whole-trace entry
    nt, t = GRID_FULL
    cfg = SchedulerConfig(n_tiles=nt, plant="grid")
    plant = GridPlant(cfg, FINGERPRINT, device=dev)
    p = power(t, nt)
    torch.cuda.synchronize()
    tc.grid_conv.launches = 0
    dts, state = plant.simulate(p)
    torch.cuda.synchronize()
    launches = tc.grid_conv.launches
    check(launches >= 1, "the grid_conv main path launched no kernel")
    check(tuple(state.shape) == (plant.gy, plant.W)
          and bool(torch.isfinite(dts).all()),
          f"grid_conv main path: state {tuple(state.shape)}, dts finite "
          f"{bool(torch.isfinite(dts).all())}")
    ref, plain_ms = timed(lambda: plain(plant, p, plant.init_state(())))
    e = max_err((dts, state), ref, "phase E main path")
    err = max(err, e)
    kernel_ms = event_ms(lambda: plant.simulate(p), 10)
    cost = tc.grid_conv_cost(t, nt, plant.gy, plant.gx, plant.substeps)
    bound_ms, bound_by = bound(cost["bytes"], cost["ops"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    clock_mhz = float(smi.stdout.split()[0])
    chain = SHFL_LATENCY_CYCLES + 7 * FP32_LATENCY_CYCLES
    floor_ms = t * plant.substeps * chain / (clock_mhz * 1e3)
    print(f"[phaseE] grid_conv [{t}, {nt}] state [{plant.gy}, {plant.W}] "
          f"main path (GridPlant.simulate): {launches} launch(es), "
          f"max_abs_err vs plain {e:.3e}, state bit-exact "
          f"{torch.equal(state, ref[1])}; kernel {kernel_ms:.3f} ms (median "
          f"of 10, CUDA events), plain {plain_ms:.1f} ms (one run); "
          f"roofline bound {bound_ms:.5f} ms by {bound_by} "
          f"({cost['bytes'] / 1e6:.2f} MB, {cost['ops'] / 1e9:.3f} GFLOP); "
          f"dependence floor, an estimate from assumed latencies (not "
          f"measured): {floor_ms:.3f} ms ({t} steps x {chain} cycles at "
          f"{clock_mhz:.0f} MHz)")

    # ROM_PEAK_TOL gate at full width: the fitted bank through thermal_conv
    rom = FittedROMPlant(cfg, FINGERPRINT, device=dev)
    gain = np.asarray(rom.poles.gain)
    check(bool((gain == gain[0]).all()), "ROM gains differ across tiles")
    rom_dts, _ = ops.thermal_conv(p, torch.eye(nt, device=dev),
                                  rom.poles.decay, gain[0])
    pk_grid, pk_rom = float(dts.max()), float(rom_dts.max())
    rel = abs(pk_rom - pk_grid) / pk_grid
    check(rel <= ROM_PEAK_TOL, f"ROM peak {pk_rom:.4f} vs grid "
          f"{pk_grid:.4f}: rel err {rel:.4f} > {ROM_PEAK_TOL}")
    print(f"[phaseE] ROM_PEAK_TOL gate, 47 tiles x {t} steps: grid peak "
          f"{pk_grid:.4f} C, ROM peak {pk_rom:.4f} C ({rom.describe()}), "
          f"rel err {rel:.2e} <= {ROM_PEAK_TOL}")
    return {"name": "grid_conv", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/grid_conv.cu",
            "replaces": "src/repro/kernels/thermal_conv.py:157",
            "launches": launches, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "rom_peak_rel_err": rel}


def phase_f(dev, window) -> None:
    """The plant ladder in the fleet, serve --plant rom, DVFS and the
    Appendix-B dataset on the card."""
    import numpy as np
    import torch

    from repro_torch.core import dataset90k, dvfs, workload
    from repro_torch.core.coupling import coupling_matrix, row_normalise
    from repro_torch.core.density import rtok_from_rho
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.core.thermal import two_pole
    from repro_torch.fleet import FleetEngine
    from repro_torch.launch import serve

    t, n, nt = window.shape
    offered = float(rtok_from_rho(torch.from_numpy(window)).double().sum(
        dim=(1, 2)).mean())
    for plant, backend in (("grid", "fused"), ("rom", "broadcast")):
        eng = FleetEngine(SchedulerConfig(n_tiles=nt, mode="v24",
                                          plant=plant), backend=backend)
        check(eng.device.type == "cuda", f"engine on {eng.device}")
        if backend == "fused":
            check(eng.backend_impl.run_block is None,
                  "fused grid fleet did not take the per-step path")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, telem = eng.run_block(eng.init(n), window)
        d = telem.as_dict()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(all(np.isfinite(v) for v in d.values()),
              f"{plant} fleet telemetry not finite: {d}")
        check(bool(torch.isfinite(state.thermal).all()),
              f"{plant} fleet state not finite")
        got = d["released_mtps"] + d["throttled_mtps"]
        check(abs(got - offered) <= 1e-5 * offered,
              f"{plant} fleet: released + throttled {got} != {offered}")
        print(f"[phaseF] plant={plant} on {backend} "
              f"({eng.sched.plant.describe()}): {n} pkgs x {nt} tiles x "
              f"{t} steps in {wall * 1e3:.1f} ms (host clock, per-step "
              f"path), throttled share "
              f"{d['throttled_mtps'] / got:.6f} " + json.dumps(d))

    res = serve.main(["--stream", "--plant", "rom", "--fleet-backend",
                      "broadcast", "--fleet", "4096", "--waves", "4",
                      "--gen", "256"])
    torch.cuda.synchronize()
    check(res["flushes"] == res["host_syncs"] == 4,
          f"serve --plant rom: {res['flushes']} flushes")
    check(all(np.isfinite(v) for d in res["stream"] for v in d.values()),
          "serve --plant rom telemetry not finite")
    print(f"[phaseF] serve --stream --plant rom --fleet-backend broadcast "
          f"--fleet 4096: {res['flushes']} flushes, "
          f"{res['pkg_steps_per_s']:.4g} pkg-steps/s")

    g8 = row_normalise(coupling_matrix(8, cols=4)).to(dev)
    trace = workload.make_trace(0, 4000, "inference", n_tiles=8, device=dev)
    base = dvfs.simulate_reactive(trace, gamma=g8, poles=two_pole())
    v24 = dvfs.simulate_v24(trace, gamma=g8, poles=two_pole())
    released = float(dvfs.released_compute(base, v24))
    check(all(bool(torch.isfinite(x).all()) for x in
              (base.temp, base.freq, v24.temp, v24.freq)),
          "DVFS traces not finite")
    check(int(v24.events) == 0, f"V7.0 tripped DVFS {int(v24.events)} times")
    print(f"[phaseF] 8-tile DVFS (4,000 steps, inference): reactive perf "
          f"{float(base.perf):.4f}, peak {float(base.temp.max()):.2f} C, "
          f"{int(base.events)} events; V7.0 perf {float(v24.perf):.4f}, "
          f"peak {float(v24.temp.max()):.2f} C, 0 events; released "
          f"compute {released:+.4f}")
    ds = dataset90k.generate(device=dev)
    check(ds.rho.device.type == "cuda", "dataset not on the card")
    a, b, r2 = dataset90k.fit_affine(ds.rtok, ds.dt_junction)
    check(abs(r2 - 0.9911) <= 0.002, f"dataset R^2 {r2} not 0.9911")
    print(f"[phaseF] Appendix-B dataset (90,000 steps, on the card): "
          f"alpha {a:.3f}, beta {b:.2f}, R^2 {r2:.5f}")


if __name__ == "__main__":
    main()
