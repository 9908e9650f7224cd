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
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# NVIDIA H100 SXM data sheet: HBM3 bandwidth and f32 rate outside the
# tensor cores (the rates assume the full 700 W power limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
TOL = dict(rtol=1e-5, atol=1e-5)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


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
    t0 = time.perf_counter()
    lib = _build.build("fleet_step")
    print(f"[phase0] built {lib.name} in {time.perf_counter() - t0:.2f} s")

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

    def event_ms(fn, reps: int) -> float:
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
