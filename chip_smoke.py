#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0  prints the card's name and power limit (nvidia-smi) and builds the
         eight kernel sources of the checkout, one nvcc each, in parallel.
Phase A  the `fleet_step` CUDA kernel against its plain PyTorch version
         (`fleet_step_reference`) on the card at 1 tile × 4,096 packages
         (serve --stream's shape: no Γ), 4 tiles × 200 and 47 tiles × 64,
         T = 512, in each of the four control modes — traces and state
         within rtol = atol = 1e-5, event counts and the reactive_poll latch
         exact — each window timed beside its bound and PR 14's time
         (FLEET_PREV_WINDOW_MS); the kernels' registers and spills (nvcc
         -Xptxas -v).
Phase B  the main path: `FleetEngine(SchedulerConfig(n_tiles=47, mode="v24"),
         backend="fused")` on the card (the 47-tile Ponte-Vecchio package),
         4,096 packages, a 2,048-step diurnal swell of ρ from 0.9 to 2.7 and
         back streamed through `ingest.stream` in 8 flushes of 256 — exactly
         8 kernel launches, finite telemetry, released + throttled = ΣR_tok
         per window, the controller throttling in the middle flushes.  Then,
         on the peak window from its warm state, the kernel held against
         the plain version, its time beside its time before the redesign
         (FLEET_PREV_MS), its bound, registers and the plain version's
         time, and a per-stage breakdown of one flush.
Phase C  `repro_torch.launch.serve --stream --fleet 4096 --fleet-backend fused
         --waves 4 --gen 256`, in process: 4 flushes, 4 launches; then the
         kernel held against the plain version on serve's first window
         [256, 1 tile, 4,096], timed beside its bound and PR 14's time.
Phase D  the `thermal_conv` CUDA kernel against its plain version
         (`thermal_conv_reference`), bit for bit and one launch per call:
         8 tiles × 4,000 steps with the 8-tile Γ of
         examples/multi_tile_sim.py, 47 tiles with the Ponte-Vecchio Γ,
         ragged 100 tiles × 777, 512 × 1,000 (bench_multitile's shape), a
         dense random Γ at 100 and 2,048 tiles, NaN / ±inf spans in the
         power at 47 and 512 tiles (NaN and inf where the plain version has
         them), and two chained halves against one run.  Then its main path
         at full width: `kernels.ops.thermal_conv` over 512 tiles × 90,000
         steps (the paper's dataset length at the kernel's datacenter
         width), power 80 + 40·U(0,1) W — exactly one launch, bit-equal to
         the plain version, timed beside its time before the redesign
         (THERMAL_PREV_MS), its bound, its dependence-floor estimate, the
         plain version and Γ·P alone in torch.matmul; and the same length
         at the 47-tile Ponte-Vecchio grid, timed.
Phase E  the `grid_conv` CUDA kernel against its plain version
         (`grid_conv_reference`, the reference's adjacency operands) at 1, 2
         and 47 tiles × grid_substeps 1, 2 × grid_contrast 0, 0.5, and at
         every patch edge it compiles (grid_cells 2..16, 5 tiles) — the
         final state bit-exact, dts within 1e-5, one launch per trace.  Then
         its main path at full width: `GridPlant(n_tiles=47).simulate` over
         90,000 steps (state [8, 376]) — held against the plain version,
         timed beside its time before the redesign (GRID_PREV_MS), its
         roofline bound, its dependence-floor estimate and its registers —
         and the ROM_PEAK_TOL gate there: the fitted ROM's peak ΔT (through
         `thermal_conv`) within 0.02 of the grid's.
Phase F  the plant ladder in the fleet (per-step path): 47-tile v24 fleets
         of 4,096 packages with plant="grid" on the fused backend and
         plant="rom" on broadcast over Phase B's peak window; serve --stream
         --plant rom --fleet-backend broadcast --fleet 4096; the 8-tile
         reactive vs V7.0 DVFS comparison (released compute) and the
         Appendix-B dataset's R², both made and run on the card.
Phase G  the model-serving kernels against their plain versions on the
         card, in f32 (flash atol 2e-5, ssd atol 3e-5: the reference's own
         bounds) and bf16 (flash atol 2e-2).  `flash_attention` on both of
         its routes, each launch checked to take the route `flash_route`
         names: bf16 with d in {64, 112, 128, 256} on the tensor-core kernel
         (flash_attention_tc.cu), f32, mixed types and d = 32 on the
         CUDA-core kernel (flash_attention.cu) — the reference test's sweep,
         Zamba2-7B's [8, 1,024, 32, 112] and Gemma-2B's [8, 1,024, 8 on 1,
         256] prefill shapes, MHA / GQA / MQA at every tensor-core head
         dim, causal and not, windows (one that empties every row),
         q_offsets and ragged Tq / Tk; `ssd` on the reference test's sweep
         (mamba and rwkv regimes, u, include_current both ways, an h0), odd
         and unaligned N / P, f32 and bf16 c, x (a bf16 y also within one
         bf16 step), two chained halves against one run, and Zamba2-7B's
         prefill shape [8, 1,024, 112, 64 / 64] with f32 d and b, bf16 c
         and x.  Each timed at its main-path shape beside its first
         version's time, its bound and its plain version; flash also beside
         the CUDA-core kernel on the same values in f32 and
         scaled_dot_product_attention (library_ms, a yardstick only).
Phase H  the serving slice end to end at full width in bf16: `serve`
         --arch zamba2-7b, then gemma-2b, --batch 8 --prompt-len 1024
         --gen 32 --waves 3 --fleet 64 — exactly 81 ssd and 13 flash
         launches per Zamba2-7B prefill, 18 flash per Gemma-2B prefill and
         none in decode, every flash launch on the tensor-core route; a
         profiled prefill and decode step of each (device time by kernel
         group, idle share; each kernel group holds exactly those
         launches).  Then, with no JAX on the card,
         full-width correctness inside the port: Zamba2-7B in f32 (batch 2,
         prompt 128) decoding position 128 equals the full forward's last
         logits within 2e-4 × max|logit|, and its prefill on the kernels
         equals the same prefill on the plain versions within 1e-4 of each
         leaf's largest magnitude.

Phase I  the §10 Monte-Carlo population and `fleet_step`'s per-package planes.
         (a) The kernel against its plain version: heterogeneous rows (per
         tile and per package) in every mode at 1, 8 and 47 tiles; the
         degraded-fallback plane with NaN and ±inf spans in some packages'
         ρ, the operator pins, and both with het rows, uncoupled (packed
         layout) and coupled (wide layout); the wide layout at 129 and 200
         tiles in every mode and 512 coupled v24 tiles — traces and state
         within 1e-5, events, latches, counters and held ρ exact, one
         launch per window.  (b) `serve --montecarlo 2000 --fleet-backend
         fused` (3,000 steps, burn-in 400): exactly 6 `fleet_step`
         launches (3 survey blocks × 2 surveys), per-trial statistics
         within 1e-5 of the same draws on broadcast and of
         `montecarlo.run_reference` on the card; the §10 lines and trials/s.
         (c) 131,072 trials × 3,000 steps on fused, timed, with one survey
         block's kernel time beside its bound at both population sizes.
         (d) `serve --stream --node n3` on fused against broadcast, and a
         degraded-fallback fleet of Phase B's size (4,096 packages × 47
         coupled v24 tiles, 768 steps) under a `FaultPlan` (hint outage,
         dropout, corruption) on fused against broadcast, with the window
         of its outage timed in the wide layout beside the same clean
         window in the wide and the packed layout.

Phase J  the resident fleet control plane (PR 18).  (a) `fma_f32.cu` against
         its plain version (`fma_f32_reference`, on the card and on the
         CPU), one launch a call, bit for bit, at the broadcast fleet's
         shapes (scalars, a strided Γ column, per-package planes, the pole
         bank) and on crafted halfway sums and a dense random Γ; timed at
         the Γ walk's [4,096, 47] beside its byte bound, its plain version
         and the two-rounding f64 form, with its launches in one
         broadcast-fleet step.  (b) `FleetService(SchedulerConfig(n_tiles=
         47, mixed_mode=True), backend="fused", flush_every=256)` warmed to
         8,192 packages, 4,096 packages attached over four tenants (one per
         workload kind), six flushes with an attach that grows the capacity
         to 8,192, a canary(0.25), a threshold edit, an `ingest` chunk, a
         snapshot, and 2,049 detaches that shrink it back to 4,096: every
         flush one `fleet_step` launch and the synchronizing calls of ONE
         device→host copy (sync debug mode), held to a broadcast service
         stepping the same chunk from the same state; `FleetService.restore`
         vs the uninterrupted service ≤1e-5; no kernel library built or
         loaded after warmup; per-flush host ms by stage.  (c)
         `GroupedFleetEngine` (pole and ROM groups of 1,024 on the kernel,
         16 grid lanes per step, 47 tiles, node banks and pins) bit for bit
         against per-group oracles.  (d) `serve --serve --fleet-backend fused
         --serve-flushes 4 --port 0 --fleet 0` as a process, driven over
         HTTP.  (e) `serve --chaos` on the card.

Phase K  every model family of configs/ served.  (a) The serving
         kernels at this slice's shapes against their plain versions:
         flash on the CUDA-core route at DeepSeek-V2's MLA prefill [2,
         1,024, 128, q/k 192 / v 128] with the explicit scale 192^-0.5,
         causal (f32 within 2e-5, bf16 within 2e-2); flash on the
         tensor-core route in bf16 (within 2e-2) at musicgen-large's
         prefill [8, 1,024, 32 on 32, 64] and chameleon-34b's [8, 1,024,
         64 on 8, 128], causal, and at Mixtral's [2, 4,608, 32 on 8, 128]
         with its 4,096-token window, which masks keys there; `ssd` at
         RWKV6's [8, 1,024, 32, 64/64] with `u` and include_current=False
         in f32 and with f32 d, bf16 k / v / r, in the reference kernel
         test's rwkv regime (within 3e-5) and at the model's own scale
         (the w0 / lora decay, unit k and r: within 1e-5 of max|y| and of
         max|hT|, and held beside the exact f64 recurrence); a bf16 y
         also within one bf16 step — each launch on the route
         `flash_route` names, each timed beside its bound, flash also
         beside scaled_dot_product_attention with the same scale, or the
         window as a dense mask (library_ms, a yardstick only).  (b) Serving at full width in
         bf16 with SERVE_ARGV: `serve --arch rwkv6-1.6b` (24 ssd per
         prefill, no flash) and musicgen-large (48 layers, stub frame
         embeddings: 48 flash per prefill); then through
         `serve._wave_loop` with `dataclasses.replace(cfg, n_layers=k)`,
         the depth cut to fit 80 GB: chameleon-34b at 24 of 48 layers (24
         flash), mixtral-8x7b at 8 of 32 with --batch 2 --prompt-len 4608
         --gen 32 (8 flash on the tensor-core route; the prefill masks
         keys, the ring rolls by 512, decode writes slot pos % 4096) and
         deepseek-v2-236b at 4 of 60 with --batch 2 --prompt-len 1024
         --gen 16 (4 flash on the CUDA-core route) — exact launch counts
         and routes, none in decode; a profiled prefill and decode step
         of RWKV6 and of the Mixtral cut.  (c) Full-width correctness in
         f32 inside the port: RWKV6 (batch 2, prompt 128) decode vs the
         full forward within 2e-4 × max|logit| and its prefill on the
         kernels vs on the plain versions within 1e-4 of each leaf's
         largest magnitude, then where the decode gap comes from (the
         same gap on the plain versions, with the prefill's scan at chunk
         1, the two forwards against each other, and at one layer);
         mixtral-8x7b at 2 layers with a prompt of
         4,100 (the ring wraps) and deepseek-v2-236b at 1 layer (absorbed
         MLA decode vs the expanded forward), each with the capacity
         factor ceil(E / k), at which no routed token overflows (under the
         published 1.3 the forward may drop a token that decode keeps);
         Gemma-2B with kv_cache_dtype="int8" decode vs forward within 0.05
         relative, the cache still int8.

Phase L  training (PR 20).  (a) `flash_attention_stats` (each route's
         forward with its f32 output and row statistics) against the plain
         statistics, its output bit-equal to the serving launch's, and the
         backward kernel (flash_attention_bwd.cu) against the plain backward
         (`make_flash`'s bwd) on the plain residuals — gradients within
         1e-5 (f32) and 5e-3 (bf16) of each one's largest magnitude, the
         same bits on two launches — at Gemma-2B's training shape [8, 1,024,
         8 on 1, 256] bf16, the 100M example's [8, 256, 10 on 5, 64] f32,
         Zamba2-7B's [8, 1,024, 32, 112], MLA's [2, 1,024, 128, 192 / 128],
         a window, a ragged T, rows a window empties and f32 at d 256; timed
         at Gemma's shape beside its bound, the plain backward and
         scaled_dot_product_attention's backward (enable_gqa; library_ms, a
         yardstick only).  (b) Gemma-2B at full width and depth in bf16:
         loss and gradients on the kernels (36 forward launches on the
         tensor-core route, 18 backward) against FlashAttention on its
         plain branches (no launch), the loss within 1e-3 and each
         gradient leaf within 5e-2 of its largest magnitude (bf16 P in the
         tensor-core forward and bf16 activations through 18 layers and
         their recompute).  (c) The same in f32 at 2 layers (the CUDA-core
         route): each leaf within 1e-4.  (d) `repro_torch.launch.train
         --arch gemma-2b --batch 8 --seq 1024 --steps 6` in process:
         finite losses, exactly 36 forward and 18 backward launches a
         step, the warm step time, tok/s, peak device memory, and a
         profiled warm step (device time by group: flash forward, flash
         backward, GEMM, the rest; the AdamW update's span; idle share);
         then checkpoint and auto-resume through the same driver at full
         width with the depth cut to CKPT_LAYERS (a full-depth train state
         is 30 GB a checkpoint): --steps 6 --ckpt-every 3, then --steps 8,
         the restored state bit-equal to the saved one (steps 3, 5, then
         6, 7; the three newest kept).  (e)
         examples/torch_train_100m.py on the card (f32, the CUDA-core
         route forward and backward): exact launches, the loss falls.

The line before the last is one JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without CUDA, or outside a checkout of the repository, it exits non-zero and
prints no result.  It catches nothing: any failed check ends the run.
"""
from __future__ import annotations

import contextlib
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
# bf16 on the tensor cores: the least time for work whose inputs are bf16
PEAK_BF16_PER_S = 989e12
# dependent-issue latencies ASSUMED (not measured) for the estimate of the
# grid recurrence's dependence floor, printed beside its times but not in
# the kernels line: an f32 add or multiply, and a warp shuffle, in SM cycles;
# one substep's chain is a shuffle and 8 dependent f32 operations (w·left,
# + w·right, + vert, − deg·s, κ·, + (d − ĝ·s), r·, s +)
FP32_LATENCY_CYCLES = 4
SHFL_LATENCY_CYCLES = 24
GRID_CHAIN_FP32_OPS = 8
TOL = dict(rtol=1e-5, atol=1e-5)
KERNELS = ("fleet_step", "thermal_conv", "grid_conv", "flash_attention",
           "flash_attention_tc", "ssd", "fma_f32", "flash_attention_bwd")
# full-width (tiles, steps) of the thermal kernels' main paths: the paper's
# 90k-step dataset length at thermal_conv's datacenter width (N = 512, the
# reference kernel's stated O(512)) and at the 47-tile Ponte-Vecchio grid
THERMAL_FULL = (512, 90_000)
GRID_FULL = (47, 90_000)
# the serving slice's main path: each model's prefill shapes at --batch 8
# --prompt-len 1024 (flash: B, T, H, KV, d; ssd: B, T, H, N, P), the serve
# command, and the batch and prompt of the f32 decode-vs-forward check
FLASH_MAIN = {"zamba2-7b": (8, 1024, 32, 32, 112),
              "gemma-2b": (8, 1024, 8, 1, 256)}
SSD_MAIN = (8, 1024, 112, 64, 64)
# the first versions of those kernels at those shapes (NVIDIA H100 80GB
# HBM3, 700 W; PERF.md's kernel table), printed beside the current times:
# flash (f32 FMAs on the CUDA cores) by (H, d), then ssd (unpipelined)
FLASH_FIRST_MS = {(32, 112): 5.792, (8, 256): 4.047}
SSD_FIRST_MS = 3.180
# the versions of fleet_step and grid_conv before their redesign, at their
# main-path shapes (NVIDIA H100 80GB HBM3, 700 W; PERF.md's kernel table):
# fleet_step per [256, 47, 4,096] peak window, grid_conv per [90,000, 47]
FLEET_PREV_MS = 3.430
GRID_PREV_MS = 19.386
# thermal_conv before its redesign (the dense-product kernel), per
# [90,000, 512] trace (NVIDIA H100 80GB HBM3, 700 W; PERF.md's kernel table)
THERMAL_PREV_MS = 9.962
# PR 14's fleet_step at the other windows timed here — Phase A's by (mode,
# tiles, packages) at T = 512, and serve --stream's first window — the mean
# of its two times in scripts/kernel_ab.py against PR 14's source, one call
# (NVIDIA H100 80GB HBM3, 700 W)
FLEET_PREV_WINDOW_MS = {
    ("v24", 1, 4096): 0.697, ("reactive", 1, 4096): 0.402,
    ("reactive_poll", 1, 4096): 0.571, ("off", 1, 4096): 0.447,
    ("v24", 4, 200): 1.169, ("reactive", 4, 200): 0.507,
    ("reactive_poll", 4, 200): 0.623, ("off", 4, 200): 0.489,
    ("v24", 47, 64): 2.256, ("reactive", 47, 64): 0.837,
    ("reactive_poll", 47, 64): 0.939, ("off", 47, 64): 0.878,
    "serve": 0.433,
}
# serve --stream as Phase C runs it: 1,024 steps of a 4,096-package 1-tile
# fleet in 4 flushes
SERVE_STREAM_ARGV = ["--stream", "--fleet", "4096", "--fleet-backend",
                     "fused", "--waves", "4", "--gen", "256"]
SERVE_ARGV = ["--batch", "8", "--prompt-len", "1024", "--gen", "32",
              "--waves", "3", "--fleet", "64"]
F32_CHECK = (2, 128)
# Phase I: the paper's population (trials, steps, burn-in), the fleet-scale
# one, and the survey block the fused backend launches per chunk
MC_STEPS, MC_BURN_IN, MC_CHUNK = 3000, 400, 1024
MC_ARGV = ["--montecarlo", "2000", "--mc-steps", str(MC_STEPS),
           "--fleet-backend", "fused"]
MC_FLEET_TRIALS = 131_072
# Phase I (d): the degraded-fallback stream (packages, tiles, steps,
# flush: Phase B's fleet) and the step its fleet-wide hint outage starts
FB_STREAM = (4096, 47, 768, 256)
FB_OUTAGE = 300


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


def bound(nbytes: float, ops: float,
          peak_ops: float = PEAK_F32_PER_S) -> tuple[float, str]:
    """(least ms the card could take, what sets it) at the data-sheet peaks
    (operations at ``peak_ops``: f32, or bf16 where the inputs are bf16)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(out, ref, where: str, rtol: float = TOL["rtol"],
            atol: float = TOL["atol"]) -> float:
    """Kernel outputs vs plain outputs, each within |Δ| ≤ atol + rtol·|plain|
    (compared in f32), rtol = atol = 1e-5 unless given."""
    import torch

    err = 0.0
    for i, (a, b) in enumerate(zip(out, ref)):
        a, b = a.float(), b.float()
        check(bool(torch.isfinite(a).all()), f"{where}: output {i} not finite")
        d = float((a - b).abs().max())
        check(torch.allclose(a, b, rtol=rtol, atol=atol),
              f"{where}: output {i} differs from the plain version by {d:.3e}")
        err = max(err, d)
    return err


def registers(name: str, kernel: str = "") -> str:
    """`nvcc -Xptxas -v`'s registers and spill bytes of each kernel in the
    library ``name`` whose mangled name contains ``kernel``, each named by
    its template arguments (``<2, true>``)."""
    import re

    from repro_torch.kernels import _build

    def args(mangled: str) -> str:
        vals = re.findall(r"L([ib])(\d+)E", mangled.split("kernelI", 1)[-1]
                          .split("Ev", 1)[0])
        return "<" + ", ".join(v if t == "i" else ("true" if v == "1" else
                                                    "false")
                               for t, v in vals) + ">"

    return "; ".join(
        f"{args(k)}: {u['registers']} registers, {u['spill_stores']} B "
        f"spill stores, {u['spill_loads']} B spill loads"
        for k, u in sorted(_build.resource_usage(name).items())
        if kernel in k)


def fleet_trace(n_tiles: int, n: int, steps: int):
    """The reference's fleet trace (examples/fleet_sim.py) as [T, n, tiles]
    f32 numpy: a diurnal swell over the paper's density domain plus
    per-(package, tile) process jitter — cool at both ends, throttling for
    part of the fleet mid-way."""
    import numpy as np

    rng = np.random.default_rng(0)
    swell = 0.9 + 1.8 * np.sin(
        np.linspace(0.0, np.pi, steps, dtype=np.float32)) ** 2
    jitter = 0.2 * rng.standard_normal((n, n_tiles)).astype(np.float32)
    return np.clip(swell[:, None, None] + jitter, 0.9, 2.7).astype(np.float32)


def warm_window(backend, state0, trace, flush: int, peak: int):
    """(args, kwargs) of `fleet_step` on flush ``peak`` of ``trace`` from
    the warm state the stream reaches there."""
    warm = state0
    for i in range(peak):
        warm = backend.run_block(
            warm, backend.put_trace(trace[i * flush:(i + 1) * flush]))[0]
    chunk = backend.put_trace(trace[peak * flush:(peak + 1) * flush])
    args, kwargs = backend.kernel_inputs(warm, chunk)
    return warm, chunk, args, kwargs


def fleet_window(dev, mode: str, n_tiles: int, n: int, t: int, seed: int):
    """(kernel args, kwargs) of `fleet_step` for one Phase A window: a fresh
    fleet state and a seeded uniform density trace over the paper's
    domain."""
    import torch

    from repro_torch.core.scheduler import SchedulerConfig, ThermalScheduler
    from repro_torch.fleet.backends.fused import FusedBackend

    sched = ThermalScheduler(SchedulerConfig(n_tiles=n_tiles, mode=mode),
                             device=dev)
    backend = FusedBackend(sched)
    state = backend.init(n)._replace(step=torch.tensor(5, dtype=torch.int32))
    g = torch.Generator().manual_seed(seed)
    rho = (0.9 + 1.8 * torch.rand((t, n, n_tiles), generator=g)).to(dev)
    return backend.kernel_inputs(state, rho)


def serve_window(dev, trace):
    """(kernel args, kwargs) of `fleet_step` on the first window of `serve
    --stream`'s density trace (SERVE_STREAM_ARGV): 1 tile, no Γ, from a
    fresh fleet."""
    from repro_torch.core.scheduler import SchedulerConfig, ThermalScheduler
    from repro_torch.fleet.backends.fused import FusedBackend

    backend = FusedBackend(ThermalScheduler(
        SchedulerConfig(n_tiles=1, mode="v24", step_ms=5.0), device=dev))
    return backend.kernel_inputs(backend.init(trace.shape[1]),
                                 backend.put_trace(trace[:256]))


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
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.fleet import FleetEngine, chunk_source, stream
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

    # ---------------------------------------------------------------- phase A
    max_err = 0.0
    for n_tiles, n in ((1, 4096), (4, 200), (47, 64)):
        for mode in ("v24", "reactive", "reactive_poll", "off"):
            args, kwargs = fleet_window(dev, mode, n_tiles, n, 512,
                                        seed=n_tiles)
            out = fs.fleet_step(*args, **kwargs)
            torch.cuda.synchronize()
            ref = fs.fleet_step_reference(*args, **kwargs)
            where = f"phase A {mode} {n_tiles} tiles x {n} pkgs"
            err = compare(out, ref, where)
            max_err = max(max_err, err)
            ms = event_ms(lambda: fs.fleet_step(*args, **kwargs), 5)
            b_ms, b_by = bound(*fs.fleet_step_cost(args[0], args[6], args[7]))
            print(f"[phaseA] {mode:13s} {n_tiles:2d} tiles x {n:4d} pkgs "
                  f"T=512: max_abs_err {err:.3e}, events "
                  f"{int(out[4].sum())} == plain {int(ref[4].sum())}; "
                  f"kernel {ms:.4f} ms (median of 5, CUDA events; "
                  f"{FLEET_PREV_WINDOW_MS[(mode, n_tiles, n)]} ms before its "
                  f"redesign), bound {b_ms:.4f} ms by {b_by}")
    print(f"[phaseA] fleet_step.cu (nvcc -Xptxas -v): "
          f"{registers('fleet_step')}")

    # ---------------------------------------------------------------- phase B
    n_tiles, n, steps, flush = 47, 4096, 2048, 256
    trace = fleet_trace(n_tiles, n, steps)                # [T, n, tiles]
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
    warm, chunk, args, kwargs = warm_window(backend, state0, trace, flush,
                                            peak)

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
          f"{kernel_ms:.4f} ms (median of 10, CUDA events; "
          f"{FLEET_PREV_MS} ms before its redesign), plain "
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
    print(f"[phaseB] fleet_step.cu (nvcc -Xptxas -v; 47 coupled v24 tiles "
          f"take the main-path kernel with 2 tiles a thread, <2, true>): "
          f"{registers('fleet_step', 'ILi2ELb1E')}")

    # ---------------------------------------------------------------- phase C
    fs.fleet_step.launches = 0
    res = serve.main(SERVE_STREAM_ARGV)
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
    c_trace = res["trace"]
    check(c_trace.shape == (1024, 4096, 1),
          f"serve --stream trace has shape {c_trace.shape}")
    args, kwargs = serve_window(dev, c_trace)
    out = fs.fleet_step(*args, **kwargs)
    torch.cuda.synchronize()
    ref = fs.fleet_step_reference(*args, **kwargs)
    err = compare(out, ref, "serve --stream window")
    max_err = max(max_err, err)
    ms = event_ms(lambda: fs.fleet_step(*args, **kwargs), 10)
    b_ms, b_by = bound(*fs.fleet_step_cost(args[0], args[6], args[7]))
    print(f"[phaseC] fleet_step [256, 1, 4096] on serve's first window: "
          f"max_abs_err vs plain {err:.3e}, events {int(out[4].sum())} == "
          f"plain {int(ref[4].sum())}; kernel {ms:.4f} ms (median of 10, "
          f"CUDA events; {FLEET_PREV_WINDOW_MS['serve']} ms before its "
          f"redesign), bound {b_ms:.4f} ms by {b_by}; "
          f"{registers('fleet_step', 'ILi1ELb0E')}")

    mc_entry = phase_i(dev, compare)
    tc_entry = phase_d(dev)
    gc_entry = phase_e(dev)
    phase_f(dev, trace[peak * flush:(peak + 1) * flush])
    fa_entry, ssd_entry = phase_g(dev)
    phase_h(dev, fa_entry, ssd_entry)
    phase_k(dev, fa_entry, ssd_entry)
    fma_entry = phase_j(dev)
    fb_entry = phase_l(dev)

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
        **mc_entry,
    }, tc_entry, gc_entry, fa_entry, ssd_entry, fma_entry, fb_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def plane_window(dev, mode: str, n_tiles: int, n: int, t: int, seed: int, *,
                 het: int = 0, fallback: bool = False, mixed: bool = False,
                 coupled: bool = True, bad: bool = False):
    """(kernel args, kwargs) of `fleet_step` with per-package planes: het
    rows with a tile axis of ``het`` (0: none), the fallback plane with
    NaN / ±inf spans in three packages' ρ (``bad``), the operator pins."""
    import dataclasses

    import torch

    from repro_torch.core.pdu_gate import exact_stats
    from repro_torch.core.scheduler import SchedulerConfig, ThermalScheduler
    from repro_torch.fleet.backends.fused import FusedBackend

    sched = ThermalScheduler(SchedulerConfig(n_tiles=n_tiles, mode=mode,
                                             use_coupling=coupled),
                             device=dev)
    p = dataclasses.replace(FusedBackend(sched).params, fallback=fallback,
                            mixed=mixed, stale_limit=3, recover=4)
    g = torch.Generator().manual_seed(seed)
    u = lambda lo, hi, *shape: lo + (hi - lo) * torch.rand(shape, generator=g)
    buf0 = u(0.9, 2.7, p.window, n_tiles, n)
    rho = u(0.9, 2.7, t, n_tiles, n)
    if bad:
        rho[5:12, :, 1] = float("nan")
        rho[7, 0, 2] = float("inf")
        rho[20:22, -1, 3] = -float("inf")
    put = lambda x: x.float().contiguous().to(dev)
    args = (put(rho), put(buf0), put(u(5.0, 25.0, p.n_poles, n_tiles, n)),
            put(torch.stack(exact_stats(buf0, 0, axis=0))),
            put(u(0.5, 1.0, n_tiles, n)), put(torch.zeros(1, n)),
            sched.gamma, p)
    kw = {"step0": 7}
    if mode == "reactive_poll" or fallback or mixed:
        kw["thr0"] = put(torch.rand((n_tiles, n), generator=g) < 0.5)
    if het:
        # process variation around the fleet's own bank: τ × 0.7–1.4
        # (decay a^(1/scale)), gain × 0.8–1.2, η = 1 − a_slow^ahead
        a0 = torch.tensor(p.decay)[:, None, None]
        decay = a0 ** (1.0 / u(0.7, 1.4, 1, het, n))
        gain = torch.tensor(p.gain)[:, None, None] * u(0.8, 1.2, 1, het, n)
        poll = torch.randint(1, 7, (1, het, n), generator=g)
        kw["het"] = put(torch.cat([decay, gain,
                                   (1 - decay[-1] ** p.ahead)[None],
                                   gain.sum(0)[None], poll.float()]))
    if fallback:
        kw["fb0"] = (put(u(0.9, 2.7, n_tiles, n)),
                     put(torch.randint(0, 5, (n,), generator=g)),
                     put(torch.rand(n, generator=g) < 0.3))
    if mixed:
        kw["mode0"] = put(torch.rand(n, generator=g) < 0.5)
    return args, kw


def mc_block(dev, n_trials: int, mode: str):
    """(kernel args, kwargs) of the first survey block `montecarlo.run`
    launches for a population of ``n_trials`` on fused, in ``mode``."""
    from repro_torch.core import dvfs, montecarlo, thermal

    d = montecarlo.sample_trials(1, n_trials, MC_CHUNK, device=dev)
    rth, tau, _, poll, traces = d
    lanes = montecarlo._pack(n_trials)
    n_pkg = n_trials // lanes
    cfg = dvfs.DVFSConfig()
    eng = montecarlo._engine(montecarlo._scheduler_cfg(
        cfg, lanes, mode, "incremental"), montecarlo.FINGERPRINT, "fused",
        dev)
    shape = (n_pkg, lanes)
    pkg = eng.sched.package_params(thermal.PoleParams(
        decay=montecarlo._decay(tau, cfg.dt_ms).reshape(shape)[..., None],
        gain=rth.reshape(shape)[..., None]), poll_ticks=poll.reshape(shape),
        batch_shape=(n_pkg,))
    trace = traces.mT.reshape(MC_CHUNK, n_pkg, lanes)
    state = eng.init(n_pkg, pkg=pkg, filtration_fill=trace[0])
    return eng.backend_impl.kernel_inputs(state, trace)


def phase_i(dev, compare) -> dict:
    """The §10 population and the per-package planes (module docstring);
    returns the Monte-Carlo numbers of the fleet_step kernels entry."""
    import numpy as np
    import torch

    from repro_torch.core import montecarlo
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.fleet import FaultPlan, FleetEngine, HintOutage
    from repro_torch.kernels import fleet_step as fs
    from repro_torch.launch import serve

    t_phase = time.perf_counter()

    # (a) the kernel with each plane against its plain version
    def held(where, args, kw):
        before = fs.fleet_step.launches
        out = fs.fleet_step(*args, **kw)
        torch.cuda.synchronize()
        check(fs.fleet_step.launches == before + 1,
              f"{where}: {fs.fleet_step.launches - before} launches")
        ref = fs.fleet_step_reference(*args, **kw)
        err = compare(out, ref, where)
        if ref[6] is not None:
            for name, a, b in zip(("held rho", "stale", "degraded"), out[6],
                                  ref[6]):
                check(torch.equal(a, b), f"{where}: {name} differs")
        return err, out

    cases = []
    for nt in (1, 8, 47):
        for mode in ("v24", "reactive", "reactive_poll", "off"):
            for het in (nt, 1):
                cases.append((f"het[{het}] {mode} {nt} tiles", dict(
                    mode=mode, n_tiles=nt, n=300, t=96, het=het)))
    for nt in (1, 8, 47):
        for coupled in (False, True):
            for fb, mx, het in ((True, False, 0), (False, True, 0),
                                (True, True, nt)):
                cases.append((
                    f"{'fb0 ' if fb else ''}{'mode0 ' if mx else ''}"
                    f"{'het ' if het else ''}{nt} tiles "
                    f"{'coupled' if coupled else 'uncoupled'}",
                    dict(mode="v24", n_tiles=nt, n=200, t=96, het=het,
                         fallback=fb, mixed=mx, coupled=coupled, bad=fb)))
    for nt in (129, 200):
        for mode in ("v24", "reactive", "reactive_poll", "off"):
            cases.append((f"wide {mode} {nt} tiles",
                          dict(mode=mode, n_tiles=nt, n=40, t=96)))
    cases.append(("wide v24 512 tiles", dict(mode="v24", n_tiles=512, n=64,
                                             t=48)))
    cases.append(("wide fb0 mode0 het 200 tiles", dict(
        mode="v24", n_tiles=200, n=40, t=96, het=1, fallback=True,
        mixed=True, bad=True)))
    errs, layouts = [], {}
    for i, (where, kw) in enumerate(cases):
        args, kwargs = plane_window(dev, seed=i, **kw)
        lay = fs.layout(kw["n_tiles"], args[7])
        layouts[lay] = layouts.get(lay, 0) + 1
        err, _ = held(f"phase I {where}", args, kwargs)
        errs.append(err)
    print(f"[phaseI] (a) {len(cases)} windows with per-package planes and "
          f"> 128 tiles held against the plain version ({layouts}): "
          f"max_abs_err {max(errs):.3e}, events, latches, counters and held "
          f"rho exact, one launch each")

    # (b) the paper's population end to end, on fused, then the same draws
    # on broadcast and through the per-trial oracle
    torch.cuda.synchronize()
    fs.fleet_step.launches = 0
    res = serve.main(MC_ARGV)
    torch.cuda.synchronize()
    mc_launches = fs.fleet_step.launches
    want = 2 * -(-MC_STEPS // MC_CHUNK)
    check(mc_launches == want,
          f"serve --montecarlo launched fleet_step {mc_launches} times, "
          f"want {want}")
    r = res["result"]
    n_trials = int(MC_ARGV[1])
    bcast = montecarlo.run(seed=0, n_trials=n_trials, n_steps=MC_STEPS,
                           burn_in=MC_BURN_IN, backend="broadcast",
                           device=dev)
    t0 = time.perf_counter()
    oracle = montecarlo.run_reference(seed=0, n_trials=n_trials,
                                      n_steps=MC_STEPS, burn_in=MC_BURN_IN,
                                      device=dev)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    mc_err = 0.0
    for name, other in (("broadcast", bcast), ("run_reference", oracle)):
        for f in r._fields:
            a, b = getattr(r, f), getattr(other, f)
            check(a.shape == (n_trials,) and bool(torch.isfinite(a).all()),
                  f"montecarlo {f}: shape {tuple(a.shape)} or not finite")
            d = float((a - b).abs().max())
            check(torch.allclose(a, b, **TOL),
                  f"montecarlo fused vs {name}: {f} differs by {d:.3e}")
            mc_err = max(mc_err, d)
    s = res["montecarlo"]
    check(s["baseline_mean_c"] > s["v24_mean_c"]
          and s["sigma_tighter_x"] > 1.0,
          f"the §10 population shows no tightening: {s}")
    print(f"[phaseI] (b) serve --montecarlo {n_trials} on fused: "
          f"{mc_launches} fleet_step launches, {res['trials_per_s']:.4g} "
          f"trials/s (host clock); per trial within 1e-5 of broadcast and "
          f"run_reference on the same draws (max |d| {mc_err:.3e}; "
          f"run_reference {oracle_s:.2f} s); " + json.dumps(s))

    # (c) a population at fleet scale, and one survey block's kernel time
    # beside its bound at both sizes
    torch.cuda.synchronize()
    fs.fleet_step.launches = 0
    t0 = time.perf_counter()
    draws = montecarlo.sample_trials(3, MC_FLEET_TRIALS, MC_STEPS,
                                     device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    big = montecarlo.run(burn_in=MC_BURN_IN, backend="fused", draws=draws,
                         device=dev)
    big_s = big.stats()
    t2 = time.perf_counter()
    big_wall = t2 - t0
    check(fs.fleet_step.launches == want,
          f"{MC_FLEET_TRIALS} trials: {fs.fleet_step.launches} launches")
    check(all(np.isfinite(v) for v in big_s.values()),
          f"{MC_FLEET_TRIALS} trials: non-finite statistics {big_s}")
    blocks = {}
    for trials in (n_trials, MC_FLEET_TRIALS):
        for mode in ("reactive_poll", "v24"):
            args, kwargs = mc_block(dev, trials, mode)
            fs.fleet_step(*args, **kwargs)
            ms = event_ms(lambda: fs.fleet_step(*args, **kwargs), 5)
            b_ms, b_by = bound(*fs.fleet_step_cost(
                args[0], args[6], args[7], het=kwargs["het"]))
            blocks[f"{trials}/{mode}"] = (ms, b_ms, b_by)
            print(f"[phaseI] (c) survey block {list(args[0].shape)} "
                  f"{mode}: kernel {ms:.4f} ms (median of 5, CUDA events), "
                  f"bound {b_ms:.4f} ms by {b_by}")
    blocks_ms = sum(-(-MC_STEPS // MC_CHUNK) * blocks[
        f"{MC_FLEET_TRIALS}/{m}"][0] for m in ("reactive_poll", "v24"))
    print(f"[phaseI] (c) {MC_FLEET_TRIALS} trials x {MC_STEPS} steps on "
          f"fused: {big_wall:.3f} s = {MC_FLEET_TRIALS / big_wall:.4g} "
          f"trials/s (host clock, after torch.cuda.synchronize): draws and "
          f"traces made on the card {(t1 - t0) * 1e3:.1f} ms, the two "
          f"surveys and the statistics {(t2 - t1) * 1e3:.1f} ms, of which "
          f"the {want} kernel launches ~{blocks_ms:.1f} ms (first-block "
          f"times); {want} launches; " + json.dumps(big_s))

    # (d) two more paths: a node-bank stream and a degraded-fallback stream
    node = ["--stream", "--node", "n3", "--fleet", "4096", "--waves", "4",
            "--gen", "256"]
    fs.fleet_step.launches = 0
    rf = serve.main(node + ["--fleet-backend", "fused"])
    check(fs.fleet_step.launches == 4,
          f"serve --stream --node n3: {fs.fleet_step.launches} launches")
    rb = serve.main(node + ["--fleet-backend", "broadcast"])
    for a, b in zip(rf["stream"], rb["stream"]):
        for k in a:
            tol = 1e-3 if k in ("freq_min", "at_risk_frac") else 1e-5
            check(abs(a[k] - b[k]) <= tol + tol * abs(b[k]),
                  f"--node n3 fused vs broadcast: {k} {a[k]} vs {b[k]}")
    n, nt, steps, flush = FB_STREAM
    cfg = SchedulerConfig(n_tiles=nt, mode="v24", degraded_fallback=True,
                          stale_limit_steps=4, recover_steps=8)
    plan = FaultPlan.generate(seed=5, n_packages=n, n_steps=steps,
                              faults=64, kinds=("dropout", "corrupt"))
    plan = FaultPlan(seed=plan.seed, sensor_faults=plan.sensor_faults,
                     hint_outages=(HintOutage(FB_OUTAGE, 24),))
    clean = fleet_trace(nt, n, steps)
    trace = plan.apply(clean, 0)
    got = {}
    for backend in ("fused", "broadcast"):
        eng = FleetEngine(cfg, backend=backend)
        fs.fleet_step.launches = 0
        st, tel = eng.run_chunked(eng.init(n), trace, flush)
        torch.cuda.synchronize()
        got[backend] = (st, tel, fs.fleet_step.launches)
    (sf, tf, lf), (sb, tb, _) = got["fused"], got["broadcast"]
    check(lf == steps // flush, f"fallback stream: {lf} launches")
    for f in ("events", "stale", "degraded"):
        check(torch.equal(getattr(sf, f), getattr(sb, f)),
              f"fallback stream: state.{f} differs fused vs broadcast")
    for f in ("thermal", "freq", "rho_last"):
        check(torch.allclose(getattr(sf, f), getattr(sb, f), **TOL),
              f"fallback stream: state.{f} differs fused vs broadcast")
    dc_f, dc_b = tf.degraded_count.tolist(), tb.degraded_count.tolist()
    check(dc_f == dc_b and tf.events_total.tolist()
          == tb.events_total.tolist(),
          f"fallback stream: degraded counts {dc_f} vs {dc_b}")
    check(dc_f[FB_OUTAGE // flush] == n,
          f"the outage degrades all lanes: {dc_f}")
    # the fallback fleet's window with the outage, in the wide layout, and
    # the same window of the clean trace in the wide layout and, without
    # the fallback plane, in the packed layout (Phase B's kernel)
    peak = FB_OUTAGE // flush
    window_ms = {}
    for name, c, tr in (
            ("wide, faulted", cfg, trace), ("wide, clean", cfg, clean),
            ("packed, clean", SchedulerConfig(n_tiles=nt, mode="v24"),
             clean)):
        eng = FleetEngine(c, backend="fused")
        be = eng.backend_impl
        args, kwargs = warm_window(be, eng.init(n), tr, flush, peak)[2:]
        check(fs.layout(nt, args[7]) == name.split(",")[0],
              f"fallback window {name}: layout {fs.layout(nt, args[7])}")
        fs.fleet_step(*args, **kwargs)
        window_ms[name] = event_ms(lambda: fs.fleet_step(*args, **kwargs),
                                   5)
    print(f"[phaseI] (d) serve --stream --node n3 fused == broadcast "
          f"(4 launches); fallback stream {n} x {nt} coupled v24 tiles "
          f"(wide layout), {plan.describe()}: degraded per flush {dc_f}, "
          f"events {tf.events_total.tolist()}, fused == broadcast; "
          f"fleet_step [{flush}, {nt}, {n}] on flush {peak + 1} (median of "
          f"5, CUDA events): " + json.dumps(window_ms)
          + f"; phase I {time.perf_counter() - t_phase:.1f} s")
    return {"fallback_window_ms": window_ms,
            "mc_launches": mc_launches, "mc_max_abs_err": mc_err,
            "mc_trials_per_s": res["trials_per_s"],
            "mc_fleet_trials_per_s": MC_FLEET_TRIALS / big_wall,
            "mc_block_ms": {k: v[0] for k, v in blocks.items()},
            "mc_block_bound_ms": {k: v[1] for k, v in blocks.items()}}


def timed(fn) -> tuple[object, float]:
    """(fn(), its device time in ms) for one run, by CUDA events."""
    out = []
    ms = event_ms(lambda: out.append(fn()), 1)
    return out[0], ms


def bit_equal(out, ref) -> bool:
    """Every output equal to the plain version's bit for bit, NaN for NaN
    (±inf and NaN at the same places)."""
    import torch

    return all(torch.equal(torch.isnan(a), torch.isnan(b))
               and torch.equal(torch.nan_to_num(a, nan=0.0),
                               torch.nan_to_num(b, nan=0.0))
               for a, b in zip(out, ref))


def phase_d(dev) -> dict:
    """`thermal_conv`: kernel vs plain version, then the full-width path."""
    import torch

    from repro_torch.core.coupling import (coupling_matrix,
                                           ponte_vecchio_gamma,
                                           row_normalise)
    from repro_torch.core.thermal import two_pole
    from repro_torch.kernels import ops
    from repro_torch.kernels.thermal_conv import (conv_tiles_per_block,
                                                  thermal_conv_cost,
                                                  thermal_conv_reference)

    poles = two_pole()
    gen = torch.Generator(device=dev).manual_seed(3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def power(t, n):              # bench_multitile's load: 80 + 40·U(0,1) W
        return 80.0 + 40.0 * torch.rand((t, n), generator=gen, device=dev)

    def gamma(g):
        return row_normalise(g).to(dev).contiguous()

    def dense(n):                 # a dense random Γ: the union is every column
        g = torch.rand((n, n), generator=gen, device=dev)
        return (g / g.sum(1, keepdim=True)).contiguous()

    conv = lambda p, g, s0=None: ops.thermal_conv(p, g, poles.decay,
                                                  poles.gain, s0)

    def tiles(n):                 # the kernel's tiles a block at n tiles
        tb = conv_tiles_per_block(n, sms)
        return f"{tb} tile" + ("s" if tb > 1 else "")

    def held(where, p, g, s0=None, finite=True):
        """One launch, bit-equal to the plain version; within 1e-5 of it
        (max_err, which refuses non-finite outputs) where ``finite``."""
        before = ops.thermal_conv.launches
        out = conv(p, g, s0)
        torch.cuda.synchronize()
        check(ops.thermal_conv.launches == before + 1,
              f"phase D {where}: {ops.thermal_conv.launches - before} "
              f"launches, want 1")
        ref = thermal_conv_reference(p, g, poles.decay, poles.gain, s0)
        e = max_err(out, ref, f"phase D {where}") if finite else 0.0
        check(bit_equal(out, ref), f"phase D {where}: not bit-equal to the "
              f"plain version")
        return out, e

    err = 0.0
    for where, t, g in (
            ("8 tiles x 4,000 (multi_tile_sim Γ)", 4000,
             gamma(coupling_matrix(8, cols=4))),
            ("47 tiles x 4,000 (Ponte-Vecchio Γ)", 4000,
             gamma(ponte_vecchio_gamma())),
            ("ragged 100 tiles x 777", 777, gamma(coupling_matrix(100))),
            ("512 tiles x 1,000 (bench_multitile)", 1000,
             gamma(coupling_matrix(512))),
            ("dense random Γ, 100 tiles x 1,000", 1000, dense(100)),
            ("dense random Γ, 2,048 tiles x 100", 100, dense(2048))):
        _, e = held(where, power(t, g.shape[0]), g)
        err = max(err, e)
        print(f"[phaseD] {where} ({tiles(g.shape[0])} a block): "
              f"max_abs_err vs plain {e:.3e}, bit-exact True, 1 launch")
    # non-finite power: NaN and ±inf where the plain version's dense
    # product has them, in rows whose Γ is zero at the column too
    for where, g in (("47 tiles (Ponte-Vecchio Γ)", gamma(ponte_vecchio_gamma())),
                     ("512 tiles", gamma(coupling_matrix(512)))):
        n = g.shape[0]
        p = power(2000, n)
        p[300:340, n // 3] = float("nan")
        p[900, 5] = float("inf")
        p[901, n - 2] = -float("inf")
        p[1500:1502, 0] = float("inf")
        out, _ = held(f"non-finite power, {where}", p, g, finite=False)
        print(f"[phaseD] non-finite power (NaN / +inf / -inf spans), "
              f"{where} x 2,000: bit-equal to the plain version NaN for NaN; "
              f"{int(torch.isnan(out[0]).sum())} NaN and "
              f"{int(torch.isinf(out[0]).sum())} inf of {out[0].numel()} ΔT")
    g47 = gamma(ponte_vecchio_gamma())
    p = power(2000, 47)
    full = conv(p, g47)
    first = conv(p[:977].contiguous(), g47)
    second = conv(p[977:].contiguous(), g47, first[1])
    chained = (torch.cat([first[0], second[0]]), second[1])
    e = max_err(chained, full, "phase D chained halves")
    check(bit_equal(chained, full), "phase D chained halves: not bit-equal "
          "to one run")
    err = max(err, e)
    print(f"[phaseD] two chained halves (977 + 1,023 steps) vs one run: "
          f"bit-exact True")

    # the main path at full width, through the public entry point
    n, t = THERMAL_FULL
    g, p = gamma(coupling_matrix(n)), power(t, n)
    torch.cuda.synchronize()
    ops.thermal_conv.launches = 0
    dts, state = conv(p, g)
    torch.cuda.synchronize()
    launches = ops.thermal_conv.launches
    check(launches == 1, f"the thermal_conv main path launched the kernel "
          f"{launches} times, want 1")
    check(tuple(dts.shape) == (t, n) and bool(torch.isfinite(dts).all()),
          f"thermal_conv main path: dts {tuple(dts.shape)} not finite")
    ref, plain_ms = timed(lambda: thermal_conv_reference(
        p, g, poles.decay, poles.gain))
    e = max_err((dts, state), ref, "phase D main path")
    check(bit_equal((dts, state), ref), "phase D main path: not bit-equal "
          "to the plain version")
    err = max(err, e)
    kernel_ms = event_ms(lambda: conv(p, g), 10)
    matmul_ms = event_ms(lambda: torch.matmul(p, g.T), 10)
    cost = thermal_conv_cost(p, g, 2)
    bound_ms, bound_by = bound(cost["bytes"], cost["ops_nnz"])
    dense_ms, dense_by = bound(cost["bytes"], cost["ops_dense"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    clock_mhz = float(smi.stdout.split()[0])
    # the pole chain: one dependent f32 multiply and one add a step
    floor_ms = t * 2 * FP32_LATENCY_CYCLES / (clock_mhz * 1e3)
    print(f"[phaseD] thermal_conv [{t}, {n}] main path (ops.thermal_conv, "
          f"{tiles(n)} a block): {launches} "
          f"launch, max_abs_err vs plain {e:.3e}, bit-exact True; kernel "
          f"{kernel_ms:.4f} ms (median of 10, CUDA events; {THERMAL_PREV_MS} "
          f"ms before its redesign, "
          f"{kernel_ms * clock_mhz * 1e3 / t:.1f} cycles per step at "
          f"{clock_mhz:.0f} MHz), plain {plain_ms:.1f} ms (one run); "
          f"roofline bound {bound_ms:.4f} ms by {bound_by} "
          f"({cost['bytes'] / 1e6:.1f} MB, {cost['ops_nnz'] / 1e9:.3f} GFLOP "
          f"counting Γ's {int((g != 0).sum())} non-zeros; dense "
          f"{cost['ops_dense'] / 1e9:.3f} GFLOP, {dense_ms:.4f} ms by "
          f"{dense_by}); dependence floor, an estimate from assumed "
          f"latencies (not measured): {floor_ms:.3f} ms ({t} steps x "
          f"{2 * FP32_LATENCY_CYCLES} cycles at {clock_mhz:.0f} MHz); for "
          f"information, torch.matmul of Γ·P alone {matmul_ms:.3f} ms "
          f"(allow_tf32={torch.backends.cuda.matmul.allow_tf32}); "
          f"thermal_conv.cu (nvcc -Xptxas -v, the main path's kernel): "
          f"{registers('thermal_conv', 'ILi2ELi4E')}")
    # the same length at the 47-tile Ponte-Vecchio grid (1 tile a block)
    p47 = power(t, 47)
    out47 = conv(p47, g47)
    check(bit_equal(out47, thermal_conv_reference(p47, g47, poles.decay,
                                                  poles.gain)),
          "phase D [90,000, 47]: not bit-equal to the plain version")
    ms47 = event_ms(lambda: conv(p47, g47), 10)
    b47, by47 = bound(*(lambda c: (c["bytes"], c["ops_nnz"]))(
        thermal_conv_cost(p47, g47, 2)))
    print(f"[phaseD] thermal_conv [{t}, 47] (Ponte-Vecchio Γ, "
          f"{tiles(47)} a block): kernel "
          f"{ms47:.4f} ms (median of 10, CUDA events), bit-exact True; "
          f"roofline bound {b47:.4f} ms by {by47}; dependence-floor "
          f"estimate {floor_ms:.3f} ms")
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

    def simulate(plant, p, s0, where):
        """One trace on the kernel: exactly one launch."""
        before = tc.grid_conv.launches
        out = plant.simulate(p, s0)
        torch.cuda.synchronize()
        check(tc.grid_conv.launches == before + 1,
              f"phase E {where}: {tc.grid_conv.launches - before} launches")
        return out

    def state_exact(out, ref, where):
        check(torch.equal(out[1], ref[1]), f"phase E {where}: final state "
              f"not bit-exact ({float((out[1] - ref[1]).abs().max()):.3e})")
        return True

    err = 0.0
    for nt in (1, 2, 47):
        for sub in (1, 2):
            for contrast in (0.0, 0.5):
                plant = GridPlant(SchedulerConfig(
                    n_tiles=nt, plant="grid", grid_substeps=sub,
                    grid_contrast=contrast), FINGERPRINT, device=dev)
                p = power(2000, nt)
                s0 = plant.init_state(())
                where = (f"{nt} tiles, substeps {sub}, contrast {contrast}")
                out = simulate(plant, p, s0, where)
                ref = plain(plant, p, s0)
                e = max_err(out, ref, f"phase E {where}")
                err = max(err, e)
                print(f"[phaseE] {where}, T=2000: max_abs_err vs plain "
                      f"{e:.3e}, state bit-exact "
                      f"{state_exact(out, ref, where)}, 1 launch")

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
        where = f"grid_cells {cells}"
        out = simulate(plant, p, s0, where)
        ref = plain(plant, p, s0)
        e = max_err(out, ref, f"phase E {where}")
        err = max(err, e)
        print(f"[phaseE] grid_cells {cells} (5 tiles, T=300): max_abs_err "
              f"vs plain {e:.3e}, state bit-exact "
              f"{state_exact(out, ref, where)}, 1 launch")

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
    check(launches == 1, f"the grid_conv main path launched the kernel "
          f"{launches} times, want 1")
    check(tuple(state.shape) == (plant.gy, plant.W)
          and bool(torch.isfinite(dts).all()),
          f"grid_conv main path: state {tuple(state.shape)}, dts finite "
          f"{bool(torch.isfinite(dts).all())}")
    ref, plain_ms = timed(lambda: plain(plant, p, plant.init_state(())))
    e = max_err((dts, state), ref, "phase E main path")
    state_exact((dts, state), ref, "main path")
    err = max(err, e)
    kernel_ms = event_ms(lambda: plant.simulate(p), 10)
    cost = tc.grid_conv_cost(t, nt, plant.gy, plant.gx, plant.substeps)
    bound_ms, bound_by = bound(cost["bytes"], cost["ops"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    clock_mhz = float(smi.stdout.split()[0])
    chain = SHFL_LATENCY_CYCLES + GRID_CHAIN_FP32_OPS * FP32_LATENCY_CYCLES
    floor_ms = t * plant.substeps * chain / (clock_mhz * 1e3)
    print(f"[phaseE] grid_conv [{t}, {nt}] state [{plant.gy}, {plant.W}] "
          f"main path (GridPlant.simulate): {launches} launch(es), "
          f"max_abs_err vs plain {e:.3e}, state bit-exact "
          f"{torch.equal(state, ref[1])}; kernel {kernel_ms:.4f} ms (median "
          f"of 10, CUDA events; {GRID_PREV_MS} ms before its redesign, "
          f"{kernel_ms * clock_mhz * 1e3 / (t * plant.substeps):.1f} cycles "
          f"per substep at {clock_mhz:.0f} MHz), plain {plain_ms:.1f} ms "
          f"(one run); "
          f"roofline bound {bound_ms:.5f} ms by {bound_by} "
          f"({cost['bytes'] / 1e6:.2f} MB, {cost['ops'] / 1e9:.3f} GFLOP); "
          f"dependence floor, an estimate from assumed latencies (not "
          f"measured): {floor_ms:.3f} ms ({t} steps x {chain} cycles at "
          f"{clock_mhz:.0f} MHz); grid_conv.cu (nvcc -Xptxas -v, the "
          f"{plant.gy}-cell kernel): "
          f"{registers('grid_conv', f'ILi{plant.gy}E')}")

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

def phase_g(dev) -> tuple[dict, dict]:
    """`flash_attention` (both routes) and `ssd`: kernel vs plain version,
    then timed at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as sm

    gen = torch.Generator(device=dev).manual_seed(13)
    bf16, f32 = torch.bfloat16, torch.float32
    # the reference's bounds (tests/test_kernels.py); a bf16 output is also
    # allowed one bf16 rounding step of its f32 value (rtol 2^-7), since
    # kernel and plain version may round a value on either side of a tie
    flash_tol = {f32: dict(atol=2e-5), bf16: dict(atol=2e-2)}
    BF16_STEP = 2.0 ** -7

    def qkv(B, Tq, Tk, H, KV, d, dtype, kv_dtype=None):
        r = lambda dt, *s: torch.randn(s, generator=gen, device=dev).to(dt)
        kv_dtype = kv_dtype or dtype
        return (r(dtype, B, Tq, H, d), r(kv_dtype, B, Tk, KV, d),
                r(kv_dtype, B, Tk, KV, d))

    def flash_check(q, k, v, what, causal=True, w=0, off=0):
        """One launch against the plain version; returns (error, route)."""
        route = fa.flash_route("cuda", q.dtype, k.dtype, q.shape[-1],
                               v.shape[-1])
        before = dict(fa.flash_attention.launches_by_route)
        out = fa.flash_attention(q, k, v, causal=causal, window=w,
                                 q_offset=off)
        torch.cuda.synchronize()
        check(fa.flash_attention.launches_by_route[route]
              == before[route] + 1, f"phase G flash {what}: not launched on "
              f"the {route} route")
        ref = fa.flash_attention_reference(q, k, v, causal=causal, window=w,
                                           q_offset=off)
        e = max_err((out,), (ref,), f"phase G flash {what} {q.dtype}",
                    rtol=0.0, **flash_tol[out.dtype])
        print(f"[phaseG] flash_attention {what} q {list(q.shape)} kv "
              f"[{k.shape[1]}, {k.shape[2]}] {q.dtype}/{k.dtype} causal "
              f"{causal} window {w} q_offset {off}: {route} route, "
              f"max_abs_err vs plain {e:.3e}")
        return e, route

    f_err = {"tensor_core": 0.0, "cuda_core": 0.0}
    cases = [  # (B, Tq, Tk, H, KV, d, causal, window, q_offset, what)
        (2, 256, 256, 4, 2, 64, True, 0, 0, "sweep"),
        (1, 256, 256, 8, 1, 128, True, 0, 0, "sweep MQA"),
        (2, 512, 512, 4, 4, 64, True, 128, 0, "sweep window 128"),
        (1, 128, 128, 2, 2, 256, True, 0, 0, "sweep head_dim 256"),
        *((B, T, T, H, KV, d, True, 0, 0, f"{arch} prefill")
          for arch, (B, T, H, KV, d) in FLASH_MAIN.items()),
        (2, 1000, 1000, 4, 2, 112, True, 0, 0, "ragged T=1000"),
        (2, 1000, 1000, 4, 2, 112, True, 128, 0, "ragged, window 128"),
        (2, 512, 1024, 4, 2, 64, True, 0, 512, "q_offset 512"),
        (1, 64, 200, 2, 1, 32, True, 8, 300, "window empties every row"),
        # the tensor-core route's head dims, MHA / GQA / MQA, its edges
        (1, 300, 300, 6, 6, 64, True, 0, 0, "MHA d 64 ragged"),
        (2, 200, 333, 6, 3, 112, True, 48, 133, "GQA d 112 window q_offset"),
        (1, 190, 190, 8, 1, 128, False, 0, 0, "MQA d 128 not causal"),
        (2, 130, 257, 4, 2, 256, True, 0, 127, "GQA d 256 ragged q_offset"),
        (1, 64, 200, 3, 1, 112, True, 8, 300, "MQA d 112 window empties rows"),
        (1, 97, 97, 5, 5, 256, True, 16, 0, "MHA d 256 window, odd heads")]
    for B, Tq, Tk, H, KV, d, causal, w, off, what in cases:
        for dtype in (f32, bf16):
            e, route = flash_check(*qkv(B, Tq, Tk, H, KV, d, dtype), what,
                                   causal, w, off)
            want = ("tensor_core" if dtype == bf16 and d in fa.TC_HEAD_DIMS
                    else "cuda_core")
            check(route == want, f"phase G flash {what} {dtype}: route "
                  f"{route}, want {want}")
            f_err[route] = max(f_err[route], e)
    # mixed types take the CUDA-core kernel
    e, route = flash_check(*qkv(1, 128, 128, 4, 2, 112, f32, bf16),
                           "mixed q f32, k/v bf16")
    check(route == "cuda_core", f"phase G flash mixed types: route {route}")
    f_err["cuda_core"] = max(f_err["cuda_core"], e)

    def flash_times(B, T, H, KV, d):
        q, k, v = qkv(B, T, T, H, KV, d, bf16)
        ms = event_ms(lambda: fa.flash_attention(q, k, v), 10)
        q32, k32, v32 = q.float(), k.float(), v.float()
        ms_f32 = event_ms(lambda: fa.flash_attention(q32, k32, v32), 3)
        plain = timed(lambda: fa.flash_attention_reference(q, k, v))[1]
        # the yardstick: one PyTorch call for the same function, its KV
        # heads repeated and heads moved to dim 1 outside the timed call
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (x.repeat_interleave(H // KV, dim=2).transpose(1, 2)
                  .contiguous() for x in (k, v))
        lib = event_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 10)
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        e = max_err((lib_out.transpose(1, 2),), (fa.flash_attention(q, k, v),),
                    f"SDPA vs kernel [{B}, {T}, {H}, {d}]", rtol=0.0,
                    atol=2e-2)
        cost = fa.flash_attention_cost(q, k, v)
        b_ms, b_by = bound(cost["bytes"], cost["ops"], PEAK_BF16_PER_S)
        print(f"[phaseG] flash_attention [{B}, {T}, {H} on {KV}, {d}] bf16 "
              f"causal: tensor-core kernel {ms:.4f} ms (median of 10, CUDA "
              f"events; {FLASH_FIRST_MS[(H, d)]} ms for its first, CUDA-core "
              f"version), the CUDA-core kernel on the same values in f32 "
              f"{ms_f32:.3f} ms, plain {plain:.1f} ms (one run), "
              f"scaled_dot_product_attention {lib:.4f} ms (|Δ| {e:.2e} vs "
              f"the kernel); bound {b_ms:.4f} ms by {b_by} "
              f"({cost['bytes'] / 1e6:.1f} MB, {cost['ops'] / 1e9:.2f} GFLOP "
              f"over {cost['pairs']} kept pairs per head, at the bf16 peak)")
        return ms, plain, lib, b_ms, b_by, ms_f32

    z = flash_times(*FLASH_MAIN["zamba2-7b"])
    g = flash_times(*FLASH_MAIN["gemma-2b"])
    fa_entry = {"name": "flash_attention", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
                "replaces": "src/repro/kernels/flash_attention.py:94",
                "launches": None, "max_abs_err": f_err["tensor_core"],
                "ms": z[0], "plain_ms": z[1], "bound_ms": z[3],
                "bound_by": z[4], "library_ms": z[2],
                "shape": f"zamba2-7b {list(FLASH_MAIN['zamba2-7b'])}",
                "ms_gemma": g[0], "plain_ms_gemma": g[1],
                "bound_ms_gemma": g[3], "library_ms_gemma": g[2],
                "cuda_core_source":
                    "src/repro_torch/kernels/csrc/flash_attention.cu",
                "cuda_core_max_abs_err": f_err["cuda_core"],
                "cuda_core_ms_f32": z[5], "cuda_core_ms_f32_gemma": g[5]}

    def ssd_in(B, T, H, N, P, dec_min, dtypes=(f32,) * 4):
        r = lambda *s: torch.randn(s, generator=gen, device=dev)
        d = dec_min + (0.999 - dec_min) * torch.rand(
            (B, T, H, N), generator=gen, device=dev)
        return [t.to(dt) for t, dt in zip(
            (d, 0.2 * r(B, T, H, N), r(B, T, H, P), 0.2 * r(B, T, H, N)),
            dtypes)]

    mixed = (f32, f32, bf16, bf16)         # Mamba2 at bf16: c and x in bf16
    s_err = 0.0
    for B, T, H, N, P, dec_min, inc, use_u, use_h0, dts in (
            (2, 128, 2, 64, 64, 0.90, True, False, False, None),  # mamba2
            (1, 256, 4, 32, 64, 0.80, False, True, False, None),  # rwkv, u
            (2, 128, 2, 16, 32, 0.95, False, True, True, None),
            (1, 64, 2, 64, 128, 0.70, True, False, True, None),   # strong
            (2, 1000, 3, 64, 64, 0.90, True, False, True, None),  # chunk 8
            (1, 7, 2, 6, 6, 0.90, True, True, True, None),        # odd rows
            (1, 96, 3, 20, 36, 0.90, False, True, True, mixed),
            (2, 128, 2, 64, 64, 0.90, True, False, True, mixed),
            (1, 64, 2, 64, 128, 0.70, True, True, True, mixed)):
        d, b, x, c = ssd_in(B, T, H, N, P, dec_min, dts or (f32,) * 4)
        u = (0.1 * torch.randn((H, N), generator=gen, device=dev)
             if use_u else None)
        h0 = (torch.randn((B, H, N, P), generator=gen, device=dev)
              if use_h0 else None)
        out = sm.ssd(d, b, x, c, u=u, h0=h0, include_current=inc)
        torch.cuda.synchronize()
        ref = sm.ssd_reference(d, b, x, c, u=u, h0=h0,
                               chunk=sm.chunk_for(T, 64),
                               include_current=inc)
        where = (f"ssd [{B}, {T}, {H}, {N}/{P}] decay >= {dec_min} "
                 f"include_current {inc} u {use_u} h0 {use_h0} "
                 f"{'c, x bf16' if dts else 'f32'}")
        e = max(max_err(out[:1], ref[:1], f"phase G {where} y", rtol=(
                    BF16_STEP if dts else 0.0), atol=3e-5),
                max_err(out[1:], ref[1:], f"phase G {where} hT", rtol=0.0,
                        atol=3e-5))
        s_err = max(s_err, e)
        print(f"[phaseG] {where}: max_abs_err vs plain {e:.3e}, bit-exact "
              f"{all(torch.equal(a, b) for a, b in zip(out, ref))}")
    d, b, x, c = ssd_in(2, 512, 4, 64, 64, 0.85)
    y, h = sm.ssd(d, b, x, c)
    ya, ha = sm.ssd(*(t[:, :192].contiguous() for t in (d, b, x, c)))
    yb, hb = sm.ssd(*(t[:, 192:].contiguous() for t in (d, b, x, c)), h0=ha)
    e = max_err((torch.cat([ya, yb], 1), hb), (y, h),
                "phase G ssd chained halves", rtol=0.0, atol=3e-5)
    s_err = max(s_err, e)
    print(f"[phaseG] ssd two chained halves (192 + 320 steps) vs one run: "
          f"max_abs_err {e:.3e}")

    # Zamba2-7B's prefill shape: f32 d and b, bf16 c and x, y in bf16
    zd, zb, zx, zc = ssd_in(*SSD_MAIN, 0.9, mixed)
    out = sm.ssd(zd, zb, zx, zc)
    torch.cuda.synchronize()
    ref, plain_ms = timed(lambda: sm.ssd_reference(zd, zb, zx, zc))
    e = max(max_err(out[:1], ref[:1], "phase G ssd Zamba2-7B y",
                    rtol=BF16_STEP, atol=3e-5),
            max_err(out[1:], ref[1:], "phase G ssd Zamba2-7B hT", rtol=0.0,
                    atol=3e-5))
    s_err = max(s_err, e)
    ms = event_ms(lambda: sm.ssd(zd, zb, zx, zc), 10)
    cost = sm.ssd_cost(zd, zb, zx, zc)
    b_ms, b_by = bound(cost["bytes"], cost["ops"], PEAK_BF16_PER_S)
    print(f"[phaseG] ssd Zamba2-7B prefill {list(SSD_MAIN)} (d, b f32; "
          f"c, x bf16): max_abs_err vs plain {e:.3e} (y within one bf16 "
          f"step); kernel {ms:.4f} ms (median of 10, CUDA events; "
          f"{SSD_FIRST_MS} ms for its first, unpipelined version), plain "
          f"{plain_ms:.1f} ms "
          f"(one run); bound {b_ms:.4f} ms by {b_by} "
          f"({cost['bytes'] / 1e6:.1f} MB, {cost['ops'] / 1e9:.2f} GFLOP at "
          f"the bf16 peak; {cost['ops'] / PEAK_F32_PER_S * 1e3:.3f} ms at "
          f"the f32 peak)")
    ssd_entry = {"name": "ssd", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/ssd.cu",
                 "replaces": "src/repro/kernels/ssm_scan.py:94",
                 "launches": None, "max_abs_err": s_err, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": None,
                 "shape": f"zamba2-7b {list(SSD_MAIN)}"}
    return fa_entry, ssd_entry


# the profiler's kernel groups: the port's kernels by the names their
# sources give them (flash: both routes), then the library GEMMs
PROFILE_GROUPS = (("flash_attention", ("flash_tc_kernel", "flash_kernel")),
                  ("ssd", ("ssd_kernel",)),
                  ("GEMM", ("gemm", "cutlass", "xmma", "nvjet", "sm90_")))


def profile_serving(dev, cfg, launches: dict, argv=SERVE_ARGV,
                    tag: str = "phaseH") -> None:
    """Where one full-width bf16 prefill and one decode step of ``cfg``
    spend the card's time (``argv``'s batch, prompt and gen): device time
    by kernel group (torch.profiler, CUDA activity) against the host clock
    around each, and the device's idle share in between.  The profiler's
    own host cost is in the host clock.  Each port kernel's group must hold
    exactly ``launches[group]`` kernel runs in the prefill and none in the
    decode step, so a kernel the groups do not name cannot land in another
    group unseen."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as tf

    arg = lambda k: int(argv[argv.index(k) + 1])
    batch, plen, gen = arg("--batch"), arg("--prompt-len"), arg("--gen")
    arch = cfg.name
    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    toks = torch.randint(2, cfg.vocab_size, (batch, plen), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    prefill, decode = S.make_prefill_step(cfg, plen + gen), \
        S.make_decode_step(cfg)
    last, cache = prefill(params, toks)                      # warm-up
    tok = torch.argmax(last, -1)
    decode(params, cache, tok, plen)
    torch.cuda.synchronize()
    groups = PROFILE_GROUPS
    for what, fn in (("prefill", lambda: prefill(params, toks)),
                     ("decode step", lambda: decode(params, cache, tok,
                                                    plen + 1))):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        by = {g: 0.0 for g, _ in groups} | {"other": 0.0}
        runs = {g: 0 for g, _ in groups} | {"other": 0}
        other, activities = {}, 0
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ms = e.self_device_time_total / 1e3
            activities += e.count
            g = next((g for g, keys in groups
                      if any(k in e.key.lower() for k in keys)), "other")
            by[g] += ms
            runs[g] += e.count
            if g == "other":
                other[e.key[:60]] = other.get(e.key[:60], 0.0) + ms
        busy = sum(by.values())
        for g, n in launches.items():
            want = n if what == "prefill" else 0
            check(busy == 0.0 or runs[g] == want,
                  f"profile {arch} {what}: {runs[g]} {g} kernel runs, want "
                  f"{want}")
        if busy == 0.0:
            print(f"[{tag}] {arch} {what}: the profiler recorded no device "
                  f"time (breakdown not measured); host clock {wall:.1f} ms")
            continue
        top = sorted(other.items(), key=lambda kv: -kv[1])[:4]
        print(f"[{tag}] {arch} {what} ({cfg.n_layers} layers, bf16, batch "
              f"{batch}, prompt "
              f"{plen}; torch.profiler): host clock {wall:.2f} ms, device "
              f"busy {busy:.2f} ms (idle share {1 - busy / wall:.3f}) in "
              f"{activities} device activities; by group (ms): "
              + json.dumps({g: round(v, 3) for g, v in by.items()})
              + "; largest other: " + json.dumps(
                  {k: round(v, 3) for k, v in top}))
    del params, cache
    torch.cuda.empty_cache()


@contextlib.contextmanager
def plain_versions(ssd_chunk: int | None = None):
    """The models' kernel entries (`kernels.ops`) swapped for the plain
    versions; ``ssd_chunk`` replaces the chunk each ssd call asks for (1:
    the step recurrence)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_scan as sm

    saved = ops.flash_attention, ops.ssd

    def plain_ssd(d, b, x, c, *, u=None, h0=None, chunk=64,
                  include_current=True):
        return sm.ssd_reference(d, b, x, c, u=u, h0=h0,
                                chunk=sm.chunk_for(d.shape[1],
                                                   ssd_chunk or chunk),
                                include_current=include_current)
    ops.flash_attention, ops.ssd = fa.flash_attention_reference, plain_ssd
    try:
        yield
    finally:
        ops.flash_attention, ops.ssd = saved


def kernels_vs_plain(prefill, what: str, bound: float = 1e-4) -> float:
    """``prefill()`` (→ (logits, cache)) on the kernels against the same
    call on the plain versions: logits and every cache leaf within
    ``bound`` of the leaf's largest magnitude; the plain run must launch
    no kernel.  Returns the worst relative difference."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as sm

    last, cache = prefill()
    before = (fa.flash_attention.launches, sm.ssd.launches)
    with plain_versions():
        last_p, cache_p = prefill()
    check((fa.flash_attention.launches, sm.ssd.launches) == before,
          f"{what}: the plain-version prefill launched a kernel")
    worst = 0.0
    for name, a, b in [("logits", last, last_p)] + [
            (k, cache[k], cache_p[k]) for k in cache_p]:
        a, b = a.float(), b.float()
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        check(np.isfinite(rel) and rel <= bound,
              f"{what}: {name} on the kernels vs the plain versions differs "
              f"by {rel:.3e} of its largest magnitude")
        worst = max(worst, rel)
    return worst


def phase_h(dev, fa_entry: dict, ssd_entry: dict) -> None:
    """The serving slice at full width, then full-width correctness inside
    the port (no JAX on the card)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as sm
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    waves = int(SERVE_ARGV[SERVE_ARGV.index("--waves") + 1])
    gen = int(SERVE_ARGV[SERVE_ARGV.index("--gen") + 1])
    flash_per_prefill = {"zamba2-7b": 13, "gemma-2b": 18}
    ssd_per_prefill = {"zamba2-7b": 81, "gemma-2b": 0}
    total = {"flash": 0, "ssd": 0}
    for arch in ("zamba2-7b", "gemma-2b"):
        torch.cuda.synchronize()
        fa.reset_launches()
        sm.ssd.launches = 0
        t0 = time.perf_counter()
        res = serve.main(["--arch", arch, *SERVE_ARGV])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        nf, ns = fa.flash_attention.launches, sm.ssd.launches
        total["flash"] += nf
        total["ssd"] += ns
        check(nf == flash_per_prefill[arch] * waves,
              f"serve {arch}: {nf} flash launches in {waves} waves, want "
              f"{flash_per_prefill[arch]} per prefill and none in decode")
        routes = fa.flash_attention.launches_by_route
        check(routes["tensor_core"] == nf and routes["cuda_core"] == 0,
              f"serve {arch}: flash launches by route {routes}, want every "
              f"bf16 launch on the tensor-core route")
        check(ns == ssd_per_prefill[arch] * waves,
              f"serve {arch}: {ns} ssd launches in {waves} waves, want "
              f"{ssd_per_prefill[arch]} per prefill and none in decode")
        check(np.isfinite(res["p50"]) and np.isfinite(res["p99"])
              and len(res["admitted"]) == waves
              and all(np.isfinite(v) for d in res["fleet"]
                      for v in d.values()),
              f"serve {arch}: result not finite: {res}")
        print(f"[phaseH] serve --arch {arch} {' '.join(SERVE_ARGV)} (bf16, "
              f"full width): "
              f"prefill ms per wave {json.dumps(res['prefill_ms'])}, decode "
              f"p50 {res['p50'] * 1e3:.3f} ms p99 {res['p99'] * 1e3:.3f} ms "
              f"per token (host clock after a synchronize), admissions "
              f"{res['admitted']}; launches {nf} flash_attention (all on the "
              f"tensor-core route) + {ns} ssd "
              f"= {flash_per_prefill[arch]} + {ssd_per_prefill[arch]} per "
              f"prefill, 0 in {waves * gen} decode steps; {wall:.1f} s with "
              f"the weights' draw")
        torch.cuda.empty_cache()
    fa_entry["launches"], ssd_entry["launches"] = total["flash"], total["ssd"]
    for arch in ("zamba2-7b", "gemma-2b"):
        profile_serving(dev, get_arch(arch),
                        {"flash_attention": flash_per_prefill[arch],
                         "ssd": ssd_per_prefill[arch]})

    # full-width correctness: Zamba2-7B in f32 (~26.6 GB of weights)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("zamba2-7b"), dtype="float32")
    params = tf.init_params(torch.Generator(device=dev).manual_seed(1), cfg)
    batch, plen = F32_CHECK
    toks = torch.randint(2, cfg.vocab_size, (batch, plen + 1), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    full, _ = tf.forward(params, cfg, toks)
    last, cache, pos = tf.prefill(params, cfg, toks[:, :plen], plen + 32)
    lg, _ = tf.decode_step(params, cfg, cache, toks[:, plen], pos)
    scale = float(full[:, -1].abs().max())
    err = float((lg - full[:, -1]).abs().max())
    check(np.isfinite(err) and err <= 2e-4 * scale,
          f"Zamba2-7B f32: decode at {plen} vs forward {err:.3e} > 2e-4 x "
          f"{scale:.3f}")
    print(f"[phaseH] Zamba2-7B f32 (batch {batch}, prompt {plen}): decode "
          f"at position {plen} vs the full forward's last logits max |Δ| "
          f"{err:.3e} (bound 2e-4 x max|logit| = {2e-4 * scale:.3e})")

    worst = kernels_vs_plain(
        lambda: tf.prefill(params, cfg, toks[:, :plen], plen + 32)[:2],
        "Zamba2-7B f32 prefill")
    print(f"[phaseH] Zamba2-7B f32 prefill on the kernels vs on the plain "
          f"versions: logits and every cache leaf within {worst:.3e} of "
          f"their largest magnitude (bound 1e-4)")
    del params, cache
    torch.cuda.empty_cache()


# Phase K: this slice's kernel shapes — flash on the CUDA-core route at
# DeepSeek-V2's MLA prefill (B, T, H, d, dv; --batch 2 --prompt-len 1024);
# flash on the tensor-core route at the serve shapes no other phase holds
# (B, T, H, KV, d, window): musicgen-large's and chameleon-34b's prefill at
# SERVE_ARGV's batch and prompt, and Mixtral's windowed one (--batch 2
# --prompt-len 4608); ssd at RWKV6's (B, T, H, N, P; SERVE_ARGV's batch and
# prompt)
MLA_FLASH = (2, 1024, 128, 192, 128)
TC_FLASH = {"musicgen-large": (8, 1024, 32, 32, 64, 0),
            "chameleon-34b": (8, 1024, 64, 8, 128, 0),
            "mixtral-8x7b": (2, 4608, 32, 8, 128, 4096)}
RWKV_SSD = (8, 1024, 32, 64, 64)
# the serving runs: (arch, layers kept — None for the published depth —,
# argv after SERVE_ARGV, flash launches per prefill and their route, ssd
# launches per prefill).  Cuts: chameleon-34b's 48 layers are ~68.6 GB of
# bf16 weights on an 80 GB card; mixtral-8x7b's 46.7 B parameters are
# ~93 GB in bf16; one deepseek-v2-236b layer is ~8.1 GB in bf16, and its
# routed experts take up to 15 GB more as f32 while a layer runs.
K_SERVE = (
    ("rwkv6-1.6b", None, [], 0, None, 24),
    ("musicgen-large", None, [], 48, "tensor_core", 0),
    ("chameleon-34b", 24, [], 24, "tensor_core", 0),
    ("mixtral-8x7b", 8, ["--batch", "2", "--prompt-len", "4608", "--gen",
                         "32"], 8, "tensor_core", 0),
    ("deepseek-v2-236b", 4, ["--batch", "2", "--prompt-len", "1024",
                             "--gen", "16"], 4, "cuda_core", 0),
)
# the f32 checks: Mixtral's cut and prompt (past its 4,096-token window, so
# the ring wraps), DeepSeek-V2's cut and prompt
K_F32_MIXTRAL = (2, 4100)
K_F32_DEEPSEEK = (1, 128)


def serve_argv(extra=()) -> list:
    """SERVE_ARGV with the values of the flags in ``extra`` (flag, value,
    …) replaced by those."""
    argv = list(SERVE_ARGV)
    for flag, value in zip(extra[::2], extra[1::2]):
        argv[argv.index(flag) + 1] = value
    return argv


def phase_k(dev, fa_entry: dict, ssd_entry: dict) -> None:
    """Every model family of `configs` served on the card: the kernels at
    this slice's shapes against their plain versions, serving at full width
    in bf16 (depth cut where the weights do not fit), then full-width
    correctness inside the port in f32."""
    import dataclasses
    import math

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as sm
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(19)
    bf16, f32 = torch.bfloat16, torch.float32
    BF16_STEP = 2.0 ** -7
    r = lambda dt, *s: torch.randn(s, generator=gen, device=dev).to(dt)

    # ------------------------------------------------ (a) kernels vs plain
    def flash_k(what, q, k, v, want_route, atol, window=0, scale=None):
        route = fa.flash_route("cuda", q.dtype, k.dtype, q.shape[-1],
                               v.shape[-1])
        check(route == want_route, f"phase K flash {what}: route {route}, "
              f"want {want_route}")
        before = dict(fa.flash_attention.launches_by_route)
        out = fa.flash_attention(q, k, v, window=window, scale=scale)
        torch.cuda.synchronize()
        check(fa.flash_attention.launches_by_route[route]
              == before[route] + 1, f"phase K flash {what}: not launched on "
              f"the {route} route")
        ref, plain_ms = timed(lambda: fa.flash_attention_reference(
            q, k, v, window=window, scale=scale))
        e = max_err((out,), (ref,), f"phase K flash {what}", rtol=0.0,
                    atol=atol)
        return out, e, plain_ms

    def sdpa(q, k, v, **kw):
        """The yardstick: one PyTorch call, KV heads repeated and heads on
        dim 1 outside the timed call."""
        g = q.shape[2] // k.shape[2]
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (x.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
                  for x in (k, v))
        ms = event_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                             **kw), 10)
        return ms, F.scaled_dot_product_attention(qt, kt, vt, **kw
                                                  ).transpose(1, 2)

    # MLA: q/k head dim 192, v 128, the explicit scale, causal
    B, T, H, d, dv = MLA_FLASH
    mla_scale = d ** -0.5                 # (dh + rd) ** -0.5, dh 128, rd 64
    mla = {}
    for dt, atol in ((f32, 2e-5), (bf16, 2e-2)):
        q, k, v = r(dt, B, T, H, d), r(dt, B, T, H, d), r(dt, B, T, H, dv)
        out, e, plain_ms = flash_k(f"MLA {dt}", q, k, v, "cuda_core", atol,
                                   scale=mla_scale)
        mla[dt] = (q, k, v, out, e, plain_ms)
    q, k, v, out, e_mla, mla_plain = mla[bf16]
    mla_ms = event_ms(lambda: fa.flash_attention(q, k, v, scale=mla_scale),
                      10)
    mla_lib, lib_out = sdpa(q, k, v, is_causal=True, scale=mla_scale)
    d_lib = max_err((lib_out,), (out,), "phase K SDPA vs kernel (MLA)",
                    rtol=0.0, atol=2e-2)
    cost = fa.flash_attention_cost(q, k, v)
    mla_bound, mla_by = bound(cost["bytes"], cost["ops"], PEAK_BF16_PER_S)
    print(f"[phaseK] flash_attention MLA {list(MLA_FLASH)} (q/k 192, v 128, "
          f"scale 192^-0.5, causal) on the CUDA-core route: max_abs_err vs "
          f"plain {mla[f32][4]:.3e} in f32 (bound 2e-5), {e_mla:.3e} in "
          f"bf16 (bound 2e-2); bf16 kernel {mla_ms:.4f} ms (median of 10, "
          f"CUDA events), plain {mla_plain:.1f} ms (one run), "
          f"scaled_dot_product_attention {mla_lib:.4f} ms (|Δ| {d_lib:.2e} "
          f"vs the kernel); bound {mla_bound:.4f} ms by {mla_by} "
          f"({cost['bytes'] / 1e6:.1f} MB, {cost['ops'] / 1e9:.2f} GFLOP at "
          f"the bf16 peak)")
    del mla

    # the tensor-core route at each serve shape no other phase holds:
    # musicgen-large's and chameleon-34b's prefill, causal, and Mixtral's,
    # where the window of 4,096 masks keys of a 4,608 prompt
    tc = {}
    for arch, (B, T, H, KV, d, w) in TC_FLASH.items():
        q, k, v = (r(bf16, B, T, H, d), r(bf16, B, T, KV, d),
                   r(bf16, B, T, KV, d))
        what = f"{arch} window {w}" if w else arch
        out, e, plain_ms = flash_k(what, q, k, v, "tensor_core", 2e-2,
                                   window=w)
        ms = event_ms(lambda: fa.flash_attention(q, k, v, window=w), 10)
        cost = fa.flash_attention_cost(q, k, v, window=w)
        causal_pairs = T * (T + 1) // 2
        if w:
            check(cost["pairs"] < causal_pairs,
                  f"phase K {what}: the window masks no key")
            i = torch.arange(T, device=dev)
            keep = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
            lib, lib_out = sdpa(q, k, v, attn_mask=keep)
            how = (f"window {w} ({cost['pairs']} kept pairs per head of "
                   f"{causal_pairs} causal)")
            lib_how = ("with the window as a dense boolean [T, T] mask — "
                       "SDPA's masked path, which skips no key block —")
            del keep
        else:
            lib, lib_out = sdpa(q, k, v, is_causal=True)
            how, lib_how = "causal", "causal"
        d_lib = max_err((lib_out,), (out,), f"phase K SDPA vs kernel "
                        f"({what})", rtol=0.0, atol=2e-2)
        b_ms, b_by = bound(cost["bytes"], cost["ops"], PEAK_BF16_PER_S)
        print(f"[phaseK] flash_attention {arch} {[B, T, H, KV, d]} bf16, "
              f"{how} on the tensor-core route: max_abs_err vs plain "
              f"{e:.3e} (bound 2e-2); kernel {ms:.4f} ms (median of 10, "
              f"CUDA events), plain {plain_ms:.1f} ms (one run), "
              f"scaled_dot_product_attention {lib_how} {lib:.4f} ms (|Δ| "
              f"{d_lib:.2e} vs the kernel); bound {b_ms:.4f} ms by {b_by} "
              f"({cost['bytes'] / 1e6:.1f} MB, {cost['ops'] / 1e9:.2f} "
              f"GFLOP at the bf16 peak)")
        tc[arch] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        library_ms=lib, max_abs_err=e)
        del q, k, v, out, lib_out
    torch.cuda.empty_cache()

    # RWKV6's shape in two regimes.  The reference kernel test's rwkv
    # regime, for which its 3e-5 bound is set: decay U(0.8, 0.999) in f32,
    # k and r 0.2·N(0, 1).  The model's own scale: the decay
    # exp(-exp(w0 + tanh(x·w1)·w2)) of rwkv6_init's w0 = -4 and lora
    # weights on unit-RMS x, unit k and r — there y reaches ~10^2 and f32
    # rounding scales with it, so the bound is 1e-5 of max|y| (of max|hT|
    # for the state), and both kernel and plain version are also held to
    # the exact recurrence in f64.  v N(0, 1), the bonus u 0.1·N(0, 1), no
    # current token.
    B, T, H, N, P = RWKV_SSD
    D = H * N
    u = 0.1 * torch.randn((H, N), generator=gen, device=dev)
    vv = r(f32, B, T, H, P)
    lora = r(f32, B, T, D) @ (r(f32, D, 64) * D ** -0.5)
    regimes = {
        "rwkv regime": (0.8 + 0.199 * torch.rand((B, T, H, N), generator=gen,
                                                 device=dev),
                        0.2 * r(f32, B, T, H, N), 0.2 * r(f32, B, T, H, N)),
        "model scale": (torch.exp(-torch.exp(-4.0 + torch.tanh(lora) @ (
            r(f32, 64, D) * 64 ** -0.5))).reshape(B, T, H, N),
            r(f32, B, T, H, N), r(f32, B, T, H, N)),
    }
    del lora

    def exact(d, b, x, c):
        """The recurrence step by step in f64: y_t = c_t·(d_t⊙h_{t-1}) +
        (c_t·u·b_t) x_t, h_t = d_t⊙h_{t-1} + b_t⊗x_t."""
        d, b, x, c = (t.double() for t in (d, b, x, c))
        h = torch.zeros((B, H, N, P), dtype=torch.float64, device=dev)
        ys = []
        for t in range(T):
            h = d[:, t, ..., None] * h
            ys.append(torch.einsum("bhn,bhnp->bhp", c[:, t], h)
                      + torch.einsum("bhn,hn,bhn->bh", c[:, t], u.double(),
                                     b[:, t])[..., None] * x[:, t])
            h = h + b[:, t, ..., None] * x[:, t, :, None, :]
        return torch.stack(ys, 1), h

    s_err, s_model = 0.0, None
    for regime, (decay, kk, rr) in regimes.items():
        model = regime == "model scale"
        for what, dts in (("f32", (f32,) * 4), ("d f32, k v r bf16",
                                                (f32, bf16, bf16, bf16))):
            ins = [t.to(dt) for t, dt in zip((decay, kk, vv, rr), dts)]
            out = sm.ssd(*ins, u=u, include_current=False)
            torch.cuda.synchronize()
            ref, plain_ms = timed(lambda: sm.ssd_reference(
                *ins, u=u, chunk=sm.chunk_for(T, 64), include_current=False))
            y_max = float(ref[0].float().abs().max())
            h_max = float(ref[1].abs().max())
            ay, ah = ((1e-5 * y_max, 1e-5 * h_max) if model
                      else (3e-5, 3e-5))
            bf = dts[2] == bf16
            ey = max_err(out[:1], ref[:1], f"phase K ssd RWKV6 {regime} "
                         f"{what} y", rtol=BF16_STEP if bf else 0.0, atol=ay)
            eh = max_err(out[1:], ref[1:], f"phase K ssd RWKV6 {regime} "
                         f"{what} hT", rtol=0.0, atol=ah)
            if not model:
                s_err = max(s_err, ey, eh)
            elif not bf:
                s_model = (ey, y_max)
            step = " + one bf16 step" if bf else ""
            line = (f"[phaseK] ssd RWKV6 {list(RWKV_SSD)} {regime} ({what}, "
                    f"u, include_current False): max|y| {y_max:.3f}, "
                    f"max|hT| {h_max:.3f}; kernel vs plain max_abs_err y "
                    f"{ey:.3e} (bound {ay:.3e}{step}), hT {eh:.3e} (bound "
                    f"{ah:.3e})")
            if model and not bf:
                y64, h64 = exact(*ins)
                line += (f"; vs the f64 recurrence: kernel y "
                         f"{float((out[0].double() - y64).abs().max()):.3e} "
                         f"hT {float((out[1].double() - h64).abs().max()):.3e}"
                         f", plain y "
                         f"{float((ref[0].double() - y64).abs().max()):.3e} "
                         f"hT {float((ref[1].double() - h64).abs().max()):.3e}")
                del y64, h64
            print(line)
    rwkv_ms = event_ms(lambda: sm.ssd(*ins, u=u, include_current=False), 10)
    cost = sm.ssd_cost(*ins, u=u)
    rwkv_bound, rwkv_by = bound(cost["bytes"], cost["ops"], PEAK_BF16_PER_S)
    print(f"[phaseK] ssd RWKV6 {list(RWKV_SSD)} model scale (d f32; k, v, r "
          f"bf16): kernel {rwkv_ms:.4f} ms (median of 10, CUDA events), "
          f"plain {plain_ms:.1f} ms (one run); bound {rwkv_bound:.4f} ms by "
          f"{rwkv_by} ({cost['bytes'] / 1e6:.1f} MB, "
          f"{cost['ops'] / 1e9:.2f} GFLOP at the bf16 peak)")
    del regimes, decay, kk, vv, rr, ins, out, ref
    torch.cuda.empty_cache()

    # ------------------------------------------ (b) serving at full width
    waves = int(SERVE_ARGV[SERVE_ARGV.index("--waves") + 1])
    total = {"flash": 0, "ssd": 0, "cuda_core": 0}
    cut_cfgs = {}
    for arch, layers, extra, n_flash, route, n_ssd in K_SERVE:
        argv = ["--arch", arch, *serve_argv(extra)]
        torch.cuda.synchronize()
        fa.reset_launches()
        sm.ssd.launches = 0
        t0 = time.perf_counter()
        if layers is None:
            res = serve.main(argv)
            depth = f"all {get_arch(arch).n_layers} layers"
        else:
            args = serve.parse_args(argv)
            cfg, sched_cfg, rho = serve.wave_setup(args)
            cfg = cut_cfgs[arch] = dataclasses.replace(cfg, n_layers=layers)
            depth = (f"dataclasses.replace(cfg, n_layers={layers}) of "
                     f"{get_arch(arch).n_layers}, through serve._wave_loop")
            res = serve._wave_loop(args, cfg, sched_cfg, rho)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        nf, ns = fa.flash_attention.launches, sm.ssd.launches
        routes = dict(fa.flash_attention.launches_by_route)
        total["flash"] += nf
        total["ssd"] += ns
        total["cuda_core"] += routes["cuda_core"]
        check(nf == n_flash * waves and (route is None
                                         or routes[route] == nf),
              f"serve {arch}: flash launches {routes} in {waves} waves, "
              f"want {n_flash} per prefill on the {route} route and none "
              f"in decode")
        check(ns == n_ssd * waves,
              f"serve {arch}: {ns} ssd launches in {waves} waves, want "
              f"{n_ssd} per prefill and none in decode")
        check(np.isfinite(res["p50"]) and np.isfinite(res["p99"])
              and len(res["admitted"]) == waves
              and all(np.isfinite(v) for d in res["fleet"]
                      for v in d.values()),
              f"serve {arch}: result not finite: {res}")
        print(f"[phaseK] serve --arch {arch} {' '.join(argv[2:])} (bf16, "
              f"full width, {depth}): prefill ms per wave "
              f"{json.dumps(res['prefill_ms'])}, decode p50 "
              f"{res['p50'] * 1e3:.3f} ms p99 {res['p99'] * 1e3:.3f} ms per "
              f"token (host clock after a synchronize), admissions "
              f"{res['admitted']}; launches {nf} flash_attention "
              f"{json.dumps(routes)} + {ns} ssd = {n_flash} + {n_ssd} per "
              f"prefill, none in decode; {wall:.1f} s with the weights' "
              f"draw")
        del res
        torch.cuda.empty_cache()
    fa_entry["launches"] += total["flash"]
    ssd_entry["launches"] += total["ssd"]
    profile_serving(dev, get_arch("rwkv6-1.6b"),
                    {"flash_attention": 0, "ssd": 24}, tag="phaseK")
    profile_serving(dev, cut_cfgs["mixtral-8x7b"],
                    {"flash_attention": 8, "ssd": 0},
                    argv=serve_argv(K_SERVE[3][2]), tag="phaseK")
    torch.cuda.empty_cache()

    # -------------------------------- (c) full-width correctness in f32
    torch.backends.cuda.matmul.allow_tf32 = False

    def decode_gap(params, cfg, toks, plen):
        """Decode at position ``plen`` after a prefill of ``plen`` tokens
        against the full forward's last logits: (max|Δ|, those logits)."""
        full, _ = tf.forward(params, cfg, toks)
        want = full[:, -1]
        del full
        _, cache, pos = tf.prefill(params, cfg, toks[:, :plen], plen + 32)
        lg, _ = tf.decode_step(params, cfg, cache, toks[:, plen], pos)
        return float((lg - want).abs().max()), want

    def decode_vs_forward(cfg, batch, plen, what, seed):
        """decode_gap within 2e-4 × max|logit| on fresh weights and tokens.
        Returns (params, tokens, gap, max|logit|)."""
        params = tf.init_params(torch.Generator(device=dev).manual_seed(
            seed), cfg)
        toks = torch.randint(2, cfg.vocab_size, (batch, plen + 1),
                             device=dev, generator=torch.Generator(
                                 device=dev).manual_seed(seed + 1))
        err, want = decode_gap(params, cfg, toks, plen)
        scale = float(want.abs().max())
        check(np.isfinite(err) and err <= 2e-4 * scale,
              f"{what}: decode at {plen} vs forward {err:.3e} > 2e-4 x "
              f"{scale:.3f}")
        print(f"[phaseK] {what} (f32, batch {batch}, prompt {plen}): decode "
              f"at position {plen} vs the full forward's last logits max "
              f"|Δ| {err:.3e} (bound 2e-4 x max|logit| = "
              f"{2e-4 * scale:.3e})")
        return params, toks, err, scale

    batch, plen = F32_CHECK
    cfg = dataclasses.replace(get_arch("rwkv6-1.6b"), dtype="float32")
    params, toks, gap_k, scale = decode_vs_forward(cfg, batch, plen,
                                                   "RWKV6-1.6B", 3)
    prompt = toks[:, :plen]
    worst = kernels_vs_plain(
        lambda: tf.prefill(params, cfg, prompt, plen + 32)[:2],
        "RWKV6-1.6B f32 prefill")
    print(f"[phaseK] RWKV6-1.6B f32 prefill on the kernels vs on the plain "
          f"versions: logits and every cache leaf within {worst:.3e} of "
          f"their largest magnitude (bound 1e-4)")
    # where that gap comes from.  The forward's plen + 1 = 129 tokens take
    # chunk 1 (the step recurrence decode also runs), the prefill's 128
    # chunk 64.  The same comparison on the plain versions (is it the
    # kernel?), with the prefill's scan at chunk 1 too (is it the chunked
    # scan?), the kernels' forward against the plain versions' (two f32
    # orders of the same sums), and the gap at one layer (does depth grow
    # it?); each as a share of max|logit|.
    _, want_k = decode_gap(params, cfg, toks, plen)
    with plain_versions():
        gap_p, want_p = decode_gap(params, cfg, toks, plen)
    with plain_versions(ssd_chunk=1):
        gap_1, _ = decode_gap(params, cfg, toks, plen)
    fwd_kp = float((want_k - want_p).abs().max())
    del params, want_k, want_p
    cfg1 = dataclasses.replace(cfg, n_layers=1)
    params = tf.init_params(torch.Generator(device=dev).manual_seed(3), cfg1)
    gap_l1, want1 = decode_gap(params, cfg1, toks, plen)
    scale1 = float(want1.abs().max())
    shares = [gap_k / scale, gap_p / scale, gap_1 / scale, fwd_kp / scale,
              gap_l1 / scale1]
    check(all(np.isfinite(x) for x in shares),
          f"RWKV6-1.6B decode-gap study not finite: {shares}")
    print(f"[phaseK] RWKV6-1.6B f32 decode-vs-forward gap as a share of "
          f"max|logit|: on the kernels {shares[0]:.3e}; on the plain "
          f"versions {shares[1]:.3e}; plain with the prefill's scan at "
          f"chunk 1 {shares[2]:.3e}; the kernels' forward vs the plain "
          f"versions' forward {shares[3]:.3e}; at 1 of {cfg.n_layers} layers on the "
          f"kernels {shares[4]:.3e} (max|logit| {scale1:.3f})")
    del params, prompt, toks, want1
    torch.cuda.empty_cache()

    # MoE: a capacity factor of ceil(E / k) gives cap >= g, so no routed
    # token overflows in the forward, the prefill or decode (their groups
    # differ); the published 1.3 may drop a token in the forward that
    # decode keeps
    for arch, (layers, plen), seed in (("mixtral-8x7b", K_F32_MIXTRAL, 5),
                                       ("deepseek-v2-236b", K_F32_DEEPSEEK,
                                        7)):
        base = get_arch(arch)
        cf = float(math.ceil(base.n_experts / base.top_k))
        cfg = dataclasses.replace(base, dtype="float32", n_layers=layers,
                                  moe_capacity_factor=cf)
        what = (f"{arch} at {layers} of {base.n_layers} layers, capacity "
                f"factor {cf} (published {base.moe_capacity_factor})")
        params, *_ = decode_vs_forward(cfg, 1 if arch.startswith("mixtral")
                                       else 2, plen, what, seed)
        del params
        torch.cuda.empty_cache()

    # the int8 KV cache: Gemma-2B, decode vs the forward within 0.05
    # relative (the reference's test_int8_kv_decode_close_to_bf16 bound)
    cfg = dataclasses.replace(get_arch("gemma-2b"), dtype="float32")
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    params = tf.init_params(torch.Generator(device=dev).manual_seed(9), cfg)
    toks = torch.randint(2, cfg.vocab_size, (batch, plen + 1), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(10))
    want = tf.forward(params, cfg, toks)[0][:, -1]
    _, cache, pos = tf.prefill(params, cfg8, toks[:, :plen], plen + 32)
    check(cache["k"].dtype == torch.int8, "int8 prefill: cache not int8")
    lg, cache = tf.decode_step(params, cfg8, cache, toks[:, plen], pos)
    check(cache["k"].dtype == cache["v"].dtype == torch.int8
          and cache["ks"].dtype == torch.float16,
          "int8 decode: the cache left int8")
    rel = float((lg - want).abs().max() / want.abs().max())
    check(np.isfinite(rel) and rel < 0.05,
          f"Gemma-2B int8 cache: decode vs forward {rel:.3e} relative")
    print(f"[phaseK] Gemma-2B f32 with kv_cache_dtype int8 (batch {batch}, "
          f"prompt {plen}): decode vs the full forward's last logits "
          f"{rel:.3e} of max|logit| (bound 0.05); the cache stays int8 "
          f"with f16 scales")
    del params, cache, toks, want
    torch.cuda.empty_cache()

    tags = {"musicgen-large": "musicgen", "chameleon-34b": "chameleon",
            "mixtral-8x7b": "window"}
    for arch, t in tc.items():
        fa_entry.update({f"{key}_{tags[arch]}": val
                         for key, val in t.items()})
        fa_entry["max_abs_err"] = max(fa_entry["max_abs_err"],
                                      t["max_abs_err"])
    fa_entry.update(
        ms_mla=mla_ms, plain_ms_mla=mla_plain, bound_ms_mla=mla_bound,
        library_ms_mla=mla_lib, cuda_core_max_abs_err_mla=e_mla,
        launches_phase_k=total["flash"],
        launches_phase_k_cuda_core=total["cuda_core"])
    fa_entry["cuda_core_max_abs_err"] = max(
        fa_entry["cuda_core_max_abs_err"], e_mla)
    ssd_entry.update(ms_rwkv6=rwkv_ms, plain_ms_rwkv6=plain_ms,
                     bound_ms_rwkv6=rwkv_bound,
                     max_abs_err_rwkv6_model=s_model[0],
                     max_abs_y_rwkv6_model=s_model[1],
                     launches_phase_k=total["ssd"])
    ssd_entry["max_abs_err"] = max(ssd_entry["max_abs_err"], s_err)
    print(f"[phaseK] done in {time.perf_counter() - t_phase:.1f} s")


# Phase J: the resident control plane at cell B's width — the service's
# config, warmup horizon, packages (four tenants, one per workload kind)
# and flush window; the grouped fleet's groups; serve --serve's argv
SVC_TILES, SVC_PACKAGES, SVC_WARM, SVC_FLUSH = 47, 4096, 8192, 256
SVC_TENANTS = ("acme", "zeta", "orion", "vega")
GROUP_COUNTS = {"pole": 1024, "rom": 1024, "grid": 16}
SERVE_SERVE_ARGV = ["--serve", "--fleet-backend", "fused",
                    "--serve-flushes", "4", "--port", "0", "--fleet", "0"]
CHAOS_ARGV = ["--chaos"]


def count_syncs(fn):
    """(fn(), the synchronizing CUDA calls it made), counted by PyTorch's
    sync debug mode (one warning per synchronizing call)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # count the per-call warning only: the first "warn" of a process also
    # emits a one-time notice that the mode is a prototype
    return out, sum("called a synchronizing CUDA operation" in
                    str(w.message) for w in caught)


def records_close(got: dict, want: dict, where: str) -> float:
    """Two flush records: telemetry and per-tenant stats within 1e-5
    (freq_min / at_risk_frac 1e-3, counters exact), alert lists equal;
    returns the worst relative difference of the 1e-5 fields."""
    exact = ("n_packages", "events_total", "events_step", "degraded_count",
             "n_lanes", "events", "degraded_lanes")
    knife = ("freq_min", "at_risk_frac")
    worst = 0.0

    def close(a, b, k, w):
        nonlocal worst
        if k in exact:
            check(a == b, f"{w}: {k} {a} vs {b}")
            return
        tol = 1e-3 if k in knife else 1e-5
        check(abs(a - b) <= tol + tol * abs(b), f"{w}: {k} {a} vs {b}")
        if k not in knife:
            worst = max(worst, abs(a - b) / max(abs(b), 1e-9))

    for k, v in want["telemetry"].items():
        close(got["telemetry"][k], v, k, f"{where} telemetry")
    check(got["tenants"].keys() == want["tenants"].keys(),
          f"{where}: tenants {sorted(got['tenants'])} vs "
          f"{sorted(want['tenants'])}")
    for name, stats in want["tenants"].items():
        for k, v in stats.items():
            close(got["tenants"][name][k], v, k, f"{where} tenant {name}")
    strip = lambda al: [(a["tenant"], a["kind"], a["event"]) for a in al]
    check(strip(got["alerts"]) == strip(want["alerts"]),
          f"{where}: alerts {got['alerts']} vs {want['alerts']}")
    return worst


def phase_j(dev) -> dict:
    """`fma_f32`'s kernel against its plain version, then the resident
    control plane at full width, the grouped fleet, serve --serve and
    serve --chaos."""
    import shutil
    import urllib.request

    import numpy as np
    import torch

    from repro_torch import fma_f32, fma_f32_reference
    from repro_torch.core import nodebank
    from repro_torch.core.density import _RTOK_ICEPT_F32, _RTOK_SLOPE_F32
    from repro_torch.core.pdu_gate import exact_stats
    from repro_torch.core.scheduler import SchedulerConfig, ThermalScheduler
    from repro_torch.core.workload import KINDS
    from repro_torch.fleet import FleetEngine, FleetService
    from repro_torch.fleet.groups import GroupedFleetEngine
    from repro_torch.kernels import _build
    from repro_torch.kernels import fleet_step as fs
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    # ---- (a) the FMA kernel against its plain version, at the broadcast
    # fleet's shapes (4,096 packages x 47 tiles) and on crafted cases
    n, nt = SVC_PACKAGES, SVC_TILES
    g = torch.Generator(device=dev).manual_seed(18)
    u = lambda lo, hi, *s: lo + (hi - lo) * torch.rand(s, generator=g,
                                                       device=dev)
    gamma = ThermalScheduler(SchedulerConfig(n_tiles=nt),
                             device=dev).gamma
    rho, p, acc = u(0.9, 2.7, n, nt), u(0.0, 120.0, n, nt), u(0, 900, n, nt)
    big = torch.tensor([2 ** 23 + 2896, 2 ** 23 + 1], dtype=torch.float64)
    small = torch.tensor([2 ** 23 - 2895, 2 ** 23 - 1], dtype=torch.float64)
    half = (torch.cat([(u(-1, 1, 20000) * 2.0 ** -torch.randint(
                0, 20, (20000,), generator=g, device=dev)),
                (big * 2.0 ** -35).float().to(dev)]),
            torch.cat([u(-100, 100, 20000), (small * 2.0 ** -35).float()
                       .to(dev)]),
            torch.cat([u(-100, 100, 20000),
                       torch.tensor([1.0, 1 + 2 ** -23], device=dev)]))
    dense = torch.rand((2048, 2048), generator=g, device=dev)
    dense = dense / dense.sum(1, keepdim=True)
    cases = {
        "power_from_rho [4096, 47], scalar a and c":
            (_RTOK_SLOPE_F32, rho, _RTOK_ICEPT_F32),
        "Gamma walk step: column [47] (stride 47) x [4096, 1] + [4096, 47]":
            (gamma[:, 3], p[:, 3:4], acc),
        "csum: scalar x [4096, 47] + [4096, 47]": (8.5, rho, acc),
        "budget: [4096, 1] x [4096, 47] + scalar":
            (-u(0.1, 0.9, n, 1), acc, 69.0),
        "pole update: [2] x [4096, 47, 2] + [4096, 47, 2]":
            (u(0.5, 0.99, 2), u(0, 40, n, nt, 2), u(0, 1, n, nt, 2)),
        "halfway sums (a.b = 2^-24 +- 2^-70 beside c ~ 1), 20,002":
            half,
        "dense random Gamma [2048, 2048]: a column x [64, 1] + [64, 2048]":
            (dense[:, 7], u(80.0, 120.0, 64, 1), u(50.0, 120.0, 64, 2048)),
    }
    fma_err = 0.0
    for name, (a, b, c) in cases.items():
        before = fma_f32.launches
        out = fma_f32(a, b, c)
        torch.cuda.synchronize()
        check(fma_f32.launches == before + 1,
              f"fma_f32 {name}: {fma_f32.launches - before} launches")
        ref = fma_f32_reference(a, b, c)
        cpu = lambda x: x.cpu() if torch.is_tensor(x) else x
        ref_cpu = fma_f32_reference(cpu(a), cpu(b), cpu(c))
        check(torch.equal(out, ref) and torch.equal(out.cpu(), ref_cpu),
              f"fma_f32 {name}: differs from the plain version in "
              f"{int((out != ref).sum())} elements")
        fma_err = max(fma_err, float((out - ref).abs().max()))
    tail = fma_f32(*half)[-2:].tolist()
    check(tail == [1 + 2 ** -23] * 2, f"fma_f32 halfway cases: {tail}")
    walk = cases["Gamma walk step: column [47] (stride 47) x [4096, 1] + "
                 "[4096, 47]"]
    reps = 200

    def per_call(fn):
        return event_ms(lambda: [fn() for _ in range(reps)], 5) / reps

    fma_ms = per_call(lambda: fma_f32(*walk))
    fma_plain_ms = per_call(lambda: fma_f32_reference(*walk))
    a, b, c = walk
    twice_ms = per_call(lambda: (a * b.double() + c.double()).float())
    fma_bytes = 4 * (a.numel() + b.numel() + 2 * c.numel())
    fma_bound, fma_by = bound(fma_bytes, 2 * c.numel())
    eng = FleetEngine(SchedulerConfig(n_tiles=nt, mode="v24"),
                      backend="broadcast", device=dev)
    st = eng.init(n)
    window = fleet_trace(nt, n, 3 * SVC_FLUSH + 4)[3 * SVC_FLUSH:]
    step_rho = torch.from_numpy(window).to(dev)
    for k in range(2):
        st, _, _ = eng.step(st, step_rho[k])
    torch.cuda.synchronize()
    fma_f32.launches = 0
    st, _, tel = eng.step(st, step_rho[2])
    step_launches = fma_f32.launches
    step_ms = []
    for k in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, _, tel = eng.step(st, step_rho[3])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"[phaseJ] fma_f32.cu bit-equal to its plain version on the card "
          f"and on the CPU in {len(cases)} cases, one launch each; at the "
          f"Gamma walk's [{n}, {nt}]: kernel {fma_ms:.5f} ms a call (mean "
          f"of {reps}, CUDA events), plain {fma_plain_ms:.5f} ms, the "
          f"two-rounding f64 form {twice_ms:.5f} ms (for information), "
          f"bound {fma_bound:.5f} ms by {fma_by} ({fma_bytes / 1e6:.2f} "
          f"MB); {step_launches} fma_f32 launches in one broadcast-fleet "
          f"step at {n} x {nt} (v24), the step {np.median(step_ms):.3f} ms "
          f"(host clock, median of 5); {registers('fma_f32')}")

    # ---- (b) the resident control plane at full width, on fused, each
    # flush record held to a broadcast service fed the same chunks
    cfg = SchedulerConfig(n_tiles=nt, mode="v24", mixed_mode=True)
    snap = ROOT / "build" / "phase_j_snapshots"
    shutil.rmtree(snap, ignore_errors=True)
    svc = FleetService(cfg, backend="fused", flush_every=SVC_FLUSH,
                       snapshot_dir=str(snap), log_capacity=8, device=dev)
    oracle = FleetService(cfg, backend="broadcast", flush_every=SVC_FLUSH,
                          log_capacity=8, device=dev)
    check(svc.device.type == dev.type, f"service on {svc.device}")
    t0 = time.perf_counter()
    buckets = svc.warmup(SVC_WARM)
    warm_s = time.perf_counter() - t0
    counts = dict(_build.COUNTS)
    t0 = time.perf_counter()
    attach_syncs = 0
    for i in range(n):
        _, k = count_syncs(lambda: svc.attach(
            f"pkg{i}", SVC_TENANTS[i % 4], KINDS[i % 4]))
        attach_syncs += k
        oracle.attach(f"pkg{i}", SVC_TENANTS[i % 4], KINDS[i % 4])
    torch.cuda.synchronize()
    attach_s = time.perf_counter() - t0
    _, per_copy = count_syncs(
        lambda: torch.ones(3, device=dev).cpu())
    check(per_copy >= 1, "sync debug mode saw no D2H copy")
    fs.fleet_step.launches = fma_f32.launches = 0
    ticks, worst, svc_fma = [], 0.0, 0

    def tick(**kw):
        nonlocal worst, svc_fma
        syncs0, launches0 = svc.host_syncs, fs.fleet_step.launches
        fma0, state0 = fma_f32.launches, svc.state
        rec, k = count_syncs(lambda: svc.tick(**kw))
        svc_fma += fma_f32.launches - fma0
        check(svc.host_syncs == syncs0 + 1 and k == per_copy,
              f"flush {rec['flush']}: {svc.host_syncs - syncs0} copies, "
              f"{k} synchronizing calls (one copy makes {per_copy})")
        check(fs.fleet_step.launches == launches0 + 1,
              f"flush {rec['flush']}: "
              f"{fs.fleet_step.launches - launches0} fleet_step launches")
        # the broadcast service steps the same window from the same state,
        # its sliding statistics re-derived from the ring as the fused
        # backend re-derives them on entry (a fresh lane's closed-form sums
        # differ from those by an ulp, which the coupled law's knife edge
        # amplifies: PERF.md, PR 18)
        ft = state0.filtration
        oracle.state = state0._replace(filtration=ft._replace(**dict(zip(
            ("wsum", "csum", "rsum"), exact_stats(ft.buf, ft.ptr)))))
        want = oracle.tick(chunk=rec["rho"])
        worst = max(worst, records_close(rec, want,
                                         f"flush {rec['flush']}"))
        ticks.append(dict(svc.last_tick_ms))
        print(f"[phaseJ] flush {rec['flush']}: capacity {rec['capacity']}, "
              f"n {rec['telemetry']['n_packages']}, p99 "
              f"{rec['telemetry']['temp_p99_c']:.2f} C, alerts "
              f"{[(a['tenant'], a['kind'], a['event']) for a in rec['alerts']]}"
              f", fed {rec['ingest_fed']}; host ms " + json.dumps(
                  {k: round(v, 3) for k, v in svc.last_tick_ms.items()}))
        return rec

    tick()
    tick()
    for s in (svc, oracle):                   # n + 1 packages: grow to 2n
        plan = s.attach("extra", "acme", "training")["plan"]
        check(plan == "grow", f"attach past 4,096: plan {plan}")
    tick()
    feed = np.full((SVC_FLUSH, nt), 2.6, np.float32)
    for s in (svc, oracle):
        s.canary(0.25)
        s.set_thresholds("zeta", t_crit_c=60.0)
    check(svc.ingest("orion", feed)["accepted"], "ingest refused")
    rec = tick()
    check(rec["ingest_fed"] == ["orion"], f"ingest fed {rec['ingest_fed']}")
    svc.save_snapshot(blocking=True)
    tick()
    gone = ["extra"] + [f"pkg{i}" for i in range(n) if i % 4 >= 2]
    t0 = time.perf_counter()
    for name in gone:                          # n / 2 left: shrink to n
        for s in (svc, oracle):
            plan = s.detach(name)["plan"]
    check(plan == "shrink" and svc.registry.capacity == n,
          f"detach to {n // 2}: plan {plan}, capacity "
          f"{svc.registry.capacity}")
    detach_s = time.perf_counter() - t0
    final = tick()
    torch.cuda.synchronize()
    check(fs.fleet_step.launches == len(ticks),
          f"{fs.fleet_step.launches} fleet_step launches in {len(ticks)} "
          f"flushes")
    svc_launches = {"fleet_step": fs.fleet_step.launches,
                    "fma_f32": svc_fma}
    t0 = time.perf_counter()
    restored = FleetService.restore(str(snap), device=dev)
    check(restored.flushes == final["flush"],
          f"restored at flush {restored.flushes}")
    again = restored.tick()
    restore_s = time.perf_counter() - t0
    rel = records_close(again, final, "restore vs uninterrupted")
    for f in ("thermal", "freq", "events", "throttled", "ctrl_mode"):
        a = getattr(restored.state, f).float()
        b = getattr(svc.state, f).float()
        check(torch.allclose(a, b, **TOL), f"restored state.{f} differs")
    check(_build.COUNTS == counts, f"kernel libraries built or loaded after "
          f"warmup: {counts} -> {_build.COUNTS}")
    med = {k: float(np.median([t[k] for t in ticks[:2] + ticks[4:5]]))
           for k in ticks[0]}
    print(f"[phaseJ] service {n} packages x {nt} tiles on fused, flush "
          f"{SVC_FLUSH}: warmup of {buckets} buckets {warm_s:.2f} s, "
          f"{n} attaches (each on both services) {attach_s:.2f} s, the "
          f"fused service's with {attach_syncs} synchronizing calls, "
          f"{len(gone)} detaches "
          f"{detach_s:.2f} s; {len(ticks)} flushes, "
          f"{svc_launches['fleet_step']} fleet_step launches (1 a flush) "
          f"and {svc_launches['fma_f32']} fma_f32 launches, 1 D2H copy a "
          f"flush, each "
          f"record held to the broadcast service (worst rel "
          f"{worst:.2e}); median host ms of the plain flushes "
          + json.dumps({k: round(v, 3) for k, v in med.items()})
          + f"; restore + 1 flush {restore_s:.2f} s, vs uninterrupted "
          f"{rel:.2e}; builds / loads after warmup: 0 / 0")

    # ---- (c) the grouped fleet: pole and ROM groups on the kernel, a small
    # grid group per step, against per-group oracles bit for bit
    gcfg = SchedulerConfig(n_tiles=nt, mode="v24", mixed_mode=True,
                           heterogeneous=True)
    ge = GroupedFleetEngine(gcfg, backend="fused",
                            groups=tuple(GROUP_COUNTS), device=dev)
    nodes = [("base", "n7", "n5", "n3")[i % 4]
             for i in range(GROUP_COUNTS["pole"])]
    pkg = {"pole": nodebank.fleet_package_params(ge.engines["pole"].sched,
                                                 nodes)}
    states = ge.init(GROUP_COUNTS, pkg=pkg)
    pins = {grp: torch.arange(k, device=dev) % 3 == 0
            for grp, k in GROUP_COUNTS.items()}
    for grp in ge.groups:
        states[grp] = states[grp]._replace(ctrl_mode=pins[grp])
    total = sum(GROUP_COUNTS.values())
    gtrace = torch.from_numpy(fleet_trace(nt, total, SVC_FLUSH)).to(dev)
    fs.fleet_step.launches = 0
    t0 = time.perf_counter()
    _, temps, freqs = ge.block_traces(states, gtrace)
    torch.cuda.synchronize()
    group_s = time.perf_counter() - t0
    check(fs.fleet_step.launches == 2,
          f"grouped window: {fs.fleet_step.launches} fleet_step launches")
    sl = ge.lane_slices(states)
    for grp in ge.groups:
        e = FleetEngine(ge.engines[grp].cfg, backend="fused", device=dev)
        st = e.init(GROUP_COUNTS[grp], pkg=pkg.get(grp))._replace(
            ctrl_mode=pins[grp])
        _, tg, fg = e.block_traces(st, gtrace[:, sl[grp]])
        check(torch.equal(temps[:, sl[grp]], tg)
              and torch.equal(freqs[:, sl[grp]], fg),
              f"grouped {grp} lanes differ from the {grp} oracle")
    _, grec = ge.run_block(ge.init(GROUP_COUNTS, pkg=pkg), gtrace)
    gd = grec.as_dict()
    check(gd["n_packages"] == total and all(np.isfinite(v)
                                           for v in gd.values()),
          f"grouped flush record {gd}")
    print(f"[phaseJ] GroupedFleetEngine {GROUP_COUNTS} x {nt} tiles on "
          f"fused: one window {group_s * 1e3:.1f} ms (host clock; 2 "
          f"fleet_step launches, grid per step), every group bit-equal to "
          f"its oracle; merged record " + json.dumps(gd))

    # ---- (d) serve --serve as a process, driven over HTTP
    env = {**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve",
         *SERVE_SERVE_ARGV], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        lines, base = [], None
        for line in proc.stdout:
            lines.append(line)
            if "control plane on http://" in line:
                base = line.split("control plane on ")[1].split()[0]
                break
        check(base is not None, "serve --serve never listened:\n"
              + "".join(lines)[-3000:])

        def call(path, body=None):
            req = urllib.request.Request(
                base + path, data=None if body is None
                else json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                raw = r.read().decode()
            return raw if path == "/dashboard" else json.loads(raw)

        check(call("/healthz")["ok"], "serve --serve: /healthz not ok")
        call("/thresholds", {"tenant": "ops", "t_crit_c": 40.0})
        fed = call("/ingest", {"tenant": "ops",
                               "chunk": [[2.6]] * 50})
        check(fed["accepted"], f"serve --serve: ingest {fed}")
        check("fleet control plane" in call("/dashboard"),
              "serve --serve: /dashboard")
        check(call("/fleet")["n_active"] == 0, "serve --serve: not empty")
        # the attach starts the flushes: the last call, so that the four
        # flushes cannot end the process under a pending request
        call("/attach", {"package": "probe", "tenant": "ops"})
        out, _ = proc.communicate(timeout=600)
        lines.append(out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = "".join(lines)
    flushes = [l for l in text.splitlines() if l.startswith("[serve] flush")]
    check(proc.returncode == 0 and len(flushes) == 4,
          f"serve --serve: rc {proc.returncode}, {len(flushes)} flushes:\n"
          + text[-3000:])
    check("alerts 0" not in flushes[0],
          f"serve --serve: the first flush raised no alert: {flushes[0]}")
    print("[phaseJ] serve --serve (" + " ".join(SERVE_SERVE_ARGV)
          + "), driven over HTTP (thresholds, ingest, dashboard, "
          "attach): " + " | ".join(flushes))

    # ---- (e) serve --chaos on the card
    t0 = time.perf_counter()
    check(serve.main(CHAOS_ARGV) == {"chaos": "ok"}, "serve --chaos")
    chaos_s = time.perf_counter() - t0
    print(f"[phaseJ] serve --chaos: all gates passed in {chaos_s:.1f} s; "
          f"phase J {time.perf_counter() - t_phase:.1f} s")
    return {"name": "fma_f32", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fma_f32.cu",
            "replaces": "none: not a TPU kernel (the single-rounding f32 "
                        "FMA that XLA contracts in the reference's compiled "
                        "fleet loop)",
            "launches": svc_launches["fma_f32"],
            "launches_per_broadcast_step": step_launches,
            "max_abs_err": fma_err, "ms": fma_ms, "plain_ms": fma_plain_ms,
            "two_rounding_ms": twice_ms, "bound_ms": fma_bound,
            "bound_by": fma_by, "library_ms": None,
            "service_fleet_step_launches": svc_launches["fleet_step"],
            "service_tick_ms": med}


# Phase L: the training slice.  The backward kernel's cases (what, B, Tq,
# Tk, H, KV, d, dv, dtype name, causal, window, q_offset); the bounds on
# its gradients as a share of each gradient's largest magnitude (the
# first chip run measured at most 9.5e-7 in f32 and 2.3e-3 in bf16); the
# train step's bounds kernels vs plain versions (probe: 1.7e-2 per bf16
# leaf, loss 2e-5 relative); the driver's arguments; the depth of the
# checkpoint-and-resume run
FLASH_BWD_CASES = (
    ("Gemma-2B training", 8, 1024, 1024, 8, 1, 256, 256, "bfloat16", True,
     0, 0),
    ("the 100M example", 8, 256, 256, 10, 5, 64, 64, "float32", True, 0, 0),
    ("Zamba2-7B", 8, 1024, 1024, 32, 32, 112, 112, "bfloat16", True, 0, 0),
    ("MLA", 2, 1024, 1024, 128, 128, 192, 128, "bfloat16", True, 0, 0),
    ("window 128", 2, 600, 600, 4, 2, 64, 64, "bfloat16", True, 128, 0),
    ("ragged T=1000", 2, 1000, 1000, 4, 2, 112, 112, "bfloat16", True, 0, 0),
    ("window empties rows", 1, 100, 300, 4, 1, 128, 128, "bfloat16", True,
     64, 400),
    ("f32 d 256 window", 2, 200, 200, 4, 2, 256, 256, "float32", True, 96,
     0),
    ("f32 not causal, q_offset", 1, 130, 257, 4, 2, 48, 40, "float32",
     False, 0, 64))
FLASH_BWD_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
TRAIN_BF16_TOL = 5e-2
TRAIN_LOSS_TOL = 1e-3
TRAIN_F32_TOL = 1e-4
TRAIN_ARGV = ["--arch", "gemma-2b", "--batch", "8", "--seq", "1024",
              "--log-every", "1"]
TRAIN_STEPS = 6
CKPT_LAYERS = 1
EXAMPLE_ARGV = ["--steps", "40"]


@contextlib.contextmanager
def plain_flash_grads():
    """`FlashAttention` kept, its two kernel branches on the card swapped
    for the plain versions (`flash_attention_stats_reference`,
    `flash_attention_backward_reference`): the train step's plain run."""
    from repro_torch.kernels import flash_attention as fa

    saved = fa.flash_attention_stats, fa.flash_attention_backward

    def stats(q, k, v, **kw):
        o, m, l = fa.flash_attention_stats_reference(q, k, v, **kw)
        return o.to(q.dtype), o, m, l

    def backward(q, k, v, o, m, l, do, **kw):
        return fa.flash_attention_backward_reference(q, k, v, o, m, l,
                                                     do.contiguous(), **kw)
    fa.flash_attention_stats, fa.flash_attention_backward = stats, backward
    try:
        yield
    finally:
        fa.flash_attention_stats, fa.flash_attention_backward = saved


def grads_vs_plain(params, cfg, toks, labs, where: str, bound: float,
                   route: str) -> tuple[float, float]:
    """Loss and gradients of ``params`` on the kernels (exactly 2 forward
    launches on ``route`` and 1 backward a layer) against the same call
    with FlashAttention on its plain branches (no launch): the loss within
    TRAIN_LOSS_TOL relative, each gradient leaf within ``bound`` of its
    largest magnitude.  Returns (loss, worst leaf share)."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps as S

    L = cfg.n_layers
    fa.reset_launches()
    loss, _, g_k = S.loss_and_grads(params, cfg, toks, labs)
    torch.cuda.synchronize()
    routes = dict(fa.flash_attention.launches_by_route)
    check(routes[route] == 2 * L and fa.flash_attention.launches == 2 * L
          and fa.flash_attention_backward.launches == L,
          f"{where}: forward launches {routes}, backward "
          f"{fa.flash_attention_backward.launches}; want {2 * L} on the "
          f"{route} route and {L}")
    with plain_flash_grads():
        loss_p, _, g_p = S.loss_and_grads(params, cfg, toks, labs)
    torch.cuda.synchronize()
    check(fa.flash_attention.launches == 2 * L
          and fa.flash_attention_backward.launches == L,
          f"{where}: the plain run launched a kernel")
    lk, lp = float(loss), float(loss_p)
    check(np.isfinite(lk) and abs(lk - lp) <= TRAIN_LOSS_TOL * abs(lp),
          f"{where}: loss {lk} on the kernels, {lp} on the plain versions")
    worst = 0.0
    for i, (a, b) in enumerate(zip(g_k, g_p)):
        a, b = a.float(), b.float()
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        check(np.isfinite(rel) and rel <= bound, f"{where}: gradient leaf "
              f"{i} {list(a.shape)} differs by {rel:.3e} of its largest "
              f"magnitude (bound {bound})")
        worst = max(worst, rel)
    print(f"[phaseL] {where}: loss {lk:.6f} on the kernels, {lp:.6f} on the "
          f"plain versions; {2 * L} forward launches ({route}) and {L} "
          f"backward, none in the plain run; the {len(g_k)} gradient "
          f"leaves within {worst:.3e} of their largest magnitude (bound "
          f"{bound})")
    return lk, worst


def train_batch(dev, cfg, seed: int):
    """Random (tokens, labels) at TRAIN_ARGV's batch and sequence length,
    token ids below 32,768 (the data pipeline's range)."""
    import torch

    arg = lambda k: int(TRAIN_ARGV[TRAIN_ARGV.index(k) + 1])
    g = torch.Generator(device=dev).manual_seed(seed)
    hi = min(32768, cfg.vocab_size)
    shape = (arg("--batch"), arg("--seq"))
    return (torch.randint(2, hi, shape, generator=g, device=dev),
            torch.randint(2, hi, shape, generator=g, device=dev))


def profile_train_step(dev, cfg, state, n_tiles: int) -> None:
    """Where one warm train step spends the card's time: device time by
    group (torch.profiler, CUDA activity) against the host clock, the
    AdamW update's span (its `record_function` range on the device) and
    the idle share.  The flash groups must hold exactly 2 × layers forward
    and 3 × layers backward kernel runs (three kernels a backward call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps as S

    toks, labs = train_batch(dev, cfg, 5)
    batch = {"tokens": toks, "labels": labs,
             "rho": torch.full((n_tiles,), 1.9, device=dev)}
    step = S.make_train_step(cfg, n_tiles, device=dev)
    state, _ = step(state, batch)                        # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups = (("flash forward", ("flash_tc_kernel", "flash_kernel")),
              ("flash backward", ("dkdv_kernel", "dq_kernel",
                                  "delta_kernel")),
              ("GEMM", ("gemm", "cutlass", "xmma", "nvjet", "sm90_")))
    ranges = ("loss_and_grads", "adamw_update")
    by = {k: 0.0 for k, _ in groups} | {"other": 0.0}
    runs = {k: 0 for k, _ in groups} | {"other": 0}
    span, other = {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        if e.key in ranges:
            span[e.key] = ms
            continue
        k = next((k for k, keys in groups
                  if any(x in e.key.lower() for x in keys)), "other")
        by[k] += ms
        runs[k] += e.count
        if k == "other":
            other[e.key[:50]] = other.get(e.key[:50], 0.0) + ms
    busy = sum(by.values())
    L = cfg.n_layers
    check(busy == 0.0 or (runs["flash forward"] == 2 * L
                          and runs["flash backward"] == 3 * L),
          f"profiled train step: {runs['flash forward']} flash forward and "
          f"{runs['flash backward']} backward kernel runs, want {2 * L} and "
          f"{3 * L}")
    if busy == 0.0:
        print(f"[phaseL] profiled train step: the profiler recorded no "
              f"device time (breakdown not measured); host clock "
              f"{wall:.1f} ms")
        return
    top = sorted(other.items(), key=lambda kv: -kv[1])[:4]
    print(f"[phaseL] {cfg.name} train step ({cfg.dtype}, batch "
          f"{list(toks.shape)}; torch.profiler): host clock {wall:.1f} ms, device busy "
          f"{busy:.1f} ms (idle share {1 - busy / wall:.3f}); by group (ms): "
          + json.dumps({k: round(v, 3) for k, v in by.items()})
          + "; the AdamW update's span on the device "
          f"{span.get('adamw_update', float('nan')):.3f} ms; largest other: "
          + json.dumps({k: round(v, 3) for k, v in top}))


def phase_l(dev) -> dict:
    """Training: the backward kernel, Gemma-2B's gradients on the kernels
    vs the plain versions, the train driver with checkpoint and resume,
    and the 100M example."""
    import dataclasses
    import importlib.util
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import tree_leaves
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train
    from repro_torch.models import transformer as tf

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(20)
    fwd_tol = {"float32": dict(atol=2e-5), "bfloat16": dict(atol=2e-2)}

    # ---- (a) the statistics output and the backward kernel
    worst_abs, worst_rel = 0.0, {"float32": 0.0, "bfloat16": 0.0}
    timing = None
    for what, B, Tq, Tk, H, KV, d, dv, dt, causal, w, off in \
            FLASH_BWD_CASES:
        dtype = getattr(torch, dt)
        r = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
        q, k, v, do = r(B, Tq, H, d), r(B, Tk, KV, d), r(B, Tk, KV, dv), \
            r(B, Tq, H, dv)
        kw = dict(causal=causal, window=w, q_offset=off)
        route = fa.flash_route("cuda", dtype, dtype, d, dv)
        before = fa.flash_attention.launches_by_route[route]
        out, o, m, l = fa.flash_attention_stats(q, k, v, **kw)
        torch.cuda.synchronize()
        check(fa.flash_attention.launches_by_route[route] == before + 1,
              f"phase L {what}: statistics forward not on the {route} route")
        check(torch.equal(out, fa.flash_attention(q, k, v, **kw)),
              f"phase L {what}: the statistics launch changes the output")
        po, pm, pl = fa.flash_attention_stats_reference(q, k, v, **kw)
        e_o = max_err((o,), (po,), f"phase L {what} o_f32", rtol=0.0,
                      **fwd_tol[dt])
        empty = pm <= -1e29
        check(torch.equal(empty, m <= -1e29), f"phase L {what}: rows "
              f"without keys differ ({int(empty.sum())} plain)")
        e_m = float(((m - pm).abs() / pm.abs().clamp(min=1.0)).max())
        e_l = float(((l - pl).abs() / pl).max())
        check(e_m <= 1e-5 and e_l <= 1e-5, f"phase L {what}: statistics "
              f"m {e_m:.3e}, l {e_l:.3e} from the plain ones (bound 1e-5)")
        g1 = fa.flash_attention_backward(q, k, v, po, pm, pl, do, **kw)
        g2 = fa.flash_attention_backward(q, k, v, po, pm, pl, do, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(g1, g2)),
              f"phase L {what}: two backward launches differ")
        gp = fa.flash_attention_backward_reference(q, k, v, po, pm, pl, do,
                                                   **kw)
        rels = []
        for name, a, b in zip(("dq", "dk", "dv"), g1, gp):
            a, b = a.float(), b.float()
            check(bool(torch.isfinite(a).all()), f"phase L {what}: {name} "
                  f"not finite")
            diff = float((a - b).abs().max())
            rel = diff / max(float(b.abs().max()), 1e-30)
            check(rel <= FLASH_BWD_TOL[dt], f"phase L {what}: {name} differs "
                  f"from the plain backward by {rel:.3e} of its largest "
                  f"magnitude (bound {FLASH_BWD_TOL[dt]})")
            worst_abs = max(worst_abs, diff)
            rels.append(rel)
        worst_rel[dt] = max(worst_rel[dt], *rels)
        print(f"[phaseL] {what} [{B}, {Tq}/{Tk}, {H} on {KV}, {d}/{dv}] {dt} "
              f"causal {causal} window {w} q_offset {off}: forward with "
              f"statistics on the {route} route, o_f32 within {e_o:.3e}, m "
              f"{e_m:.2e}, l {e_l:.2e} of the plain ones ({int(empty.sum())} "
              f"rows without keys), output bit-equal to the serving launch; "
              f"backward dq/dk/dv within " + "/".join(f"{x:.2e}" for x in rels)
              + f" of their largest magnitude (bound {FLASH_BWD_TOL[dt]}), "
              f"the same bits on two launches")
        if timing is None:           # the first case: Gemma-2B's shape
            ms = event_ms(lambda: fa.flash_attention_backward(
                q, k, v, po, pm, pl, do, **kw), 5)
            fwd_ms = event_ms(lambda: fa.flash_attention_stats(q, k, v, **kw),
                              10)
            serve_ms = event_ms(lambda: fa.flash_attention(q, k, v, **kw), 10)
            plain_ms = timed(lambda: fa.flash_attention_backward_reference(
                q, k, v, po, pm, pl, do, **kw))[1]
            qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            lib_o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                   enable_gqa=True)
            lib_ms = event_ms(lambda: torch.autograd.grad(
                lib_o, (qs, ks, vs), do.transpose(1, 2), retain_graph=True),
                5)
            cost = fa.flash_attention_backward_cost(q, k, v, **kw)
            b_ms, b_by = bound(cost["bytes"], cost["ops"], PEAK_BF16_PER_S)
            timing = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by)
            print(f"[phaseL] flash_attention_backward [{B}, {Tq}, {H} on "
                  f"{KV}, {d}] bf16 causal: kernel {ms:.4f} ms (median of 5, "
                  f"CUDA events; three launches), plain {plain_ms:.1f} ms "
                  f"(one run), scaled_dot_product_attention's backward "
                  f"(enable_gqa) {lib_ms:.4f} ms; bound {b_ms:.4f} ms by "
                  f"{b_by} ({cost['bytes'] / 1e6:.1f} MB, "
                  f"{cost['ops'] / 1e9:.2f} GFLOP over {cost['pairs']} kept "
                  f"pairs per head, at the bf16 peak; "
                  f"{cost['ops'] / PEAK_F32_PER_S * 1e3:.3f} ms at the f32 "
                  f"peak); the forward with statistics {fwd_ms:.4f} ms, "
                  f"the serving forward {serve_ms:.4f} ms; "
                  f"{registers('flash_attention_bwd', 'ILi16E')}")
            del qs, ks, vs, lib_o
    del q, k, v, do, o, m, l, po, pm, pl, g1, g2, gp
    torch.cuda.empty_cache()

    # ---- (b) Gemma-2B at full width and depth, bf16: kernels vs plain
    cfg = get_arch("gemma-2b")
    toks, labs = train_batch(dev, cfg, 21)
    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    grads_vs_plain(params, cfg, toks, labs, "Gemma-2B bf16 [8 x 1,024] "
                   "full width and depth", TRAIN_BF16_TOL, "tensor_core")
    del params
    torch.cuda.empty_cache()

    # ---- (c) f32 at full width, 2 layers: the CUDA-core route
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=2)
    params = tf.init_params(torch.Generator(device=dev).manual_seed(0),
                            cfg32)
    grads_vs_plain(params, cfg32, toks, labs, "Gemma-2B f32 [8 x 1,024] "
                   "full width, 2 layers", TRAIN_F32_TOL, "cuda_core")
    del params
    torch.cuda.empty_cache()

    # ---- (d) the driver: full width and depth, then checkpoint and resume
    argv = TRAIN_ARGV + ["--steps", str(TRAIN_STEPS)]
    torch.cuda.synchronize()
    fa.reset_launches()
    res = train.main(argv)
    torch.cuda.synchronize()
    L, n = cfg.n_layers, TRAIN_STEPS
    fwd, bwd = dict(fa.flash_attention.launches_by_route), \
        fa.flash_attention_backward.launches
    check(fwd == {"tensor_core": 2 * L * n, "cuda_core": 0} and bwd == L * n,
          f"train: forward launches {fwd}, backward {bwd}; want "
          f"{2 * L * n} on the tensor-core route and {L * n}")
    bwd_main = bwd
    check(len(res["losses"]) == n and all(np.isfinite(res["losses"])),
          f"train: losses {res['losses']}")
    print(f"[phaseL] python -m repro_torch.launch.train {' '.join(argv)} "
          f"(bf16, full width and depth): losses "
          f"{json.dumps([round(x, 4) for x in res['losses']])}; warm step "
          f"{res['warm_step_ms']:.1f} ms (median of {n - 1}, host clock "
          f"after a synchronize; per step "
          f"{json.dumps([round(x, 1) for x in res['step_ms']])}), "
          f"{res['tok_s']:,.0f} tok/s, peak device memory "
          f"{res['peak_bytes'] / 2**30:.2f} GiB; launches a step: "
          f"{2 * L} forward on the tensor-core route and {L} backward "
          f"(exactly {fwd['tensor_core']} and {bwd} in {n} steps)")
    profile_train_step(dev, cfg, res["state"], 8)
    del res
    torch.cuda.empty_cache()

    saved_get = train.get_arch
    train.get_arch = lambda name: dataclasses.replace(saved_get(name),
                                                      n_layers=CKPT_LAYERS)
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ck = ["--ckpt-every", "3", "--ckpt-dir", tmp]
            first = train.main(TRAIN_ARGV + ["--steps", "6"] + ck)
            mgr = CheckpointManager(tmp)
            check(mgr.steps() == [3, 5], f"train: checkpoints {mgr.steps()}, "
                  f"want steps 3 and 5")
            restored = mgr.restore(5, first["state"])
            check(all(torch.equal(a, b) for a, b in zip(
                tree_leaves(restored), tree_leaves(first["state"]))),
                "train: the restored state differs from the saved one")
            del restored
            second = train.main(TRAIN_ARGV + ["--steps", "8"] + ck)
            check(second["start"] == 6 and len(second["losses"]) == 2
                  and all(np.isfinite(second["losses"]))
                  and mgr.steps() == [5, 6, 7],
                  f"train: resume started at {second['start']}, losses "
                  f"{second['losses']}, checkpoints {mgr.steps()}")
            size = sum(f.stat().st_size for f in Path(tmp).rglob("*.npy"))
    finally:
        train.get_arch = saved_get
    print(f"[phaseL] checkpoint and auto-resume through the driver (Gemma-2B "
          f"full width, {CKPT_LAYERS} layers): --steps 6 --ckpt-every 3 "
          f"saved steps 3 and 5, the restored state bit-equal to the saved "
          f"one; --steps 8 resumed at step 6 (losses "
          f"{json.dumps([round(x, 4) for x in second['losses']])}) and saved "
          f"steps 6 and 7 (the three newest kept); {size / 2**30:.2f} GiB "
          f"on disk, "
          f"{time.perf_counter() - t0:.1f} s")
    del first, second
    torch.cuda.empty_cache()

    # ---- (e) the 100M example in f32: the CUDA-core route both ways
    spec = importlib.util.spec_from_file_location(
        "torch_train_100m", ROOT / "examples" / "torch_train_100m.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    L = example.config().n_layers
    n = int(EXAMPLE_ARGV[EXAMPLE_ARGV.index("--steps") + 1])
    fa.reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        first_loss, last_loss = example.main(EXAMPLE_ARGV
                                             + ["--ckpt-dir", tmp])
    fwd, bwd = dict(fa.flash_attention.launches_by_route), \
        fa.flash_attention_backward.launches
    check(fwd == {"tensor_core": 0, "cuda_core": 2 * L * n} and bwd == L * n,
          f"100M example: forward launches {fwd}, backward {bwd}")
    check(np.isfinite(last_loss) and last_loss < first_loss,
          f"100M example: loss {first_loss} -> {last_loss} did not fall")
    print(f"[phaseL] examples/torch_train_100m.py {' '.join(EXAMPLE_ARGV)} "
          f"(f32): loss {first_loss:.4f} -> {last_loss:.4f}; "
          f"{2 * L} forward and {L} backward launches a step on the CUDA-core "
          f"route; {time.perf_counter() - t0:.1f} s; phase L "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"name": "flash_attention_backward", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/ref.py:201",
            "launches": bwd_main, "max_abs_err": worst_abs,
            "max_rel_err_f32": worst_rel["float32"],
            "max_rel_err_bf16": worst_rel["bfloat16"], **timing,
            "shape": "gemma-2b [8, 1024, 8 on 1, 256] bf16"}


if __name__ == "__main__":
    main()
