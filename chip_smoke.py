#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0  prints the card's name and power limit (nvidia-smi) and builds the
         ten kernel sources of the checkout, one nvcc each, in parallel.
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
         --gen 16 --waves 3 --fleet 64 — exactly 81 ssd and 13 flash
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
         2,048 packages, 1,024 packages attached over four tenants (one per
         workload kind), six flushes with an attach that grows the capacity
         to 2,048, a canary(0.25), a threshold edit, an `ingest` chunk, a
         snapshot, and 513 detaches that shrink it back to 1,024: every
         flush one `fleet_step` launch and the synchronizing calls of ONE
         device→host copy (sync debug mode), held to a broadcast service
         stepping the same chunk from the same state, and bit-equal to a
         second fused service ticked from the same state on the same chunk
         (the per-tenant sums run in a fixed order); `FleetService.restore`
         vs the uninterrupted service ≤1e-5; no kernel library built or
         loaded after warmup; per-flush host ms by stage.  (c)
         `GroupedFleetEngine` (pole and ROM groups of 256 on the kernel,
         16 grid lanes per step, 47 tiles, node banks and pins) bit for bit
         against per-group oracles.  (d) `serve --serve --fleet-backend fused
         --serve-flushes 4 --port 0 --fleet 0` as a process, driven over
         HTTP.  (e) `serve --chaos` on the card.

Phase K  every model family of configs/ served.  (a) The serving
         kernels at this slice's shapes against their plain versions:
         flash at DeepSeek-V2's MLA prefill [2, 1,024, 128, q/k 192 / v
         128] with the explicit scale 192^-0.5, causal (f32 on the
         CUDA-core route within 2e-5, bf16 on the tensor-core route
         within 2e-2, timed beside the CUDA-core kernel's earlier time,
         SDPA and the bound); flash on the
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
         --gen 16 (8 flash on the tensor-core route; the prefill masks
         keys, the ring rolls by 512, decode writes slot pos % 4096) and
         deepseek-v2-236b at 4 of 60 with --batch 2 --prompt-len 1024
         --gen 16 (4 flash on the tensor-core route) — exact launch counts
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

Phase L  training.  (a) `flash_attention_stats` (each
         route's forward with its f32 output and row statistics) against
         the plain statistics, its output bit-equal to the serving
         launch's, and the backward — on the route `flash_route` names:
         flash_attention_bwd_tc.cu for bf16 at the tensor-core pairs,
         flash_attention_bwd.cu for the rest — against the plain backward
         (`make_flash`'s bwd) on the plain residuals — gradients within
         1e-5 (f32) and 5e-3 (bf16) of each one's largest magnitude, the
         same bits on two launches — at Gemma-2B's training shape [8, 1,024,
         8 on 1, 256] bf16, the 100M example's [8, 256, 10 on 5, 64] f32,
         Zamba2-7B's [8, 1,024, 32, 112], MLA's [2, 1,024, 128, 192 / 128],
         a window, a ragged T, rows a window empties, f32 at d 256 and bf16
         at d 96 (the CUDA-core kernel's bf16 check); timed at Gemma's,
         Zamba2's, MLA's and the 100M example's shapes beside the bound,
         the plain backward and scaled_dot_product_attention's backward
         (enable_gqa; library_ms, a yardstick only).  (b) Gemma-2B at full
         width and depth in bf16: loss and gradients on the kernels (36
         forward launches and 18 backward, all on the tensor-core route)
         against FlashAttention on its
         plain branches (no launch), the loss within 1e-3 and each
         gradient leaf within 5e-2 of its largest magnitude (bf16 P in the
         tensor-core forward and bf16 activations through 18 layers and
         their recompute).  (c) The same in f32 at 2 layers (the CUDA-core
         route): each leaf within 1e-4.  (d) `repro_torch.launch.train
         --arch gemma-2b --batch 8 --seq 1024 --steps 4` in process:
         finite losses, exactly 36 forward and 18 backward launches a
         step, all on the tensor-core route, the warm step time, tok/s, peak device memory, and a
         profiled warm step (device time by group: flash forward, flash
         backward, GEMM, the rest; the AdamW update's span; idle share);
         then checkpoint and auto-resume through the same driver at full
         width with the depth cut to CKPT_LAYERS (a full-depth train state
         is 30 GB a checkpoint): --steps 6 --ckpt-every 3, then --steps 8,
         the restored state bit-equal to the saved one (steps 3, 5, then
         6, 7; the three newest kept).  (e)
         examples/torch_train_100m.py on the card (f32, the CUDA-core
         route forward and backward): exact launches, the loss falls.
         (f) The ssd backward (csrc/ssd_bwd.cu) against its plain version
         (`ssd_backward_reference`) on the states the forward's states
         variant keeps, whose y and hT must equal the serving launch's bit
         for bit: at Zamba2-7B's [8, 1,024, 112, 64/64] (f32 d, b, bf16 c,
         x), RWKV6-1.6B's [8, 1,024, 32, 64/64] with u and
         include_current=False (f32 d, bf16 k, v, r), an f32 case with h0
         and dhT, and a ragged T (chunk 8) with P = 128 — each leaf in its
         input's dtype, within 1e-4 (f32) or 5e-3 (bf16) of its largest
         magnitude, the same bits on two launches; timed at the two
         models' shapes beside the plain version and the bound (at a third
         of the TF32 peak, the products' 3×TF32 split on the tensor cores;
         the f32 CUDA-core bound beside it; no library call computes it),
         with each pass's device time (torch.profiler), the kernel's one
         route and each pass's shared bytes and resident blocks an SM.  (g) RWKV6-1.6B at full depth and Zamba2-7B
         with its depth cut (ZAMBA2_GRAD_LAYERS) in bf16: the loss on the
         kernels against FlashAttention and SsdFunction on their plain
         branches within 1e-3, and the launches (the gradients' gap is
         printed: at this depth bf16 rounding alone moves them by up to
         ~0.3 of a leaf's max); then in f32 at 2 layers (RWKV6) and one
         shared-block group (Zamba2, 6 layers) each leaf within 1e-4, and
         at the same depth (RWKV6's 24 layers, the Zamba2 cut) within 1e-3
         of its largest magnitude.  (h) `repro_torch.launch.train --arch
         rwkv6-1.6b` and `--arch zamba2-7b` (the same cut) --batch 8 --seq 1024
         --steps 4 in process: finite losses, exactly 2 ssd forward and 1
         backward launches a layer a step (and Zamba2's shared block 1
         flash forward and 1 backward an application, on the tensor-core
         route), the warm step, tok/s, peak device memory and a profiled
         warm step (flash, ssd forward, ssd backward, GEMM, the AdamW
         span, the rest, idle share).

Phase M  the fleet on a device mesh in one process (`sharded`,
         `sharded_fused`; run after Phase C, from Phase B's and C's
         results).  (a) Phase B's fleet and stream on `sharded_fused` over
         every visible card (``devices=0``: n_devices() equals the card
         count) and (b) over four partitions of card 0 (a device pool that
         repeats it; 1,024 packages a partition): exactly 8 × d and 32
         `fleet_step` launches, one host sync a flush, the flush records
         against Phase B's within the fleet gates (counters exact,
         freq_min / at_risk_frac 1e-3, the rest 1e-5), every window's
         per-lane temperatures and frequencies and the state bit-equal to
         `fused`'s; warm ms per flush of fused, (a) and (b) in turns,
         `run_block` per window and the kernel alone at 4,096 and 1,024
         packages; a 129-tile degraded-fallback fleet (wide layout) and a
         heterogeneous one of 4 × 250 packages, one window each, bit-equal.
         (c) `sharded` per step against broadcast on the four partitions,
         47 tiles × 4,096 over 256 steps: outputs and state bit-equal, step
         ms of both.  (d) `serve --stream ... --fleet-backend sharded_fused
         --fleet-devices 0` against Phase C's records, and `serve
         --montecarlo 2000 --fleet-backend sharded_fused` against fused's
         (per-trial statistics and the §10 lines equal), launches counted.
         (e) `FleetService` on the four partitions in Phase J's scenario
         (4,096 packages, four tenants, grow, canary, snapshot, restore),
         each flush record equal to a fused service's fed the same chunks
         (the per-tenant sums run in a fixed order), one
         device→host copy and one launch a partition a flush, the restored
         service bit-equal to the uninterrupted one, then the state moved
         from 4 partitions to 2 by `reshard_state` and two more flushes
         bit-equal.

Phase N  the fleet across processes (`repro_torch.distributed.multihost`;
         run after Phase M, from Phase B's, C's and M's results).  Two
         ranks of one process group on the card over gloo (NCCL refuses
         two ranks on one card), started by `multihost.run_process_group`:
         Phase B's fleet and trace, rebuilt in each rank from the seed,
         through `distributed_stream` on `sharded_fused` with each rank's
         pool the card once (sharded_fused[2dev/2proc]) and twice
         ([4dev/2proc]) — in every rank exactly 8 × its partitions
         `fleet_step` launches, one record fetch, one collective and the
         synchronizing calls of one device→host copy a flush; the records
         the same on every rank and within the fleet gates of Phase B's
         `fused` records (equality reported), the final state, assembled
         from both ranks, within 1e-5 of Phase B's (bit-equality
         reported); warm ms per flush per rank (the host clock between
         records) beside Phase M's `fused`, the bytes the flush's
         collective moves and that collective alone.
         Then `serve --stream --fleet-backend sharded_fused --distributed`
         on two ranks, each through `serve.main`'s argument parser with
         --coordinator / --num-processes / --process-id: one launch and one
         host sync a flush per rank, records the same on every rank and
         within the gates of Phase C's, flush lines from rank 0 alone.  A
         rank that fails ends the group and the script, non-zero.

Phase O  training on a (pod, data, model) mesh of gloo ranks on the card
         (`phase_o`): Gemma-2B at full width and depth on (data 1, model
         2) against its one-device step, its collectives counted by
         `launch.hlo_census` (output bytes a rank) and its peak device
         memory; the reduced families on (data 2, model 2); the compressed
         all-reduce; the kernels at the mesh's local shapes.

Phase P  the dry run (`launch.dryrun`, in a child process that owns a fake
         process group): (a) gemma-2b × train_4k on 16×16 and × decode_32k
         on 2×16×16 on "cuda" fake tensors; (b) Phase O's Gemma-2B step on
         a fake group of its two ranks — its census equal to Phase O's
         measured one by kind in count and bytes, its predicted peak within
         10 % of Phase O's measured peak; (c) each kernel's shape rule
         against the kernel at the local shapes (a) and Phase O met (shape,
         dtype, stride); (d) the roofline of Phase L's one-device step
         beside its warm step.

Phase Q  the four examples ported last, each through its `main` on the card
         at the reference example's sizes, every launcher of the kernels
         they reach capturing its first arguments at each new signature
         (`Capture`), each captured launch then made again beside its plain
         version (`hold_captured`).  (a) examples/torch_fleet_sim.py (512
         packages x 4 tiles, 48 steps) on every backend, per step and
         through `FleetEngine.run`: events 0, each backend's last
         temperatures and frequencies within 1e-5 of broadcast's and its
         records within the fleet gates, ms per step; `--stream` on fused
         (exactly one `fleet_step` launch a 6-step chunk, one host sync a
         flush) against the stream on broadcast; `--node n3` per step and
         streamed on both.  (b) examples/torch_thermal_dashboard.py, every
         panel's tensors on the card: α, β, R², the step response, Rth, η,
         panel 5's released compute, peaks and traces within 1e-5 of the
         same functions on the CPU on the same inputs; `--url`
         against `serve_http` on a free port over a `FleetService` on
         fused (two flushes, two launches).  (c) examples/torch_quickstart.py:
         Effect ① as on the CPU on the same trace (1e-5), no V24 event,
         finite losses, the flash launches of ten train steps exact by
         route.  (d) examples/torch_serve_batched.py: flash and ssd launches
         exact by route (one a layer a prefill), admissions as the CPU
         run's.  Each phase prints its seconds ([time]).

The line before the last is one JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without CUDA, or outside a checkout of the repository, it exits non-zero and
prints no result.  It catches nothing: any failed check ends the run.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the NVIDIA H100 SXM's data-sheet rates (`launch/roofline.py`): HBM3
# bandwidth, f32 outside the tensor cores, bf16 on the tensor cores (the
# least time for work whose inputs are bf16) and dense TF32 (an f32
# product split into three TF32 products, the ssd backward's 3×TF32, runs
# at a third of it)
try:
    from repro_torch.launch.roofline import HBM_BW as PEAK_BYTES_PER_S
    from repro_torch.launch.roofline import PEAK_F32_FLOPS as PEAK_F32_PER_S
    from repro_torch.launch.roofline import PEAK_FLOPS as PEAK_BF16_PER_S
    from repro_torch.launch.roofline import \
        PEAK_TF32_FLOPS as PEAK_TF32_PER_S
except ImportError as e:
    raise SystemExit(f"chip_smoke: FAIL: {e}: run from a checkout of the "
                     f"repository") from None
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
           "flash_attention_tc", "ssd", "fma_f32", "flash_attention_bwd",
           "flash_attention_bwd_tc", "ssd_bwd")
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
SERVE_ARGV = ["--batch", "8", "--prompt-len", "1024", "--gen", "16",
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
    its template arguments (``<2, true>``), after its own name where nvcc
    tagged it with an anonymous namespace (``dq_kernel <256, 256>``)."""
    import re

    from repro_torch.kernels import _build

    def args(mangled: str) -> str:
        vals = re.findall(r"L([ib])(\d+)E", mangled.split("kernelI", 1)[-1]
                          .split("Ev", 1)[0])
        return "<" + ", ".join(v if t == "i" else ("true" if v == "1" else
                                                    "false")
                               for t, v in vals) + ">"

    def base(mangled: str) -> str:
        """The kernel's own name (after nvcc's anonymous-namespace tag),
        or "" where the name has no such tag."""
        m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
        return (mangled[m.end():m.end() + int(m.group(1))] + " "
                if m else "")

    return "; ".join(
        f"{base(k)}{args(k)}: {u['registers']} registers, "
        f"{u['spill_stores']} B spill stores, {u['spill_loads']} B spill "
        f"loads"
        for k, u in sorted(_build.resource_usage(name).items())
        if kernel in k)


def compare(out, ref, where: str) -> float:
    """`fleet_step`'s outputs vs its plain version's: max abs error of the
    float planes (rtol = atol = 1e-5), events and latch exact."""
    import torch

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
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    dev = torch.device("cuda")
    t_start = time.perf_counter()

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
    seconds = {"0": time.perf_counter() - t_start}
    print(f"[phase0] built {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.2f} s")
    print(f"[time] phase 0 {seconds['0']:.1f} s")

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

    seconds["A-C"] = time.perf_counter() - t_start - seconds["0"]
    print(f"[time] phases A-C {seconds['A-C']:.1f} s")

    def run(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        print(f"[time] phase {name} {seconds[name]:.1f} s")
        return out

    mesh_entry = run("M", phase_m, dev, trace, flushed, state, res)
    proc_entry = run("N", phase_n, dev, flushed, state, res,
                     mesh_entry["ms_per_flush_mesh"]["fused"])
    mc_entry = run("I", phase_i, dev, compare)
    tc_entry = run("D", phase_d, dev)
    gc_entry = run("E", phase_e, dev)
    run("F", phase_f, dev, trace[peak * flush:(peak + 1) * flush])
    fa_entry, ssd_entry = run("G", phase_g, dev)
    run("H", phase_h, dev, fa_entry, ssd_entry)
    run("K", phase_k, dev, fa_entry, ssd_entry)
    fma_entry = run("J", phase_j, dev)
    fb_entries = run("L", phase_l, dev)
    mesh_entries = run("O", phase_o, dev, GEMMA_LOSS)
    run("P", phase_p, dev)
    q_launches = run("Q", phase_q, dev)
    print(f"[time] phases " + json.dumps(
        {k: round(v, 1) for k, v in seconds.items()})
        + f"; the whole run {time.perf_counter() - t_start:.1f} s")

    entries = [{
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
        **mesh_entry,
        **proc_entry,
    }, tc_entry, gc_entry, fa_entry, ssd_entry, fma_entry, *fb_entries,
        *mesh_entries]
    for entry in entries:
        entry["launches_phase_q"] = q_launches.get(entry["name"], 0)
    fa_entry["launches_phase_q_cuda_core"] = \
        q_launches["flash_attention_cuda_core"]
    print(json.dumps({"kernels": entries}))
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


# Phase K: this slice's kernel shapes — flash at
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
                         "16"], 8, "tensor_core", 0),
    ("deepseek-v2-236b", 4, ["--batch", "2", "--prompt-len", "1024",
                             "--gen", "16"], 4, "tensor_core", 0),
)
# the f32 checks: Mixtral's cut and prompt (past its 4,096-token window, so
# the ring wraps), DeepSeek-V2's cut and prompt
K_F32_MIXTRAL = (2, 4100)
K_F32_DEEPSEEK = (1, 128)
# MLA's flash before the tensor-core route for d ≠ dv: the CUDA-core kernel
# at MLA_FLASH in bf16 (NVIDIA H100 80GB HBM3, 700 W; PERF.md's kernel
# table)
MLA_CUDA_CORE_MS = 11.936


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

    # MLA: q/k head dim 192, v 128, the explicit scale, causal; bf16 on the
    # tensor-core route, f32 on the CUDA-core one
    B, T, H, d, dv = MLA_FLASH
    mla_scale = d ** -0.5                 # (dh + rd) ** -0.5, dh 128, rd 64
    mla = {}
    for dt, atol, want in ((f32, 2e-5, "cuda_core"),
                           (bf16, 2e-2, "tensor_core")):
        q, k, v = r(dt, B, T, H, d), r(dt, B, T, H, d), r(dt, B, T, H, dv)
        out, e, plain_ms = flash_k(f"MLA {dt}", q, k, v, want, atol,
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
          f"scale 192^-0.5, causal): max_abs_err vs plain {mla[f32][4]:.3e} "
          f"in f32 on the CUDA-core route (bound 2e-5), {e_mla:.3e} in bf16 "
          f"on the tensor-core route (bound 2e-2); bf16 kernel "
          f"{mla_ms:.4f} ms (median of 10, CUDA events; {MLA_CUDA_CORE_MS} "
          f"ms on the CUDA-core kernel before this route), plain "
          f"{mla_plain:.1f} ms (one run), "
          f"scaled_dot_product_attention {mla_lib:.4f} ms (|Δ| {d_lib:.2e} "
          f"vs the kernel); bound {mla_bound:.4f} ms by {mla_by} "
          f"({cost['bytes'] / 1e6:.1f} MB, {cost['ops'] / 1e9:.2f} GFLOP at "
          f"the bf16 peak)")
    mla_f32_err = mla[f32][4]
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
        library_ms_mla=mla_lib, max_abs_err_mla=e_mla,
        cuda_core_max_abs_err_mla_f32=mla_f32_err,
        launches_phase_k=total["flash"],
        launches_phase_k_cuda_core=total["cuda_core"])
    fa_entry["max_abs_err"] = max(fa_entry["max_abs_err"], e_mla)
    fa_entry["cuda_core_max_abs_err"] = max(
        fa_entry["cuda_core_max_abs_err"], mla_f32_err)
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
SVC_TILES, SVC_PACKAGES, SVC_WARM, SVC_FLUSH = 47, 1024, 2048, 256
SVC_TENANTS = ("acme", "zeta", "orion", "vega")
GROUP_COUNTS = {"pole": 256, "rom": 256, "grid": 16}
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
    # the same service again, ticked from the same state on the same chunk:
    # its records must be the same bits (the per-tenant sums run in a fixed
    # order, where index_add_'s float atomics reorder them run to run)
    twin = FleetService(cfg, backend="fused", flush_every=SVC_FLUSH,
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
        for s_ in (oracle, twin):
            s_.attach(f"pkg{i}", SVC_TENANTS[i % 4], KINDS[i % 4])
    torch.cuda.synchronize()
    attach_s = time.perf_counter() - t0
    _, per_copy = count_syncs(
        lambda: torch.ones(3, device=dev).cpu())
    check(per_copy >= 1, "sync debug mode saw no D2H copy")
    fs.fleet_step.launches = fma_f32.launches = 0
    ticks, worst, svc_fma, twin_launches = [], 0.0, 0, 0

    def tick(**kw):
        nonlocal worst, svc_fma, twin_launches
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
        twin.state = state0
        l0 = fs.fleet_step.launches
        again = twin.tick(chunk=rec["rho"])
        twin_launches += fs.fleet_step.launches - l0
        check(again["telemetry"] == rec["telemetry"]
              and again["tenants"] == rec["tenants"],
              f"flush {rec['flush']}: the same service run twice gives "
              f"other bits")
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
    for s in (svc, oracle, twin):          # n + 1 packages: grow to 2n
        plan = s.attach("extra", "acme", "training")["plan"]
        check(plan == "grow", f"attach past {n}: plan {plan}")
    tick()
    feed = np.full((SVC_FLUSH, nt), 2.6, np.float32)
    for s in (svc, oracle, twin):
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
        for s in (svc, oracle, twin):
            plan = s.detach(name)["plan"]
    check(plan == "shrink" and svc.registry.capacity == n,
          f"detach to {n // 2}: plan {plan}, capacity "
          f"{svc.registry.capacity}")
    detach_s = time.perf_counter() - t0
    final = tick()
    torch.cuda.synchronize()
    check(fs.fleet_step.launches - twin_launches == len(ticks),
          f"{fs.fleet_step.launches - twin_launches} fleet_step launches in "
          f"{len(ticks)} flushes")
    svc_launches = {"fleet_step": fs.fleet_step.launches - twin_launches,
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
          f"{n} attaches (each on the three services) {attach_s:.2f} s, the "
          f"fused service's with {attach_syncs} synchronizing calls, "
          f"{len(gone)} detaches "
          f"{detach_s:.2f} s; {len(ticks)} flushes, "
          f"{svc_launches['fleet_step']} fleet_step launches (1 a flush) "
          f"and {svc_launches['fma_f32']} fma_f32 launches, 1 D2H copy a "
          f"flush, each "
          f"record held to the broadcast service (worst rel "
          f"{worst:.2e}) and bit-equal to the same service's run again "
          f"from the same state; median host ms of the plain flushes "
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


# Phase L: the training slice.  The backward kernels' cases (what, B, Tq,
# Tk, H, KV, d, dv, dtype name, causal, window, q_offset: bf16 at the
# tensor-core pairs takes flash_attention_bwd_tc.cu, the rest
# flash_attention_bwd.cu, as `flash_route` says); the cases timed, by tag;
# the bounds on the gradients as a share of each gradient's largest
# magnitude (the CUDA-core kernel's first chip run measured at most 9.5e-7
# in f32 and 2.3e-3 in bf16); the train step's bounds kernels vs plain
# versions (probe: 1.7e-2 per bf16 leaf, loss 2e-5 relative); the driver's
# arguments; the depth of the checkpoint-and-resume run
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
     False, 0, 64),
    ("bf16 d 96 (no tensor-core pair)", 2, 300, 300, 4, 2, 96, 96,
     "bfloat16", True, 0, 0))
FLASH_BWD_TIMED = {"Gemma-2B training": "gemma", "Zamba2-7B": "zamba2",
                   "MLA": "mla", "the 100M example": "100m"}
# the backward before its tensor-core kernel: flash_attention_bwd.cu in
# bf16 at Gemma-2B's shape (NVIDIA H100 80GB HBM3, 700 W; PERF.md's kernel
# table)
FLASH_BWD_CUDA_CORE_MS = 12.130
FLASH_BWD_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
# the forward's output against its plain version (Phase G's bounds, the
# reference's tests/test_kernels.py)
FLASH_FWD_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
TRAIN_BF16_TOL = 5e-2
# At full depth in bf16 the ssd families' gradients move with rounding
# alone: the plain path against itself at ssd chunk 32 (the same sums in
# another order) differs by up to 0.33 of a leaf's largest magnitude at
# RWKV6-1.6B's 24 layers and 0.075 at 12 Zamba2-7B layers; in f32 kernels
# and plain versions agree within 1.3e-4 at 24 RWKV6 layers
# (scripts/ssd_train_limits.py).  So Phase L (g) gates the loss and the
# launches in bf16 at depth, and the gradients in f32 at the same depth
# within SSD_F32_DEPTH_TOL of each leaf's largest magnitude
SSD_F32_DEPTH_TOL = 1e-3
TRAIN_LOSS_TOL = 1e-3
GEMMA_LOSS = None      # Phase L (b)'s one-device Gemma-2B loss, for Phase O
TRAIN_F32_TOL = 1e-4
TRAIN_ARGV = ["--arch", "gemma-2b", "--batch", "8", "--seq", "1024",
              "--log-every", "1"]
TRAIN_STEPS = 4
CKPT_LAYERS = 1
EXAMPLE_ARGV = ["--steps", "20"]
# Phase L (f): the ssd backward against its plain version — (name, B, T, H,
# N, P, dtypes of d, b, x, c, include_current, u, h0, dhT, lowest decay):
# Zamba2-7B's and RWKV6-1.6B's training shapes in their bf16 runs' types,
# an f32 case with h0 and dhT, a ragged T (chunk 8) with P = 128
SSD_BWD_CASES = (
    ("Zamba2-7B", 8, 1024, 112, 64, 64,
     ("float32", "float32", "bfloat16", "bfloat16"), True, False, False,
     False, 0.55),
    ("RWKV6-1.6B", 8, 1024, 32, 64, 64,
     ("float32", "bfloat16", "bfloat16", "bfloat16"), False, True, False,
     False, 0.8),
    ("f32 h0 and dhT", 2, 1024, 8, 64, 64, ("float32",) * 4, True, False,
     True, True, 0.7),
    ("ragged T=1000, P=128", 2, 1000, 4, 64, 128, ("float32",) * 4, False,
     True, True, True, 0.9))
SSD_BWD_TIMED = {"Zamba2-7B": "zamba2", "RWKV6-1.6B": "rwkv6"}
SSD_BWD_TOL = {"float32": 1e-4, "bfloat16": 5e-3}
# the backward's kernels, as the profiler names them, by pass
SSD_BWD_PASSES = {"state_grad_kernel": "A", "chunk_grad_kernel": "B",
                  "du_sum_kernel": "C"}
# Phase L (g), (h): the ssd families train at full width; Zamba2-7B with its
# depth cut to the deepest multiple of attn_every that fits (42 and 48
# layers run out of memory in AdamW's f32 temporaries of the stacked [L,
# 3,584, 14,336] in_proj leaf: scripts/ssd_train_limits.py)
ZAMBA2_TRAIN_LAYERS = 36
SSD_TRAIN = (("rwkv6-1.6b", None), ("zamba2-7b", ZAMBA2_TRAIN_LAYERS))
# Phase L (g)'s depth for Zamba2-7B, cut from ZAMBA2_TRAIN_LAYERS for chip
# time: two shared-block groups (scripts/ssd_train_limits.py's depth)
ZAMBA2_GRAD_LAYERS = 12
SSD_GRAD = (("rwkv6-1.6b", None), ("zamba2-7b", ZAMBA2_GRAD_LAYERS))


@contextlib.contextmanager
def plain_grads():
    """`FlashAttention` and `SsdFunction` kept, their kernel branches on
    the card swapped for the plain versions (`flash_attention_stats_
    reference`, `flash_attention_backward_reference`, `ssd_reference` with
    its states, `ssd_backward_reference`): the train step's plain run."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as sm

    saved = (fa.flash_attention_stats, fa.flash_attention_backward,
             sm.ssd_states, sm.ssd_backward)

    def stats(q, k, v, **kw):
        o, m, l = fa.flash_attention_stats_reference(q, k, v, **kw)
        return o.to(q.dtype), o, m, l

    def backward(q, k, v, o, m, l, do, **kw):
        return fa.flash_attention_backward_reference(q, k, v, o, m, l,
                                                     do.contiguous(), **kw)

    def ssd_states(d, b, x, c, **kw):
        return sm.ssd_reference(d, b, x, c, states=True, **kw)

    def ssd_backward(d, b, x, c, u, h0, hs, dy, dhT, **kw):
        return sm.ssd_backward_reference(d, b, x, c, u, h0, hs,
                                         dy.contiguous(), dhT, **kw)
    fa.flash_attention_stats, fa.flash_attention_backward = stats, backward
    sm.ssd_states, sm.ssd_backward = ssd_states, ssd_backward
    try:
        yield
    finally:
        (fa.flash_attention_stats, fa.flash_attention_backward,
         sm.ssd_states, sm.ssd_backward) = saved


def train_launches(cfg) -> dict:
    """Kernel launches of one `loss_and_grads` of ``cfg`` under remat:
    flash forward and backward (attention blocks: 2 forward, the block
    and its recompute, and 1 backward a layer; the hybrid's shared block,
    not rematerialised: 1 and 1 an application) and ssd forward and
    backward (2 and 1 a Mamba2 / RWKV6 layer)."""
    L = cfg.n_layers
    if cfg.family == "hybrid":
        apps = L // cfg.attn_every
        return {"flash": apps, "flash_bwd": apps, "ssd": 2 * L,
                "ssd_bwd": L}
    if cfg.family == "ssm":
        return {"flash": 0, "flash_bwd": 0, "ssd": 2 * L, "ssd_bwd": L}
    return {"flash": 2 * L, "flash_bwd": L, "ssd": 0, "ssd_bwd": 0}


def reset_train_launches() -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as sm

    fa.reset_launches()
    sm.ssd.launches = sm.ssd_backward.launches = 0


def check_train_launches(cfg, route: str, steps: int, where: str) -> dict:
    """The flash launches since `reset_train_launches` all on ``route``,
    and every count ``steps`` times `train_launches`.  Returns the
    counts."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as sm

    want = {k: v * steps for k, v in train_launches(cfg).items()}
    got = {"flash": fa.flash_attention.launches,
           "flash_bwd": fa.flash_attention_backward.launches,
           "ssd": sm.ssd.launches, "ssd_bwd": sm.ssd_backward.launches}
    routes = dict(fa.flash_attention.launches_by_route)
    b_routes = dict(fa.flash_attention_backward.launches_by_route)
    check(got == want and routes[route] == want["flash"]
          and b_routes[route] == want["flash_bwd"],
          f"{where}: launches {got}, flash forward {routes}, backward "
          f"{b_routes}; want {want}, flash on the {route} route")
    return got


def grads_vs_plain(params, cfg, toks, labs, where: str, bound: float | None,
                   route: str) -> tuple[float, float]:
    """Loss and gradients of ``params`` on the kernels (exactly the
    launches `train_launches` counts, flash on ``route``) against the same
    call with FlashAttention and SsdFunction on their plain branches (no
    launch): the loss within TRAIN_LOSS_TOL relative, each gradient leaf
    within ``bound`` of its largest magnitude (with ``bound`` None the
    leaves' gap is printed, not gated).  Returns (loss, worst leaf
    share)."""
    import numpy as np
    import torch

    from repro_torch.launch import steps as S

    reset_train_launches()
    loss, _, g_k = S.loss_and_grads(params, cfg, toks, labs)
    torch.cuda.synchronize()
    n = check_train_launches(cfg, route, 1, where)
    with plain_grads():
        loss_p, _, g_p = S.loss_and_grads(params, cfg, toks, labs)
    torch.cuda.synchronize()
    check_train_launches(cfg, route, 1, f"{where} (the plain run launched "
                         f"a kernel)")
    lk, lp = float(loss), float(loss_p)
    check(np.isfinite(lk) and abs(lk - lp) <= TRAIN_LOSS_TOL * abs(lp),
          f"{where}: loss {lk} on the kernels, {lp} on the plain versions")
    worst = 0.0
    for i, (a, b) in enumerate(zip(g_k, g_p)):
        r = (float((a.float() - b.float()).abs().max())
             / max(float(b.float().abs().max()), 1e-30))
        check(np.isfinite(r) and (bound is None or r <= bound),
              f"{where}: gradient leaf {i} {list(a.shape)} differs by "
              f"{r:.3e} of its largest magnitude (bound {bound})")
        worst = max(worst, r)
    gate = (f"bound {bound}" if bound is not None else "not gated: bf16 "
            "rounding alone moves them this far at this depth, "
            "scripts/ssd_train_limits.py; the f32 run below holds them")
    print(f"[phaseL] {where}: loss {lk:.6f} on the kernels, {lp:.6f} on the "
          f"plain versions; launches {json.dumps(n)} (flash on the {route} "
          f"route), none in the plain run; the {len(g_k)} gradient "
          f"leaves within {worst:.3e} of their largest magnitude ({gate})")
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
    the idle share.  The kernel groups must hold exactly the launches
    `train_launches` counts: the flash forward kernel runs, one dQ pass a
    flash backward call (three or four kernels a call), the ssd forward
    kernel runs and one chunk-gradient pass an ssd backward call (three
    kernels a call with u, two without)."""
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
                                  "delta_kernel", "prep_kernel",
                                  "dkdv_sum_kernel")),
              ("ssd forward", ("ssd_kernel",)),
              ("ssd backward", ("state_grad_kernel", "chunk_grad_kernel",
                                "du_sum_kernel")),
              ("GEMM", ("gemm", "cutlass", "xmma", "nvjet", "sm90_")))
    ranges = ("loss_and_grads", "adamw_update")
    by = {k: 0.0 for k, _ in groups} | {"other": 0.0}
    runs = {k: 0 for k, _ in groups} | {"other": 0}
    span, other, dq_runs, chunk_runs = {}, {}, 0, 0
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
        dq_runs += e.count if "dq_kernel" in e.key else 0
        chunk_runs += e.count if "chunk_grad_kernel" in e.key else 0
        if k == "other":
            other[e.key[:50]] = other.get(e.key[:50], 0.0) + ms
    busy = sum(by.values())
    want = train_launches(cfg)
    got = {"flash": runs["flash forward"], "flash_bwd": dq_runs,
           "ssd": runs["ssd forward"], "ssd_bwd": chunk_runs}
    check(busy == 0.0 or got == want, f"profiled train step: kernel runs "
          f"{got}, want {want}")
    if busy == 0.0:
        print(f"[phaseL] profiled train step: the profiler recorded no "
              f"device time (breakdown not measured); host clock "
              f"{wall:.1f} ms")
        return
    top = sorted(other.items(), key=lambda kv: -kv[1])[:4]
    print(f"[phaseL] {cfg.name} train step ({cfg.dtype}, {cfg.n_layers} "
          f"layers, batch {list(toks.shape)}; torch.profiler): host clock "
          f"{wall:.1f} ms, device busy "
          f"{busy:.1f} ms (idle share {1 - busy / wall:.3f}); by group (ms): "
          + json.dumps({k: round(v, 3) for k, v in by.items()})
          + "; the AdamW update's span on the device "
          f"{span.get('adamw_update', float('nan')):.3f} ms; largest other: "
          + json.dumps({k: round(v, 3) for k, v in top}))


def phase_l(dev) -> list:
    """Training: the flash backward kernels, Gemma-2B's gradients on the
    kernels vs the plain versions, the train driver with checkpoint and
    resume, the 100M example; then the ssd backward kernel and the states
    forward, RWKV6-1.6B's and the Zamba2-7B cut's gradients and their
    driver runs."""
    import dataclasses
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

    # ---- (a) the statistics output and both backward kernels
    worst_abs = dict.fromkeys(fa.ROUTES, 0.0)
    worst_rel = {r: {"float32": 0.0, "bfloat16": 0.0} for r in fa.ROUTES}
    timing = {}

    def time_bwd(tag, what, q, k, v, po, pm, pl, do, kw):
        """The backward at one case's shape: kernel, plain version, SDPA's
        backward (enable_gqa; the yardstick) and the bound."""
        B, Tq, H, d = q.shape
        KV, dv = k.shape[2], v.shape[-1]
        route = fa.flash_route("cuda", q.dtype, k.dtype, d, dv)
        ms = event_ms(lambda: fa.flash_attention_backward(
            q, k, v, po, pm, pl, do, **kw), 5)
        plain_ms = timed(lambda: fa.flash_attention_backward_reference(
            q, k, v, po, pm, pl, do, **kw))[1]
        qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        lib_o = F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=kw["causal"], enable_gqa=True)
        lib_ms = event_ms(lambda: torch.autograd.grad(
            lib_o, (qs, ks, vs), do.transpose(1, 2), retain_graph=True), 5)
        cost = fa.flash_attention_backward_cost(q, k, v, **kw)
        peak = PEAK_BF16_PER_S if q.dtype == torch.bfloat16 else \
            PEAK_F32_PER_S
        b_ms, b_by = bound(cost["bytes"], cost["ops"], peak)
        timing[tag] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by)
        before = (f"; {FLASH_BWD_CUDA_CORE_MS} ms on the CUDA-core kernel "
                  f"before the tensor-core one" if tag == "gemma" else "")
        print(f"[phaseL] flash_attention_backward {what} [{B}, {Tq}, {H} on "
              f"{KV}, {d}/{dv}] {q.dtype} causal on the {route} route: "
              f"kernel {ms:.4f} ms (median of 5, CUDA events; one "
              f"call{before}), plain {plain_ms:.1f} ms (one run), "
              f"scaled_dot_product_attention's backward (enable_gqa) "
              f"{lib_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by} "
              f"({cost['bytes'] / 1e6:.1f} MB, {cost['ops'] / 1e9:.2f} GFLOP "
              f"over {cost['pairs']} kept pairs per head, at the "
              f"{'bf16' if peak == PEAK_BF16_PER_S else 'f32'} peak)")
        del qs, ks, vs, lib_o

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
        before = fa.flash_attention_backward.launches_by_route[route]
        g1 = fa.flash_attention_backward(q, k, v, po, pm, pl, do, **kw)
        g2 = fa.flash_attention_backward(q, k, v, po, pm, pl, do, **kw)
        torch.cuda.synchronize()
        check(fa.flash_attention_backward.launches_by_route[route]
              == before + 2, f"phase L {what}: backward not on the {route} "
              f"route")
        check(all(torch.equal(a, b) for a, b in zip(g1, g2)),
              f"phase L {what}: two backward launches differ")
        gp = fa.flash_attention_backward_reference(q, k, v, po, pm, pl, do,
                                                   **kw)
        rels, flips = [], []
        for name, a, b in zip(("dq", "dk", "dv"), g1, gp):
            flips.append(float((a != b).float().mean()))
            a, b = a.float(), b.float()
            check(bool(torch.isfinite(a).all()), f"phase L {what}: {name} "
                  f"not finite")
            diff = float((a - b).abs().max())
            rel = diff / max(float(b.abs().max()), 1e-30)
            check(rel <= FLASH_BWD_TOL[dt], f"phase L {what}: {name} differs "
                  f"from the plain backward by {rel:.3e} of its largest "
                  f"magnitude (bound {FLASH_BWD_TOL[dt]})")
            worst_abs[route] = max(worst_abs[route], diff)
            rels.append(rel)
        worst_rel[route][dt] = max(worst_rel[route][dt], *rels)
        print(f"[phaseL] {what} [{B}, {Tq}/{Tk}, {H} on {KV}, {d}/{dv}] {dt} "
              f"causal {causal} window {w} q_offset {off}: forward with "
              f"statistics on the {route} route, o_f32 within {e_o:.3e}, m "
              f"{e_m:.2e}, l {e_l:.2e} of the plain ones ({int(empty.sum())} "
              f"rows without keys), output bit-equal to the serving launch; "
              f"backward on the {route} route: dq/dk/dv within "
              + "/".join(f"{x:.2e}" for x in rels)
              + f" of their largest magnitude (bound {FLASH_BWD_TOL[dt]}; "
              f"elements that differ from the plain version's "
              + "/".join(f"{x:.2e}" for x in flips)
              + "), the same bits on two launches")
        if what in FLASH_BWD_TIMED:
            tag = FLASH_BWD_TIMED[what]
            time_bwd(tag, what, q, k, v, po, pm, pl, do, kw)
            if tag == "gemma":
                fwd_ms = event_ms(lambda: fa.flash_attention_stats(
                    q, k, v, **kw), 10)
                serve_ms = event_ms(lambda: fa.flash_attention(q, k, v, **kw),
                                    10)
                print(f"[phaseL] at Gemma-2B's shape: the forward with "
                      f"statistics {fwd_ms:.4f} ms, the serving forward "
                      f"{serve_ms:.4f} ms (medians of 10, CUDA events)")
    del q, k, v, do, o, m, l, po, pm, pl, g1, g2, gp
    torch.cuda.empty_cache()
    print(f"[phaseL] flash_attention_bwd_tc.cu (nvcc -Xptxas -v): "
          f"{registers('flash_attention_bwd_tc')}")
    print(f"[phaseL] flash_attention_bwd.cu (nvcc -Xptxas -v): "
          f"{registers('flash_attention_bwd')}")

    # ---- (b) Gemma-2B at full width and depth, bf16: kernels vs plain
    cfg = get_arch("gemma-2b")
    toks, labs = train_batch(dev, cfg, 21)
    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    global GEMMA_LOSS
    GEMMA_LOSS, _ = grads_vs_plain(
        params, cfg, toks, labs, "Gemma-2B bf16 [8 x 1,024] full width and "
        "depth", TRAIN_BF16_TOL, "tensor_core")
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
        dict(fa.flash_attention_backward.launches_by_route)
    check(fwd == {"tensor_core": 2 * L * n, "cuda_core": 0}
          and bwd == {"tensor_core": L * n, "cuda_core": 0}
          and fa.flash_attention_backward.launches == L * n,
          f"train: forward launches {fwd}, backward {bwd}; want "
          f"{2 * L * n} and {L * n} on the tensor-core route")
    bwd_main = bwd["tensor_core"]
    check(len(res["losses"]) == n and all(np.isfinite(res["losses"])),
          f"train: losses {res['losses']}")
    global GEMMA_STEP_MS
    GEMMA_STEP_MS = res["warm_step_ms"]
    print(f"[phaseL] python -m repro_torch.launch.train {' '.join(argv)} "
          f"(bf16, full width and depth): losses "
          f"{json.dumps([round(x, 4) for x in res['losses']])}; warm step "
          f"{res['warm_step_ms']:.1f} ms (median of {n - 1}, host clock "
          f"after a synchronize; per step "
          f"{json.dumps([round(x, 1) for x in res['step_ms']])}), "
          f"{res['tok_s']:,.0f} tok/s, peak device memory "
          f"{res['peak_bytes'] / 2**30:.2f} GiB; launches a step: "
          f"{2 * L} forward and {L} backward, all on the tensor-core route "
          f"(exactly {fwd['tensor_core']} and {bwd_main} in {n} steps)")
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
    example = load_example("torch_train_100m")
    L = example.config().n_layers
    n = int(EXAMPLE_ARGV[EXAMPLE_ARGV.index("--steps") + 1])
    fa.reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        first_loss, last_loss = example.main(EXAMPLE_ARGV
                                             + ["--ckpt-dir", tmp])
    fwd, bwd = dict(fa.flash_attention.launches_by_route), \
        dict(fa.flash_attention_backward.launches_by_route)
    check(fwd == {"tensor_core": 0, "cuda_core": 2 * L * n}
          and bwd == {"tensor_core": 0, "cuda_core": L * n}
          and fa.flash_attention_backward.launches == L * n,
          f"100M example: forward launches {fwd}, backward {bwd}")
    check(np.isfinite(last_loss) and last_loss < first_loss,
          f"100M example: loss {first_loss} -> {last_loss} did not fall")
    print(f"[phaseL] examples/torch_train_100m.py {' '.join(EXAMPLE_ARGV)} "
          f"(f32): loss {first_loss:.4f} -> {last_loss:.4f}; "
          f"{2 * L} forward and {L} backward launches a step on the CUDA-core "
          f"route; {time.perf_counter() - t0:.1f} s")

    ssd_entry = phase_l_ssd(dev)
    print(f"[phaseL] phase L {time.perf_counter() - t_phase:.1f} s")
    tc, cc = worst_rel["tensor_core"], worst_rel["cuda_core"]
    return [{"name": "flash_attention_bwd_tc", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_tc.cu",
             "replaces": "src/repro/kernels/ref.py:201",
             "launches": bwd_main, "max_abs_err": worst_abs["tensor_core"],
             "max_rel_err_bf16": tc["bfloat16"], **timing["gemma"],
             "shape": "gemma-2b [8, 1024, 8 on 1, 256] bf16",
             **{f"{k}_{tag}": val for tag in ("zamba2", "mla")
                for k, val in timing[tag].items()}},
            {"name": "flash_attention_backward", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             "replaces": "src/repro/kernels/ref.py:201",
             "launches": bwd["cuda_core"],
             "max_abs_err": worst_abs["cuda_core"],
             "max_rel_err_f32": cc["float32"],
             "max_rel_err_bf16": cc["bfloat16"], **timing["100m"],
             "shape": "the 100M example [8, 256, 10 on 5, 64] f32"},
            ssd_entry]


def ssd_bwd_inputs(dev, case):
    """(d, b, x, c, u, h0, dy, dhT) on ``dev`` for one row of
    `SSD_BWD_CASES`, from seed 22: d uniform in [lowest decay, 0.999],
    b and c 0.2·N(0, 1), x, dy, h0, dhT N(0, 1), u 0.1·N(0, 1), each in
    the row's dtype (dy in x's)."""
    import torch

    _, B, T, H, N, P, dts, _, use_u, use_h0, use_dhT, lo = case
    dt = [getattr(torch, t) for t in dts]
    g = torch.Generator(device=dev).manual_seed(22)
    r = lambda *sh: torch.randn(sh, generator=g, device=dev)
    d = (lo + (0.999 - lo) * torch.rand((B, T, H, N), generator=g,
                                        device=dev)).to(dt[0])
    b, x, c = (0.2 * r(B, T, H, N)).to(dt[1]), r(B, T, H, P).to(dt[2]), \
        (0.2 * r(B, T, H, N)).to(dt[3])
    u = 0.1 * r(H, N) if use_u else None
    h0 = r(B, H, N, P) if use_h0 else None
    dy = r(B, T, H, P).to(dt[2])
    dhT = r(B, H, N, P) if use_dhT else None
    return d, b, x, c, u, h0, dy, dhT


def kernel_ms(fn, reps: int = 5) -> dict:
    """Device ms per call of ``fn`` in each CUDA kernel it launches, by the
    kernel's own name (torch.profiler over ``reps`` calls after one warm
    call); empty where the profiler records no device time."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = re.search(r"(\w+_kernel)", e.key)
        k = m.group(1) if m else e.key[:40]
        out[k] = out.get(k, 0.0) + e.self_device_time_total / 1e3 / reps
    return out


def ssd_bwd_pass_times() -> dict:
    """{row: {pass: device ms a call}} of the ssd backward at the
    `SSD_BWD_TIMED` rows of `SSD_BWD_CASES`, by torch.profiler
    (`kernel_ms`)."""
    import torch

    from repro_torch.kernels import ssm_scan as sm

    dev, out = torch.device("cuda"), {}
    for case in SSD_BWD_CASES:
        if case[0] not in SSD_BWD_TIMED:
            continue
        d, b, x, c, u, h0, dy, dhT = ssd_bwd_inputs(dev, case)
        inc = case[7]
        hs = sm.ssd_states(d, b, x, c, u=u, h0=h0, include_current=inc)[2]
        ms = kernel_ms(lambda: sm.ssd_backward(
            d, b, x, c, u, h0, hs, dy, dhT,
            chunk=sm.chunk_for(d.shape[1], 64), include_current=inc))
        out[case[0]] = {SSD_BWD_PASSES[k]: v for k, v in ms.items()
                        if k in SSD_BWD_PASSES}
    return out


def ssd_bwd_pass_ms() -> dict:
    """`ssd_bwd_pass_times` in a Python process of its own: in this one,
    after the earlier phases' profiler sessions, torch.profiler has
    recorded only part of the passes' kernels, or none."""
    code = (f"import json, sys; sys.path[:0] = "
            f"{[str(ROOT), str(ROOT / 'src')]!r}; import chip_smoke; "
            f"print(json.dumps(chip_smoke.ssd_bwd_pass_times()))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    check(r.returncode == 0,
          f"phase L ssd backward passes: {r.stderr[-2000:]}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    check(all(set(v) >= {"A", "B"} for v in out.values()),
          f"phase L ssd backward passes: the profiler recorded {out}")
    return out


def phase_l_ssd(dev) -> dict:
    """Training the ssd families (Phase L (f)–(h)): the ssd backward kernel
    and the forward's states variant against their plain versions,
    RWKV6-1.6B's and the Zamba2-7B cut's gradients on the kernels vs the
    plain versions, and the driver for each.  Returns the kernels line's
    ssd_backward entry."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ssm_scan as sm
    from repro_torch.launch import train
    from repro_torch.models import transformer as tf

    t_phase = time.perf_counter()
    # ---- (f) the ssd backward kernel and the forward's states variant
    pass_ms = ssd_bwd_pass_ms()
    leaves = ("dd", "db", "dx", "dc", "du", "dh0")
    ssd_rel, ssd_abs, ssd_timing = dict.fromkeys(leaves, 0.0), 0.0, {}
    for case in SSD_BWD_CASES:
        (what, B, T, H, N, P, dts, inc, use_u, use_h0, use_dhT,
         lo) = case
        d, b, x, c, u, h0, dy, dhT = ssd_bwd_inputs(dev, case)
        kw = dict(u=u, h0=h0, include_current=inc)
        ck = sm.chunk_for(T, 64)
        bkw = dict(chunk=ck, include_current=inc)
        before = sm.ssd.launches
        y, hT, hs = sm.ssd_states(d, b, x, c, **kw)
        ys, hTs = sm.ssd(d, b, x, c, **kw)
        torch.cuda.synchronize()
        check(sm.ssd.launches == before + 2, f"phase L ssd {what}: "
              f"{sm.ssd.launches - before} forward launches, want 2")
        check(torch.equal(y, ys) and torch.equal(hT, hTs), f"phase L ssd "
              f"{what}: the states launch's y or hT differs from the "
              f"serving launch's")
        hs_p = sm.ssd_reference(d, b, x, c, chunk=ck, states=True, **kw)[2]
        e_hs = float((hs - hs_p).abs().max() / hs_p.abs().max())
        check(e_hs <= SSD_BWD_TOL["float32"], f"phase L ssd {what}: the "
              f"chunk states differ by {e_hs:.3e} of their largest "
              f"magnitude")
        before = sm.ssd_backward.launches
        g1 = sm.ssd_backward(d, b, x, c, u, h0, hs, dy, dhT, **bkw)
        g2 = sm.ssd_backward(d, b, x, c, u, h0, hs, dy, dhT, **bkw)
        torch.cuda.synchronize()
        check(sm.ssd_backward.launches == before + 2, f"phase L ssd "
              f"{what}: {sm.ssd_backward.launches - before} backward "
              f"launches, want 2")
        check(all(a is None or torch.equal(a, a2) for a, a2 in zip(g1, g2)),
              f"phase L ssd {what}: two backward launches differ")
        gp = sm.ssd_backward_reference(d, b, x, c, u, h0, hs, dy, dhT, **bkw)
        rels = []
        for name, a, w in zip(leaves, g1, gp):
            if w is None:
                check(a is None, f"phase L ssd {what}: {name} without u")
                continue
            tol = SSD_BWD_TOL[str(a.dtype).split(".")[-1]]
            check(a.dtype == w.dtype and bool(torch.isfinite(a).all()),
                  f"phase L ssd {what}: {name} {a.dtype}, not finite or "
                  f"not {w.dtype}")
            diff = float((a.float() - w.float()).abs().max())
            rel = diff / max(float(w.float().abs().max()), 1e-30)
            check(rel <= tol, f"phase L ssd {what}: {name} differs from the "
                  f"plain backward by {rel:.3e} of its largest magnitude "
                  f"(bound {tol})")
            ssd_rel[name] = max(ssd_rel[name], rel)
            ssd_abs = max(ssd_abs, diff)
            rels.append(f"{name} ({str(a.dtype)[6:]}) {rel:.2e}")
        print(f"[phaseL] ssd {what} [{B}, {T}, {H}, {N}/{P}] chunk {ck} "
              f"{'/'.join(dts)} include_current {inc} u {use_u} h0 "
              f"{use_h0} dhT {use_dhT}: the states forward's y and hT "
              f"bit-equal to the serving launch's, its states within "
              f"{e_hs:.2e}; backward within " + ", ".join(rels)
              + f" of each leaf's largest magnitude (bounds f32 "
              f"{SSD_BWD_TOL['float32']}, bf16 {SSD_BWD_TOL['bfloat16']}), "
              f"the same bits on two launches")
        if what in SSD_BWD_TIMED:
            ms = event_ms(lambda: sm.ssd_backward(d, b, x, c, u, h0, hs, dy,
                                                  dhT, **bkw), 5)
            plain_ms = timed(lambda: sm.ssd_backward_reference(
                d, b, x, c, u, h0, hs, dy, dhT, **bkw))[1]
            cost = sm.ssd_backward_cost(d, b, x, c, u, dhT,
                                        include_current=inc)
            # the products on the tensor cores in 3×TF32: a third of the
            # TF32 peak; the f32 CUDA-core bound beside it
            b_ms, b_by = bound(cost["bytes"], cost["ops"],
                               PEAK_TF32_PER_S / 3)
            f32_ms, f32_by = bound(cost["bytes"], cost["ops"])
            passes = pass_ms[what]
            res = sm.ssd_backward_resources(P, d.dtype, c.dtype, x.dtype)
            fwd_ms = event_ms(lambda: sm.ssd(d, b, x, c, **kw), 10)
            st_ms = event_ms(lambda: sm.ssd_states(d, b, x, c, **kw), 10)
            ssd_timing[SSD_BWD_TIMED[what]] = dict(
                ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by, bound_f32_ms=f32_ms,
                pass_ms=passes, resources=res)
            print(f"[phaseL] ssd_backward at {what}'s shape: kernel "
                  f"{ms:.4f} ms (median of 5, CUDA events; three launches a "
                  f"call with u, two without), by pass (torch.profiler, "
                  f"device ms a call, in a process of its own): "
                  + json.dumps({k: round(v, 4) for k, v in passes.items()})
                  + f"; route: the tensor cores, 3×TF32 (mma.sync "
                  f"m16n8k8; the only route); shared bytes and blocks an "
                  f"SM by pass: {json.dumps(res)}; plain {plain_ms:.1f} ms "
                  f"(one run), no library call; bound {b_ms:.4f} ms by "
                  f"{b_by} ({cost['bytes'] / 1e6:.1f} MB, "
                  f"{cost['ops'] / 1e9:.2f} GFLOP at a third of the TF32 "
                  f"peak; at the f32 CUDA-core peak {f32_ms:.4f} ms by "
                  f"{f32_by}); the forward {fwd_ms:.4f} ms serving, "
                  f"{st_ms:.4f} ms with its states (medians of 10)")
        del d, b, x, c, u, h0, dy, dhT, y, hT, hs, ys, hTs, hs_p, g1, g2, gp
    torch.cuda.empty_cache()
    print(f"[phaseL] ssd_bwd.cu (nvcc -Xptxas -v): {registers('ssd_bwd')}")

    # ---- (g) RWKV6-1.6B at full depth and the Zamba2-7B cut: the kernels
    # vs the plain versions — bf16 at full width (the loss and the
    # launches; the gradients' gap printed), then f32 at the fewest layers
    # that run every block kind (RWKV6: 2; Zamba2: one shared-block
    # application, attn_every layers) and at the bf16 run's depth
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch, layers in SSD_GRAD:
        full = get_arch(arch)
        cfg_s = dataclasses.replace(full, n_layers=layers or full.n_layers)
        toks, labs = train_batch(dev, cfg_s, 23)
        params = tf.init_params(torch.Generator(device=dev).manual_seed(0),
                                cfg_s)
        grads_vs_plain(params, cfg_s, toks, labs, f"{arch} bf16 [8 x 1,024] "
                       f"full width, {cfg_s.n_layers} of {full.n_layers} "
                       f"layers", None, "tensor_core")
        del params
        torch.cuda.empty_cache()
        shallow = cfg_s.attn_every if cfg_s.family == "hybrid" else 2
        for n_layers, tol in ((shallow, TRAIN_F32_TOL),
                              (cfg_s.n_layers, SSD_F32_DEPTH_TOL)):
            cfg32 = dataclasses.replace(cfg_s, dtype="float32",
                                        n_layers=n_layers)
            params = tf.init_params(
                torch.Generator(device=dev).manual_seed(0), cfg32)
            grads_vs_plain(params, cfg32, toks, labs, f"{arch} f32 [8 x "
                           f"1,024] full width, {n_layers} of "
                           f"{full.n_layers} layers", tol, "cuda_core")
            del params
            torch.cuda.empty_cache()
        del toks, labs

    # ---- (h) the driver for each ssd family, bf16, batch 8 x 1,024
    ssd_driver = {}
    saved_get = train.get_arch
    for arch, layers in SSD_TRAIN:
        if layers:
            train.get_arch = lambda name, k=layers: dataclasses.replace(
                saved_get(name), n_layers=k)
        cfg_s = train.get_arch(arch)
        argv = (["--arch", arch] + TRAIN_ARGV[2:]
                + ["--steps", str(TRAIN_STEPS)])
        torch.cuda.synchronize()
        reset_train_launches()
        try:
            res = train.main(argv)
        finally:
            train.get_arch = saved_get
        torch.cuda.synchronize()
        n = check_train_launches(cfg_s, "tensor_core", TRAIN_STEPS,
                                 f"train {arch}")
        check(len(res["losses"]) == TRAIN_STEPS
              and all(np.isfinite(res["losses"])),
              f"train {arch}: losses {res['losses']}")
        cut = (f"{cfg_s.n_layers} of {get_arch(arch).n_layers} layers (the "
               f"depth cut to fit 80 GB)" if layers else "full depth")
        print(f"[phaseL] python -m repro_torch.launch.train {' '.join(argv)} "
              f"(bf16, full width, {cut}): losses "
              f"{json.dumps([round(v, 4) for v in res['losses']])}; warm step "
              f"{res['warm_step_ms']:.1f} ms (median of {TRAIN_STEPS - 1}, "
              f"host clock after a synchronize; per step "
              f"{json.dumps([round(v, 1) for v in res['step_ms']])}), "
              f"{res['tok_s']:,.0f} tok/s, peak device memory "
              f"{res['peak_bytes'] / 2**30:.2f} GiB; launches in "
              f"{TRAIN_STEPS} steps {json.dumps(n)} (flash on the "
              f"tensor-core route), exactly {json.dumps(train_launches(cfg_s))}"
              f" a step")
        profile_train_step(dev, cfg_s, res["state"], 8)
        ssd_driver[arch] = n
        del res
        torch.cuda.empty_cache()
    print(f"[phaseL] (f)-(h) {time.perf_counter() - t_phase:.1f} s")
    return {"name": "ssd_backward", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssd_bwd.cu",
           "replaces": "src/repro/kernels/ref.py:283",
           "launches": ssd_driver["zamba2-7b"]["ssd_bwd"],
           "max_abs_err": ssd_abs,
           **{f"max_rel_err_{k}": v for k, v in ssd_rel.items()},
           **ssd_timing["zamba2"],
           "shape": "zamba2-7b [8, 1024, 112, 64/64] f32 d/b, bf16 c/x",
           "launches_rwkv6": ssd_driver["rwkv6-1.6b"]["ssd_bwd"],
           **{f"{k}_rwkv6": val for k, val in ssd_timing["rwkv6"].items()}}


# Phase M: the fleet on a device mesh in one process.  The mesh of (b) and
# (e): four partitions of the one card (a pool repeating cuda:0); the steps
# of (c); the 129-tile degraded-fallback fleet (wide layout) and the
# heterogeneous fleet of 4 × 250 packages (a partition not a multiple of the
# warp's 32) checked over one window each
MESH_POOL = 4
MESH_STEPS = 256
MESH_WIDE = (129, 512)
MESH_HET = (47, 1000)


def telemetry_gate(got: dict, want: dict, where: str) -> float:
    """Two flush records' telemetry: counters exact, freq_min / at_risk_frac
    within 1e-3, the rest within 1e-5 (|Δ| ≤ 1e-5 + 1e-5·|b|); returns the
    worst relative difference of the 1e-5 fields."""
    exact = ("n_packages", "events_total", "events_step", "degraded_count")
    worst = 0.0
    for k, b in want.items():
        a = got[k]
        if k in exact:
            check(a == b, f"{where}: {k} {a} vs {b}")
            continue
        tol = 1e-3 if k in ("freq_min", "at_risk_frac") else 1e-5
        check(abs(a - b) <= tol + tol * abs(b), f"{where}: {k} {a} vs {b}")
        if tol == 1e-5:
            worst = max(worst, abs(a - b) / max(abs(b), 1e-9))
    return worst


def states_equal(a, b) -> bool:
    """Two fleet states (whole or partitioned), every leaf bit for bit."""
    import torch

    from repro_torch.distributed import gather

    def leaves(x):
        if x is None:
            return []
        if isinstance(x, tuple):
            return [y for v in x for y in leaves(v)]
        return [x]
    la, lb = leaves(gather(a)), leaves(gather(b))
    return len(la) == len(lb) and all(
        torch.equal(x.cpu(), y.cpu()) for x, y in zip(la, lb))


def phase_m(dev, trace, b_flushed, b_state, c_res) -> dict:
    """The fleet on a device mesh in one process (`sharded` /
    `sharded_fused`): Phase B's stream on every card and on four
    partitions of this one, against `fused` bit for bit with its launches
    counted; `sharded` per step against broadcast; the serving entry
    points; the resident service with `reshard_state`."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.core import nodebank
    from repro_torch.core.scheduler import SchedulerConfig, ThermalScheduler
    from repro_torch.core.workload import KINDS
    from repro_torch.distributed import (FLEET_AXIS, fleet_mesh,
                                         reshard_state)
    from repro_torch.fleet import (FleetEngine, FleetService, chunk_source,
                                   stream)
    from repro_torch.fleet.backends.fused import FusedBackend
    from repro_torch.kernels import fleet_step as fs
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    pool = [dev] * MESH_POOL
    n_tiles, n = trace.shape[2], trace.shape[1]
    flush = 256
    windows = trace.shape[0] // flush
    cfg = SchedulerConfig(n_tiles=n_tiles, mode="v24")
    fused = FleetEngine(cfg, backend="fused", device=dev)
    meshes = {
        "a": FleetEngine(cfg, backend="sharded_fused", device=dev,
                         devices=0),
        "b": FleetEngine(cfg, backend="sharded_fused", device=dev,
                         device_pool=pool)}
    parts = {"a": n_cards, "b": MESH_POOL}
    out = {}
    for tag, eng in meshes.items():
        # ---- (a) every visible card, (b) four partitions of card 0: the
        # main path's stream, launches counted around it alone
        state0 = eng.init(n)
        d = eng.backend_impl.n_devices()
        check(d == parts[tag], f"phase M ({tag}): {d} partitions, want "
              f"{parts[tag]} ({eng.backend_impl.describe()})")
        torch.cuda.synchronize()
        fs.fleet_step.launches = 0
        state, flushed, stats = stream(eng, state0,
                                       chunk_source(trace, flush))
        torch.cuda.synchronize()
        launches = fs.fleet_step.launches
        check(launches == windows * d,
              f"phase M ({tag}): {launches} fleet_step launches, want "
              f"{windows} x {d}")
        check(stats.flushes == stats.host_syncs == windows,
              f"phase M ({tag}): {stats.flushes} flushes, "
              f"{stats.host_syncs} host syncs")
        worst = max(telemetry_gate(g, w, f"phase M ({tag}) flush {i}")
                    for i, (g, w) in enumerate(zip(flushed, b_flushed)))
        same = flushed == b_flushed
        check(states_equal(state, b_state),
              f"phase M ({tag}): final state differs from fused's")
        # per-lane traces, window by window, against fused's
        sf, sm = fused.init(n), eng.init(n)
        for w in range(windows):
            chunk = trace[w * flush:(w + 1) * flush]
            sf, tf, ff = fused.block_traces(sf, fused.backend_impl.put_trace(
                chunk))
            sm, tm, fm = eng.block_traces(sm, eng.backend_impl.put_trace(
                chunk))
            check(torch.equal(tm, tf) and torch.equal(fm, ff),
                  f"phase M ({tag}) window {w}: per-lane traces differ "
                  f"from fused's")
        check(states_equal(sm, sf), f"phase M ({tag}): state differs")
        out[tag] = {"describe": eng.backend_impl.describe(),
                    "partitions": d, "launches": launches,
                    "records_equal": same, "worst_rel": worst}
        print(f"[phaseM] ({tag}) {eng.backend_impl.describe()}: Phase B's "
              f"stream ({n} x {n_tiles}, {windows} flushes of {flush}), "
              f"{launches} fleet_step launches ({windows} x {d}), "
              f"{stats.host_syncs} host syncs; per-lane temps, freqs and "
              f"state bit-equal to fused in every window; flush records "
              f"{'equal' if same else 'within the gates'} (worst rel "
              f"{worst:.2e})")
        del sf, sm, tf, ff, tm, fm

    # warm ms per flush: the whole stream, host clock after a synchronize,
    # fused and the two meshes in turns (f, a, b, b, a, f)
    def stream_ms(eng) -> float:
        st = eng.init(n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stream(eng, st, chunk_source(trace, flush))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / windows

    engines = {"fused": fused, **meshes}
    runs = {k: [] for k in engines}
    for k in ("fused", "a", "b", "b", "a", "fused"):
        runs[k].append(stream_ms(engines[k]))
    # one window's run_block from the warm state of flush 4 (CUDA events,
    # median of 10): one launch on fused, one a partition on the meshes
    peak = min(3, windows - 1)
    window_ms = {}
    for k, eng in engines.items():
        st = eng.init(n)
        for w in range(peak):
            st = eng.backend_impl.run_block(st, eng.backend_impl.put_trace(
                trace[w * flush:(w + 1) * flush]))[0]
        chunk = eng.backend_impl.put_trace(
            trace[peak * flush:(peak + 1) * flush])
        eng.backend_impl.run_block(st, chunk)
        window_ms[k] = event_ms(lambda: eng.backend_impl.run_block(st, chunk),
                                10)
    # the kernel alone on the same window: one launch over the whole fleet
    # and one over a quarter of it (a partition of (b))
    launch_ms = {}
    for m in (n, n // MESH_POOL):
        be = FusedBackend(ThermalScheduler(cfg, device=dev))
        _, _, args, kwargs = warm_window(be, be.init(m), trace[:, :m], flush,
                                         peak)
        fs.fleet_step(*args, **kwargs)
        launch_ms[m] = event_ms(lambda: fs.fleet_step(*args, **kwargs), 10)
    ms = {k: float(np.mean(v)) for k, v in runs.items()}
    print(f"[phaseM] warm ms per flush (the stream's host clock after a "
          f"synchronize, mean of 2 in turns f, a, b, b, a, f): "
          + json.dumps({k: [round(x, 3) for x in v] for k, v in runs.items()})
          + "; run_block on flush 4 from its warm state (CUDA events, "
          "median of 10): " + json.dumps(
              {k: round(v, 4) for k, v in window_ms.items()})
          + "; the fleet_step kernel alone on that window by packages "
          "(CUDA events, median of 10): " + json.dumps(
              {k: round(v, 4) for k, v in launch_ms.items()}))

    # the per-package planes on the 4-partition mesh, one window each: a
    # 129-tile degraded-fallback fleet (wide layout) with a NaN span, and a
    # heterogeneous fleet of 4 x 250 packages (node banks in turn)
    for what, (tiles, m) in (("wide", MESH_WIDE), ("het", MESH_HET)):
        kw = (dict(degraded_fallback=True) if what == "wide"
              else dict(heterogeneous=True))
        pcfg = SchedulerConfig(n_tiles=tiles, mode="v24", **kw)
        ef = FleetEngine(pcfg, backend="fused", device=dev)
        em = FleetEngine(pcfg, backend="sharded_fused", device=dev,
                         device_pool=pool)
        pkg = None
        if what == "het":
            nodes = ("base", "n7", "n5", "n3")
            pkg = nodebank.fleet_package_params(
                ef.sched, [nodes[i % 4] for i in range(m)])
        w_trace = fleet_trace(tiles, m, flush)
        if what == "wide":
            w_trace[40:90, 7, :] = np.nan
        sf, sm = ef.init(m, pkg=pkg), em.init(m, pkg=pkg)
        before = fs.fleet_step.launches
        sm, tm, fm = em.block_traces(sm, em.backend_impl.put_trace(w_trace))
        torch.cuda.synchronize()
        got = fs.fleet_step.launches - before
        sf, tf, ff = ef.block_traces(sf, ef.backend_impl.put_trace(w_trace))
        check(got == MESH_POOL, f"phase M {what}: {got} launches")
        check(torch.equal(tm, tf) and torch.equal(fm, ff)
              and states_equal(sm, sf),
              f"phase M {what}: {em.backend_impl.describe()} differs from "
              f"fused")
        print(f"[phaseM] {what}: {m} packages x {tiles} tiles on "
              f"{em.backend_impl.describe()} ({m // MESH_POOL} a "
              f"partition), one window of {flush}: {got} launches, traces "
              f"and state bit-equal to fused")

    # ---- (c) sharded, per step, against broadcast on four partitions
    eb = FleetEngine(cfg, backend="broadcast", device=dev)
    es = FleetEngine(cfg, backend="sharded", device=dev, device_pool=pool)
    sb, ss = eb.init(n), es.init(n)
    steps = torch.from_numpy(trace[peak * flush:peak * flush
                                   + MESH_STEPS]).to(dev)
    step_ms = {"broadcast": [], "sharded": []}
    c_worst = 0.0
    for k in range(MESH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sb, ob, tb = eb.step(sb, steps[k])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ss, os_, ts = es.step(ss, steps[k])
        torch.cuda.synchronize()
        step_ms["broadcast"].append((t1 - t0) * 1e3)
        step_ms["sharded"].append((time.perf_counter() - t1) * 1e3)
        for f in ("freq", "temp_c", "hint_w", "at_risk", "balance"):
            check(torch.equal(getattr(os_, f), getattr(ob, f)),
                  f"phase M (c) step {k}: {f} differs from broadcast")
        c_worst = max(c_worst, telemetry_gate(ts.as_dict(), tb.as_dict(),
                                              f"phase M (c) step {k}"))
    check(states_equal(ss, sb), "phase M (c): state differs from broadcast")
    print(f"[phaseM] (c) {es.backend_impl.describe()} per step vs broadcast, "
          f"{n} x {n_tiles} over {MESH_STEPS} steps from flush 4's start: "
          f"outputs and state bit-equal, telemetry worst rel {c_worst:.2e}; "
          f"median step ms (host clock) broadcast "
          f"{np.median(step_ms['broadcast']):.2f}, sharded "
          f"{np.median(step_ms['sharded']):.2f}")
    del eb, es, sb, ss

    # ---- (d) the serving entry points on the mesh, in process
    argv = SERVE_STREAM_ARGV[:]
    argv[argv.index("fused")] = "sharded_fused"
    waves = int(argv[argv.index("--waves") + 1])
    fs.fleet_step.launches = 0
    res = serve.main(argv + ["--fleet-devices", "0"])
    torch.cuda.synchronize()
    d_stream = fs.fleet_step.launches
    check(d_stream == waves * n_cards and res["host_syncs"] == waves,
          f"serve --stream on sharded_fused: {d_stream} launches, "
          f"{res['host_syncs']} host syncs")
    for i, (g, w) in enumerate(zip(res["stream"], c_res["stream"])):
        telemetry_gate(g, w, f"phase M (d) serve --stream flush {i}")
    mc_argv = MC_ARGV[:]
    mc_argv[mc_argv.index("fused")] = "sharded_fused"
    want = serve.main(MC_ARGV)
    fs.fleet_step.launches = 0
    got = serve.main(mc_argv)
    torch.cuda.synchronize()
    d_mc = fs.fleet_step.launches
    again = serve.main(MC_ARGV)        # fused warm, for the trials/s
    blocks = 2 * -(-MC_STEPS // MC_CHUNK)          # two surveys' blocks
    check(d_mc == blocks * n_cards, f"serve --montecarlo on sharded_fused: "
          f"{d_mc} launches, want {blocks} x {n_cards}")
    for f in got["result"]._fields:
        check(torch.equal(getattr(got["result"], f),
                          getattr(want["result"], f)),
              f"serve --montecarlo on sharded_fused: {f} differs")
    check(got["montecarlo"] == want["montecarlo"],
          "serve --montecarlo: the §10 statistics differ from fused's")
    print(f"[phaseM] (d) serve --stream --fleet-backend sharded_fused "
          f"--fleet-devices 0: {d_stream} launches, records "
          f"{'equal to' if res['stream'] == c_res['stream'] else 'within the gates of'}"
          f" Phase C's; serve --montecarlo {MC_ARGV[1]} on sharded_fused: "
          f"{d_mc} "
          f"launches, per-trial statistics and the §10 lines equal to "
          f"fused's ({got['trials_per_s']:.0f} vs {again['trials_per_s']:.0f}"
          f" trials/s, fused's second run; its first "
          f"{want['trials_per_s']:.0f})")

    # ---- (e) the resident service on four partitions against the same
    # service on fused (Phase J's scenario: four tenants, grow, canary,
    # snapshot, restore), fed the mesh service's chunks; then the state
    # resharded from 4 partitions to 2
    scfg = SchedulerConfig(n_tiles=SVC_TILES, mode="v24", mixed_mode=True)
    snap = ROOT / "build" / "phase_m_snapshots"
    shutil.rmtree(snap, ignore_errors=True)
    svc = FleetService(scfg, backend="sharded_fused", flush_every=SVC_FLUSH,
                       snapshot_dir=str(snap), log_capacity=8, device=dev,
                       device_pool=pool)
    ref = FleetService(scfg, backend="fused", flush_every=SVC_FLUSH,
                       log_capacity=8, device=dev)
    for i in range(SVC_PACKAGES):
        for s_ in (svc, ref):
            s_.attach(f"pkg{i}", SVC_TENANTS[i % 4], KINDS[i % 4])
    _, per_copy = count_syncs(lambda: torch.ones(3, device=dev).cpu())
    e_worst, e_ticks = 0.0, []

    def tick():
        nonlocal e_worst
        syncs0, l0 = svc.host_syncs, fs.fleet_step.launches
        rec, k = count_syncs(lambda: svc.tick())
        d = svc.engine.backend_impl.n_devices()
        check(svc.host_syncs == syncs0 + 1 and k == per_copy,
              f"phase M (e) flush {rec['flush']}: {k} synchronizing calls "
              f"(one copy makes {per_copy})")
        check(fs.fleet_step.launches - l0 == len(svc.state.freq.parts),
              f"phase M (e) flush {rec['flush']}: "
              f"{fs.fleet_step.launches - l0} launches on {d} partitions")
        want = ref.tick(chunk=rec["rho"])
        e_worst = max(e_worst, records_close(rec, want,
                                             f"phase M (e) flush "
                                             f"{rec['flush']}"))
        # the same per-lane traces and the per-tenant sums in a fixed
        # order: the same bits
        check(rec["telemetry"] == want["telemetry"]
              and rec["tenants"] == want["tenants"],
              f"phase M (e) flush {rec['flush']}: records differ from the "
              f"fused service's")
        e_ticks.append(dict(svc.last_tick_ms))
        return rec

    tick()
    tick()
    for s_ in (svc, ref):                    # n + 1 packages: grow to 2n
        s_.attach("extra", "acme", "training")
    tick()
    for s_ in (svc, ref):
        s_.canary(0.25)
        s_.set_thresholds("zeta", t_crit_c=60.0)
    tick()
    svc.save_snapshot(blocking=True)
    final = tick()
    check(states_equal(svc.state, ref.state),
          "phase M (e): service state differs from the fused service's")
    t0 = time.perf_counter()
    restored = FleetService.restore(str(snap), device=dev, device_pool=pool)
    while restored.flushes < svc.flushes:
        restored.tick()
    restore_s = time.perf_counter() - t0
    check(states_equal(restored.state, svc.state),
          "phase M (e): restored state differs from the uninterrupted one")
    specs = svc.engine.sched.state_pspecs(batch_axes=(FLEET_AXIS,))
    before = [p.shape[0] for p in svc.state.freq.parts]
    svc.state = reshard_state(svc.state, fleet_mesh(2, pool), specs)
    check(len(svc.state.freq.parts) == 2, "reshard_state: not 2 partitions")
    tick()
    tick()
    check(states_equal(svc.state, ref.state),
          "phase M (e): resharded service state differs from fused's")
    med = {k: float(np.median([t[k] for t in e_ticks])) for k in e_ticks[0]}
    print(f"[phaseM] (e) FleetService on "
          f"{svc.engine.backend_impl.describe()} ({SVC_PACKAGES} packages "
          f"x {SVC_TILES} tiles, four tenants, grow to "
          f"{svc.registry.capacity}, canary, snapshot, restore): "
          f"{len(e_ticks)} flushes, 1 D2H copy and one fleet_step launch a "
          f"partition each, every record equal to the fused service's "
          f"(worst rel {e_worst:.2e}), final state bit-equal; restore + "
          f"catch-up {restore_s:.2f} s, bit-equal; reshard_state "
          f"{before} -> {[p.shape[0] for p in svc.state.freq.parts]}, two "
          f"more flushes bit-equal; median host ms a flush "
          + json.dumps({k: round(v, 3) for k, v in med.items()}))
    shutil.rmtree(snap, ignore_errors=True)
    print(f"[phaseM] phase M {time.perf_counter() - t_phase:.1f} s")
    return {"launches_mesh_a": out["a"]["launches"],
            "launches_mesh_b": out["b"]["launches"],
            "ms_per_flush_mesh": ms, "run_block_ms_mesh": window_ms,
            "launch_ms_by_packages": launch_ms}


# Phase N: the fleet across processes.  Two ranks of one process group on
# the card, over gloo (NCCL refuses two ranks on one card), each rank's
# pool the card once and then twice — sharded_fused[2dev/2proc] and
# [4dev/2proc] — streaming Phase B's fleet, its trace rebuilt in each rank
# from the seed; then `serve --distributed --stream` on two ranks
PROC_RANKS = 2
PROC_POOLS = (1, 2)
PROC_SHAPE = (47, 4096, 2048, 256)      # tiles, packages, steps, flush

PROC_WORKER = r"""
import json, sys, time
sys.path.insert(0, %(root)r)
from repro_torch.distributed import multihost
topo = multihost.bootstrap_from_env()
import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map
import chip_smoke as cs
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.fleet import FleetEngine, chunk_source, distributed_stream
from repro_torch.fleet.engine import FleetTelemetry
from repro_torch.kernels import fleet_step as fs

dev = torch.device(%(device)r)
if dev.type == "cpu":
    # the CPU rehearsal: the plain version stands in for the kernel and
    # counts its calls as the kernel's wrapper counts launches
    from repro_torch.fleet.backends import fused as fused_mod
    def plain(*a, rows=None, **k):
        fs.fleet_step.launches += 1
        return fs.fleet_step_reference(*a, **k)
    fused_mod.fleet_step = plain
COUNT = {"collectives": 0, "fetches": 0}
def counting(fn, key):
    def wrapped(*a, **k):
        COUNT[key] += 1
        return fn(*a, **k)
    return wrapped
for name in ("all_reduce", "all_gather", "all_gather_object", "broadcast",
             "reduce_scatter", "all_to_all", "barrier", "reduce", "gather",
             "scatter", "send", "recv"):
    if hasattr(dist, name):
        setattr(dist, name, counting(getattr(dist, name), "collectives"))
FleetTelemetry.as_dict = counting(FleetTelemetry.as_dict, "fetches")

def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize()

def syncs(fn):
    if dev.type == "cpu":
        return fn(), 1
    return cs.count_syncs(fn)

n_tiles, n, steps, flush = %(shape)r
windows = steps // flush
trace = cs.fleet_trace(n_tiles, n, steps)
cfg = SchedulerConfig(n_tiles=n_tiles, mode="v24")
_, per_copy = syncs(lambda: torch.ones(3, device=dev).cpu())
out = {"rank": topo.process_id, "runs": []}
for local in %(pools)r:
    eng = FleetEngine(cfg, backend="sharded_fused", device=dev,
                      device_pool=[dev] * local)
    tag = eng.backend_impl.describe()
    state0 = eng.init(n)
    sync()
    dist.barrier()
    fs.fleet_step.launches = 0
    c0, b0 = dict(COUNT), dict(multihost.COUNTS)
    stamps = [time.perf_counter()]
    state, flushed, stats = distributed_stream(
        eng, state0, chunk_source(trace, flush), global_chunks=True,
        on_flush=lambda i, d: stamps.append(time.perf_counter()))
    sync()
    launches = fs.fleet_step.launches
    coll = COUNT["collectives"] - c0["collectives"]
    fetches = COUNT["fetches"] - c0["fetches"]
    nbytes = (multihost.COUNTS["bytes"] - b0["bytes"]) // windows
    cs.check(launches == windows * local,
             f"rank {topo.process_id} {tag}: {launches} fleet_step "
             f"launches, want {windows} x {local}")
    cs.check(stats.flushes == stats.host_syncs == fetches == windows,
             f"rank {topo.process_id} {tag}: {stats.flushes} flushes, "
             f"{stats.host_syncs} host syncs, {fetches} record fetches")
    cs.check(coll == windows, f"rank {topo.process_id} {tag}: {coll} "
             f"collectives in {windows} flushes")
    # one warm flush: the synchronizing calls this rank's thread makes
    st = eng.init(n)
    chunk = eng.backend_impl.put_trace(trace[:flush])
    eng.run_block(st, chunk)[1].as_dict()
    _, k = syncs(lambda: eng.run_block(st, chunk)[1].as_dict())
    cs.check(k == per_copy, f"rank {topo.process_id} {tag}: {k} "
             f"synchronizing calls in a flush (one copy makes {per_copy})")
    # warm ms per flush: the host clock between the stream's records,
    # flushes 2 on (the first pays the kernel library's load)
    flush_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    warm_ms = float(np.median(flush_ms[1:]))
    # the collective alone at a flush's size, the ranks started together
    buf = torch.zeros(nbytes, dtype=torch.uint8, device=dev)
    coll_ms = []
    for _ in range(2):
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        dist.all_reduce(buf)
        sync()
        coll_ms.append((time.perf_counter() - t0) * 1e3)
    del buf
    whole = eng.assemble(state)
    if topo.process_id == 0:
        # copies: the assembled leaves are views of one collective buffer
        torch.save(tree_map(lambda x: None if x is None
                            else x.cpu().clone(), whole),
                   %(out_dir)r + f"/state_{local}.pt")
    out["runs"].append({"describe": tag, "flushed": flushed,
                        "launches": launches, "collectives": coll,
                        "fetches": fetches, "bytes_per_flush": nbytes,
                        "warm_ms_per_flush": warm_ms, "flush_ms": flush_ms,
                        "collective_ms": coll_ms})
    del eng, state, state0, st, chunk, whole
print("RESULT " + json.dumps(out))
"""

PROC_SERVE = r"""
import json, os, sys
sys.path.insert(0, %(root)r)
from repro_torch.kernels import fleet_step as fs
from repro_torch.launch import serve
res = serve.main(%(argv)r + [
    "--coordinator", os.environ["REPRO_COORDINATOR"],
    "--num-processes", os.environ["REPRO_NUM_PROCESSES"],
    "--process-id", os.environ["REPRO_PROCESS_ID"]])
print("RESULT " + json.dumps({"stream": res["stream"],
                              "host_syncs": res["host_syncs"],
                              "launches": fs.fleet_step.launches}))
"""


def rank_results(outs: list) -> list:
    """Each rank's RESULT object, in rank order."""
    res = [json.loads(line[len("RESULT "):]) for o in outs
           for line in o.splitlines() if line.startswith("RESULT ")]
    check(len(res) == len(outs), "a rank printed no result:\n"
          + "\n".join(outs))
    return res


def states_close(a, b, where: str) -> bool:
    """Two whole fleet states: float leaves within 1e-5 (rtol = atol),
    the others exact; returns whether every leaf is bit-equal."""
    import torch

    def leaves(x):
        if x is None:
            return []
        if isinstance(x, tuple):
            return [y for v in x for y in leaves(v)]
        return [x]
    la, lb = leaves(a), leaves(b)
    check(len(la) == len(lb), f"{where}: {len(la)} vs {len(lb)} leaves")
    same = True
    for i, (x, y) in enumerate(zip(la, lb)):
        x, y = x.cpu(), y.cpu()
        if x.is_floating_point():
            check(torch.allclose(x, y, **TOL), f"{where}: leaf {i} differs "
                  f"by {float((x - y).abs().max()):.3e}")
        else:
            check(torch.equal(x, y), f"{where}: leaf {i} differs")
        same = same and torch.equal(x, y)
    return same


def phase_n(dev, b_flushed, b_state, c_res, fused_ms: float) -> dict:
    """The fleet across processes: Phase B's stream on two ranks of one
    process group, each rank's pool the card once and twice, against Phase
    B's `fused` records and state, launches, host syncs and collectives
    counted in each rank; `serve --distributed --stream` on two ranks
    against Phase C's records."""
    import shutil

    import torch

    from repro_torch.distributed import multihost

    t_phase = time.perf_counter()
    out_dir = ROOT / "build" / "phase_n"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    windows = PROC_SHAPE[2] // PROC_SHAPE[3]
    code = PROC_WORKER % {"root": str(ROOT), "device": dev.type,
                          "shape": PROC_SHAPE, "pools": PROC_POOLS,
                          "out_dir": str(out_dir)}
    t0 = time.perf_counter()
    ranks = rank_results(multihost.run_process_group(code, PROC_RANKS,
                                                     timeout=900))
    group_s = time.perf_counter() - t0
    entry = {}
    for i, local in enumerate(PROC_POOLS):
        runs = [r["runs"][i] for r in ranks]
        tag = runs[0]["describe"]
        want = (f"sharded_fused[{PROC_RANKS * local}dev/{PROC_RANKS}proc,"
                f"blk={32 if dev.type == 'cuda' else 'plain'}]")
        check(tag == want, f"phase N: {tag}, want {want}")
        for r in runs[1:]:
            check(r["flushed"] == runs[0]["flushed"],
                  f"phase N {tag}: rank {r} records differ from rank 0's")
        flushed = runs[0]["flushed"]
        worst = max(telemetry_gate(g, w, f"phase N {tag} flush {j}")
                    for j, (g, w) in enumerate(zip(flushed, b_flushed)))
        equal = flushed == b_flushed
        state = torch.load(out_dir / f"state_{local}.pt", weights_only=False)
        same = states_close(state, b_state, f"phase N {tag} final state")
        entry[tag] = {
            "launches": [r["launches"] for r in runs],
            "warm_ms_per_flush": [r["warm_ms_per_flush"] for r in runs],
            "flush_ms": [r["flush_ms"] for r in runs],
            "collective_ms": [r["collective_ms"] for r in runs],
            "bytes_per_flush": runs[0]["bytes_per_flush"]}
        print(f"[phaseN] {tag}: Phase B's stream ({PROC_SHAPE[1]} x "
              f"{PROC_SHAPE[0]}, {windows} flushes of {PROC_SHAPE[3]}) on "
              f"{PROC_RANKS} ranks: fleet_step launches per rank "
              f"{entry[tag]['launches']} ({windows} x {local}), 1 record "
              f"fetch, 1 collective and the synchronizing calls of one D2H "
              f"copy a flush on every rank; records the same on every "
              f"rank and {'equal to' if equal else 'within the gates of'} "
              f"Phase B's fused (worst rel {worst:.2e}); final state "
              f"{'bit-equal to' if same else 'within 1e-5 of'} fused's; "
              f"warm ms per flush per rank (median of flushes 2-"
              f"{windows}, host clock between records) "
              + json.dumps([round(x, 3) for x in
                            entry[tag]["warm_ms_per_flush"]])
              + f" beside fused's {fused_ms:.3f} (Phase M), each flush "
              + json.dumps([[round(x, 1) for x in r]
                            for r in entry[tag]["flush_ms"]])
              + f"; the collective moves {entry[tag]['bytes_per_flush']} "
              f"bytes a flush, alone (ms, 2 runs per rank) "
              + json.dumps([[round(x, 3) for x in r] for r in
                            entry[tag]["collective_ms"]]))

    # ---- serve --distributed --stream through the CLI's entry, two ranks
    argv = SERVE_STREAM_ARGV[:]
    argv[argv.index("fused")] = "sharded_fused"
    argv += ["--distributed"]
    if dev.type == "cpu":
        argv += ["--device", "cpu"]
    waves = int(argv[argv.index("--waves") + 1])
    t0 = time.perf_counter()
    outs = multihost.run_process_group(
        PROC_SERVE % {"root": str(ROOT), "argv": argv}, PROC_RANKS,
        timeout=600)
    serve_s = time.perf_counter() - t0
    res = rank_results(outs)
    for r in res:
        check(r["host_syncs"] == waves and r["stream"] == res[0]["stream"],
              f"serve --distributed: {r['host_syncs']} host syncs, or "
              f"records that differ across ranks")
        if dev.type == "cuda":
            check(r["launches"] == waves, f"serve --distributed: "
                  f"{r['launches']} fleet_step launches on a rank, want "
                  f"{waves}")
    for j, (g, w) in enumerate(zip(res[0]["stream"], c_res["stream"])):
        telemetry_gate(g, w, f"phase N serve --distributed flush {j}")
    check("[stream] flush" not in outs[1] and "[stream] flush" in outs[0],
          "serve --distributed: flush lines not on rank 0 alone")
    entry["serve"] = [r["launches"] for r in res]
    same = res[0]["stream"] == c_res["stream"]
    print(f"[phaseN] serve {' '.join(argv)} on {PROC_RANKS} ranks: "
          f"{waves} flushes, fleet_step launches per rank "
          f"{entry['serve']}, records the same on every rank and "
          f"{'equal to' if same else 'within the gates of'} Phase C's "
          f"one-process serve --stream; rank 0 alone prints "
          f"them ({serve_s:.1f} s with start-up)")
    shutil.rmtree(out_dir, ignore_errors=True)
    print(f"[phaseN] phase N {time.perf_counter() - t_phase:.1f} s (the "
          f"streams' group {group_s:.1f} s with start-up)")
    return {"launches_procs": {k: v["launches"] for k, v in entry.items()
                               if k != "serve"},
            "launches_procs_serve": entry["serve"],
            "ms_per_flush_procs": {k: v["warm_ms_per_flush"]
                                   for k, v in entry.items()
                                   if k != "serve"},
            "collective_bytes_per_flush": {
                k: v["bytes_per_flush"] for k, v in entry.items()
                if k != "serve"},
            "collective_ms_procs": {k: v["collective_ms"]
                                    for k, v in entry.items()
                                    if k != "serve"}}



# Phase O (step 9c): training on a (pod, data, model) mesh, gloo ranks on
# the card (NCCL refuses two ranks on one device).  (a) Gemma-2B at full
# width and depth on (data 1, model 2): tensor parallelism, half of every
# weight, moment and the vocabulary a rank
MESH_TP = (1, 2)
MESH_WARM_STEPS = 1
MESH_TILES = 8
# (b) the reduced families on a 4-rank (data 2, model 2) mesh, f32: (arch,
# widths, tp_attention, batch, seq); mixtral in the EP-only mode (its 4
# experts over "model", the rest FSDP over "data")
MESH_SMALL = (2, 2)
MESH_SMALL_CASES = (
    ("granite-3-2b", dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=256), True, 4,
     64),
    ("rwkv6-1.6b", dict(n_layers=2, vocab_size=256), True, 4, 64),
    ("mixtral-8x7b", dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, n_experts=4, top_k=2,
                          moe_d_ff=64, vocab_size=256, window=32), False, 4,
     64))


def mesh_small_config(arch: str):
    """A (b) case's reduced configuration."""
    from repro_torch.configs import get_arch, reduced
    return reduced(get_arch(arch),
                   **next(c for c in MESH_SMALL_CASES if c[0] == arch)[1])


def mesh_small_launches(arch: str) -> dict:
    """The launches of one (b) case on each rank: `train_launches` twice
    (the gradient alone, then a train step), flash on its f32 route."""
    n = {k: 2 * v for k, v in train_launches(mesh_small_config(arch)).items()}
    return {"flash": {"tensor_core": 0, "cuda_core": n["flash"]},
            "flash_bwd": {"tensor_core": 0, "cuda_core": n["flash_bwd"]},
            "ssd": n["ssd"], "ssd_bwd": n["ssd_bwd"]}


# (c) the error-feedback all-reduce: the reference test's [64, 32]
# gradient, and a model-sized one for its time and bytes
MESH_COMPRESS = ((64, 32), (2048, 2048))

MESH_COMMON = r"""
import json, sys, time, contextlib, collections, functools
sys.path.insert(0, %(root)r)
from repro_torch.distributed import multihost
multihost.bootstrap_from_env()
import torch
import torch.distributed as dist
import chip_smoke as cs
from repro_torch.checkpoint.manager import tree_leaves, tree_unflatten
from repro_torch.configs import get_arch, reduced
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssm_scan as sm
from repro_torch.launch import hlo_census as HC
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as S
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw_init

dev = torch.device(%(device)r)
rank = dist.get_rank()
SHAPES = collections.Counter()      # the local shapes each kernel saw


def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize()


# the kernel wrappers the mesh's local routes reach, and their plain
# versions on the same arguments (the forwards' outputs as the kernels
# return them)
WRAPPERS = {"flash": fa.flash_attention_stats,
           "flash_bwd": fa.flash_attention_backward,
           "ssd": sm.ssd_states, "ssd_bwd": sm.ssd_backward}


def plain(key, a, k):
    if key == "flash":
        o, m, l = fa.flash_attention_stats_reference(*a, **k)
        return o.to(a[0].dtype), o, m, l
    if key == "flash_bwd":
        return fa.flash_attention_backward_reference(*a, **k)
    if key == "ssd":
        return sm.ssd_reference(*a, states=True, **k)
    return sm.ssd_backward_reference(*a, **k)


# the same wrappers by module and name, for `cs.Capture`
TARGETS = (("repro_torch.kernels.flash_attention", "flash_attention_stats",
            "flash"),
           ("repro_torch.kernels.flash_attention", "flash_attention_backward",
            "flash_bwd"),
           ("repro_torch.kernels.ssm_scan", "ssd_states", "ssd"),
           ("repro_torch.kernels.ssm_scan", "ssd_backward", "ssd_bwd"))


def seen(fn, key):
    # the wrapper takes the kernel wrapper's place and its launch counts
    @functools.wraps(fn)
    def wrapped(*a, **k):
        SHAPES[(key, str(list(a[0].shape)) + " " + str(list(a[1].shape)[2:3])
                + " " + str(a[0].dtype).split(".")[-1])] += 1
        return fn(*a, **k)
    return wrapped


fa.flash_attention_stats = seen(WRAPPERS["flash"], "flash")
fa.flash_attention_backward = seen(WRAPPERS["flash_bwd"], "flash_bwd")
sm.ssd_states = seen(WRAPPERS["ssd"], "ssd")
sm.ssd_backward = seen(WRAPPERS["ssd_bwd"], "ssd_bwd")


def hold_captured(cap):
    # each kernel launched again on the inputs it first met at each
    # signature of the mesh's run (`cs.Capture`), beside its plain
    # version: {kernel and local shapes: per output [max |kernel - plain|,
    # max |plain|, dtype, finite]}; the launch counts are read before
    # (these are not the mesh's)
    out = {}
    for i, (key, a, k) in enumerate(cap.replays()):
        got, want = WRAPPERS[key](*a, **k), plain(key, a, k)
        at = f"{key} {i}: " + " ".join(str(list(x.shape)) for x in a[:2])
        out[at + " " + str(a[0].dtype).split(".")[-1]] = [
            None if w is None else [
                float((g.float() - w.float()).abs().max()),
                float(w.float().abs().max()), str(w.dtype).split(".")[-1],
                bool(torch.isfinite(g).all())] for g, w in zip(got, want)]
    return out


def launches():
    return {"flash": dict(fa.flash_attention.launches_by_route),
            "flash_bwd": dict(fa.flash_attention_backward.launches_by_route),
            "ssd": sm.ssd.launches, "ssd_bwd": sm.ssd_backward.launches}


def reset():
    fa.reset_launches()
    sm.ssd.launches = sm.ssd_backward.launches = 0
    SHAPES.clear()


def local_of(grads, params, mesh, specs):
    # each rank's shard of one-device gradients, placed as the parameters
    return [g.to_local() for g in tree_leaves(shd.distribute(
        tree_unflatten(params, list(grads)), mesh, specs))]
"""

MESH_WORKER_TP = MESH_COMMON + r"""
import dataclasses
cfg = dataclasses.replace(get_arch("gemma-2b"), **%(gemma)r)
mesh = M.make_test_mesh(*%(mesh)r, device_type=dev.type)
params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
# Phase L's batch (train_batch, seed 21)
g = torch.Generator(device=dev).manual_seed(21)
hi = min(32768, cfg.vocab_size)
toks = torch.randint(2, hi, %(batch)r, generator=g, device=dev)
labs = torch.randint(2, hi, %(batch)r, generator=g, device=dev)
reset()
loss1, _, g1 = S.loss_and_grads(params, cfg, toks, labs)
sync()
one_launches = launches()
pspecs = shd.param_specs(cfg, params, mesh)
g1 = local_of(g1, params, mesh, pspecs)
dp = shd.distribute(params, mesh, pspecs)
del params
if dev.type == "cuda":
    torch.cuda.empty_cache()
bspec = shd.batch_spec(mesh, 2, toks.shape[0])
batch = shd.distribute({"tokens": toks, "labels": labs}, mesh,
                       {"tokens": bspec, "labels": bspec})
batch["rho"] = torch.full((%(tiles)d,), 1.9, device=dev)
state = S.TrainState(dp, adamw_init(dp),
                     S.make_scheduler(%(tiles)d, dev).init(),
                     torch.zeros((), dtype=torch.int32))
with shd.axis_env(mesh):
    reset()
    sync()
    t0 = time.perf_counter()
    loss2, _, g2 = S.loss_and_grads(state.params, cfg, batch["tokens"],
                                    batch["labels"])
    sync()
    grads_s = time.perf_counter() - t0
    grad_launches = launches()
    worst = cs.worst_leaf([g.to_local() for g in g2], g1)
    loss2 = float(shd.full(loss2))
    del g1, g2
    step = S.make_train_step(cfg, %(tiles)d, device=dev)
    reset()
    shd.CUDA_GATHERS = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    # the collectives of the first step, as they are dispatched: the
    # census's own cost stays out of the warm steps that are timed
    census = HC.Census()
    ms, losses = [], []
    for i in range(1 + %(warm)d):
        with (census if i == 0 else contextlib.nullcontext()):
            sync()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(shd.full(m["loss"])))
peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
census = census.result()
print("RESULT " + json.dumps({
    "rank": rank, "loss_one_device": float(loss1), "loss_mesh": loss2,
    "worst_leaf": worst, "one_launches": one_launches,
    "grad_launches": grad_launches, "grads_s": grads_s,
    "train_launches": launches(), "steps": 1 + %(warm)d,
    "shapes": {f"{k} {s}": n for (k, s), n in SHAPES.items()},
    "step_ms": ms, "losses": losses, "peak_bytes": peak,
    "census": {k: census[k] for k in ("counts", "by_kind", "total_bytes")},
    "gathers": [op["shape"][0] for op in census["ops"]
                if op["kind"] == "all-gather"],
    "cuda_gathers_per_step": shd.CUDA_GATHERS / (1 + %(warm)d)}))
"""

MESH_WORKER_SMALL = MESH_COMMON + r"""
from repro_torch.optim import compression as C
import numpy as np
mesh = M.make_test_mesh(*%(mesh)r, device_type=dev.type)
out = {"rank": rank, "cases": {}}
for arch, kw, tp, B, T in %(cases)r:
    cfg = reduced(get_arch(arch), **kw)
    state = S.init_train_state(torch.Generator(device=dev).manual_seed(0),
                               cfg, %(tiles)d)
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(2, cfg.vocab_size, (B, T + 1), generator=g,
                         device=dev)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous(),
             "rho": torch.full((%(tiles)d,), 1.9, device=dev)}
    reset()
    loss1, _, g1 = S.loss_and_grads(state.params, cfg, batch["tokens"],
                                    batch["labels"])
    _, m1 = S.make_train_step(cfg, %(tiles)d, device=dev)(
        tree_unflatten(state, [t.clone() for t in tree_leaves(state)]),
        batch)
    sync()
    specs = S.train_state_specs(cfg, state, mesh, tp_attention=tp)
    g1 = local_of(g1, state.params, mesh, specs.params)
    dstate = shd.distribute(state, mesh, specs)
    shape = cs.ShapeOf(B, T)
    dbatch = shd.distribute(batch, mesh, S.batch_shardings(cfg, shape, mesh))
    with shd.axis_env(mesh, tp_activations=tp):
        reset()
        with cs.Capture(TARGETS) as cap:
            loss2, _, g2 = S.loss_and_grads(dstate.params, cfg,
                                            dbatch["tokens"], dbatch["labels"])
            dstate, m2 = S.make_train_step(cfg, %(tiles)d, device=dev)(
                dstate, dbatch)
            sync()
    out["cases"][arch] = {
        "loss_one_device": float(loss1), "loss_mesh": float(shd.full(loss2)),
        "step_loss": [float(m1["loss"]), float(shd.full(m2["loss"]))],
        "worst_leaf": cs.worst_leaf([x.to_local() for x in g2], g1),
        "launches": launches(),
        "shapes": {f"{k} {s}": n for (k, s), n in SHAPES.items()}}
    out["cases"][arch]["held"] = hold_captured(cap)

# (c) the error-feedback all-reduce over every rank ("data" of a 4 x 1 mesh)
cmesh = M.make_test_mesh(data=dist.get_world_size(), model=1,
                         device_type=dev.type)
res = []
for shape in %(compress)r:
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    mean, st = C.compressed_allreduce(g, C.compress_grads_init(g), cmesh)
    scale = float(g.abs().max() / 127.0)
    n = dist.get_world_size()
    rs = np.random.default_rng(7).standard_normal((n, *shape)).astype(
        np.float32) * np.arange(1, n + 1, dtype=np.float32).reshape(
            -1, *([1] * len(shape)))
    mine = torch.from_numpy(rs[rank]).to(dev)
    mean2, st2 = C.compressed_allreduce(mine, C.compress_grads_init(mine),
                                        cmesh)
    scale2 = float(np.abs(rs).max() / 127.0)
    exact = torch.from_numpy(rs.mean(0)).to(dev)
    ms = []
    for _ in range(3):
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        C.compressed_allreduce(mine, st2, cmesh)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    res.append({"shape": list(shape),
                "err": float((mean - g).abs().max()), "scale": scale,
                "residual": float(st.error.abs().max()),
                "ulp": float(np.spacing(np.float32(g.abs().max().item()))),
                "err2": float((mean2 - exact).abs().max()),
                "scale2": scale2,
                "residual2": float(st2.error.abs().max()),
                "mean2_sum": float(mean2.double().sum()),
                "bytes": C.allreduce_bytes(mine), "ms": ms})
out["compress"] = res
print("RESULT " + json.dumps(out))
"""


class ShapeOf(NamedTuple):
    """A train cell's shape, as `batch_shardings` reads it."""
    global_batch: int
    seq_len: int
    kind: str = "train"


# Phase O (a)'s changes to Gemma-2B (none: Phase L's configuration; the
# CPU rehearsal shrinks it)
MESH_GEMMA = {}


def mesh_gemma_config():
    """The configuration Phase O (a) trains: Gemma-2B with MESH_GEMMA."""
    import dataclasses

    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("gemma-2b"), **MESH_GEMMA)


def mesh_flash_pair(dev, gen, B, T, H, KV, d, dtype, where: str,
                    route: str) -> dict:
    """The flash forward and backward at one of Phase O's local shapes,
    causal, on random inputs: each against its plain version (the output
    within Phase G's bound, the statistics within TOL, each gradient
    within FLASH_BWD_TOL of its largest magnitude), timed beside the
    plain version, SDPA and the bound.  {"fwd": …, "bwd": …}, each with
    the kernels line's keys."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    name = str(dtype).split(".")[-1]
    peak = PEAK_BF16_PER_S if dtype == torch.bfloat16 else PEAK_F32_PER_S
    r = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
    q, k, v, do = r(B, T, H, d), r(B, T, KV, d), r(B, T, KV, d), \
        r(B, T, H, d)
    out, po, pm, pl = fa.flash_attention_stats(q, k, v)
    ro, rm, rl = fa.flash_attention_stats_reference(q, k, v)
    what = f"phase O flash ({name}) at {where}"
    f_err = max(max_err((out,), (ro.to(dtype),), what, rtol=0.0,
                        atol=FLASH_FWD_ATOL[name]),
                max_err((pm, pl), (rm, rl), what))
    g_k = fa.flash_attention_backward(q, k, v, po, pm, pl, do)
    g_p = fa.flash_attention_backward_reference(q, k, v, po, pm, pl, do)
    b_err = 0.0
    for a, b in zip(g_k, g_p):
        a, b = a.float(), b.float()
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        check(rel <= FLASH_BWD_TOL[name], f"{what}: the backward differs "
              f"by {rel:.3e} of the largest magnitude")
        b_err = max(b_err, float((a - b).abs().max()))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    qs, ks, vs = (x.detach().requires_grad_() for x in (qt, kt, vt))
    lib_o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                           enable_gqa=True)
    cost = fa.flash_attention_cost(q, k, v)
    bcost = fa.flash_attention_backward_cost(q, k, v)
    res = {"fwd": dict(
        max_abs_err=f_err,
        ms=event_ms(lambda: fa.flash_attention(q, k, v), 10),
        plain_ms=timed(lambda: fa.flash_attention_reference(q, k, v))[1],
        library_ms=event_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 10)), "bwd": dict(
        max_abs_err=b_err,
        ms=event_ms(lambda: fa.flash_attention_backward(
            q, k, v, po, pm, pl, do), 10),
        plain_ms=timed(lambda: fa.flash_attention_backward_reference(
            q, k, v, po, pm, pl, do))[1],
        library_ms=event_ms(lambda: torch.autograd.grad(
            lib_o, (qs, ks, vs), do.transpose(1, 2), retain_graph=True),
            10))}
    for part, c in (("fwd", cost), ("bwd", bcost)):
        res[part]["bound_ms"], res[part]["bound_by"] = bound(
            c["bytes"], c["ops"], peak)
    f, b = res["fwd"], res["bwd"]
    print(f"[phaseO] flash_attention at {where} [{B}, {T}, {H} on {KV}, "
          f"{d}] {name} causal, {route} route: max_abs_err vs plain "
          f"{f_err:.3e}; {f['ms']:.4f} ms (median of 10, CUDA events), "
          f"plain {f['plain_ms']:.1f} ms, SDPA {f['library_ms']:.4f} ms, "
          f"bound {f['bound_ms']:.4f} ms by {f['bound_by']}; backward "
          f"{b['ms']:.4f} ms, plain {b['plain_ms']:.1f} ms, SDPA's backward "
          f"{b['library_ms']:.4f} ms, bound {b['bound_ms']:.4f} ms by "
          f"{b['bound_by']}, max_abs_err {b_err:.3e}")
    return res


def phase_o(dev, l_loss: float | None) -> list:
    """Training on a (pod, data, model) mesh of gloo ranks on the card:
    (a) Gemma-2B at full width and depth on (data 1, model 2) against its
    one-device step (Phase L's seed and batch; ``l_loss`` its loss there),
    the tensor-core flash kernels on each rank's local heads; (b) the
    reduced families on (data 2, model 2), the ssd kernels on local heads;
    (c) the error-feedback all-reduce on CUDA tensors.  Then each kernel
    at the local shape it launched at, against its plain version, timed.
    Returns the kernels line's mesh entries."""
    import numpy as np
    import torch

    from repro_torch.distributed import multihost
    from repro_torch.kernels import ssm_scan as sm

    t_phase = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    cfg = mesh_gemma_config()
    L = cfg.n_layers
    arg = lambda k: int(TRAIN_ARGV[TRAIN_ARGV.index(k) + 1])
    Bg, Tg = arg("--batch"), arg("--seq")
    fill = {"root": str(ROOT), "device": dev.type, "tiles": MESH_TILES,
            "warm": MESH_WARM_STEPS, "gemma": MESH_GEMMA,
            "batch": (Bg, Tg)}
    # ---- (a) Gemma-2B, tensor parallel over two ranks
    t0 = time.perf_counter()
    ra = rank_results(multihost.run_process_group(
        MESH_WORKER_TP % dict(fill, mesh=MESH_TP), MESH_TP[0] * MESH_TP[1],
        timeout=900))
    a_s = time.perf_counter() - t0
    steps = 1 + MESH_WARM_STEPS
    V_local = cfg.vocab_size // MESH_TP[1]
    logits_slice = (Bg // MESH_TP[0]) * min(512, Tg) * V_local
    for r in ra:
        rel = abs(r["loss_mesh"] - r["loss_one_device"]) / abs(
            r["loss_one_device"])
        check(rel <= TRAIN_LOSS_TOL, f"phase O (a) rank {r['rank']}: loss "
              f"{r['loss_mesh']} on the mesh, {r['loss_one_device']} on one "
              f"device")
        check(r["worst_leaf"] <= TRAIN_BF16_TOL, f"phase O (a) rank "
              f"{r['rank']}: a gradient leaf differs from one device's by "
              f"{r['worst_leaf']:.3e} of its largest magnitude")
        check(all(x == x and abs(x) < 1e4 for x in r["losses"]),
              f"phase O (a): losses {r['losses']}")
        big = [s for s in r["gathers"] if (V_local in s or cfg.vocab_size
                                               in s)
               and math.prod(s) >= logits_slice]
        check(not big, f"phase O (a) rank {r['rank']}: all-gathers of a "
              f"logits slice {big}")
        if dev.type == "cuda":
            want = {"flash": {"tensor_core": 2 * L * steps, "cuda_core": 0},
                    "flash_bwd": {"tensor_core": L * steps, "cuda_core": 0},
                    "ssd": 0, "ssd_bwd": 0}
            check(r["train_launches"] == want, f"phase O (a) rank "
                  f"{r['rank']}: launches {r['train_launches']}, want {want}")
            check(r["grad_launches"] == r["one_launches"],
                  f"phase O (a): the mesh's gradient launched "
                  f"{r['grad_launches']}, one device {r['one_launches']}")
    check(ra[0]["losses"] == ra[1]["losses"], f"phase O (a): the ranks' "
          f"losses differ: {ra[0]['losses']} vs {ra[1]['losses']}")
    warm = [float(np.median(r["step_ms"][1:])) for r in ra]
    l_note = ("" if l_loss is None else f"; Phase L's one-device loss at "
              f"this seed and batch {l_loss:.6f}")
    print(f"[phaseO] (a) {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.dtype}), batch {Bg} x {Tg}, on a (data "
          f"{MESH_TP[0]}, model {MESH_TP[1]}) mesh of gloo ranks on the "
          f"card: step-1 loss "
          f"{ra[0]['loss_mesh']:.6f} on the mesh, "
          f"{ra[0]['loss_one_device']:.6f} on one device (bound "
          f"{TRAIN_LOSS_TOL} relative){l_note}; gradient leaves within "
          + ", ".join(f"{r['worst_leaf']:.3e}" for r in ra)
          + f" of their largest magnitude per rank (bound {TRAIN_BF16_TOL},"
          f" Phase L's); the gradient alone {ra[0]['grads_s']:.2f} s")
    for r in ra:
        print(f"[phaseO] (a) rank {r['rank']}: losses "
              f"{json.dumps([round(x, 4) for x in r['losses']])}; step ms "
              f"{json.dumps([round(x, 1) for x in r['step_ms']])} (warm "
              f"median {float(np.median(r['step_ms'][1:])):.1f}, host clock "
              f"after a synchronize); peak device memory "
              + (f"{r['peak_bytes'] / 2**30:.2f} GiB ({r['peak_bytes']} "
                 f"bytes)" if r["peak_bytes"] is not None
                 else "not measured")
              + f"; launches in {steps} steps "
              f"{json.dumps(r['train_launches'])}"
              f" at the local shapes {json.dumps(r['shapes'])}; routed "
              f"all-gathers a step {r['cuda_gathers_per_step']:.1f}")
        c = r["census"]
        print(f"[phaseO] (a) rank {r['rank']}: collectives of the first step "
              f"by kind [count, output bytes] (`hlo_census`): "
              + json.dumps({k: [c["counts"][k], c["by_kind"][k]]
                            for k in c["counts"]})
              + f"; no all-gather of a logits slice [{Bg // MESH_TP[0]}, "
              f"{min(512, Tg)}, {V_local}]")
    MESH_O.update(census=ra[0]["census"], peak_bytes=ra[0]["peak_bytes"])
    # ---- (b), (c): the reduced families and the compressed all-reduce
    t0 = time.perf_counter()
    rb = rank_results(multihost.run_process_group(
        MESH_WORKER_SMALL % dict(fill, mesh=MESH_SMALL,
                                 cases=MESH_SMALL_CASES,
                                 compress=MESH_COMPRESS),
        MESH_SMALL[0] * MESH_SMALL[1], timeout=600))
    b_s = time.perf_counter() - t0
    held_rel = {}           # each kernel's worst output over (b)'s ranks
    for r in rb:
        for arch, c in r["cases"].items():
            rel = abs(c["loss_mesh"] - c["loss_one_device"]) / abs(
                c["loss_one_device"])
            srel = abs(c["step_loss"][1] - c["step_loss"][0]) / abs(
                c["step_loss"][0])
            check(rel <= 1e-5 and srel <= 1e-5 and c["worst_leaf"]
                  <= TRAIN_F32_TOL, f"phase O (b) {arch} rank {r['rank']}: "
                  f"loss {c['loss_mesh']} vs {c['loss_one_device']}, step "
                  f"{c['step_loss']}, worst leaf {c['worst_leaf']:.3e}")
            if dev.type == "cuda":
                want = mesh_small_launches(arch)
                check(c["launches"] == want, f"phase O (b) {arch} rank "
                      f"{r['rank']}: launches {c['launches']}, want {want}")
                ran = {k for k, v in want.items()
                       if (sum(v.values()) if isinstance(v, dict) else v)}
                held = {k.split()[0] for k in c["held"]}
                check(held == ran, f"phase O (b) {arch} rank {r['rank']}: "
                      f"held {sorted(held)} against their plain versions, "
                      f"launched {sorted(ran)}")
            for at, outs in c["held"].items():
                gate = (FLASH_BWD_TOL if at.startswith("flash")
                        else SSD_BWD_TOL)
                for i, o in enumerate(outs):
                    if o is None:
                        continue
                    diff, top, dt, finite = o
                    rel = diff / max(top, 1e-30)
                    check(finite and rel <= gate[dt], f"phase O (b) {arch} "
                          f"rank {r['rank']}: {at} output {i} differs from "
                          f"its plain version by {rel:.3e} of its largest "
                          f"magnitude (bound {gate[dt]}) or is not finite")
                    key = at.split()[0]
                    held_rel[key] = max(held_rel.get(key, 0.0), rel)
        for c in r["compress"]:
            # the reference test's bounds; a residual may pass half a
            # quantum by the f32 rounding of gl - q·scale (an ulp of |g|)
            slack = 1e-9 if c["shape"] == [64, 32] else c["ulp"]
            check(c["err"] <= c["scale"] and c["residual"]
                  <= c["scale"] / 2 + slack, f"phase O (c) {c['shape']}: "
                  f"error {c['err']}, residual {c['residual']}, scale "
                  f"{c['scale']}")
            check(c["err2"] <= c["scale2"] and c["residual2"]
                  <= c["scale2"] / 2 + 4 * c["ulp"],
                  f"phase O (c) {c['shape']} "
                  f"differing gradients: {c['err2']} from the exact mean, "
                  f"quantum {c['scale2']}")
    for i, c in enumerate(rb[0]["compress"]):
        check(len({r["compress"][i]["mean2_sum"] for r in rb}) == 1,
              f"phase O (c) {c['shape']}: the ranks' means differ")
    for arch in rb[0]["cases"]:
        c = rb[0]["cases"][arch]
        print(f"[phaseO] (b) {arch} reduced f32 on (data {MESH_SMALL[0]}, "
              f"model {MESH_SMALL[1]}): loss {c['loss_mesh']:.6f} on the "
              f"mesh, {c['loss_one_device']:.6f} on one device; gradient "
              f"leaves within "
              + ", ".join(f"{r['cases'][arch]['worst_leaf']:.2e}"
                          for r in rb)
              + f" per rank (bound {TRAIN_F32_TOL}); a train step's loss "
              f"{c['step_loss'][1]:.6f} vs {c['step_loss'][0]:.6f}; "
              f"launches on rank 0 {json.dumps(c['launches'])} at the local "
              f"shapes {json.dumps(c['shapes'])}")
    print(f"[phaseO] (b) every kernel launched again on the inputs it first "
          f"met at each signature (`Capture`), on every rank, against its "
          f"plain version: worst output within "
          + ", ".join(f"{k} {v:.2e}" for k, v in sorted(held_rel.items()))
          + f" of its largest magnitude (bounds: flash "
          f"{FLASH_BWD_TOL['float32']}, ssd {SSD_BWD_TOL['float32']}, f32)")
    for c in rb[0]["compress"]:
        print(f"[phaseO] (c) compressed_allreduce {c['shape']} on "
              f"{len(rb)} ranks (CUDA tensors, gloo): error vs g "
              f"{c['err']:.3e} <= scale {c['scale']:.3e}, residual "
              f"{c['residual']:.3e}; differing gradients within "
              f"{c['err2']:.3e} of the exact mean (quantum "
              f"{c['scale2']:.3e}), the same on every rank; "
              f"{c['bytes']:,} bytes a rank a call (int32, as f32's), "
              f"ms a call {json.dumps([round(x, 2) for x in c['ms']])}")
    # ---- the kernels at the local shapes the mesh launched them at
    gen = torch.Generator(device=dev).manual_seed(31)
    B, T = Bg // MESH_TP[0], Tg
    H, KV, d = cfg.n_heads // MESH_TP[1], cfg.n_kv_heads, cfg.head_dim
    at = f"[{B}, {T}, {H}, {d}] [{KV}] bfloat16"
    check(all(f"{kind} {at}" in ra[0]["shapes"] for kind in
              ("flash", "flash_bwd")), f"phase O: Gemma-2B's local flash "
          f"shape {at} is not one (a) launched at: {ra[0]['shapes']}")
    pair_tc = mesh_flash_pair(dev, gen, B, T, H, KV, d, torch.bfloat16,
                         "the mesh's local shape", "tensor-core")
    shape_a = f"gemma-2b local [{B}, {T}, {H} on {KV}, {d}] bf16, 2 ranks"
    # (b)'s local shapes, from its configurations and its mesh: granite's
    # flash pair on the f32 route, RWKV6's ssd pair with u
    (dp, tp), recorded = MESH_SMALL, rb[0]["cases"]

    def local_shape(arch):
        case = next(c for c in MESH_SMALL_CASES if c[0] == arch)
        return mesh_small_config(arch), case[3] // dp, case[4]

    gcfg, sB, sT = local_shape("granite-3-2b")
    H, KV, d = gcfg.n_heads // tp, max(gcfg.n_kv_heads // tp, 1), \
        gcfg.head_dim
    at = f"[{sB}, {sT}, {H}, {d}] [{KV}] float32"
    check(all(f"{kind} {at}" in recorded["granite-3-2b"]["shapes"] for kind
              in ("flash", "flash_bwd")), f"phase O: granite's local flash "
          f"shape {at} is not one (b) launched at: "
          f"{recorded['granite-3-2b']['shapes']}")
    pair_cc = mesh_flash_pair(dev, gen, sB, sT, H, KV, d, torch.float32,
                         "granite's local shape in (b)", "CUDA-core")
    shape_g = (f"granite-3-2b reduced local [{sB}, {sT}, {H} on {KV}, {d}] "
               f"f32, 4 ranks; launches: granite's and mixtral's on rank 0")
    rcfg, sB, sT = local_shape("rwkv6-1.6b")
    sN = rcfg.rwkv_head_dim
    sH = rcfg.d_model // sN // tp
    at = f"[{sB}, {sT}, {sH}, {sN}] [{sH}] float32"
    for kind in ("ssd", "ssd_bwd"):
        check(f"{kind} {at}" in recorded["rwkv6-1.6b"]["shapes"],
              f"phase O: RWKV6's local {kind} shape {at} is not one (b) "
              f"launched at: {recorded['rwkv6-1.6b']['shapes']}")
    rs = lambda *s: torch.rand(s, generator=gen, device=dev)
    dd = 0.8 + 0.199 * rs(sB, sT, sH, sN)
    bb_, cc = (0.2 * torch.randn(sB, sT, sH, sN, generator=gen, device=dev)
               for _ in range(2))
    xx, dy = (torch.randn(sB, sT, sH, sN, generator=gen, device=dev)
              for _ in range(2))
    uu = 0.1 * torch.randn(sH, sN, generator=gen, device=dev)
    ck = sm.chunk_for(sT, 64)
    y, hT = sm.ssd(dd, bb_, xx, cc, u=uu, include_current=False)
    yr, hr = sm.ssd_reference(dd, bb_, xx, cc, u=uu, include_current=False,
                              chunk=ck)
    s_err = max_err((y, hT), (yr, hr), "phase O ssd at the local shape",
                    rtol=3e-5, atol=3e-5)
    s_ms = event_ms(lambda: sm.ssd(dd, bb_, xx, cc, u=uu,
                                   include_current=False), 10)
    s_plain = timed(lambda: sm.ssd_reference(
        dd, bb_, xx, cc, u=uu, include_current=False, chunk=ck))[1]
    scost = sm.ssd_cost(dd, bb_, xx, cc, uu)
    s_bound, s_by = bound(scost["bytes"], scost["ops"])
    hs = sm.ssd_states(dd, bb_, xx, cc, u=uu, chunk=ck,
                       include_current=False)[2]
    bkw = dict(chunk=ck, include_current=False)
    g_k = sm.ssd_backward(dd, bb_, xx, cc, uu, None, hs, dy, None, **bkw)
    g_p = sm.ssd_backward_reference(dd, bb_, xx, cc, uu, None, hs, dy, None,
                                    **bkw)
    sb_err = 0.0
    for name, a, b in zip(("dd", "db", "dx", "dc", "du", "dh0"), g_k, g_p):
        if b is None:
            check(a is None, f"phase O ssd backward: {name} without h0")
            continue
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        check(bool(torch.isfinite(a).all()) and rel
              <= SSD_BWD_TOL["float32"], f"phase O ssd backward at the "
              f"local shape: {name} {rel:.3e} of its largest magnitude")
        sb_err = max(sb_err, float((a - b).abs().max()))
    sb_ms = event_ms(lambda: sm.ssd_backward(
        dd, bb_, xx, cc, uu, None, hs, dy, None, **bkw), 10)
    sb_plain = timed(lambda: sm.ssd_backward_reference(
        dd, bb_, xx, cc, uu, None, hs, dy, None, **bkw))[1]
    sbcost = sm.ssd_backward_cost(dd, bb_, xx, cc, uu, None,
                                  include_current=False)
    sb_bound, sb_by = bound(sbcost["bytes"], sbcost["ops"],
                            PEAK_TF32_PER_S / 3)
    print(f"[phaseO] ssd at RWKV6's local shape in (b) [{sB}, {sT}, {sH}, "
          f"{sN}/{sN}] f32 with u: max_abs_err vs plain {s_err:.3e}; "
          f"{s_ms:.4f} ms (median of 10), plain {s_plain:.1f} ms, bound "
          f"{s_bound:.4f} ms by {s_by}; backward {sb_ms:.4f} ms, plain "
          f"{sb_plain:.1f} ms, bound {sb_bound:.4f} ms by {sb_by} (3xTF32: "
          f"a third of the TF32 peak), max_abs_err {sb_err:.3e}")
    print(f"[phaseO] phase O {time.perf_counter() - t_phase:.1f} s ((a) "
          f"{a_s:.1f} s, (b) and (c) {b_s:.1f} s with start-up)")
    a0 = ra[0]
    tc_launch = a0["train_launches"]["flash"]["tensor_core"]
    tcb_launch = a0["train_launches"]["flash_bwd"]["tensor_core"]
    b_launch = lambda kind, route=None: sum(
        c["launches"][kind] if route is None else
        c["launches"][kind][route] for c in recorded.values())
    shape_r = f"rwkv6 reduced local [{sB}, {sT}, {sH}, {sN}/{sN}] f32, " \
        f"4 ranks"
    return [
        {"name": "flash_attention_tc_mesh", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
         "replaces": "src/repro/kernels/flash_attention.py:94",
         "launches": tc_launch, **pair_tc["fwd"], "shape": shape_a,
         "warm_step_ms_mesh": warm, "peak_gib_mesh": [
             None if r["peak_bytes"] is None else r["peak_bytes"] / 2**30
             for r in ra]},
        {"name": "flash_attention_bwd_tc_mesh", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_tc.cu",
         "replaces": "src/repro/kernels/ref.py:201",
         "launches": tcb_launch, **pair_tc["bwd"], "shape": shape_a},
        {"name": "flash_attention_mesh", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:94",
         "launches": b_launch("flash", "cuda_core"), **pair_cc["fwd"],
         "max_rel_err_mesh_inputs": held_rel.get("flash"),
         "shape": shape_g},
        {"name": "flash_attention_bwd_mesh", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/ref.py:201",
         "launches": b_launch("flash_bwd", "cuda_core"), **pair_cc["bwd"],
         "max_rel_err_mesh_inputs": held_rel.get("flash_bwd"),
         "shape": shape_g},
        {"name": "ssd_mesh", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd.cu",
         "replaces": "src/repro/kernels/ssm_scan.py:94",
         "launches": b_launch("ssd"), "max_abs_err": s_err, "ms": s_ms,
         "plain_ms": s_plain, "bound_ms": s_bound, "bound_by": s_by,
         "library_ms": None,
         "max_rel_err_mesh_inputs": held_rel.get("ssd"), "shape": shape_r},
        {"name": "ssd_backward_mesh", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_bwd.cu",
         "replaces": "src/repro/kernels/ref.py:283",
         "launches": b_launch("ssd_bwd"), "max_abs_err": sb_err,
         "ms": sb_ms, "plain_ms": sb_plain, "bound_ms": sb_bound,
         "bound_by": sb_by, "library_ms": None,
         "max_rel_err_mesh_inputs": held_rel.get("ssd_bwd"),
         "shape": shape_r}]


# Phase P: the dry run (step 11).  (a) two production cells on "cuda" fake
# tensors; (b) Phase O (a)'s own step on a fake group of its ranks, held to
# what Phase O measured; the predicted peak within DRY_PEAK_TOL of it
DRY_CELLS = (("gemma-2b", "train_4k", False), ("gemma-2b", "decode_32k",
                                                True))
DRY_PEAK_TOL = 0.10
MESH_O = {}             # Phase O (a) rank 0's census and peak, for Phase P
GEMMA_STEP_MS = None    # Phase L (d)'s warm one-device step, for Phase P

DRY_WORKER = r"""
import dataclasses, json, sys, time
sys.path.insert(0, %(src)r)
import torch
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_test_mesh

out = {"cells": []}
for arch, shape, multi in %(cells)r:
    with D.fake_group(512 if multi else 256):
        out["cells"].append(D.run_cell(arch, shape, multi,
                                       device=%(device)r))
cfg = dataclasses.replace(get_arch("gemma-2b"), **%(gemma)r)
with D.fake_group(%(ranks)d):
    mesh = make_test_mesh(*%(mesh)r, device_type=%(device)r)
    t0 = time.perf_counter()
    cell = D.build_cell(cfg, ShapeConfig("phase_o", %(seq)d, %(batch)d,
                                         "train"),
                        mesh, n_tiles=%(tiles)d, device=%(device)r)
    out["phase_o"] = D.record(cell, time.perf_counter() - t0)
print("RESULT " + json.dumps(out))
"""


def replay(op, sig, dev):
    """One kernel op on real tensors of a recorded signature (a tensor as
    [shape, dtype], drawn in [0.5, 1): a valid decay, a finite attention)
    and on fake tensors of the same: each output's shape, dtype and
    stride from the kernel and from the shape rule."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    gen = torch.Generator(device=dev).manual_seed(41)
    real = [0.5 + 0.5 * torch.rand(a[0], generator=gen, device=dev).to(
        getattr(torch, a[1])) if isinstance(a, list) and len(a) == 2
        and isinstance(a[1], str) else a for a in sig]
    got = op(*real)
    torch.cuda.synchronize()
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) if torch.is_tensor(a) else a
                for a in real]
        want = op(*fake)
    meta = lambda ts: [(tuple(t.shape), t.dtype, t.stride()) for t in
                       (ts if isinstance(ts, (tuple, list)) else (ts,))]
    return meta(got), meta(want)


def phase_p(dev) -> None:
    """The dry run (`repro_torch.launch.dryrun`) on the card's machine, in
    a child process that owns the fake process group: (a) the production
    cells of DRY_CELLS on "cuda" fake tensors, each record printed; (b)
    Phase O (a)'s Gemma-2B step on a fake group of its two ranks — rank
    0's census equal to the one Phase O (a) measured, by kind in count and
    bytes, and the predicted peak within DRY_PEAK_TOL of Phase O (a)'s
    ``max_memory_allocated``; (c) each kernel's shape rule against the
    kernel: the outputs' shapes, dtypes and strides equal at the local
    shapes (a)'s train cell and Phase O met (both flash routes); (d) the
    roofline of Phase L's one-device Gemma-2B step beside its measured
    warm step (no gate)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    import repro_torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import roofline

    t_phase = time.perf_counter()
    arg = lambda k: int(TRAIN_ARGV[TRAIN_ARGV.index(k) + 1])
    script = DRY_WORKER % {
        "src": str(ROOT / "src"), "cells": DRY_CELLS, "device": dev.type,
        "gemma": MESH_GEMMA, "ranks": MESH_TP[0] * MESH_TP[1],
        "mesh": MESH_TP, "seq": arg("--seq"), "batch": arg("--batch"),
        "tiles": MESH_TILES}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    check(proc.returncode == 0 and len(lines) == 1, "phase P: the dry run "
          f"failed (exit {proc.returncode}):\n{proc.stdout[-4000:]}\n"
          f"{proc.stderr[-4000:]}")
    out = json.loads(lines[0][len("RESULT "):])
    # ---- (a) the production cells
    for rec in out["cells"]:
        check(rec["ok"], f"phase P (a): {rec}")
        m, c, r = rec["memory"], rec["collectives"], rec["roofline"]
        print(f"[phaseP] (a) {rec['arch']} x {rec['shape']} x {rec['mesh']} "
              f"on {rec['device']} fake tensors: argument "
              f"{m['argument_bytes'] / 2**30:.3f} GiB, peak "
              f"{m['peak_bytes'] / 2**30:.3f} GiB, output "
              f"{m['output_bytes'] / 2**30:.3f} GiB a rank; "
              f"{rec['flops']:.4e} flops a rank; collectives a rank "
              f"[count, bytes] " + json.dumps(
                  {k: [c["counts"][k], c["by_kind"][k]] for k in c["counts"]})
              + f"; roofline compute {r['t_compute_s']:.4g} s, memory "
              f"{r['t_memory_s']:.4g} s, collective "
              f"{r['t_collective_s']:.4g} s ({r['bottleneck']}), analytic "
              f"{r['per_chip_hbm_gb']:.2f} GB a chip; lower "
              f"{rec['lower_s']} s, run {rec['run_s']} s")
    # ---- (b) Phase O (a)'s step, predicted against measured
    po = out["phase_o"]
    pc, mc = po["collectives"], MESH_O["census"]
    check(pc["counts"] == mc["counts"] and pc["by_kind"] == mc["by_kind"],
          f"phase P (b): the dry run's census {pc['counts']} "
          f"{pc['by_kind']} differs from Phase O's measured {mc['counts']} "
          f"{mc['by_kind']}")
    pred, meas = po["memory"]["peak_bytes"], MESH_O["peak_bytes"]
    rel = abs(pred - meas) / meas
    check(rel <= DRY_PEAK_TOL, f"phase P (b): predicted peak {pred} bytes, "
          f"Phase O measured {meas} ({rel:.3f} apart)")
    print(f"[phaseP] (b) Phase O (a)'s step (Gemma-2B, bf16, batch "
          f"{arg('--batch')} x {arg('--seq')}, data {MESH_TP[0]} x model "
          f"{MESH_TP[1]}) on a fake group: census by kind [count, bytes] "
          + json.dumps({k: [pc["counts"][k], pc["by_kind"][k]]
                        for k in pc["counts"]})
          + f" equal to Phase O's measured rank 0; predicted peak "
          f"{pred / 2**30:.3f} GiB (argument "
          f"{po['memory']['argument_bytes'] / 2**30:.3f}) against measured "
          f"{meas / 2**30:.3f} GiB ({rel:.4f} apart, bound {DRY_PEAK_TOL}); "
          f"{po['flops']:.4e} flops a rank")
    # ---- (c) every shape rule against its kernel
    ops = torch.ops.repro_torch
    sigs = {}
    for rec in (out["cells"][0], po):
        for name, calls in rec["collectives"]["kernels"].items():
            for sig in calls:
                sigs.setdefault(name.split(".")[-1], []).append(sig)
    # O (b)'s granite flash pair on the CUDA-core route (f32)
    gcfg = mesh_small_config("granite-3-2b")
    case = next(c for c in MESH_SMALL_CASES if c[0] == "granite-3-2b")
    gB, gT = case[3] // MESH_SMALL[0], case[4]
    gH, gKV = gcfg.n_heads // MESH_SMALL[1], max(
        gcfg.n_kv_heads // MESH_SMALL[1], 1)
    q4 = [[gB, gT, gH, gcfg.head_dim], "float32"]
    k4 = [[gB, gT, gKV, gcfg.head_dim], "float32"]
    ml = [[gB, gH, gT], "float32"]
    fargs = [True, 0, 0, gcfg.head_dim ** -0.5]
    sigs.setdefault("flash_attention_stats", []).append([q4, k4, k4, *fargs])
    sigs.setdefault("flash_attention_backward", []).append(
        [q4, k4, k4, q4, ml, ml, q4, *fargs])
    for sig in list(sigs.get("flash_attention_stats", [])):
        sigs.setdefault("flash_attention", []).append(sig)
    rcfg = mesh_small_config("rwkv6-1.6b")
    case = next(c for c in MESH_SMALL_CASES if c[0] == "rwkv6-1.6b")
    sB, sT = case[3] // MESH_SMALL[0], case[4]
    sN = rcfg.rwkv_head_dim
    sH = rcfg.d_model // sN // MESH_SMALL[1]
    t4 = [[sB, sT, sH, sN], "float32"]
    u, st = [[sH, sN], "float32"], [[sB, sH, sN, sN], "float32"]
    ck = 64 if sT % 64 == 0 else sT
    hs = [[sB, sT // ck, sH, sN, sN], "float32"]
    sigs["ssd"] = [[t4, t4, t4, t4, u, None, ck, False]]
    sigs["ssd_states"] = [[t4, t4, t4, t4, u, None, ck, False]]
    sigs["ssd_backward"] = [[t4, t4, t4, t4, u, None, hs, t4, st, ck,
                             False]]
    seen = {}
    for name, calls in sorted(sigs.items()):
        for sig in calls:
            got, want = replay(getattr(ops, name), sig, dev)
            check(got == want, f"phase P (c): {name} at {sig}: the kernel "
                  f"gives {got}, its shape rule {want}")
            seen.setdefault(name, []).append(
                [list(a[0]) for a in sig if isinstance(a, list)
                 and len(a) == 2 and isinstance(a[1], str)][0])
    for n_tiles in (MESH_TILES, 256):
        a = torch.rand(n_tiles, device=dev)
        with torch.no_grad():
            real = repro_torch.fma_f32(a, a, 1.5)
        with FakeTensorMode() as mode:
            fa_ = mode.from_tensor(a)
            fake = repro_torch.fma_f32(fa_, fa_, 1.5)
        check((real.shape, real.dtype, real.stride()) == (
            fake.shape, fake.dtype, fake.stride()),
            f"phase P (c): fma_f32 at [{n_tiles}]")
        seen.setdefault("fma_f32", []).append([n_tiles])
    print("[phaseP] (c) each shape rule's outputs equal its kernel's in "
          "shape, dtype and stride, at (first input's shape): "
          + json.dumps(seen))
    # ---- (d) the roofline of Phase L's one-device step
    cfg = mesh_gemma_config()
    rl = roofline.analytic(cfg, ShapeConfig("phase_l", arg("--seq"),
                                            arg("--batch"), "train"),
                           {"data": 1, "model": 1}).as_dict()
    step = "not measured" if GEMMA_STEP_MS is None else \
        f"{GEMMA_STEP_MS:.1f} ms"
    print(f"[phaseP] (d) roofline of Phase L's one-device {cfg.name} step "
          f"(batch {arg('--batch')} x {arg('--seq')}, bf16): compute "
          f"{rl['t_compute_s'] * 1e3:.2f} ms, memory "
          f"{rl['t_memory_s'] * 1e3:.2f} ms, collective "
          f"{rl['t_collective_s'] * 1e3:.2f} ms ({rl['bottleneck']}-bound); "
          f"measured warm step {step} (no gate)")
    print(f"[phaseP] phase P {time.perf_counter() - t_phase:.1f} s")



# Phase Q: the four examples ported last (examples/torch_fleet_sim.py,
# torch_thermal_dashboard.py, torch_quickstart.py, torch_serve_batched.py),
# each through its `main` at the reference example's sizes: (a)'s
# backends, and the node bank it also streams
Q_BACKENDS = ("broadcast", "fused", "vmap", "sharded", "sharded_fused")
Q_NODE = "n3"
# the launchers each kernel's wrapper reaches on a card, by module and
# name, and the kernel each launches: Phase Q captures each one's first
# arguments at each new signature of its inputs
Q_LAUNCHERS = (("repro_torch", "_fma_plan", "fma_f32"),
               ("repro_torch.fleet.backends.fused", "fleet_step",
                "fleet_step"),
               ("repro_torch.kernels.flash_attention", "_launch",
                "flash_attention"),
               ("repro_torch.kernels.flash_attention", "_launch_tc",
                "flash_attention_tc"),
               ("repro_torch.kernels.flash_attention", "_launch_bwd",
                "flash_attention_backward"),
               ("repro_torch.kernels.flash_attention", "_launch_bwd_tc",
                "flash_attention_bwd_tc"),
               ("repro_torch.kernels.ssm_scan", "_launch", "ssd"))


def load_example(name: str):
    """examples/<name>.py as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def signature(x):
    """What makes a launch new: each tensor's shape, dtype, strides and
    data pointer modulo 16 bytes, every other argument's value (a float's
    type only: fma_f32's scalar operands)."""
    import torch

    if torch.is_tensor(x):
        return (tuple(x.shape), str(x.dtype), x.stride(), x.data_ptr() % 16)
    if type(x) in (tuple, list):
        return tuple(signature(y) for y in x)
    return "float" if isinstance(x, float) else repr(x)


def clone_args(x):
    """``x`` with each tensor copied into new memory at its own shape,
    strides and data pointer modulo 256 bytes: a view copies the span of
    storage it covers, so a launch on the copy meets the layout the
    captured launch met."""
    import torch

    if type(x) in (tuple, list):
        return type(x)(clone_args(y) for y in x)
    if not torch.is_tensor(x):
        return x
    x = x.detach()
    if x.numel() == 0:
        return x.clone()
    span = 1 + sum((n - 1) * s for n, s in zip(x.shape, x.stride()))
    at = x.data_ptr() % 256 // x.element_size()
    buf = torch.empty(at + span, dtype=x.dtype, device=x.device)
    buf[at:] = x.as_strided((span,), (1,), x.storage_offset())
    return buf.as_strided(x.shape, x.stride(), at)


class Capture:
    """Within the context every (module, name, kernel) of ``targets`` is
    wrapped: the arguments it first met at each new signature, cloned
    before the call (``first``: (kernel, signature) -> (args, kwargs)).
    Phase Q wraps the kernels' launchers (`Q_LAUNCHERS`), Phase O (b)'s
    ranks the public wrappers; the launch counts are untouched (each lives
    on the kernel's public wrapper)."""

    def __init__(self, targets=Q_LAUNCHERS):
        self.targets, self.first, self._saved = targets, {}, []

    def _wrap(self, orig, kernel):
        first = self.first

        class Wrapped:
            # a call captures, then calls ``orig``; every attribute is
            # ``orig``'s (a wrapper's launch counts go on counting there)
            def __call__(self, *a, **k):
                key = (kernel, signature(a) + signature(sorted(k.items())))
                if key not in first:
                    first[key] = (clone_args(a),
                                  {n: clone_args(v) for n, v in k.items()})
                return orig(*a, **k)

            def __getattr__(self, name):
                return getattr(orig, name)

            def __setattr__(self, name, value):
                setattr(orig, name, value)

        return Wrapped()

    def replays(self):
        """(kernel, args, kwargs) of each capture, each copy's signature
        checked equal to the launch's it was captured from."""
        for (kernel, sig), (a, k) in self.first.items():
            check(signature(a) + signature(sorted(k.items())) == sig,
                  f"{kernel}: the captured copy's layout differs from the "
                  f"launch's")
            yield kernel, a, k

    def __enter__(self):
        import importlib

        for mod_name, attr, kernel in self.targets:
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            self._saved.append((mod, attr, orig))
            setattr(mod, attr, self._wrap(orig, kernel))
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved.clear()


def worst_leaf(got, want) -> float:
    """The largest |got − want| of the tensors, each over its ``want``'s
    largest magnitude."""
    w = 0.0
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        w = max(w, float((a - b).abs().max())
                / max(float(b.abs().max()), 1e-30))
    return w


def hold_captured(cap: Capture, where: str) -> dict:
    """Each captured launch made again beside its kernel's plain version
    on the same inputs (these launches are not the path's: counts are read
    before): fma_f32 bit for bit, fleet_step by ``compare`` (traces and
    state 1e-5, events and latch exact), the flash forward within
    FLASH_FWD_ATOL (Phase G's bounds) with its statistics, the flash
    backward within FLASH_BWD_TOL of each gradient's largest magnitude,
    ssd within 3e-5 (the reference kernel test's bound).  Returns {kernel:
    [signatures held, worst error]}."""
    import torch

    import repro_torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fleet_step as fs
    from repro_torch.kernels import ssm_scan as sm

    held = {}
    for kernel, a, k in cap.replays():
        shapes = [list(t.shape) for t in a[:4] if torch.is_tensor(t)]
        at = f"{where}: {kernel} at {shapes}"
        if kernel == "fma_f32":
            check(torch.equal(repro_torch.fma_f32(*a),
                              repro_torch.fma_f32_reference(*a)),
                  f"{at}: not bit-equal to the plain version")
            err = 0.0
        elif kernel == "fleet_step":
            err = compare(fs.fleet_step(*a, **k),
                          fs.fleet_step_reference(*a, **k), at)
        elif kernel in ("flash_attention", "flash_attention_tc"):
            q, kk, v, causal, window, q_offset, scale = a[:7]
            kw = dict(causal=causal, window=window, q_offset=q_offset,
                      scale=scale)
            launch = fa._launch if kernel == "flash_attention" else \
                fa._launch_tc
            got = launch(*a, **k)
            if k.get("stats", False):
                o, m, l = fa.flash_attention_stats_reference(q, kk, v, **kw)
                want = (o.to(q.dtype), o, m, l)
            else:
                got, want = (got,), (fa.flash_attention_reference(
                    q, kk, v, **kw),)
            err = max_err(got, want, at,
                          atol=FLASH_FWD_ATOL[str(q.dtype).split(".")[-1]])
        elif kernel in ("flash_attention_backward",
                        "flash_attention_bwd_tc"):
            q, kk, v, o, m, l, do, causal, window, q_offset, scale = a
            launch = fa._launch_bwd if kernel == "flash_attention_backward" \
                else fa._launch_bwd_tc
            got = launch(*a)
            check(all(bool(torch.isfinite(g).all()) for g in got),
                  f"{at}: not finite")
            err = worst_leaf(got, fa.flash_attention_backward_reference(
                q, kk, v, o, m, l, do, causal=causal, window=window,
                q_offset=q_offset, scale=scale))
            tol = FLASH_BWD_TOL[str(q.dtype).split(".")[-1]]
            check(err <= tol, f"{at}: {err:.3e} of the largest gradient")
        else:
            d, b, x, c, u, h0, ck, inc = a
            err = max_err(sm._launch(*a, **k), sm.ssd_reference(
                d, b, x, c, u=u, h0=h0, chunk=ck, include_current=inc,
                states=k.get("states", False)), at, rtol=3e-5, atol=3e-5)
        n, worst = held.get(kernel, (0, 0.0))
        held[kernel] = (n + 1, max(worst, err))
    return held


def q_reset() -> None:
    """Every launch count Phase Q reads set to 0."""
    import repro_torch
    from repro_torch.kernels import fleet_step as fs

    reset_train_launches()
    fs.fleet_step.launches = 0
    repro_torch.fma_f32.launches = 0


def q_counts() -> dict:
    """The launch counts since `q_reset`: fleet_step, fma_f32, the flash
    forward and backward by route, ssd and its backward."""
    import repro_torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fleet_step as fs
    from repro_torch.kernels import ssm_scan as sm

    return {"fleet_step": fs.fleet_step.launches,
            "fma_f32": repro_torch.fma_f32.launches,
            "flash": dict(fa.flash_attention.launches_by_route),
            "flash_bwd": dict(fa.flash_attention_backward.launches_by_route),
            "ssd": sm.ssd.launches, "ssd_bwd": sm.ssd_backward.launches}


def phase_q(dev) -> dict:
    """The four examples on the card, each through its `main` at the
    reference example's sizes, with every kernel it launched held to its
    plain version on the inputs it first met at each shape.  Returns the
    launches of the examples' runs by kernel (the kernels line's
    ``launches_phase_q``)."""
    import collections

    import numpy as np
    import torch

    from repro_torch.core import dataset90k, pdu_gate, thermal
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.fleet import FleetService, serve_http
    from repro_torch.kernels.flash_attention import flash_route

    t_phase = time.perf_counter()
    total = collections.Counter()
    held = {}

    def add(c: dict) -> dict:
        for k, v in c.items():
            if isinstance(v, dict):
                for route, n in v.items():
                    total[f"{k}_{route}"] += n
            else:
                total[k] += v
        return c

    def hold(cap: Capture, where: str) -> None:
        for kernel, (n, err) in hold_captured(cap, where).items():
            m, worst = held.get(kernel, (0, 0.0))
            held[kernel] = (m + n, max(worst, err))

    # ---- (a) torch_fleet_sim: every backend, the stream, a node bank
    t0 = time.perf_counter()
    ex = load_example("torch_fleet_sim")
    chunks = -(-ex.STEPS // ex.FLUSH)
    runs = {}
    with Capture() as cap:
        for backend in Q_BACKENDS:
            q_reset()
            res = runs[backend] = ex.main(["--backend", backend])
            c = add(q_counts())
            # the per-step loop runs the scheduler's update on every
            # backend (fused's window kernel serves whole chunks)
            check(c["fma_f32"] > 0 and c["fleet_step"] == 0,
                  f"phase Q (a) {backend}: launches {c}")
            check(res["events"] == res["run_events"] == 0,
                  f"phase Q (a) {backend}: events {res['events']} per "
                  f"step, {res['run_events']} by the runner")
            print(f"[phaseQ] (a) torch_fleet_sim --backend {backend}: "
                  f"{res['ms_per_step']:.3f} ms per step (host clock, "
                  f"synchronized; {ex.N_PACKAGES} packages x {ex.N_TILES} "
                  f"tiles), {c['fma_f32']} fma_f32 launches over "
                  f"{2 * ex.STEPS} steps, events 0, final p99 "
                  f"{res['records'][ex.STEPS - 1]['temp_p99_c']:.3f} C, "
                  f"runner peak p99 {res['run_peak_p99']:.3f} C")
        base = runs["broadcast"]
        worst = 0.0
        for backend, res in runs.items():
            err = max_err((res["temps"], res["freqs"]),
                          (base["temps"], base["freqs"]),
                          f"phase Q (a) {backend} vs broadcast")
            for i, d in res["records"].items():
                telemetry_gate(d, base["records"][i],
                               f"phase Q (a) {backend} step {i}")
            worst = max(worst, err)
        print(f"[phaseQ] (a) every backend's last temperatures and "
              f"frequencies within {worst:.3e} of broadcast's, its printed "
              f"records within the fleet gates")
        streams = {}
        for tag, argv in (("fused", ["--backend", "fused"]),
                          ("broadcast", []),
                          (f"{Q_NODE} fused", ["--node", Q_NODE,
                                               "--backend", "fused"]),
                          (f"{Q_NODE} broadcast", ["--node", Q_NODE])):
            q_reset()
            res = streams[tag] = ex.main(argv + ["--stream"])
            c = add(q_counts())
            want = chunks if "fused" in tag else 0
            check(c["fleet_step"] == want and res["flushes"] == chunks
                  and res["host_syncs"] == res["flushes"],
                  f"phase Q (a) --stream {tag}: {c['fleet_step']} "
                  f"fleet_step launches (want {want}), {res['flushes']} "
                  f"flushes, {res['host_syncs']} host syncs")
            print(f"[phaseQ] (a) torch_fleet_sim --stream {tag}: "
                  f"{res['ms_per_step']:.3f} ms per step, "
                  f"{c['fleet_step']} fleet_step launches in "
                  f"{res['flushes']} flushes, {res['host_syncs']} host "
                  f"syncs, events {res['events']}")
        check(streams["fused"]["events"] == 0, "phase Q (a): the stream "
              "tripped a thermal event")
        for tag in ("fused", f"{Q_NODE} fused"):
            other = tag.replace("fused", "broadcast")
            for i, (d, w) in enumerate(zip(streams[tag]["flushed"],
                                           streams[other]["flushed"])):
                telemetry_gate(d, w, f"phase Q (a) --stream {tag} flush "
                               f"{i + 1} vs {other}")
        q_reset()
        node = ex.main(["--node", Q_NODE])
        add(q_counts())
        check(node["events"] == node["run_events"]
              == streams[f"{Q_NODE} fused"]["events"],
              f"phase Q (a) --node {Q_NODE}: events {node['events']} per "
              f"step, {node['run_events']} by the runner, "
              f"{streams[f'{Q_NODE} fused']['events']} streamed")
    hold(cap, "phase Q (a)")
    print(f"[phaseQ] (a) --node {Q_NODE}: {node['events']} events per "
          f"step, by the runner and streamed on fused and broadcast; "
          f"streamed records of fused within the fleet gates of "
          f"broadcast's; {time.perf_counter() - t0:.1f} s")

    # ---- (b) torch_thermal_dashboard: the local panels, then --url
    t0 = time.perf_counter()
    ex = load_example("torch_thermal_dashboard")
    q_reset()
    with Capture() as cap:
        res = ex.main([])
    c = add(q_counts())
    check(c["fma_f32"] > 0, f"phase Q (b): launches {c}")
    t = res["dataset"]
    check(all(x.device.type == "cuda" for x in (
        t.rtok, res["trace"], res["step_response"], res["eta"])),
          "phase Q (b): a panel did not run on the card")
    a, b, r2 = dataset90k.fit_affine(t.rtok.cpu(), t.dt_junction.cpu())
    sr = thermal.step_response(thermal.single_pole(), 400, 100.0)
    max_err(res["step_response"].cpu(), sr, "phase Q (b) panel 2's step "
            "response vs the CPU")
    p5 = ex.panel5(res["trace"].cpu())
    cpu = {"alpha": a, "beta": b, "r2": r2, "rth": float(sr[-1]) / 100.0,
           "eta20": float(pdu_gate.eta(20.)),
           "eta50": float(pdu_gate.eta(50.)), "released": p5["released"],
           "peak_v24": p5["peak_v24"], "peak_base": p5["peak_base"]}
    for k, w in cpu.items():
        check(abs(res[k] - w) <= 1e-5 + 1e-5 * abs(w),
              f"phase Q (b): {k} {res[k]} on the card, {w} on the CPU")
    err = max_err([res[k].cpu() for k in ("t_v24", "f_v24", "t_base",
                                          "f_base")],
                  [p5[k] for k in ("t_v24", "f_v24", "t_base", "f_base")],
                  "phase Q (b) panel 5 traces vs the CPU")
    print(f"[phaseQ] (b) torch_thermal_dashboard: alpha {res['alpha']:.4f} "
          f"beta {res['beta']:.3f} R2 {res['r2']:.6f} Rth {res['rth']:.5f} "
          f"eta {res['eta20']:.6f} / {res['eta50']:.6f}, released "
          f"{res['released']:.6f}, peaks {res['peak_v24']:.3f} / "
          f"{res['peak_base']:.3f} C, each within 1e-5 of the same "
          f"functions on the CPU on the same inputs (panel 5's traces "
          f"within {err:.3e}); {c['fma_f32']} fma_f32 launches")
    svc = FleetService(SchedulerConfig(n_tiles=4),
                       backend="fused", min_capacity=4, flush_every=8,
                       device=dev)
    for i in range(3):
        svc.attach(f"q{i}", tenant="acme")
    q_reset()
    with Capture() as cap2:
        for _ in range(2):
            svc.tick()
    c = add(q_counts())
    check(c["fleet_step"] == 2, f"phase Q (b): the control plane's two "
          f"flushes launched fleet_step {c['fleet_step']} times")
    server, thread = serve_http(svc, port=0)
    try:
        live = ex.main(["--url",
                        f"http://127.0.0.1:{server.server_address[1]}"])
    finally:
        server.shutdown()
        thread.join(timeout=10)
    check(len(live["records"]) == 2, f"phase Q (b) --url: "
          f"{len(live['records'])} flush records rendered, want 2")
    hold(cap, "phase Q (b)")
    hold(cap2, "phase Q (b) control plane")
    print(f"[phaseQ] (b) --url against serve_http on port "
          f"{server.server_address[1]} (FleetService on fused, 3 packages, "
          f"2 flushes, 2 fleet_step launches): rendered "
          f"{len(live['records'])} flush records; "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- (c) torch_quickstart: Effect ① and the training loop
    t0 = time.perf_counter()
    ex = load_example("torch_quickstart")
    cfg = ex.train_config()
    dt = getattr(torch, cfg.dtype)
    route = flash_route("cuda", dt, dt, cfg.head_dim, cfg.head_dim)
    q_reset()
    with Capture() as cap:
        res = ex.main([])
    got = check_train_launches(cfg, route, ex.TRAIN_STEPS,
                               "phase Q (c) torch_quickstart")
    c = add(q_counts())
    check(res["v24_events"] == 0 and res["train_events"] == 0
          and all(np.isfinite(res["losses"])),
          f"phase Q (c): V24 events {res['v24_events']}, train events "
          f"{res['train_events']}, losses {res['losses']}")
    check(res["trace"].device.type == "cuda", "phase Q (c): the trace is "
          "not on the card")
    e = ex.effect_one(res["trace"].cpu())
    for k, w in e.items():
        check(abs(res[k] - w) <= 1e-5 + 1e-5 * abs(w),
              f"phase Q (c): {k} {res[k]} on the card, {w} on the CPU")
    hold(cap, "phase Q (c)")
    print(f"[phaseQ] (c) torch_quickstart: released {res['released']:.6f}, "
          f"perf {res['base_perf']:.6f} -> {res['v24_perf']:.6f}, peak "
          f"{res['base_peak']:.3f} -> {res['v24_peak']:.3f} C, events "
          f"{res['base_events']} -> 0, each as on the CPU on the same "
          f"trace (1e-5); losses {json.dumps([round(x, 4) for x in res['losses']])}; "
          f"flash {got['flash']} forward and {got['flash_bwd']} backward "
          f"launches on the {route} route, {c['fma_f32']} fma_f32; "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- (d) torch_serve_batched: the three scenarios
    t0 = time.perf_counter()
    ex = load_example("torch_serve_batched")
    from repro_torch.configs import get_arch, reduced
    want = {"flash": 0, "ssd": 0}
    for argv in ex.SCENARIOS.values():
        arg = lambda k: argv[argv.index(k) + 1]
        scfg = reduced(get_arch(arg("--arch")))
        kind = "ssd" if scfg.family == "ssm" else "flash"
        want[kind] += scfg.n_layers * int(arg("--waves"))
    q_reset()
    with Capture() as cap:
        res = ex.main([])
    c = add(q_counts())
    froute = flash_route("cuda", torch.float32, torch.float32, 32, 32)
    check(c["flash"][froute] == sum(c["flash"].values()) == want["flash"]
          and c["ssd"] == want["ssd"] and sum(c["flash_bwd"].values()) == 0,
          f"phase Q (d): launches {c}, want flash {want['flash']} on the "
          f"{froute} route and ssd {want['ssd']} (one a layer a prefill)")
    ref = ex.main(["--device", "cpu"])
    for name in ("mixtral", "rwkv6", "fleet"):
        check(res[name]["admitted"] == ref[name]["admitted"],
              f"phase Q (d) {name}: admissions {res[name]['admitted']} on "
              f"the card, {ref[name]['admitted']} on the CPU")
    hold(cap, "phase Q (d)")
    print(f"[phaseQ] (d) torch_serve_batched: admissions "
          f"{json.dumps({k: v['admitted'] for k, v in res.items()})} as on "
          f"the CPU; {c['flash'][froute]} flash launches on the {froute} "
          f"route, {c['ssd']} ssd; p50 / p99 ms "
          f"{json.dumps({k: [round(v['p50'] * 1e3, 2), round(v['p99'] * 1e3, 2)] for k, v in res.items()})}; "
          f"{time.perf_counter() - t0:.1f} s")
    print("[phaseQ] each kernel launched again on the inputs it first met "
          "at each signature, beside its plain version: " + json.dumps(
              {k: {"held": n, "max_err": e} for k, (n, e) in held.items()}))
    print(f"[phaseQ] phase Q {time.perf_counter() - t_phase:.1f} s")
    return {"fleet_step": total["fleet_step"], "fma_f32": total["fma_f32"],
            "flash_attention": total["flash_tensor_core"],
            "flash_attention_cuda_core": total["flash_cuda_core"],
            "flash_attention_bwd_tc": total["flash_bwd_tensor_core"],
            "flash_attention_backward": total["flash_bwd_cuda_core"],
            "ssd": total["ssd"], "ssd_backward": total["ssd_bwd"]}


if __name__ == "__main__":
    main()
