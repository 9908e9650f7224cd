"""Serving launcher: the model-serving wave loop and the ``--stream`` soak.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --batch 8 --prompt-len 1024 --gen 32 --waves 3 --fleet 64
    PYTHONPATH=src python -m repro_torch.launch.serve --stream \
        --fleet 4096 --fleet-backend fused --waves 4 --gen 256

Port of `repro.launch.serve`.  The default path is the wave loop: each wave
steps the fleet engine once (``--fleet N`` packages, package 0 served by
this host; a fleet of one serves the base density) and admits
``max(1, int(batch × freq0))`` prompts — the thermal hint throttles
ADMISSION, not frequency (the serving half of the paper's Effect ①) —
then runs one prefill and ``--gen`` greedy decode steps, timing the p50 /
p99 token latency (the first decode call is not counted).  Weights are the
reference's random initialisation at the published widths, drawn on the
device from ``--seed``; prompts are drawn from ``--seed`` too.  On a card
prefill runs every attention through the hand-written flash kernel and
every Mamba2 layer through the ssd kernel; decode runs neither.  Served
families: dense (Gemma, Granite) and hybrid (Zamba2).

``--stream`` replaces the wave loop with the control-plane soak: the whole
``waves × gen``-step density trace of a ``--fleet``-package fleet is driven
through the streaming ingest loop (`repro_torch.fleet.ingest`) — pinned,
asynchronous host→device uploads, a bounded look-ahead hint queue,
telemetry reduced on the device over each ``gen``-step flush window and
fetched with ONE host sync per flush.

In both, the base density is ρv24 of ``--arch`` at the serving shape
(``--batch`` × ``--prompt-len + --gen``, decode), and each package adds its
own load jitter drawn from a `torch.Generator` seeded by ``--seed``.  (The
reference draws with ``jax.random``, whose streams PyTorch cannot
reproduce; parity tests compare with a fleet of one or feed traces the
reference made.)  The scheduler defaults match the reference: one tile,
``step_ms=5``, v24, backend ``broadcast``.  ``--device`` defaults to
``cuda`` and the run fails without a card unless ``--device cpu`` is given.

``--montecarlo N`` runs the §10 process-variation population instead: N
heterogeneous trials (per-trial Rth/τ/η/polling draws in the fleet state,
drawn on the device from ``--seed``) paired baseline/V24 over
``--mc-steps`` steps through ``--fleet-backend`` (on ``fused`` one
`fleet_step` launch per 1,024-step survey block; the statistics skip a
400-step burn-in, so a shorter run raises), printing the
peak-temperature distributions, σ tightening, uplift and the §3.4
guard-band margins derived from them.  ``--node`` gives every fleet lane
that technology node's pole rows (`core.nodebank`; ``base`` keeps the
homogeneous fleet).

Not ported yet, each exits non-zero naming its ROADMAP step: ``--serve``
and ``--chaos`` (both need the resident `FleetService`) and
``--distributed``; the unported model families (`transformer.
check_supported`).  ``--plant grid|rom`` streams through the per-step path
of ``broadcast``; on ``fused`` ``rom`` rides the kernel's het rows and
``grid`` is handed to the per-step path.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.density import rho_v24
from repro_torch.core.plant import available_plants
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.fleet import (FleetEngine, available_backends, chunk_source,
                               stream)
from repro_torch.launch import steps as S
from repro_torch.models import transformer as tf

_NOT_PORTED = {
    "serve": ("--serve (the resident control plane)", 8),
    "chaos": ("--chaos (the fault-injection soak: its service phases need "
              "the resident FleetService)", 8),
    "distributed": ("--distributed (multi-host streaming)", 9),
}


def _node_pkg(eng, node: str, n: int):
    """Per-lane `PackageParams` rows for a non-base ``--node`` fleet (None
    keeps the homogeneous fleet)."""
    if node == "base":
        return None
    from repro_torch.core.nodebank import fleet_package_params
    return fleet_package_params(eng.sched, [node] * n)


def _montecarlo(args) -> dict:
    """--montecarlo N: the §10 process-variation population through the
    fleet; prints the §10 statistics and the §3.4 guard-band margins."""
    from repro_torch.core import guardband, montecarlo
    dev = resolve_device(args.device)
    _sync(dev)
    t0 = time.perf_counter()
    r = montecarlo.run(seed=args.seed, n_trials=args.montecarlo,
                       n_steps=args.mc_steps, backend=args.fleet_backend,
                       filtration_impl=args.filtration, plant=args.plant,
                       device=dev)
    s = r.stats()
    dt = time.perf_counter() - t0
    print(f"[mc] {args.montecarlo} trials x {args.mc_steps} steps "
          f"(paired baseline+v24) on '{args.fleet_backend}' "
          f"plant '{args.plant}' in {dt:.1f} s "
          f"({args.montecarlo / dt:.0f} trials/s)")
    print(f"[mc] baseline peak-T {s['baseline_mean_c']:.1f}C "
          f"sigma {s['baseline_std_c']:.2f}C, exceedance "
          f"{s['baseline_time_above_frac'] * 100:.1f}%")
    print(f"[mc] v24      peak-T {s['v24_mean_c']:.1f}C "
          f"sigma {s['v24_std_c']:.2f}C, exceedance "
          f"{s['v24_time_above_frac'] * 100:.2f}%")
    print(f"[mc] sigma tightening {s['sigma_tighter_x']:.1f}x, uplift "
          f"{s['uplift_mean'] * 100:.1f}% "
          f"[p5 {s['uplift_p5'] * 100:.1f}%, p95 {s['uplift_p95'] * 100:.1f}%]")
    for g in guardband.from_montecarlo(s):
        print(f"[mc] guard-band {g.category}: {g.margin_before * 100:.0f}% "
              f"-> {g.margin_after * 100:.1f}% (-{g.reduction_pct:.1f}%)")
    return {"montecarlo": s, "trials_per_s": args.montecarlo / dt,
            "result": r}


def _stream_soak(args, sched_cfg: SchedulerConfig, rho: float) -> dict:
    """--stream: fleet control-plane soak through the streaming ingest loop."""
    n = max(args.fleet, 1)
    eng = FleetEngine(sched_cfg, backend=args.fleet_backend,
                      device=args.device)
    steps = args.waves * args.gen
    t = np.linspace(0.0, np.pi, steps, dtype=np.float32)
    swell = rho * (0.85 + 0.3 * np.sin(t) ** 2)                # [T]
    gen = torch.Generator().manual_seed(args.seed)
    jitter = 0.15 * torch.randn((n, sched_cfg.n_tiles), generator=gen)
    trace = np.clip(swell[:, None, None] + jitter.numpy(), 0.9, 2.7
                    ).astype(np.float32)                       # [T, n, tiles]

    def on_flush(i, d):
        print(f"[stream] flush {i}: p50 {d['temp_p50_c']:.1f}C "
              f"p99 {d['temp_p99_c']:.1f}C f_mean {d['freq_mean']:.3f} "
              f"released {d['released_mtps']:.1f} MTPS "
              f"events {int(d['events_total'])}")

    state = eng.init(n, pkg=_node_pkg(eng, args.node, n))
    print(f"[stream] backend {eng.backend_impl.describe()} on {eng.device} "
          f"({eng.backend_impl.n_devices()} device(s)), fleet {n}")
    t0 = time.perf_counter()
    state, flushed, stats = stream(eng, state, chunk_source(trace, args.gen),
                                   on_flush=on_flush)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    rate = stats.steps * n / max(dt, 1e-9)
    print(f"[stream] done: {stats.steps} steps x {n} pkgs "
          f"({eng.backend_impl.describe()}) in {dt*1e3:.0f} ms "
          f"({rate:.0f} pkg-steps/s), {stats.host_syncs} host syncs / "
          f"{stats.flushes} flushes (contract: 1/flush)")
    return {"stream": flushed, "host_syncs": stats.host_syncs,
            "flushes": stats.flushes, "pkg_steps_per_s": rate,
            "trace": trace}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _wave_loop(args, cfg, sched_cfg: SchedulerConfig, rho: float) -> dict:
    """Thermal-admission serving waves: fleet step → prefill → decode."""
    dev = resolve_device(args.device)
    # f32 products in full f32, as the reference computes them (PyTorch's
    # default too; stated because TF32 would keep only ~3 digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    max_seq = args.prompt_len + args.gen
    params = tf.init_params(torch.Generator(device=dev).manual_seed(
        args.seed), cfg)
    prefill_fn = S.make_prefill_step(cfg, max_seq)
    decode_fn = S.make_decode_step(cfg)

    n_pkgs = max(args.fleet, 1)
    fleet = FleetEngine(sched_cfg, backend=args.fleet_backend, device=dev)
    fst = fleet.init(n_pkgs, pkg=_node_pkg(fleet, args.node, n_pkgs))
    if args.fleet > 1:
        print(f"[fleet] backend {fleet.backend_impl.describe()} "
              f"({fleet.backend_impl.n_devices()} device(s))")
        jitter = 0.15 * torch.randn(
            (n_pkgs,), generator=torch.Generator().manual_seed(args.seed))
    else:
        jitter = torch.zeros((1,))   # a fleet of one serves the base density
    prompt_gen = torch.Generator(device=dev).manual_seed(args.seed)

    lat, admitted_hist, fleet_telem, prefill_ms = [], [], [], []
    for wave in range(args.waves):
        # --- thermal admission control -----------------------------------
        rho_fleet = torch.clamp(rho + jitter * (1 + wave % 3), 0.9, 2.7)
        fst, out, telem = fleet.step(fst, rho_fleet)
        freq0 = float(out.freq[0, 0])
        if args.fleet > 1:
            d = telem.as_dict()
            fleet_telem.append(d)
            print(f"[fleet] wave {wave}: n={args.fleet} "
                  f"p50 {d['temp_p50_c']:.1f}C p99 {d['temp_p99_c']:.1f}C "
                  f"events {int(d['events_total'])} "
                  f"released {d['released_mtps']:.1f} MTPS")
        admit = max(1, int(args.batch * freq0))
        admitted_hist.append(admit)

        prompts = torch.randint(2, cfg.vocab_size, (admit, args.prompt_len),
                                generator=prompt_gen, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        last, cache = prefill_fn(params, prompts)
        tok = torch.argmax(last, -1)
        _sync(dev)
        prefill_ms.append((time.perf_counter() - t0) * 1e3)

        for i in range(args.gen):
            t1 = time.perf_counter()
            logits, cache = decode_fn(params, cache, tok,
                                      args.prompt_len + i)
            tok = torch.argmax(logits, -1)
            _sync(dev)
            if wave or i:               # the first call warms up, as the
                lat.append(time.perf_counter() - t1)   # reference's jit
        print(f"[serve] wave {wave}: admitted {admit}/{args.batch}, "
              f"prefill {prefill_ms[-1]:.1f} ms, "
              f"decode p50 {np.percentile(lat, 50)*1e3:.2f} ms "
              f"p99 {np.percentile(lat, 99)*1e3:.2f} ms, "
              f"T {float(out.temp_c.reshape(-1)[0]):.1f}C")
    p50, p99 = np.percentile(lat, 50), np.percentile(lat, 99)
    print(f"[serve] done: p50 {p50*1e3:.2f} ms, p99 {p99*1e3:.2f} ms, "
          f"p99/p50 {p99/max(p50,1e-9):.2f}, admissions {admitted_hist}")
    result = {"p50": p50, "p99": p99, "admitted": admitted_hist,
              "prefill_ms": prefill_ms}
    if fleet_telem:
        result["fleet"] = fleet_telem
        last = fleet_telem[-1]
        print(f"[fleet] final: events {int(last['events_total'])}, "
              f"p99 {last['temp_p99_c']:.1f}C, "
              f"released {last['released_mtps']:.1f} MTPS "
              f"(throttled {last['throttled_mtps']:.1f})")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--waves", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device the model and fleet run on (cpu "
                         "only when asked for)")
    ap.add_argument("--fleet", type=int, default=1,
                    help="simulate N packages")
    ap.add_argument("--fleet-backend", default="broadcast",
                    choices=available_backends(),
                    help="fleet execution strategy")
    ap.add_argument("--filtration", default="incremental",
                    choices=["incremental", "ring"],
                    help="filtration fast path (O(1) sliding stats) or the "
                         "ring-buffer oracle")
    ap.add_argument("--plant", default="pole", choices=available_plants(),
                    help="thermal-plant fidelity rung")
    ap.add_argument("--node", default="base",
                    help="technology-node parameter bank "
                         "(repro_torch.core.nodebank): every fleet lane gets "
                         "that node's pole rows; non-base nodes run a "
                         "heterogeneous fleet")
    ap.add_argument("--stream", action="store_true",
                    help="streaming control-plane soak (async ingest, 1 "
                         "host sync per gen-step flush)")
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--chaos", action="store_true")
    ap.add_argument("--montecarlo", type=int, default=0,
                    help="run the §10 Monte-Carlo population with N trials "
                         "instead of serving")
    ap.add_argument("--mc-steps", type=int, default=3_000,
                    help="steps per Monte-Carlo trial, past the 400-step "
                         "burn-in (>= 3000 reproduces the paper's §10 "
                         "distributions)")
    args = ap.parse_args(argv)

    for flag, (what, step) in _NOT_PORTED.items():
        if getattr(args, flag):
            raise SystemExit(f"repro_torch.launch.serve: {what} is not "
                             f"ported yet: ROADMAP queue 1 step {step}")
    if args.montecarlo:
        return _montecarlo(args)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    sched_cfg = SchedulerConfig(n_tiles=1, mode="v24", step_ms=5.0,
                                filtration_impl=args.filtration,
                                plant=args.plant,
                                heterogeneous=args.node != "base")
    shape = ShapeConfig("serve", args.prompt_len + args.gen, args.batch,
                        "decode")
    rho = float(rho_v24(cfg, shape))
    if args.stream:
        return _stream_soak(args, sched_cfg, rho)
    try:
        tf.check_supported(cfg)
    except NotImplementedError as e:
        raise SystemExit(f"repro_torch.launch.serve: {e}")
    return _wave_loop(args, cfg, sched_cfg, rho)


if __name__ == "__main__":
    main()
