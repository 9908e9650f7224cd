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
every Mamba2 and RWKV6 layer through the ssd kernel; decode runs neither.
Every architecture in `configs` is served: dense (Gemma, Granite), hybrid
(Zamba2), ssm (RWKV6), moe (Mixtral with its sliding-window ring,
DeepSeek-V2 with MLA) and the stub frontends (chameleon's patch and
musicgen's frame embeddings: prompts are 0.02·N(0, 1) embeddings
[admit, prompt_len, d_model] and decode feeds one fixed embedding
[admit, d_model] every step, as the reference does).

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

``--serve`` starts the RESIDENT control plane (`repro_torch.fleet.service`)
instead of the wave loop: a `FleetService` on ``--device`` with
``--fleet`` packages attached (0: it starts empty and packages attach over
HTTP), warmed across its capacity buckets, ticking one flush per
``--flush-every`` steps while the HTTP operator API
(docs/torch_serving.md) listens on ``--port``; it runs until POST
/shutdown, SIGTERM (a final blocking snapshot with ``--snapshot-dir``) or
``--serve-flushes`` flushes of a non-empty fleet.  ``--chaos`` runs the
fault-injection soak: hint starvation and recovery, sensor-fault
containment on every backend, the degraded alert's edges at the service,
and SIGTERM → snapshot → `FleetService.restore` ≤1e-5-equivalent to an
uninterrupted run with no kernel library built or loaded after the
restore's warmup; it exits non-zero on any failed gate.

``--fleet-backend sharded|sharded_fused`` places the fleet of
``--stream``, ``--montecarlo`` and ``--serve`` (and the wave loop's) on a
device mesh in this process: the package axis partitioned over
``--fleet-devices`` cards (0: every visible one), one `fleet_step` launch
per partition per window on ``sharded_fused``.  A budget the fleet size
does not divide degrades loudly to the largest divisor (a RuntimeWarning);
the ``[stream]`` / ``[fleet]`` lines log the backend's actual mesh after
init.

``--distributed`` makes this invocation ONE rank of a process group
(`repro_torch.distributed.multihost`) running the ``--stream`` soak on a
mesh backend: start one per rank with ``--coordinator`` (rank 0's
host:port), ``--num-processes`` and ``--process-id``; ``--fleet`` is the
GLOBAL fleet size.  The group is joined before anything else runs; every
rank makes the same global trace from ``--seed``, cuts its own lane span
and streams it (`fleet.distributed_stream`), one collective a flush; the
records are the same on every rank, and rank 0 prints them.  A rank's mesh
takes its visible cards (``--device cpu``: the host).  It needs
``--stream`` and ``--fleet-backend sharded|sharded_fused``.

``--plant grid|rom`` streams through the per-step path of ``broadcast``;
on ``fused`` ``rom`` rides the kernel's het rows and ``grid`` is handed to
the per-step path.
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
from repro_torch.distributed import multihost
from repro_torch.fleet import (FleetEngine, available_backends, chunk_source,
                               distributed_stream, stream)
from repro_torch.launch import steps as S
from repro_torch.models import transformer as tf


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
                       device=dev, devices=args.fleet_devices or None)
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
    """--stream: fleet control-plane soak through the streaming ingest loop.

    With ``--distributed`` this is ONE rank of a process group (`main`
    joined it): the fleet size is global, every rank makes the whole trace
    from the seed and streams its own lane span, and the records, the same
    on every rank, are printed by rank 0 alone."""
    n = max(args.fleet, 1)
    eng = FleetEngine(sched_cfg, backend=args.fleet_backend,
                      device=args.device, devices=args.fleet_devices or None)
    steps = args.waves * args.gen
    t = np.linspace(0.0, np.pi, steps, dtype=np.float32)
    swell = rho * (0.85 + 0.3 * np.sin(t) ** 2)                # [T]
    gen = torch.Generator().manual_seed(args.seed)
    jitter = 0.15 * torch.randn((n, sched_cfg.n_tiles), generator=gen)
    trace = np.clip(swell[:, None, None] + jitter.numpy(), 0.9, 2.7
                    ).astype(np.float32)                       # [T, n, tiles]

    topo = multihost.topology()
    rank0 = topo.process_id == 0

    def on_flush(i, d):
        if rank0:
            print(f"[stream] flush {i}: p50 {d['temp_p50_c']:.1f}C "
                  f"p99 {d['temp_p99_c']:.1f}C f_mean {d['freq_mean']:.3f} "
                  f"released {d['released_mtps']:.1f} MTPS "
                  f"events {int(d['events_total'])}")

    state = eng.init(n, pkg=_node_pkg(eng, args.node, n))
    # the mesh is resolved at init: the line names the ACTUAL devices
    tag = (f"[stream p{topo.process_id}/{topo.num_processes}]"
           if args.distributed else "[stream]")
    print(f"{tag} backend {eng.backend_impl.describe()} on {eng.device} "
          f"({eng.backend_impl.n_devices()} device(s)), fleet {n}")
    t0 = time.perf_counter()
    if args.distributed:
        state, flushed, stats = distributed_stream(
            eng, state, chunk_source(trace, args.gen), global_chunks=True,
            on_flush=on_flush)
    else:
        state, flushed, stats = stream(eng, state,
                                       chunk_source(trace, args.gen),
                                       on_flush=on_flush)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    rate = stats.steps * n / max(dt, 1e-9)
    print(f"{tag} done: {stats.steps} steps x {n} pkgs "
          f"({eng.backend_impl.describe()}) in {dt*1e3:.0f} ms "
          f"({rate:.0f} pkg-steps/s), {stats.host_syncs} host syncs / "
          f"{stats.flushes} flushes (contract: 1/flush)")
    return {"stream": flushed, "host_syncs": stats.host_syncs,
            "flushes": stats.flushes, "pkg_steps_per_s": rate,
            "trace": trace}


def _serve_resident(args, sched_cfg: SchedulerConfig) -> dict:
    """--serve: the resident multi-tenant control plane
    (docs/torch_serving.md).

    With ``--snapshot-dir`` the service journals every membership op and
    snapshots every ``--snapshot-every`` flushes; a SIGTERM (preemption)
    takes one final BLOCKING snapshot before exiting, so
    `FleetService.restore()` resumes the stream losslessly."""
    import dataclasses

    from repro_torch.distributed.fault_tolerance import PreemptionGuard
    from repro_torch.fleet.service import FleetService, serve_http
    # the resident plane always carries the per-lane controller pins so
    # operators can canary (POST /canary, /mode) without a restart;
    # unpinned lanes are bit-identical to a plain v24 fleet
    sched_cfg = dataclasses.replace(sched_cfg, mixed_mode=True)
    svc = FleetService(sched_cfg, backend=args.fleet_backend,
                       min_capacity=4, flush_every=args.flush_every,
                       seed=args.seed,
                       snapshot_dir=args.snapshot_dir or None,
                       snapshot_every=args.snapshot_every,
                       heartbeat_timeout_s=args.heartbeat_timeout,
                       device=args.device, devices=args.fleet_devices or None)
    n0 = max(args.fleet, 0)      # 0: start empty, packages attach over HTTP
    buckets = svc.warmup(max_packages=max(2 * n0, 8))
    print(f"[serve] warmed {buckets} capacity buckets on {svc.device}, "
          f"backend {svc.engine.backend_impl.describe()} "
          f"(no kernel library built or loaded from here)")
    for i in range(n0):
        svc.attach(f"pkg{i}", tenant="default", kind="inference",
                   node=args.node)
    guard = PreemptionGuard()
    server, _ = serve_http(svc, host=args.host, port=args.port)
    host, port = server.server_address[:2]
    print(f"[serve] control plane on http://{host}:{port} — "
          f"GET /healthz /telemetry /fleet /alerts /dashboard, "
          f"POST /attach /detach /thresholds /ingest /replay /shutdown "
          f"/canary /mode", flush=True)
    flushes = 0
    try:
        while (not svc.shutting_down and not guard.should_exit
               and (args.serve_flushes == 0
                    or flushes < args.serve_flushes)):
            rec = svc.tick()
            if rec is None:
                time.sleep(0.05)       # empty fleet — idle until an attach
                continue
            flushes += 1
            d = rec["telemetry"]
            print(f"[serve] flush {rec['flush']}: n={d['n_packages']} "
                  f"cap={rec['capacity']} p99 {d['temp_p99_c']:.1f}C "
                  f"f_mean {d['freq_mean']:.3f} "
                  f"alerts {len(rec['alerts'])}", flush=True)
    finally:
        if guard.should_exit and svc.snapshot_dir is not None:
            step = svc.save_snapshot(blocking=True)
            print(f"[serve] preempted: final snapshot at step {step} "
                  f"-> {svc.snapshot_dir}")
        guard.restore()
        server.shutdown()
    return {"flushes": flushes, "port": port,
            "capacity": svc.registry.capacity,
            "n_active": svc.registry.n_active,
            "host_syncs": svc.host_syncs,
            "preempted": guard.should_exit}


def _chaos_soak(args) -> dict:
    """--chaos: the fault-injection soak, four phases, each gated — any
    failure exits non-zero:

      1. fleet-wide hint starvation: every lane falls back to reactive
         polling, then recovers with hysteresis;
      2. per-lane sensor faults (dropout + NaN/Inf corruption): contained
         on every backend (broadcast, fused, vmap), unaffected lanes
         bit-match a fault-free run, telemetry equivalent across backends;
      3. the service surface: the ``degraded`` alert fires on the rising
         edge and clears on the falling edge;
      4. mid-run SIGTERM → final snapshot → `FleetService.restore()`
         resumes ≤1e-5-equivalent to an uninterrupted oracle, with no
         kernel library built or loaded after the restore's warmup.
    """
    import os
    import signal
    import tempfile

    from repro_torch.distributed.fault_tolerance import PreemptionGuard
    from repro_torch.distributed.sharding import gather
    from repro_torch.fleet import FaultPlan
    from repro_torch.fleet.faults import HintOutage, SensorFault
    from repro_torch.fleet.service import FleetService
    from repro_torch.kernels import _build

    dev = resolve_device(args.device)
    failures: list[str] = []

    def check(ok, msg):
        print(f"[chaos] {'ok  ' if ok else 'FAIL'} {msg}")
        if not ok:
            failures.append(msg)

    def host(x) -> np.ndarray:
        """A leaf on the host (a mesh backend's partitions gathered)."""
        return gather(x).detach().cpu().numpy()

    cfg = SchedulerConfig(n_tiles=2, mode="v24", filtration_window=16,
                          degraded_fallback=True, stale_limit_steps=4,
                          recover_steps=8)
    n, T, K = 8, 384, 64
    rng = np.random.default_rng(args.seed)
    trace = rng.uniform(0.9, 2.7, (T, n, cfg.n_tiles)).astype(np.float32)

    # -- phase 1: hint starvation — engage + hysteresis recovery ----------
    starve = FaultPlan(seed=args.seed, hint_outages=(HintOutage(96, 24),))
    eng = FleetEngine(cfg, backend="broadcast", device=dev, debug_nan=True)
    st, tel = eng.run_chunked(eng.init(n), starve.apply(trace, 0), K)
    dc = host(tel.degraded_count)                  # [F] window peaks
    check(int(dc[96 // K]) == n,
          f"starvation flush degrades all {n} lanes (peaks {dc.tolist()})")
    check(int(dc[-1]) == 0, "fleet recovered by the final flush")
    check(int(host(st.degraded).sum()) == 0, "no lane left degraded")

    # -- phase 2: sensor faults — containment on every backend ------------
    plan = FaultPlan(seed=args.seed,
                     sensor_faults=(SensorFault(2, "dropout", 120, 48),
                                    SensorFault(5, "corrupt", 180, 32)))
    faulted = plan.apply(trace, 0)
    ok_lanes = [i for i in range(n) if i not in plan.faulted_lanes()]
    exact = ("events_total", "events_step", "degraded_count", "n_packages")
    knife = ("freq_min", "at_risk_frac")
    ref = None
    for be in available_backends():
        e1 = FleetEngine(cfg, backend=be, device=dev, debug_nan=True)
        s1, t1 = e1.run_chunked(e1.init(n), faulted, K)
        e0 = FleetEngine(cfg, backend=be, device=dev)
        s0, _ = e0.run_chunked(e0.init(n), trace, K)
        bit = all(np.array_equal(host(getattr(s1, f))[ok_lanes],
                                 host(getattr(s0, f))[ok_lanes])
                  for f in ("freq", "thermal", "events", "rho_last"))
        check(bit, f"{be}: unaffected lanes bit-match the fault-free run")
        d1 = {k: host(v) for k, v in t1._asdict().items()}
        check(int(d1["degraded_count"].max()) >= 1
              and int(d1["degraded_count"][-1]) == 0,
              f"{be}: faulted lanes degrade and recover "
              f"(peaks {d1['degraded_count'].tolist()})")
        if ref is None:
            ref = d1
            continue
        for k, v in d1.items():
            if k in exact:
                same = np.array_equal(ref[k], v)
            elif k in knife:
                same = np.allclose(ref[k], v, rtol=1e-3, atol=1e-3)
            else:
                same = np.allclose(ref[k], v, rtol=1e-4, atol=5e-5)
            check(same, f"{be}: telemetry[{k}] matches "
                        f"{available_backends()[0]}")

    # -- phase 3: degraded alert rises and clears at the service ----------
    svc = FleetService(cfg, flush_every=50, seed=args.seed, debug_nan=True,
                       device=dev)
    for i in range(4):
        svc.attach(f"pkg{i}", tenant="acme")
    svc.set_thresholds("acme", degraded_limit=0)
    cap = svc.registry.capacity
    chunk = rng.uniform(0.9, 2.7, (50, cap, cfg.n_tiles)).astype(np.float32)
    bad_chunk = chunk.copy()
    bad_chunk[25:, 0, :] = np.nan       # lane 0 dark through the flush edge
    svc.tick(chunk=chunk)
    rec_bad = svc.tick(chunk=bad_chunk)
    rec_ok = svc.tick(chunk=chunk)      # sensor back — recover + clear
    rec_clean = svc.tick(chunk=chunk)   # fully recovered window
    fired = [a for a in rec_bad["alerts"] if a["kind"] == "degraded"]
    cleared = [a for a in rec_ok["alerts"] if a["kind"] == "degraded"]
    check(len(fired) == 1 and fired[0]["event"] == "fired",
          f"degraded alert fired once ({fired})")
    check(len(cleared) == 1 and cleared[0]["event"] == "cleared",
          f"degraded alert cleared once ({cleared})")
    check(not [a for a in rec_clean["alerts"] if a["kind"] == "degraded"],
          "no duplicate degraded events once steady")
    check(rec_bad["telemetry"]["degraded_count"] >= 1
          and rec_clean["telemetry"]["degraded_count"] == 0,
          "flush records carry the degraded counts")

    # -- phase 4: SIGTERM mid-run → snapshot → restore → equivalence ------
    def drive(svc, until, grow_at):
        while svc.flushes < until:
            if svc.flushes == grow_at:       # capacity transition mid-run
                for i in range(4, 9):
                    svc.attach(f"pkg{i}", tenant="acme")
            svc.tick()
        return svc.log.rows()[-1]["telemetry"]

    f_total, f_kill, f_grow = 16, 10, 6
    oracle = FleetService(cfg, flush_every=50, seed=args.seed, device=dev)
    for i in range(4):
        oracle.attach(f"pkg{i}", tenant="acme")
    final_oracle = drive(oracle, f_total, f_grow)

    with tempfile.TemporaryDirectory() as tmp:
        victim = FleetService(cfg, flush_every=50, seed=args.seed,
                              snapshot_dir=tmp, snapshot_every=4,
                              device=dev)
        victim.warmup(16)
        for i in range(4):
            victim.attach(f"pkg{i}", tenant="acme")
        guard = PreemptionGuard()
        drive(victim, f_kill, f_grow)
        os.kill(os.getpid(), signal.SIGTERM)     # preemption notice
        time.sleep(0)                            # let the handler run
        check(guard.should_exit, "SIGTERM reached the PreemptionGuard")
        victim.save_snapshot(blocking=True)      # the --serve exit path
        guard.restore()
        del victim

        restored = FleetService.restore(tmp, debug_nan=True, device=dev)
        check(restored.flushes == f_kill and restored.registry.n_active == 9,
              f"restored at flush {restored.flushes} with "
              f"{restored.registry.n_active} packages")
        counts = dict(_build.COUNTS)
        final_restored = drive(restored, f_total, f_grow)
        check(_build.COUNTS == counts,
              f"no kernel library built or loaded after restore "
              f"({counts} -> {_build.COUNTS})")
        worst = max(abs(final_restored[k] - final_oracle[k])
                    / max(abs(final_oracle[k]), 1e-9)
                    for k in final_oracle)
        check(worst <= 1e-5,
              f"restore ≤1e-5-equivalent to uninterrupted "
              f"(worst rel diff {worst:.2e})")
        restored.wait_snapshots()

    if failures:
        print(f"[chaos] {len(failures)} failure(s):")
        for f in failures:
            print(f"[chaos]   - {f}")
        raise SystemExit(1)
    print("[chaos] all gates passed")
    return {"chaos": "ok"}


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
    fleet = FleetEngine(sched_cfg, backend=args.fleet_backend, device=dev,
                        devices=args.fleet_devices or None)
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

        if cfg.frontend == "token":
            prompts = torch.randint(2, cfg.vocab_size,
                                    (admit, args.prompt_len),
                                    generator=prompt_gen, device=dev)
        else:                        # stub frontend: frame / patch embeds
            prompts, frame = (0.02 * torch.randn(
                shape, generator=prompt_gen, device=dev) for shape in (
                    (admit, args.prompt_len, cfg.d_model),
                    (admit, cfg.d_model)))
        _sync(dev)
        t0 = time.perf_counter()
        last, cache = prefill_fn(params, prompts)
        tok = torch.argmax(last, -1) if cfg.frontend == "token" else frame
        _sync(dev)
        prefill_ms.append((time.perf_counter() - t0) * 1e3)

        for i in range(args.gen):
            t1 = time.perf_counter()
            logits, cache = decode_fn(params, cache, tok,
                                      args.prompt_len + i)
            if cfg.frontend == "token":      # a stub frontend's frame stays
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


def parse_args(argv=None) -> argparse.Namespace:
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
    ap.add_argument("--fleet-devices", type=int, default=0,
                    help="sharded/sharded_fused backend device budget "
                         "(0 = all visible)")
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
    ap.add_argument("--distributed", action="store_true",
                    help="join a process group: this invocation is ONE rank "
                         "of a --stream soak on a mesh backend (start one "
                         "per rank with --process-id 0..N-1; --fleet is "
                         "the GLOBAL fleet size)")
    ap.add_argument("--coordinator", default="127.0.0.1:8476",
                    help="--distributed: rank 0's host:port")
    ap.add_argument("--num-processes", type=int, default=1,
                    help="--distributed: the group's process count")
    ap.add_argument("--process-id", type=int, default=0,
                    help="--distributed: this process's rank")
    ap.add_argument("--serve", action="store_true",
                    help="resident control plane: FleetService + HTTP "
                         "operator API instead of the wave loop "
                         "(docs/torch_serving.md)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="--serve bind address")
    ap.add_argument("--port", type=int, default=8787,
                    help="--serve port (0 = ephemeral)")
    ap.add_argument("--flush-every", type=int, default=50,
                    help="--serve steps per flush window")
    ap.add_argument("--serve-flushes", type=int, default=0,
                    help="--serve: stop after N flushes (0 = run until "
                         "POST /shutdown)")
    ap.add_argument("--snapshot-dir", default="",
                    help="--serve: journal + snapshot directory; enables "
                         "crash-consistent recovery via "
                         "FleetService.restore()")
    ap.add_argument("--snapshot-every", type=int, default=8,
                    help="--serve: async snapshot every N flushes "
                         "(needs --snapshot-dir)")
    ap.add_argument("--heartbeat-timeout", type=float, default=0.0,
                    help="--serve: mark /healthz stalled when no flush "
                         "lands for this many seconds (0 = off)")
    ap.add_argument("--chaos", action="store_true",
                    help="fault-injection soak: starvation fallback + "
                         "recovery, sensor-fault containment on every "
                         "backend, degraded alert edges, SIGTERM -> "
                         "snapshot -> restore equivalence; exits non-zero "
                         "on any failed gate")
    ap.add_argument("--montecarlo", type=int, default=0,
                    help="run the §10 Monte-Carlo population with N trials "
                         "instead of serving")
    ap.add_argument("--mc-steps", type=int, default=3_000,
                    help="steps per Monte-Carlo trial, past the 400-step "
                         "burn-in (>= 3000 reproduces the paper's §10 "
                         "distributions)")
    args = ap.parse_args(argv)
    if args.distributed:
        if not args.stream:
            ap.error("--distributed requires --stream (the multi-process "
                     "path is the streaming fleet soak)")
        if args.fleet_backend not in ("sharded", "sharded_fused"):
            ap.error(f"--distributed needs a device-mesh backend "
                     f"(sharded/sharded_fused), got --fleet-backend "
                     f"{args.fleet_backend}")
    return args


def wave_setup(args) -> tuple:
    """(the model config, the fleet's scheduler config, the base density
    ρv24 at the serving shape) for ``args``."""
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    sched_cfg = SchedulerConfig(n_tiles=1, mode="v24", step_ms=5.0,
                                filtration_impl=args.filtration,
                                plant=args.plant,
                                heterogeneous=args.node != "base")
    shape = ShapeConfig("serve", args.prompt_len + args.gen, args.batch,
                        "decode")
    return cfg, sched_cfg, float(rho_v24(cfg, shape))


def main(argv=None):
    args = parse_args(argv)
    if args.distributed:
        # the group first: every engine built later sees its global mesh
        topo = multihost.initialize(args.coordinator, args.num_processes,
                                    args.process_id)
        print(f"[distributed] {topo.describe()}", flush=True)
    if args.chaos:
        return _chaos_soak(args)
    if args.montecarlo:
        return _montecarlo(args)

    cfg, sched_cfg, rho = wave_setup(args)
    if args.serve:                   # resident control plane, no wave loop
        return _serve_resident(args, sched_cfg)
    if args.stream:
        return _stream_soak(args, sched_cfg, rho)
    return _wave_loop(args, cfg, sched_cfg, rho)


if __name__ == "__main__":
    main()
