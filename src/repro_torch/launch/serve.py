"""Fleet serving driver — the ``--stream`` control-plane soak on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --stream \\
        --fleet 4096 --fleet-backend fused --waves 4 --gen 256

Port of `repro.launch.serve`'s ``--stream`` path: the whole
``waves × gen``-step density trace of a ``--fleet``-package fleet is driven
through the streaming ingest loop (`repro_torch.fleet.ingest`) — pinned,
asynchronous host→device uploads, a bounded look-ahead hint queue, telemetry
reduced on the device over each ``gen``-step flush window and fetched with
ONE host sync per flush.  The base density is ρv24 of ``--arch`` at the
serving shape (``--batch`` × ``--prompt-len + --gen``, decode); each package
adds its own load jitter, drawn from a `torch.Generator` seeded by
``--seed``.  (The reference draws it with ``jax.random``, whose streams
PyTorch cannot reproduce; parity tests feed traces the reference made.)

The scheduler defaults match the reference: one tile, ``step_ms=5``, v24,
backend ``broadcast``.  ``--device`` defaults to ``cuda`` and the run fails
without a card unless ``--device cpu`` is given.

Not ported yet, each exits non-zero naming its ROADMAP step: the model wave
loop (the default without ``--stream``), ``--montecarlo``, ``--serve``,
``--chaos`` and ``--distributed``; ``--node`` other than ``base``.
``--plant grid|rom`` streams through the per-step path of ``broadcast``
(``grid`` also on ``fused``, which hands it to that path; ``rom`` on
``fused`` raises, ROADMAP queue 1 step 5).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.density import rho_v24
from repro_torch.core.plant import available_plants
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.fleet import (FleetEngine, available_backends, chunk_source,
                               stream)

_NOT_PORTED = {
    "montecarlo": ("--montecarlo (the §10 Monte-Carlo population)", 5),
    "serve": ("--serve (the resident control plane)", 8),
    "chaos": ("--chaos (the fault-injection soak)", 5),
    "distributed": ("--distributed (multi-host streaming)", 9),
}


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

    state = eng.init(n)
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
                    help="torch device the fleet runs on (cpu only when "
                         "asked for)")
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
                    help="technology-node parameter bank (only 'base' is "
                         "ported)")
    ap.add_argument("--stream", action="store_true",
                    help="streaming control-plane soak (async ingest, 1 "
                         "host sync per gen-step flush)")
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--chaos", action="store_true")
    ap.add_argument("--montecarlo", type=int, default=0)
    args = ap.parse_args(argv)

    for flag, (what, step) in _NOT_PORTED.items():
        if getattr(args, flag):
            raise SystemExit(f"repro_torch.launch.serve: {what} is not "
                             f"ported yet: ROADMAP queue 1 step {step}")
    if not args.stream:
        raise SystemExit("repro_torch.launch.serve: the model-serving wave "
                         "loop is not ported yet (ROADMAP queue 1 step 10); "
                         "run with --stream")
    if args.node != "base":
        raise SystemExit(f"repro_torch.launch.serve: --node {args.node} "
                         f"(heterogeneous node banks) is not ported yet: "
                         f"ROADMAP queue 1 step 5")

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    sched_cfg = SchedulerConfig(n_tiles=1, mode="v24", step_ms=5.0,
                                filtration_impl=args.filtration,
                                plant=args.plant)
    shape = ShapeConfig("serve", args.prompt_len + args.gen, args.batch,
                        "decode")
    return _stream_soak(args, sched_cfg, float(rho_v24(cfg, shape)))


if __name__ == "__main__":
    main()
