"""Fleet-scale thermal scheduling on the PyTorch port: 512 packages.

    PYTHONPATH=src python examples/torch_fleet_sim.py [--backend fused] [--stream]
    PYTHONPATH=src python examples/torch_fleet_sim.py --device cpu

The port's counterpart of examples/fleet_sim.py.  Simulates a fleet of 512
four-tile packages through a diurnal load swell (ρ ramps 0.9 → 2.7 and
back, plus per-package process jitter drawn with numpy from seed 0).  The
`FleetEngine` advances every package's V24 scheduler in one batched call a
step — on the broadcast, fused, vmap, sharded or sharded_fused backend —
and reports fleet-wide telemetry: thermal events (want 0), p50/p99
junction temperature, and the throughput released vs held back.

``--stream`` runs the same trace through the streaming ingest loop
(`repro_torch.fleet.ingest`) in 6-step flushes: one host sync a flush.  On
a card the fused and sharded_fused backends advance each flush's chunk in
one launch of the hand-written `fleet_step` kernel; the per-step loop (and
the broadcast backend everywhere) runs the scheduler's update, whose fused
multiply-adds are launches of `fma_f32`.  Runs on CUDA unless ``--device
cpu`` is given.  Returns the numbers its tests and chip_smoke.py check.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.nodebank import available_nodes, fleet_package_params
from repro_torch.core.plant import available_plants
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.fleet import (FleetEngine, available_backends, chunk_source,
                               stream)

N_PACKAGES, N_TILES, STEPS, FLUSH = 512, 4, 48, 6


def swell_trace(n_packages: int, steps: int, n_tiles: int = N_TILES,
                seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(swell [steps], trace [steps, n_packages, n_tiles]) f32: the diurnal
    swell plus per-(package, tile) jitter, clipped to ρ's domain."""
    t = np.linspace(0.0, np.pi, steps, dtype=np.float32)
    swell = (0.9 + 1.8 * np.sin(t) ** 2).astype(np.float32)
    jitter = 0.2 * np.random.default_rng(seed).standard_normal(
        (n_packages, n_tiles)).astype(np.float32)
    trace = np.clip(swell[:, None, None] + jitter, 0.9, 2.7)
    return swell, trace.astype(np.float32)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--backend", default="broadcast",
                    choices=available_backends())
    ap.add_argument("--devices", type=int, default=0,
                    help="sharded/sharded_fused backend device budget "
                         "(0 = all visible)")
    ap.add_argument("--stream", action="store_true",
                    help="drive the trace through the streaming ingest loop")
    ap.add_argument("--filtration", default="incremental",
                    choices=["incremental", "ring"],
                    help="O(1) sliding-stats fast path or ring-buffer oracle")
    ap.add_argument("--plant", default="pole", choices=available_plants(),
                    help="thermal-plant fidelity rung")
    ap.add_argument("--node", default="base", choices=available_nodes(),
                    help="technology-node parameter bank: every lane gets "
                         "that node's thermal/DVFS rows (non-base = "
                         "heterogeneous pole fleet)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu only when asked for)")
    ap.add_argument("--packages", type=int, default=N_PACKAGES)
    ap.add_argument("--steps", type=int, default=STEPS)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    n, steps = args.packages, args.steps
    mesh = args.backend in ("sharded", "sharded_fused")
    eng = FleetEngine(SchedulerConfig(n_tiles=N_TILES, mode="v24",
                                      filtration_impl=args.filtration,
                                      plant=args.plant,
                                      heterogeneous=args.node != "base"),
                      backend=args.backend, device=dev,
                      devices=(args.devices or None) if mesh else None)

    def init():
        if args.node == "base":
            return eng.init(n)
        return eng.init(n, pkg=fleet_package_params(eng.sched,
                                                    [args.node] * n))

    state = init()
    swell, trace = swell_trace(n, steps)
    print(f"fleet of {n} packages x {N_TILES} tiles, {steps} steps, "
          f"backend {eng.backend_impl.describe()}")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    res = {"backend": args.backend, "trace": trace}

    if args.stream:
        print("flush  p50C   p99C  f_mean  released  events")

        def on_flush(i, d):
            print(f"{i:5d}  {d['temp_p50_c']:5.1f}  {d['temp_p99_c']:5.1f}  "
                  f"{d['freq_mean']:.3f}  {d['released_mtps']:8.1f}  "
                  f"{int(d['events_total']):d}")
        sync()
        t0 = time.perf_counter()
        state, flushed, stats = stream(eng, state, chunk_source(trace, FLUSH),
                                       on_flush=on_flush)
        sync()
        wall = time.perf_counter() - t0
        print(f"\ndone: {int(flushed[-1]['events_total'])} thermal events "
              f"(target 0), final-window p99 {flushed[-1]['temp_p99_c']:.1f}C, "
              f"{stats.host_syncs} host syncs for {stats.steps} steps")
        return dict(res, flushed=flushed, flushes=stats.flushes,
                    host_syncs=stats.host_syncs, steps=stats.steps,
                    events=int(flushed[-1]["events_total"]),
                    ms_per_step=wall * 1e3 / stats.steps)

    print("step  rho   p50C   p99C  maxC  f_mean  released  throttled  events")
    rho = torch.from_numpy(trace).to(eng.device)
    records = {}
    sync()
    t0 = time.perf_counter()
    for i in range(steps):
        state, out, telem = eng.step(state, rho[i])
        if i % 6 == 0 or i == steps - 1:
            d = records[i] = telem.as_dict()
            print(f"{i:4d}  {float(swell[i]):.2f}  {d['temp_p50_c']:5.1f}  "
                  f"{d['temp_p99_c']:5.1f}  {d['temp_max_c']:5.1f}  "
                  f"{d['freq_mean']:.3f}  {d['released_mtps']:8.1f}  "
                  f"{d['throttled_mtps']:9.1f}  {int(d['events_total']):d}")
    sync()
    wall = time.perf_counter() - t0
    d = records[steps - 1]
    print(f"\ndone: {int(d['events_total'])} thermal events across the fleet "
          f"(target 0), final p99 {d['temp_p99_c']:.1f}C")

    # same trace through the whole-trace runner
    _, telems = eng.run(init(), rho)
    peak = float(telems.temp_p99_c.max())
    run_events = int(telems.events_total[-1])
    print(f"scan runner agrees: peak p99 {peak:.1f}C, events {run_events}")
    return dict(res, records=records, events=int(d["events_total"]),
                temps=eng.gather(out.temp_c).cpu(),
                freqs=eng.gather(out.freq).cpu(),
                run_peak_p99=peak, run_events=run_events,
                ms_per_step=wall * 1e3 / steps)


if __name__ == "__main__":
    main()
