#!/usr/bin/env python3
"""Time one broadcast-fleet step of the port at cell B's size on one GPU.

    python3 examples/torch_broadcast_step.py [--src DIR] [--reps 10]

Builds `FleetEngine(SchedulerConfig(n_tiles=47, mode="v24"),
backend="broadcast")` with 4,096 packages — the per-step path, whose Γ
products and fused multiply-adds go through `repro_torch.fma_f32` — from
the package under ``DIR/src`` (default: this checkout), steps it 3 times
to warm up, then times ``reps`` steps on a seeded uniform density in
[0.9, 2.7], each on the host clock between two `torch.cuda.synchronize()`
calls.  Prints one JSON line: the source, the median and every step's ms,
and the FMA kernel launches of one step where the package counts them.
Comparing two trees on one card means running both in one call, in turns
(this, other, other, this).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]),
                    help="tree whose src/repro_torch is timed")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.fleet import FleetEngine

    if not torch.cuda.is_available():
        raise SystemExit("torch_broadcast_step: needs a GPU")
    n, nt = 4096, 47
    eng = FleetEngine(SchedulerConfig(n_tiles=nt, mode="v24"),
                      backend="broadcast", device="cuda")
    rng = np.random.default_rng(0)
    rho = torch.from_numpy(rng.uniform(0.9, 2.7, (args.reps + 4, n, nt))
                           .astype(np.float32)).cuda()
    state = eng.init(n)
    for k in range(3):
        state, _, _ = eng.step(state, rho[k])
    counter = getattr(repro_torch.fma_f32, "launches", None)
    if counter is not None:
        repro_torch.fma_f32.launches = 0
    state, _, _ = eng.step(state, rho[3])
    launches = (repro_torch.fma_f32.launches if counter is not None
                else None)
    times = []
    for k in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _, telem = eng.step(state, rho[4 + k])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"src": str(Path(args.src).resolve()),
                      "device": torch.cuda.get_device_name(0),
                      "median_ms": statistics.median(times),
                      "step_ms": times, "fma_launches_per_step": launches,
                      "freq_mean": float(telem.freq_mean)}))


if __name__ == "__main__":
    main()
