"""Quickstart on the PyTorch port: the paper's V24 pipeline in a page.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The port's counterpart of examples/quickstart.py.  Runs on CUDA unless
``--device cpu`` is given.

1. Build a workload-density trace (LLM inference bursts, §3.1), drawn on
   the device from seed 0.
2. Run the reactive-DVFS baseline vs the V24 PDU-gate controller on the same
   thermal plant (Rth = 0.45 °C/W, τ = 80 ms fingerprint).
3. Report Effect ①: released compute, peak temperature, P99 latency.
4. Train a tiny LM (Gemma-2B reduced to 2 layers, f32) for a few steps with
   the ThermalScheduler in the loop.  On a card every attention runs the
   hand-written flash kernels forward and backward, on the route
   `flash_route` picks (the CUDA-core kernels for f32).

`main` returns Effect ①'s numbers, the train losses and the trace.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch, reduced
from repro_torch.core import dvfs, workload
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.launch import steps as S

TRACE_STEPS, TRAIN_STEPS, N_TILES = 5000, 10, 4


def effect_one(trace: torch.Tensor) -> dict:
    """Effect ①: the reactive baseline and V24 on one trace."""
    base = dvfs.simulate_reactive(trace)
    v24 = dvfs.simulate_v24(trace)
    return {"base_perf": float(base.perf), "v24_perf": float(v24.perf),
            "base_peak": float(base.temp.max()),
            "v24_peak": float(v24.temp.max()),
            "base_events": int(base.events), "v24_events": int(v24.events),
            "released": float(dvfs.released_compute(base, v24)),
            "base_p99": float(base.p99_latency),
            "v24_p99": float(v24.p99_latency)}


def train_config():
    return reduced(get_arch("gemma-2b"), n_layers=2)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu only when asked for)")
    ap.add_argument("--steps", type=int, default=TRACE_STEPS,
                    help="length of the Effect ① trace")
    ap.add_argument("--train-steps", type=int, default=TRAIN_STEPS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ---- 1+2: Effect ① on a synthetic trace ------------------------------
    trace = workload.make_trace(0, args.steps, "inference", device=dev)
    e = effect_one(trace)
    print("== Effect ①: thermal-throttling elimination ==")
    print(f"  baseline perf {e['base_perf']:.3f} "
          f"(peak {e['base_peak']:.1f} °C, "
          f"{e['base_events']} throttle events)")
    print(f"  V24      perf {e['v24_perf']:.3f} "
          f"(peak {e['v24_peak']:.1f} °C, {e['v24_events']} events)")
    print(f"  released compute: +{e['released'] * 100:.1f} % "
          f"(paper: +20-30 %)")
    print(f"  P99 latency: {e['base_p99']:.2f} -> {e['v24_p99']:.2f}")

    # ---- 3: the same controller inside a training loop --------------------
    print(f"\n== V24 inside a PyTorch training loop (gemma-2b, reduced) "
          f"on {dev} ==")
    cfg = train_config()
    data = SyntheticLMData(cfg, DataConfig(batch=4, seq_len=64))
    state = S.init_train_state(torch.Generator(device=dev).manual_seed(0),
                               cfg, n_tiles=N_TILES)
    step = S.make_train_step(cfg, N_TILES, device=dev)
    rho = torch.full((N_TILES,), 2.0, device=dev)
    losses = []
    try:
        for i in range(args.train_steps):
            b = data.next()
            state, m = step(state, {
                "tokens": torch.from_numpy(b["tokens"]).to(dev),
                "labels": torch.from_numpy(b["labels"]).to(dev),
                "rho": rho})
            losses.append(float(m["loss"]))
            if i % 3 == 0:
                print(f"  step {i}: loss {losses[-1]:.3f}  "
                      f"Tmax {float(m['thermal_temp_max']):.1f} °C  "
                      f"f {float(m['thermal_freq_min']):.3f}  "
                      f"eta {float(m['thermal_eta']) * 100:.1f} %")
    finally:
        data.close()
    train_events = int(state.sched.events)
    print("done — junction never crossed 85 °C:", train_events == 0)
    return dict(e, losses=losses, train_events=train_events, trace=trace)


if __name__ == "__main__":
    main()
