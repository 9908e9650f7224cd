"""The paper's Fig. 3 fingerprint dashboard as terminal panels, on the port.

    PYTHONPATH=src python examples/torch_thermal_dashboard.py [--device cpu]

The port's counterpart of examples/thermal_dashboard.py.  Every panel runs
on ``--device`` (CUDA unless ``--device cpu`` is given): the Appendix-B
dataset is drawn and fitted there, the step response and η computed
there.  The live panels (5 and 7) run on the fleet engine — a fleet of
one package driven through `FleetEngine.block_traces`, the same whole-chunk
path the control plane serves from; its default broadcast backend launches
`fma_f32` for the scheduler's fused multiply-adds on a card.

Against a RUNNING port control plane (``repro_torch.launch.serve --serve``,
or `repro_torch.fleet.serve_http` on the same endpoints):

    PYTHONPATH=src python examples/torch_thermal_dashboard.py \
        --url http://127.0.0.1:8787

polls GET /telemetry and renders the recorded flush history (fleet p99
junction temperature, mean frequency, at-risk fraction, alert feed) as the
same sparkline panels.  `main` returns the panels' numbers.
"""
import argparse
import json
import sys
import urllib.request
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import dataset90k, pdu_gate, thermal, workload
from repro_torch.core.fingerprint import FINGERPRINT as FP
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.fleet import FleetEngine


def spark(values, width=60, lo=None, hi=None):
    """A sparkline of a 1-D tensor, array or list."""
    blocks = " ▁▂▃▄▅▆▇█"
    v = np.asarray(values.detach().cpu() if torch.is_tensor(values)
                   else values, np.float32)
    idx = np.linspace(0, len(v) - 1, min(width, len(v))).astype(int)
    v = v[idx]
    lo = float(v.min()) if lo is None else lo
    hi = float(v.max()) if hi is None else hi
    t = (v - lo) / max(hi - lo, 1e-9)
    return "".join(blocks[int(x * (len(blocks) - 1))] for x in t)


def fleet_traces(trace: torch.Tensor, mode: str):
    """(temps [T, tiles], freqs [T, tiles], mean freq) for one package
    through the fleet engine's whole-chunk path, on ``trace``'s device."""
    eng = FleetEngine(SchedulerConfig(n_tiles=trace.shape[1], mode=mode),
                      device=trace.device)
    _, temps, freqs = eng.block_traces(eng.init(1), trace[:, None, :])
    return temps[:, 0, :], freqs[:, 0, :], float(freqs.mean())


def panel5(trace: torch.Tensor) -> dict:
    """Panel 5's numbers: V24 vs the reactive-polling baseline."""
    t24, f24, perf24 = fleet_traces(trace, "v24")
    tb, fb, perfb = fleet_traces(trace, "reactive_poll")
    return {"t_v24": t24, "f_v24": f24, "t_base": tb, "f_base": fb,
            "perf_v24": perf24, "perf_base": perfb,
            "released": perf24 / perfb - 1.0,
            "peak_v24": float(t24.max()), "peak_base": float(tb.max())}


def local_dashboard(dev: torch.device, steps: int = 2000) -> dict:
    print("═" * 72)
    print(" XRM-SSD V24 Thermal Resistance Fingerprint Dashboard"
          " (Fig. 3 repro)")
    print("═" * 72)

    # Panel 1: ρ–ΔT coupling scatter → regression
    t = dataset90k.generate(device=dev)
    a, b, r2 = dataset90k.fit_affine(t.rtok, t.dt_junction)
    print(f"\n[1] ΔT = α·R_tok + β:  α={a:.2f} °C/MTPS  β={b:.1f} °C  "
          f"R²={r2:.4f}  (pub: 63.0, −1256.6, 0.9911)")

    # Panel 2: τ = 80 ms exponential rise + look-ahead window
    sr = thermal.step_response(thermal.single_pole(), 400, 100.0,
                               device=dev)
    print(f"\n[2] step response (τ={FP.tau_ms:.0f} ms; ▄ = V24 20–50 ms "
          f"window)")
    print("    " + spark(sr, 64))
    print("    " + " " * int(20 / 400 * 64) + "▄" * int(30 / 400 * 64))

    # Panel 3: Rth validation
    ss = float(sr[-1]) / 100.0
    print(f"\n[3] Rth = {ss:.3f} °C/W  (pub 0.45, target band 0.42–0.50)")

    # Panel 4: Δλ–ΔT spectral stability
    drift = FP.kappa_to_nm_per_c * 4.15
    print(f"\n[4] κ_TO = {FP.kappa_to_nm_per_c} nm/°C — "
          f"Δλ(4.15 °C) = {drift:.3f} nm < ±0.5 nm spec")

    # Panel 5: live trace through the FLEET engine: V24 vs the §9
    # reactive-polling baseline, one package, whole-chunk path
    trace = workload.make_trace(1, steps, "inference", device=dev)
    p5 = panel5(trace)
    print("\n[5] ρv24(t)      " + spark(trace[:, 0], 60, 0.9, 2.7))
    print("    T_v24 (°C)   " + spark(p5["t_v24"][:, 0], 60, 45, 92))
    print("    T_base (°C)  " + spark(p5["t_base"][:, 0], 60, 45, 92))
    print("    f_v24        " + spark(p5["f_v24"][:, 0], 60, 0.5, 1.0))
    print("    f_base       " + spark(p5["f_base"][:, 0], 60, 0.5, 1.0))
    print(f"\n    released compute: +{p5['released'] * 100:.1f} %   "
          f"peak: {p5['peak_v24']:.1f} vs {p5['peak_base']:.1f} °C")

    # Panel 6: η
    eta = pdu_gate.eta(torch.tensor([20., 50.], device=dev))
    eta20, eta50 = float(eta[0]), float(eta[1])
    print(f"\n[6] η: 20 ms → {eta20 * 100:.2f} %   "
          f"50 ms → {eta50 * 100:.2f} %   (pub 22.12 / 46.47)")

    # Panel 7 (V7.0 seventh panel): dρ/dt ramp hint
    ramp = workload.make_trace(2, steps, "training", device=dev)
    drho = torch.gradient(ramp[:, 0])[0]
    print("\n[7] dρ/dt ramp hint (V7.0 seventh fingerprint panel)")
    print("    ρ     " + spark(ramp[:, 0], 60, 0.9, 2.7))
    print("    dρ/dt " + spark(drho.abs(), 60))
    print("\n" + "═" * 72)
    return {"alpha": a, "beta": b, "r2": r2, "rth": ss, "drift_nm": drift,
            "eta20": eta20, "eta50": eta50, "step_response": sr, "eta": eta,
            "dataset": t, "trace": trace,
            "drho_abs_max": float(drho.abs().max()), **p5}


def live_dashboard(url: str, last: int) -> dict:
    """Operator view of a running control plane: GET /telemetry history."""
    def get(path):
        with urllib.request.urlopen(url.rstrip("/") + path, timeout=5) as r:
            return json.loads(r.read())

    health = get("/healthz")
    snap = get(f"/telemetry?last={last}")
    alerts = get("/alerts")["alerts"]
    recs = [r for r in snap["records"] if r.get("kind") == "flush"]
    print("═" * 72)
    print(f" Fleet control plane @ {url} — capacity {health['capacity']}, "
          f"{health['n_active']} active, {health['flushes']} flushes")
    print("═" * 72)
    if not recs:
        print("\n  (no flushes recorded yet — attach a package and wait "
              "one flush)")
        return {"records": recs, "alerts": alerts}
    series = lambda k: [r["telemetry"][k] for r in recs]
    print(f"\n  flushes {int(recs[0]['flush'])}..{int(recs[-1]['flush'])} "
          f"({len(recs)} shown)")
    print("  T_p99 (°C)   " + spark(series("temp_p99_c"), 60))
    print("  T_max (°C)   " + spark(series("temp_max_c"), 60))
    print("  f_mean       " + spark(series("freq_mean"), 60, 0.5, 1.0))
    print("  at-risk      " + spark(series("at_risk_frac"), 60, 0.0, 1.0))
    print("  released     " + spark(series("released_mtps"), 60))
    last_rec = recs[-1]
    for name, st in sorted(last_rec.get("tenants", {}).items()):
        print(f"  tenant {name}: {int(st['n_lanes'])} pkg, "
              f"peak {st['temp_peak_c']:.1f}°C, f_min {st['freq_min']:.3f}, "
              f"drift {st['drift_nm']:.3f} nm")
    print(f"\n  alerts ({len(alerts)} total):")
    for ev in alerts[-5:]:
        print(f"    flush {int(ev['flush'])}: {ev['tenant']} {ev['kind']} "
              f"{ev['value']:.4g} > {ev['limit']:.4g}")
    print("\n" + "═" * 72)
    return {"records": recs, "alerts": alerts}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--url", default=None,
                    help="poll a running control plane (e.g. "
                         "http://127.0.0.1:8787) instead of the local "
                         "fingerprint panels")
    ap.add_argument("--last", type=int, default=60,
                    help="--url mode: flush records of history to render")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the local panels (cpu only when "
                         "asked for)")
    ap.add_argument("--steps", type=int, default=2000,
                    help="length of the panel 5 and 7 traces")
    args = ap.parse_args(argv)
    if args.url:
        return live_dashboard(args.url, args.last)
    return local_dashboard(resolve_device(args.device), args.steps)


if __name__ == "__main__":
    main()
