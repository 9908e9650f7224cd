"""V7.0 multi-tile simulation (paper §5) on the PyTorch port: 8-tile package
with the N×N coupling matrix, two-pole kernel, and coupled pre-positioning.

    PYTHONPATH=src python examples/torch_multi_tile_sim.py [--device cpu]

The port's counterpart of examples/multi_tile_sim.py.  Runs on CUDA unless
``--device cpu`` is given; on CUDA the pole-bank trace goes through the
hand-written `thermal_conv` kernel, on the CPU through its plain version.
"""
import argparse

from repro_torch import resolve_device
from repro_torch.core import coupling, dvfs, thermal, workload
from repro_torch.core.density import power_from_rho
from repro_torch.kernels import ops

N_TILES = 8


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu only when asked for)")
    ap.add_argument("--steps", type=int, default=4000)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("== V7.0 multi-tile thermal control (8-tile Foveros package) ==\n")
    gamma = coupling.coupling_matrix(N_TILES, cols=4)
    print("Γ coupling matrix (paper Fig. 4 left):")
    for row in gamma.tolist():
        print("   " + " ".join(f"{v:.2f}" for v in row))
    st = coupling.sparsity_stats(gamma, threshold=0.12)
    print(f"significant neighbours/tile: {st['neighbours_mean']:.1f} "
          f"(pub 5-8)\n")

    gamma_n = coupling.row_normalise(gamma).to(dev)
    trace = workload.make_trace(0, args.steps, "inference", n_tiles=N_TILES,
                                device=dev)
    poles = thermal.two_pole()
    print(f"two-pole kernel: τ₁=5.0 ms (Foveros Cu-Cu), τ₂=80.0 ms "
          f"(package RC); A₁+A₂={float(poles.gain.sum()):.2f} °C/W\n")

    base = dvfs.simulate_reactive(trace, gamma=gamma_n, poles=poles)
    v24 = dvfs.simulate_v24(trace, gamma=gamma_n, poles=poles)
    released = float(dvfs.released_compute(base, v24))
    print(f"baseline: perf {float(base.perf):.3f}, "
          f"peak {float(base.temp.max()):.1f} °C, events {int(base.events)}")
    print(f"V7.0:     perf {float(v24.perf):.3f}, "
          f"peak {float(v24.temp.max()):.1f} °C, events {int(v24.events)}")
    print(f"released: +{released * 100:.1f} %\n")
    print("per-tile peak °C (V7.0):",
          " ".join(f"{float(v24.temp[:, i].max()):.1f}"
                   for i in range(N_TILES)))

    pw = power_from_rho(trace)
    dts, _ = ops.thermal_conv(pw, gamma_n, poles.decay, poles.gain)
    dts_ref, _ = thermal.simulate(poles, pw, gamma=gamma_n)
    err = float((dts - dts_ref).abs().max())
    route = "CUDA kernel" if dev.type == "cuda" else "plain version (CPU)"
    print(f"\nthermal_conv ({route}) vs thermal.simulate: "
          f"max |ΔT err| = {err:.2e} °C")
    return {"released": released, "v24_events": int(v24.events),
            "kernel_err": err}


if __name__ == "__main__":
    main()
