#!/usr/bin/env python3
"""Time the port's `fleet_step`, `grid_conv` and `thermal_conv` CUDA kernels
against another build of the same kernels, in turns, on one card.

    python3 scripts/kernel_ab.py --against DIR

DIR holds ``fleet_step.cu``, ``grid_conv.cu`` and/or ``thermal_conv.cu``
with the same ``extern "C"`` launch function and argument struct as the
sources under ``src/repro_torch/kernels/csrc/`` — an earlier revision's,
for example (``git show REV:src/repro_torch/kernels/csrc/grid_conv.cu >
DIR/grid_conv.cu``); a ``thermal_conv.cu`` may also have the interface of
the dense-product kernel before its redesign (no tiles-a-block field, no
scratch argument).  Each is compiled with the port's nvcc flags into DIR
and timed at the windows ``chip_smoke.py`` times: `fleet_step` on each
Phase A window (four modes at 1 tile × 4,096, 4 × 200 and 47 × 64
packages, T = 512), on the 47-tile × 4,096-package peak window (flush 4 of
Phase B's stream) from its warm state and on serve --stream's first window
[256, 1, 4,096] (Phase C); `grid_conv` on ``GridPlant(n_tiles=47)`` ×
90,000 steps; `thermal_conv` on [90,000, 512] (Phase D's main path) and
[90,000, 47] (the Ponte-Vecchio Γ).  The order is this checkout's build,
the other, the other, this checkout's; each time is the median of 10
launches by CUDA events.  The two builds' outputs are compared (max |Δ|,
bit-exact or not).  Prints one JSON object per window, then the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

REPS = 10   # launches per timing, as chip_smoke.py times the main path


def build_other(src: Path) -> Path:
    """``src`` compiled with the port's flags, beside it."""
    from repro_torch.kernels import _build

    out = src.with_suffix(".so")
    report = _build.compile_source(src, out)
    usage = [ln.strip() for ln in report.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[ab] built {out}: " + " | ".join(usage))
    return out


def in_turns(name: str, run, other: Path, run_other=None) -> dict:
    """``run()`` on this checkout's library and on the one at ``other`` (or
    ``run_other()``, where the other build has another C interface), in
    the order this, other, other, this; times and the outputs'
    agreement."""
    import contextlib

    import torch

    from chip_smoke import event_ms
    from repro_torch.kernels import _build

    times = {"this": [], "other": []}
    outs = {}
    for who in ("this", "other", "other", "this"):
        f = run_other if who == "other" and run_other else run
        with (contextlib.nullcontext() if who == "this" or run_other
              else _build.loaded_from(name, other)):
            outs[who] = f()
            torch.cuda.synchronize()
            times[who].append(event_ms(f, REPS))
    pairs = [(a, b) for a, b in zip(outs["this"], outs["other"])
             if a is not None]
    diff = max(float((a - b).abs().max()) for a, b in pairs)
    exact = all(torch.equal(a, b) for a, b in pairs)
    return {"kernel": name, "this_ms": times["this"],
            "other_ms": times["other"], "max_abs_diff": diff,
            "bit_exact": exact}


def fleet_windows(dev):
    """(label, args, kwargs) of every `fleet_step` window chip_smoke times."""
    from chip_smoke import (SERVE_STREAM_ARGV, fleet_trace, fleet_window,
                            serve_window, warm_window)
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.fleet import FleetEngine
    from repro_torch.launch import serve

    for n_tiles, n in ((1, 4096), (4, 200), (47, 64)):
        for mode in ("v24", "reactive", "reactive_poll", "off"):
            args, kwargs = fleet_window(dev, mode, n_tiles, n, 512,
                                        seed=n_tiles)
            yield [mode, n_tiles, n, 512], args, kwargs
    n_tiles, n, flush, peak = 47, 4096, 256, 3
    trace = fleet_trace(n_tiles, n, 2048)
    eng = FleetEngine(SchedulerConfig(n_tiles=n_tiles, mode="v24"),
                      backend="fused")
    _, _, args, kwargs = warm_window(eng.backend_impl, eng.init(n), trace,
                                     flush, peak)
    yield ["peak", n_tiles, n, flush], args, kwargs
    args, kwargs = serve_window(dev, serve.main(SERVE_STREAM_ARGV)["trace"])
    yield ["serve", 1, 4096, 256], args, kwargs


def dense_conv(lib_path: Path):
    """A runner for a `thermal_conv` build with the interface of the
    dense-product kernel before its redesign — struct (T, n, n_poles,
    decay[8], coef[8]), pointers (power, Γ, state0, dts, state) and the
    stream — or None if the build has this checkout's interface."""
    import ctypes

    import torch

    from repro_torch.kernels import thermal_conv as tc

    lib = ctypes.CDLL(str(lib_path))
    if hasattr(lib, "thermal_conv_scratch_words"):
        return None

    class Consts(ctypes.Structure):
        _fields_ = [f for f in tc._ConvConsts._fields_
                    if f[0] != "tiles_per_block"]

    fn = lib.thermal_conv_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(Consts)] + [ctypes.c_void_p] * 6

    def run(power, gamma, decay, gain):
        a, coef = tc._pole_consts(decay, gain)
        t, n = power.shape
        c = Consts(T=t, n=n, n_poles=a.shape[0])
        for k in range(a.shape[0]):
            c.decay[k], c.coef[k] = float(a[k]), float(coef[k])
        state0 = torch.zeros((n, a.shape[0]), device=power.device)
        dts, state = torch.empty_like(power), torch.empty_like(state0)
        err = fn(ctypes.byref(c), power.data_ptr(), gamma.data_ptr(),
                 state0.data_ptr(), dts.data_ptr(), state.data_ptr(),
                 torch.cuda.current_stream(power.device).cuda_stream)
        if err:
            raise RuntimeError(f"thermal_conv (other build): cudaError_t "
                               f"{err}")
        return dts, state

    return run


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, required=True)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a GPU")
    dev = torch.device("cuda")
    from repro_torch.core.density import power_from_rho
    from repro_torch.core.fingerprint import FINGERPRINT
    from repro_torch.core.plant import GridPlant
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.kernels import fleet_step as fs

    results = []
    src = a.against / "fleet_step.cu"
    if src.is_file():
        other = build_other(src)
        for label, args, kwargs in fleet_windows(dev):
            results.append(in_turns(
                "fleet_step", lambda: fs.fleet_step(*args, **kwargs), other)
                | {"window": label})
    src = a.against / "grid_conv.cu"
    if src.is_file():
        other = build_other(src)
        plant = GridPlant(SchedulerConfig(n_tiles=47, plant="grid"),
                          FINGERPRINT, device=dev)
        gen = torch.Generator(device=dev).manual_seed(9)
        p = power_from_rho(0.9 + 1.8 * torch.rand((90_000, 47), generator=gen,
                                                  device=dev))
        results.append(in_turns("grid_conv", lambda: plant.simulate(p), other)
                       | {"window": [90_000, 47]})
    src = a.against / "thermal_conv.cu"
    if src.is_file():
        from repro_torch.core.coupling import (coupling_matrix,
                                               ponte_vecchio_gamma,
                                               row_normalise)
        from repro_torch.core.thermal import two_pole
        from repro_torch.kernels import ops

        other = build_other(src)
        legacy = dense_conv(other)
        poles = two_pole()
        gen = torch.Generator(device=dev).manual_seed(3)
        for n, g in ((512, coupling_matrix(512)), (47, ponte_vecchio_gamma())):
            g = row_normalise(g).to(dev).contiguous()
            p = 80.0 + 40.0 * torch.rand((90_000, n), generator=gen,
                                         device=dev)
            results.append(in_turns(
                "thermal_conv",
                lambda: ops.thermal_conv(p, g, poles.decay, poles.gain),
                other, legacy and (lambda: legacy(p, g, poles.decay,
                                                  poles.gain)))
                | {"window": [90_000, n]})
    for r in results:
        print(json.dumps(r))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
