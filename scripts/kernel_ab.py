#!/usr/bin/env python3
"""Time the port's `fleet_step`, `grid_conv`, `thermal_conv`, flash
attention and `ssd` backward CUDA kernels against another build of the
same kernels, in turns, on one card.

    python3 scripts/kernel_ab.py --against DIR

DIR holds ``fleet_step.cu``, ``grid_conv.cu``, ``thermal_conv.cu`` and/or
``ssd_bwd.cu``
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
[90,000, 47] (the Ponte-Vecchio Γ).  Flash attention, bf16 at Gemma-2B's
[8, 1,024, 8 on 1, 256], Zamba2-7B's [8, 1,024, 32, 112] and DeepSeek-V2's
MLA [2, 1,024, 128, 192/128]: this checkout's route (`flash_route`)
against the route DIR's sources give the same call — the tensor-core
forward against DIR's ``flash_attention_tc.cu``, both called through the
same bare ctypes runner (whose argument struct follows each source: one
without the ``dv`` field has no d ≠ dv route, so MLA's shape runs DIR's
CUDA-core ``flash_attention.cu``), the backward against DIR's
``flash_attention_bwd.cu`` (the CUDA-core backward, the only one before
the tensor-core kernel), on the plain forward's statistics.  The `ssd`
backward against DIR's ``ssd_bwd.cu`` (same ``extern "C"`` launch and
argument struct), at Zamba2-7B's and RWKV6-1.6B's training shapes
(``chip_smoke.py``'s timed Phase L (f) rows, the same inputs), both through
`ssm_scan.ssd_backward`: besides the times in turns, each build's device
ms per call in each of its kernels (torch.profiler: the passes) and each
build's largest gap per leaf to `ssd_backward_reference`, as a share of the
leaf's largest magnitude.  The order is
this checkout's build, the other, the other, this checkout's; each time is
the median of 10 launches by CUDA events.  The two builds' outputs are
compared (max |Δ|, bit-exact or not).  Prints one JSON object per window,
then the card's name and power limit.
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
# flash attention's windows: (label, B, T, H, KV, d, dv)
FLASH_AB = (("gemma-2b", 8, 1024, 8, 1, 256, 256),
            ("zamba2-7b", 8, 1024, 32, 32, 112, 112),
            ("deepseek-v2 mla", 2, 1024, 128, 128, 192, 128))


def build_other(src: Path) -> Path:
    """``src`` compiled with the port's flags, beside it."""
    from repro_torch.kernels import _build

    out = src.with_suffix(".so")
    report = _build.compile_source(src, out)
    usage = [ln.strip() for ln in report.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[ab] built {out}: " + " | ".join(usage))
    return out


def in_turns(name: str, run, other: Path | None, run_other=None,
             loaded: bool = False) -> dict:
    """``run()`` on this checkout's library and on the one at ``other`` (or
    ``run_other()``, where the other build has another C interface or is
    reached by another call — with ``other`` loaded as ``name`` if
    ``loaded``), in the order this, other, other, this; times and the
    outputs' agreement."""
    import contextlib

    import torch

    from chip_smoke import event_ms
    from repro_torch.kernels import _build

    times = {"this": [], "other": []}
    outs = {}
    for who in ("this", "other", "other", "this"):
        f = run_other if who == "other" and run_other else run
        swap = who == "other" and other is not None and (
            run_other is None or loaded)
        with (_build.loaded_from(name, other) if swap
              else contextlib.nullcontext()):
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


def tc_forward(lib_path: Path, source: str):
    """A causal-forward runner for a ``flash_attention_tc.cu`` build, its
    argument struct read from its source (one without the ``dv`` field
    takes d = dv only).  Both builds go through such a runner, so that the
    host's share of a timing is the same for both."""
    import ctypes

    import torch

    has_dv = "d, dv," in source
    lib = ctypes.CDLL(str(lib_path))

    class Args(ctypes.Structure):
        _fields_ = ([(f, ctypes.c_int) for f in (
            "B", "Tq", "Tk", "H", "KV", "d", *(("dv",) if has_dv else ()),
            "causal", "window", "q_offset")] + [("scale", ctypes.c_float)])

    fn = lib.flash_attention_tc_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(Args)] + [ctypes.c_void_p] * 5

    def run(q, k, v):
        B, Tq, H, d = q.shape
        dv = v.shape[-1]
        a = Args(B=B, Tq=Tq, Tk=k.shape[1], H=H, KV=k.shape[2], d=d,
                 causal=1, window=0, q_offset=0, scale=float(d ** -0.5))
        if has_dv:
            a.dv = dv
        out = torch.empty((B, Tq, H, dv), dtype=q.dtype, device=q.device)
        err = fn(ctypes.byref(a), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(),
                 torch.cuda.current_stream(q.device).cuda_stream)
        if err:
            raise RuntimeError(f"flash_attention_tc ({lib_path.name}): "
                               f"cudaError_t {err}")
        return out

    return run, has_dv


def flash_windows(dev, against: Path):
    """(library name, label, this, the other build's path or None, other)
    of each flash attention window whose other build DIR holds: ``other``
    runs with that build loaded under the name, or calls its own."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    from repro_torch.kernels import _build

    fwd_tc = against / "flash_attention_tc.cu"
    fwd_cc = against / "flash_attention.cu"
    bwd_cc = against / "flash_attention_bwd.cu"
    if not any(f.is_file() for f in (fwd_tc, fwd_cc, bwd_cc)):
        return
    this_tc, _ = tc_forward(_build.build("flash_attention_tc"),
                            (_build.CSRC / "flash_attention_tc.cu")
                            .read_text())
    tc, tc_dv = (tc_forward(build_other(fwd_tc), fwd_tc.read_text())
                 if fwd_tc.is_file() else (None, False))
    cc = build_other(fwd_cc) if fwd_cc.is_file() else None
    bwd = build_other(bwd_cc) if bwd_cc.is_file() else None
    gen = torch.Generator(device=dev).manual_seed(21)
    for label, B, T, H, KV, d, dv in FLASH_AB:
        r = lambda *s: torch.randn(s, generator=gen, device=dev).to(
            torch.bfloat16)
        q, k, v, do = r(B, T, H, d), r(B, T, KV, d), r(B, T, KV, dv), \
            r(B, T, H, dv)
        this = lambda: (this_tc(q, k, v),)
        if tc and (d == dv or tc_dv):
            yield ("flash_attention_tc", label, this, None,
                   lambda: (tc(q, k, v),))
        elif cc:
            # the other build has no tensor-core route for d ≠ dv: its
            # route was the CUDA-core kernel
            yield ("flash_attention", label, this, cc,
                   lambda: (fa._launch(q, k, v, True, 0, 0, d ** -0.5),))
        if bwd:
            po, pm, pl = fa.flash_attention_stats_reference(q, k, v)
            yield ("flash_attention_bwd", label,
                   lambda: fa.flash_attention_backward(q, k, v, po, pm, pl,
                                                       do),
                   bwd, lambda: fa._launch_bwd(q, k, v, po, pm, pl, do, True,
                                               0, 0, d ** -0.5))


def ssd_bwd_ab(dev, against: Path) -> list:
    """The `ssd` backward of this checkout against DIR's ``ssd_bwd.cu`` at
    chip_smoke's timed Phase L (f) shapes: times in turns, the outputs'
    agreement, each build's per-kernel device times and its largest gap
    per leaf to the plain version."""
    src = against / "ssd_bwd.cu"
    if not src.is_file():
        return []
    import torch

    from chip_smoke import (SSD_BWD_CASES, SSD_BWD_TIMED, kernel_ms,
                            ssd_bwd_inputs)
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssm_scan as sm

    leaves = ("dd", "db", "dx", "dc", "du", "dh0")
    other = build_other(src)
    out = []
    for case in SSD_BWD_CASES:
        if case[0] not in SSD_BWD_TIMED:
            continue
        d, b, x, c, u, h0, dy, dhT = ssd_bwd_inputs(dev, case)
        inc = case[7]
        hs = sm.ssd_states(d, b, x, c, u=u, h0=h0, include_current=inc)[2]
        bkw = dict(chunk=sm.chunk_for(d.shape[1], 64), include_current=inc)
        args = (d, b, x, c, u, h0, hs, dy, dhT)
        run = lambda: sm.ssd_backward(*args, **bkw)
        res = in_turns("ssd_bwd", run, other) | {"window": case[0]}
        plain = sm.ssd_backward_reference(*args, **bkw)

        def gaps():
            got = run()
            return {n: float((a.float() - w.float()).abs().max()
                             / w.float().abs().max())
                    for n, a, w in zip(leaves, got, plain) if w is not None}

        res["this_rel_err"], res["this_kernel_ms"] = gaps(), kernel_ms(run)
        with _build.loaded_from("ssd_bwd", other):
            res["other_rel_err"] = gaps()
            res["other_kernel_ms"] = kernel_ms(run)
        out.append(res)
        del d, b, x, c, u, h0, dy, dhT, hs, args, plain
        torch.cuda.empty_cache()
    return out


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
    results += ssd_bwd_ab(dev, a.against)
    for name, label, this, path, other in flash_windows(dev, a.against):
        results.append(in_turns(name, this, path, other, loaded=True)
                       | {"window": label})
    for r in results:
        print(json.dumps(r))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
