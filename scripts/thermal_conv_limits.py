#!/usr/bin/env python3
"""What bounds the `thermal_conv` CUDA kernel, measured on one card.

    python3 scripts/thermal_conv_limits.py

Builds ``scripts/thermal_conv_limits.cu`` with the port's nvcc flags and
prints, one JSON object a line, then the card's name and power limit:

  * ``chain``: the two-pole recurrence alone in one warp, in SM cycles a
    step (clock64 over 100 chunks of 384 steps): the kernel's own 16-step
    loop over shared memory (``run_chunk``), the same ticks from registers,
    and a bare dependent FMUL→FADD chain — the dependence floor of a
    90,000-step trace is 90,000 times the last;
  * ``l2``: L2 read bandwidth over a 24 MB L2-resident buffer, coalesced
    16-byte loads and one float from each of random 32-byte sectors;
  * ``stage``: the kernel's staging of its blocks' Γ-union columns of a
    [90,000, 512] power trace (4 tiles a block, 128 blocks) with nothing
    consuming it, beside the sectors it touches.

Each time is the median of 5 runs (CUDA events).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("thermal_conv_limits: needs a GPU")
    from chip_smoke import event_ms
    from repro_torch.core.coupling import coupling_matrix, row_normalise
    from repro_torch.kernels import _build
    from repro_torch.kernels import thermal_conv as tc

    dev = torch.device("cuda")
    out_lib = _build.BUILD_DIR / "thermal_conv_limits.so"
    out_lib.parent.mkdir(parents=True, exist_ok=True)
    _build.compile_source(ROOT / "scripts" / "thermal_conv_limits.cu",
                          out_lib)
    lib = ctypes.CDLL(str(out_lib))
    for f in ("limits_chain", "limits_l2", "limits_stage"):
        getattr(lib, f).restype = ctypes.c_int
    lib.limits_chain.argtypes = [ctypes.POINTER(tc._ConvConsts),
                                 ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_void_p]
    lib.limits_l2.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.limits_stage.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 2
                                 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                                 + [ctypes.c_void_p])
    sink = torch.zeros(4, device=dev)

    c = tc._ConvConsts(T=1, n=1, n_poles=2, tiles_per_block=4)
    c.decay[0], c.decay[1], c.coef[0], c.coef[1] = 0.99, 0.98, 1e-3, 1e-3
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    chunks = 100
    for mode, what in ((0, "run_chunk over shared memory"),
                       (1, "the same ticks from registers"),
                       (2, "bare FMUL->FADD chain")):
        for _ in range(2):            # the first run warms the clocks
            assert lib.limits_chain(ctypes.byref(c), mode, chunks,
                                    sink.data_ptr(), cycles.data_ptr()) == 0
            torch.cuda.synchronize()
        print(json.dumps({"chain": what, "cycles_per_step": int(cycles) / (
            chunks * 384)}))

    buf = torch.rand(24 * 2 ** 20 // 4, device=dev)
    reps = 20
    ms = event_ms(lambda: lib.limits_l2(buf.data_ptr(), buf.numel(), reps, 0,
                                        sink.data_ptr()), 5)
    print(json.dumps({"l2": "coalesced 16-byte loads", "ms": ms,
                      "tb_per_s": buf.numel() * 4 * reps / ms / 1e9}))
    reps = 2000
    ms = event_ms(lambda: lib.limits_l2(buf.data_ptr(), buf.numel(), reps, 1,
                                        sink.data_ptr()), 5)
    sectors = 132 * 4 * 256 * reps
    print(json.dumps({"l2": "random 32-byte sectors", "ms": ms,
                      "g_sectors_per_s": sectors / ms / 1e6}))

    n, t, tb = 512, 90_000, 4
    g = row_normalise(coupling_matrix(n))
    unions = [torch.nonzero((g[i:i + tb] != 0).any(0)).flatten()
              for i in range(0, n, tb)]
    maxu = max(len(u) for u in unions)
    ucols = torch.zeros((len(unions), maxu), dtype=torch.int32)
    for b, u in enumerate(unions):
        ucols[b, :len(u)] = u
    count = torch.tensor([len(u) for u in unions], dtype=torch.int32)
    sectors = sum(len(set((u * 4 // 32).tolist())) for u in unions)
    ucols, count = ucols.to(dev), count.to(dev)
    power = 80.0 + 40.0 * torch.rand((t, n), device=dev)
    ms = event_ms(lambda: lib.limits_stage(
        power.data_ptr(), t, n, ucols.data_ptr(), count.data_ptr(), maxu,
        len(unions), sink.data_ptr()), 5)
    print(json.dumps({"stage": f"[{t}, {n}], {tb} tiles a block, "
                               f"{len(unions)} blocks", "ms": ms,
                      "sectors_per_step": sectors,
                      "g_sectors_per_s": sectors * t / ms / 1e6}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
