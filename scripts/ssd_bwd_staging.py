#!/usr/bin/env python3
"""Where the `ssd` backward stages du's terms, on the card.

    python3 scripts/ssd_bwd_staging.py

`chunk_grad_kernel` (src/repro_torch/kernels/csrc/ssd_bwd.cu) stages the
terms dsu·c·b of each (step, state column) in a shared tile for the walk
that sums them into du's partial.  This script builds the kernel as it is
(the dh tile) and with the terms staged over the L tile, which the same
elementwise loop reads (each entry read, then written, by one thread), and
runs both through `ssm_scan.ssd_backward` with u at a few shapes, with
and without ``include_current``.  Prints the card's name and power limit,
then one JSON object a case: each build's largest gap per leaf to
`ssd_backward_reference` as a share of the leaf's largest magnitude, and
whether the two builds' outputs are equal bit for bit.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHIPPED, OVER_L = "float* sDu = sDh;", "float* sDu = sL;"
CASES = ((1, 64, 1, 16, 16, False), (2, 256, 4, 64, 64, False),
         (2, 256, 4, 64, 64, True), (1, 128, 2, 64, 64, False),
         (2, 1000, 4, 64, 128, False))
LEAVES = ("dd", "db", "dx", "dc", "du", "dh0")


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ssd_bwd_staging: needs a GPU")
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssm_scan as sm

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    src = (_build.CSRC / "ssd_bwd.cu").read_text()
    if src.count(SHIPPED) != 1:
        raise SystemExit(f"ssd_bwd_staging: {SHIPPED!r} not found once")
    variant = _build.BUILD_DIR / "ssd_bwd_du_over_L.cu"
    variant.parent.mkdir(parents=True, exist_ok=True)
    variant.write_text(src.replace(SHIPPED, OVER_L))
    _build.build("ssd")
    _build.build("ssd_bwd")
    _build.compile_source(variant, variant.with_suffix(".so"))
    dev = torch.device("cuda")
    for B, T, H, N, P, inc in CASES:
        g = torch.Generator(device=dev).manual_seed(1)
        r = lambda *s: torch.randn(s, generator=g, device=dev)
        d = 0.8 + 0.199 * torch.rand((B, T, H, N), generator=g, device=dev)
        b, x, c = 0.2 * r(B, T, H, N), r(B, T, H, P), 0.2 * r(B, T, H, N)
        u, dy = 0.1 * r(H, N), r(B, T, H, P)
        kw = dict(chunk=sm.chunk_for(T, 64), include_current=inc)
        hs = sm.ssd_states(d, b, x, c, u=u, include_current=inc)[2]
        args = (d, b, x, c, u, None, hs, dy, None)
        want = sm.ssd_backward_reference(*args, **kw)
        shipped = sm.ssd_backward(*args, **kw)
        with _build.loaded_from("ssd_bwd", variant.with_suffix(".so")):
            over_l = sm.ssd_backward(*args, **kw)
        torch.cuda.synchronize()
        gap = lambda got: {n: float((a - w).abs().max() / w.abs().max())
                           for n, a, w in zip(LEAVES, got, want)}
        print(json.dumps({
            "shape": [B, T, H, N, P], "include_current": inc,
            "chunk": kw["chunk"], "shipped": gap(shipped),
            "du_over_L": gap(over_l),
            "bit_equal": all(torch.equal(a, o)
                             for a, o in zip(shipped, over_l))}), flush=True)


if __name__ == "__main__":
    main()
