#!/usr/bin/env python3
"""What the `ssd` backward's code size costs, on the card.

    python3 scripts/ssd_bwd_code_size.py

``csrc/ssd_bwd.cu`` keeps its loops over k-steps and steps rolled
(``#pragma unroll 1``) and its staging helpers out of line
(``__noinline__``).  This script builds the source as it is and a copy with
every such loop unrolled and every such helper inlined, counts each
build's SASS instructions by kernel (``cuobjdump -sass``), and times both
through `ssm_scan.ssd_backward` at Zamba2-7B's and RWKV6-1.6B's training
shapes (``chip_smoke.py``'s timed Phase L (f) rows) in turns — this, other,
other, this; each time the median of 10 launches by CUDA events — with
each build's device ms per kernel (torch.profiler) and the two builds'
outputs compared.  Prints the card's name and power limit, then one JSON
object per build and per shape.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))


def sass_counts(lib: Path) -> dict:
    """SASS instructions of each kernel in the library, by kernel name."""
    out = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    counts = {}
    for fn in re.split(r"\n\s*Function : ", out)[1:]:
        mangled = fn.split("\n", 1)[0].strip()
        m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
        name = mangled[m.end():m.end() + int(m.group(1))]
        args = re.findall(r"L([ib])(\d+)E", mangled[m.end():].split("Ev")[0])
        key = name + "<" + ", ".join(v for _, v in args) + ">"
        counts[key] = len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+[@A-Z]", fn))
    return counts


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ssd_bwd_code_size: needs a GPU")
    from chip_smoke import (SSD_BWD_CASES, SSD_BWD_TIMED, kernel_ms,
                            ssd_bwd_inputs)
    from kernel_ab import build_other, in_turns
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssm_scan as sm

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    src = (_build.CSRC / "ssd_bwd.cu").read_text()
    unrolled = _build.BUILD_DIR / "ssd_bwd_unrolled.cu"
    unrolled.parent.mkdir(parents=True, exist_ok=True)
    unrolled.write_text(src.replace("#pragma unroll 1\n", "#pragma unroll\n")
                        .replace("__noinline__", "__forceinline__"))
    _build.build("ssd")
    this, other = _build.build("ssd_bwd"), build_other(unrolled)
    for label, lib in (("this", this), ("unrolled", other)):
        print(json.dumps({"build": label, "sass_instructions":
                          sass_counts(lib)}), flush=True)
    dev = torch.device("cuda")
    for case in SSD_BWD_CASES:
        if case[0] not in SSD_BWD_TIMED:
            continue
        d, b, x, c, u, h0, dy, dhT = ssd_bwd_inputs(dev, case)
        inc = case[7]
        hs = sm.ssd_states(d, b, x, c, u=u, h0=h0, include_current=inc)[2]
        args = (d, b, x, c, u, h0, hs, dy, dhT)
        run = lambda: sm.ssd_backward(*args, chunk=sm.chunk_for(
            d.shape[1], 64), include_current=inc)
        res = in_turns("ssd_bwd", run, other) | {"window": case[0]}
        res["this_kernel_ms"] = kernel_ms(run)
        with _build.loaded_from("ssd_bwd", other):
            res["other_kernel_ms"] = kernel_ms(run)
        print(json.dumps(res), flush=True)
        del d, b, x, c, u, h0, dy, dhT, hs, args
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
