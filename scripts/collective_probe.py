#!/usr/bin/env python3
"""What the flush's collective costs between two ranks on one card.

    python3 scripts/collective_probe.py [--mib 1,64,592]

Starts two ranks of a process group (`repro_torch.distributed.multihost.
run_process_group`) on the one card and times a ``uint8`` sum
``all_reduce`` — the collective `multihost.gather_spans` makes once a
flush — at each size of ``--mib``: on gloo with CUDA tensors (the path
the mesh backends take), on gloo with host tensors, and then on NCCL,
which refuses two ranks on one card (the line it fails with is printed).
Each size is timed 3 times per rank, host clock around the call after a
synchronize and a barrier.  Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

WORKER = r"""
import json, os, time
from repro_torch.distributed import multihost
multihost.initialize(os.environ["REPRO_COORDINATOR"], 2,
                     int(os.environ["REPRO_PROCESS_ID"]),
                     backend=%(backend)r, timeout_s=60)
import torch
import torch.distributed as dist
rank = dist.get_rank()
out = {"rank": rank, "backend": %(backend)r}
for where in %(places)r:
    dev = torch.device(where)
    for mib in %(mib)r:
        buf = torch.zeros(mib << 20, dtype=torch.uint8, device=dev)
        half = buf.numel() // 2
        buf[rank * half:(rank + 1) * half] = 3   # each rank its own half
        ms = []
        for _ in range(3):
            b = buf.clone()
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            dist.all_reduce(b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        assert bool((b[:2 * half] == 3).all()), "the sum is not the gather"
        out[f"{where} {mib} MiB"] = ms
print("RESULT " + json.dumps(out))
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", default="1,64,592")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.distributed import multihost

    if not torch.cuda.is_available():
        raise SystemExit("collective_probe: needs a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    mib = [int(x) for x in args.mib.split(",")]
    outs = multihost.run_process_group(
        WORKER % {"backend": "gloo", "places": ["cuda", "cpu"], "mib": mib},
        2, timeout=600)
    for o in outs:
        for line in o.splitlines():
            if line.startswith("RESULT "):
                res = json.loads(line[len("RESULT "):])
                print(f"[gloo] rank {res.pop('rank')}: " + json.dumps(
                    {k: [round(x, 2) for x in v] for k, v in res.items()
                     if k != "backend"}))
    try:
        multihost.run_process_group(
            WORKER % {"backend": "nccl", "places": ["cuda"], "mib": [1]},
            2, timeout=120)
        print("[nccl] two ranks on one card ran")
    except RuntimeError as err:
        lines = str(err).splitlines()
        why = ([line for line in lines if "Duplicate GPU" in line]
               or [line for line in lines if "Error" in line])
        print("[nccl] two ranks on one card refused: "
              + (why[0].strip() if why else str(err)[-300:]))


if __name__ == "__main__":
    main()
