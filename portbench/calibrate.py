"""Readings behind a cell's correctness limits: the program's and the
control's numbers on many seeds, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 5 [--control] [--out calib.jsonl]

For each seed: the cell's set-up and a short window at its own load, then
the comparison's readings of what the program produced and, with
``--control``, of the control (the reference in the nearest precision
below the configuration's, in the program's place).  One JSON line a seed.
Not part of a benchmark run.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    from portbench import harness
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        _, kind, ctx = harness.prepare(ROOT, args.workload, seed,
                                         args.seconds, False)
        kind.setup(ctx)
        kind.window(ctx)
        kind.release(ctx)
        line = {"workload": args.workload, "seed": seed, "e2e": ctx.e2e,
                "program": kind.readings(ctx)}
        if args.control:
            line["control"] = kind.readings(ctx, control=True)
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del ctx, kind
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
