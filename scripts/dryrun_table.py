#!/usr/bin/env python3
"""The dry run's results as PERF.md's table: one row a live cell, each
value as "16×16 · 2×16×16".

    python3 scripts/dryrun_table.py [results/dryrun_torch.json]

Per rank: argument and peak GiB, TFLOP (the local ops' flops), each
collective kind as count and GB (output bytes); then the analytic
roofline's compute, memory and collective seconds and its bottleneck.
Exits 1 if a cell is missing or not ``ok``.
"""
import json
import sys

KINDS = (("all-reduce", "AR"), ("all-gather", "AG"),
         ("reduce-scatter", "RS"), ("all-to-all", "A2A"))


def pair(a, b, fmt):
    return f"{fmt(a)} · {fmt(b)}"


def main(path: str = "results/dryrun_torch.json") -> None:
    with open(path) as f:
        res = json.load(f)
    cells = sorted({(r["arch"], r["shape"]) for r in res.values()},
                   key=lambda c: (c[0], ("train_4k", "prefill_32k",
                                         "decode_32k", "long_500k")
                                  .index(c[1])))
    print("| cell | arg GiB | peak GiB | TFLOP | collectives: n, GB | "
          "roofline s: compute / memory / collective | bound |")
    print("|---|---|---|---|---|---|---|")
    bad = []
    for arch, shape in cells:
        rs = [res.get(f"{arch}|{shape}|{m}") for m in ("single", "multi")]
        if not all(r and r.get("ok") for r in rs):
            bad.append((arch, shape))
            continue
        one, two = rs
        gib = lambda key: pair(one["memory"][key] / 2**30,
                               two["memory"][key] / 2**30,
                               lambda v: f"{v:.2f}")
        coll = []
        for kind, tag in KINDS:
            n = [r["collectives"]["counts"].get(kind, 0) for r in rs]
            gb = [r["collectives"]["by_kind"].get(kind, 0) / 1e9 for r in rs]
            if any(n):
                coll.append(f"{tag} {n[0]}, {gb[0]:.3g} · {n[1]}, "
                            f"{gb[1]:.3g}")
        terms = " · ".join(
            f"{r['roofline']['t_compute_s']:.3g} / "
            f"{r['roofline']['t_memory_s']:.3g} / "
            f"{r['roofline']['t_collective_s']:.3g}" for r in rs)
        bound = " · ".join(r["roofline"]["bottleneck"] for r in rs)
        print(f"| {arch} {shape} | {gib('argument_bytes')} | "
              f"{gib('peak_bytes')} | "
              f"{pair(one['flops'] / 1e12, two['flops'] / 1e12, lambda v: f'{v:.4g}')}"
              f" | {'; '.join(coll)} | {terms} | {bound} |")
    if bad:
        print(f"missing or failed: {bad}", file=sys.stderr)
        raise SystemExit(1)


if __name__ == "__main__":
    main(*sys.argv[1:])
