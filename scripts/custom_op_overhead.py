#!/usr/bin/env python3
"""What the dispatcher costs the flash and ssd kernel entries.

    python3 scripts/custom_op_overhead.py [--device cuda|cpu] [--calls 200]

Each flash and ssd entry has a ``torch.library.custom_op`` (its shape rule
and flop formula hang on it); a real tensor with no dispatch mode active
calls the op's implementation directly (`repro_torch.kernels.call_op`).
This script times both ways, and the public entry (which takes the
direct way), at the shapes Phase O of ``chip_smoke.py`` meets and at
Gemma-2B's serving shape: the flash forward, the forward with
statistics and the backward, the ssd forward and its backward.  For each
way and entry: the host's microseconds a call (``--calls`` calls in a row,
one synchronize at the end, host clock) and the device-timed milliseconds
of one call (median of 10, CUDA events around the call, as
``chip_smoke.py``'s ``ms``).  The ways are timed in alternation, in one
process, and each is checked to give the same outputs.  Prints the
card's name and power limit first and one JSON object last.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssm_scan as sm


def cases(dev: torch.device):
    """(name, op, impl, args, entry) for each entry at each shape: the
    op, its implementation, their arguments, and the public entry (a
    callable of no arguments) that computes the same."""
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda dt, *s: torch.randn(s, generator=g, device=dev).to(dt)
    out = []
    for where, (B, T, H, KV, d, dt) in {
            "granite local f32 [2, 64, 2 on 1, 16]":
                (2, 64, 2, 1, 16, torch.float32),
            "gemma-2b local bf16 [8, 1024, 4 on 1, 256]":
                (8, 1024, 4, 1, 256, torch.bfloat16),
            "gemma-2b serving bf16 [8, 1024, 8 on 1, 256]":
                (8, 1024, 8, 1, 256, torch.bfloat16)}.items():
        q, k, v, do = (r(dt, B, T, H, d), r(dt, B, T, KV, d),
                       r(dt, B, T, KV, d), r(dt, B, T, H, d))
        _, o, m, l = fa.flash_attention_stats(q, k, v)
        fwd = (q, k, v, True, 0, 0, d ** -0.5)
        out += [(f"flash_attention {where}", fa._flash_op, fa._flash_impl,
                 fwd, lambda q=q, k=k, v=v: fa.flash_attention(q, k, v)),
                (f"flash_attention_stats {where}", fa._flash_stats_op,
                 fa._flash_stats_impl, fwd,
                 lambda q=q, k=k, v=v: fa.flash_attention_stats(q, k, v)),
                (f"flash_attention_backward {where}", fa._flash_bwd_op,
                 fa._flash_bwd_impl, (q, k, v, o, m, l, do, True, 0, 0,
                                      d ** -0.5),
                 lambda a=(q, k, v, o, m, l, do):
                 fa.flash_attention_backward(*a))]
    B, T, H, N, P = 2, 64, 1, 64, 64      # RWKV6 reduced's local ssd
    d = 0.6 + 0.4 * torch.rand((B, T, H, N), generator=g, device=dev)
    b, c = r(torch.float32, B, T, H, N), r(torch.float32, B, T, H, N)
    x, dy = r(torch.float32, B, T, H, P), r(torch.float32, B, T, H, P)
    u = r(torch.float32, H, N)
    y, hT, hs = sm.ssd_states(d, b, x, c, u=u, include_current=False)
    where = "rwkv6 local f32 [2, 64, 1, 64/64] with u"
    out += [(f"ssd {where}", sm._ssd_op, sm._ssd_impl,
             (d, b, x, c, u, None, 64, False),
             lambda: sm.ssd(d, b, x, c, u=u, include_current=False)),
            (f"ssd_backward {where}", sm._ssd_bwd_op, sm._ssd_bwd_impl,
             (d, b, x, c, u, None, hs, dy, hT, 64, False),
             lambda: sm.ssd_backward(d, b, x, c, u, None, hs, dy, hT,
                                     include_current=False))]
    return out


def host_us(fn, args, calls: int, sync) -> float:
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    sync()
    return (time.perf_counter() - t0) / calls * 1e6


def device_ms(fn, args, dev) -> float | None:
    if dev.type != "cuda":
        return None
    times = []
    for _ in range(10):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
        sync = torch.cuda.synchronize
    else:
        sync = lambda: None
    rows = {}
    for name, op, impl, a, entry in cases(dev):
        ref, got = impl(*a), op(*a)
        same = all(torch.equal(p, q) for p, q in zip(
            ref if isinstance(ref, tuple) else (ref,),
            got if isinstance(got, tuple) else (got,)))
        if not same:
            raise SystemExit(f"{name}: the op and its implementation differ")
        ways = (("op", op, a), ("direct", impl, a), ("entry", entry, ()))
        us = {w: [] for w, _, _ in ways}
        ms = {w: [] for w, _, _ in ways}
        for _ in range(3):
            for way, fn, xs in ways:
                us[way].append(host_us(fn, xs, args.calls, sync))
                ms[way].append(device_ms(fn, xs, dev))
        row = {f"{w}_host_us": float(np.median(us[w])) for w in us}
        row.update({f"{w}_ms": (None if ms[w][0] is None
                                else float(np.median(ms[w]))) for w in ms})
        row["overhead_us"] = row["op_host_us"] - row["direct_host_us"]
        rows[name] = row
        print(f"{name}: host {row['op_host_us']:.1f} us a call through the "
              f"op, {row['direct_host_us']:.1f} direct "
              f"(+{row['overhead_us']:.1f}), {row['entry_host_us']:.1f} "
              f"through the public entry; one call "
              + ("not measured" if row["op_ms"] is None else
                 f"{row['op_ms']:.4f} ms through the op, "
                 f"{row['direct_ms']:.4f} direct, {row['entry_ms']:.4f} "
                 f"through the entry (CUDA events, median)"))
    res = {"device": str(dev), "torch": torch.__version__, "rows": rows}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
