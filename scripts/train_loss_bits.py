#!/usr/bin/env python3
"""The one-device train step's losses at a fixed seed, bit for bit.

    python3 scripts/train_loss_bits.py [--src DIR] [--device cpu|cuda]
        [--arch gemma-2b] [--layers N] [--batch 8] [--seq 1024]
        [--steps 3]

Draws the parameters and a batch from fixed seeds (the parameters on the
device's generator, seed 0; tokens below 32,768, seed 21), runs
`launch.steps.make_train_step` ``--steps`` times on DIR's port (default:
this checkout's ``src``) and prints each step's loss and gradient norm as
f32 hex.  Run it on two checkouts to show that a change leaves the
one-device step bit for bit as it was.  Reduced widths with ``--reduced``
(the configs' `reduced`, f32).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import struct
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch

    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch import steps as S

    dev = torch.device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    state = S.init_train_state(torch.Generator(device=dev).manual_seed(0),
                               cfg, 8)
    g = torch.Generator(device=dev).manual_seed(21)
    hi = min(32768, cfg.vocab_size)
    shape = (args.batch, args.seq)
    batch = {"tokens": torch.randint(2, hi, shape, generator=g, device=dev),
             "labels": torch.randint(2, hi, shape, generator=g, device=dev),
             "rho": torch.full((8,), 1.9, device=dev)}
    step = S.make_train_step(cfg, 8, device=dev)
    hexf = lambda x: struct.pack(">f", float(x)).hex()
    out = []
    for _ in range(args.steps):
        state, m = step(state, batch)
        out.append({"loss": hexf(m["loss"]),
                    "grad_norm": hexf(m["grad_norm"])})
    print(json.dumps({"src": args.src, "arch": cfg.name,
                      "layers": cfg.n_layers, "steps": out}))


if __name__ == "__main__":
    main()
