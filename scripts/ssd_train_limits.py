#!/usr/bin/env python3
"""What bounds training the ssd families (RWKV6, Zamba2) on one card.

    python3 scripts/ssd_train_limits.py [--depths 36,42,48]
        [--spread rwkv6-1.6b:bfloat16:2,8,24 ...]

Prints the card's name and power limit, then one JSON object a line:

  * ``depth``: `repro_torch.launch.train --arch zamba2-7b --batch 8 --seq
    1024 --steps 3` with the depth cut to each of ``--depths`` layers, each
    in a process of its own — the warm step and the peak device memory, or
    the out-of-memory error and what was allocated when it struck (the
    train state is ~12 bytes a parameter, and AdamW's f32 temporaries of
    the stacked [L, …] leaves come on top);
  * ``spread``: for each arch, dtype and depth of ``--spread``, one
    `loss_and_grads` at full width and batch 8 × 1,024 on the kernels, on
    the plain versions (`chip_smoke.plain_grads`), and on the plain versions
    with the ssd chunk 32 instead of 64 (the same sums in another order):
    per gradient leaf, as shares of its largest magnitude, the kernels'
    gap to the plain run and the plain run's own spread, and the per-layer
    gap of the leaf where the kernels' is largest.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SPREAD = ("rwkv6-1.6b:bfloat16:2,8,24", "rwkv6-1.6b:float32:24",
          "zamba2-7b:bfloat16:12")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--depths", default="36,42,48",
                    help="Zamba2-7B depths to train (comma-separated)")
    ap.add_argument("--spread", nargs="*", default=list(SPREAD),
                    help="arch:dtype:depth,depth,... gradient cases")
    ap.add_argument("--one-depth", type=int, default=0,
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def one_depth(layers: int) -> dict:
    """The driver at ``layers`` of Zamba2-7B's 81, in this process."""
    import torch

    from repro_torch.launch import train

    get_arch = train.get_arch
    train.get_arch = lambda name: dataclasses.replace(get_arch(name),
                                                      n_layers=layers)
    try:
        res = train.main(["--arch", "zamba2-7b", "--batch", "8", "--seq",
                          "1024", "--steps", "3", "--log-every", "0"])
    except torch.OutOfMemoryError as e:
        return {"layers": layers, "out_of_memory": str(e).split(".")[0],
                "allocated_gib": torch.cuda.memory_allocated() / 2**30}
    return {"layers": layers, "warm_step_ms": res["warm_step_ms"],
            "peak_gib": res["peak_bytes"] / 2**30}


def leaf_names(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_names(tree[k], f"{prefix}/{k}")
    else:
        yield prefix


def spread(dev, arch: str, dtype: str, layers: int) -> dict:
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ssm_scan as sm
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_arch(arch), n_layers=layers, dtype=dtype)
    toks, labs = cs.train_batch(dev, cfg, 23)
    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    names = list(leaf_names(params))
    loss_k, _, g_k = S.loss_and_grads(params, cfg, toks, labs)
    with cs.plain_grads():
        loss_p, _, g_p = S.loss_and_grads(params, cfg, toks, labs)
    chunk_for = sm.chunk_for
    sm.chunk_for = lambda T, chunk: chunk_for(T, 32)
    try:
        with cs.plain_grads():
            loss_n, _, g_n = S.loss_and_grads(params, cfg, toks, labs)
    finally:
        sm.chunk_for = chunk_for
    rel = lambda a, b: (float((a.float() - b.float()).abs().max())
                        / max(float(b.float().abs().max()), 1e-30))
    gap = {n: rel(a, b) for n, a, b in zip(names, g_k, g_p)}
    own = {n: rel(a, b) for n, a, b in zip(names, g_n, g_p)}
    worst = max(gap, key=gap.get)
    a, b = g_k[names.index(worst)].float(), g_p[names.index(worst)].float()
    by_layer = None
    if a.ndim >= 2 and a.shape[0] == layers:    # a stacked [L, ...] leaf
        by_layer = [float((a[i] - b[i]).abs().max()) / float(b.abs().max())
                    for i in range(layers)]
    return {"arch": arch, "dtype": dtype, "layers": layers,
            "loss": [float(loss_k), float(loss_p), float(loss_n)],
            "kernels_vs_plain": gap, "plain_chunk32_vs_plain": own,
            "worst_leaf": worst, "worst_leaf_by_layer": by_layer}


def main(argv=None) -> None:
    args = parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ssd_train_limits: needs a GPU")
    if args.one_depth:
        print(json.dumps({"depth": one_depth(args.one_depth)}), flush=True)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build

    with ThreadPoolExecutor(6) as pool:     # one nvcc each, together
        list(pool.map(_build.build, (
            "ssd", "ssd_bwd", "flash_attention", "flash_attention_tc",
            "flash_attention_bwd", "flash_attention_bwd_tc")))
    for layers in (int(x) for x in args.depths.split(",") if x):
        out = subprocess.run([sys.executable, __file__, "--one-depth",
                              str(layers)], capture_output=True, text=True)
        line = [ln for ln in out.stdout.splitlines()
                if ln.startswith('{"depth"')]
        print(line[-1] if line else json.dumps(
            {"depth": {"layers": layers, "error": out.stderr[-300:]}}),
            flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    for case in args.spread:
        arch, dtype, depths = case.split(":")
        for layers in (int(x) for x in depths.split(",")):
            print(json.dumps({"spread": spread(dev, arch, dtype, layers)}),
                  flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
