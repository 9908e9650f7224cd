#!/usr/bin/env python3
"""What collectives cost, and which ones gloo takes, between ranks on one
card.

    python3 scripts/collective_probe.py [--mib 1,64,592] [--ops 32]

Starts two ranks of a process group (`repro_torch.distributed.multihost.
run_process_group`) on the one card and times a ``uint8`` sum
``all_reduce`` — the collective `multihost.gather_spans` makes once a
flush — at each size of ``--mib``: on gloo with CUDA tensors (the path
the mesh backends take), on gloo with host tensors, and then on NCCL,
which refuses two ranks on one card (the line it fails with is printed).
Each size is timed 3 times per rank, host clock around the call after a
synchronize and a barrier.  Prints the card's name and power limit first.

``--ops MIB`` instead probes, on CUDA tensors over gloo between two ranks,
every collective a DTensor program on the mesh issues —
``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``, a MAX ``all_reduce`` of f32 and a SUM
``all_reduce`` of int32 (the error-feedback all-reduce's two) — each on a
tensor of MIB MiB: whether it runs, whether its result is right, and its
time (3 runs a rank).  Then DTensor's Shard → Replicate (the functional
all-gather) on CUDA tensors, in a group of its own: as DTensor issues it,
and routed through c10d (`sharding.route_cuda_all_gather`, what the card's
meshes do) — whether each runs, crashes or is wrong.
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

OPS_WORKER = r"""
import json, os, time
from repro_torch.distributed import multihost
multihost.initialize(os.environ["REPRO_COORDINATOR"], 2,
                     int(os.environ["REPRO_PROCESS_ID"]), timeout_s=60)
import torch
import torch.distributed as dist
rank, world, dev = dist.get_rank(), 2, torch.device("cuda")
n = (%(mib)d << 20) // 4


def run(name, fn, check):
    ms = []
    try:
        for _ in range(3):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            ms.append(round((time.perf_counter() - t0) * 1e3, 2))
        ok = bool(check(got))
        res = {"ok": ok, "ms": ms}
    except Exception as e:                 # noqa: BLE001 — reported
        res = {"ok": False, "error": f"{type(e).__name__}: {e}"[:300]}
    print("RESULT " + json.dumps({"rank": rank, "op": name, **res}))


x = torch.full((n,), float(rank + 1), device=dev)


def gather():
    out = torch.empty(world * n, device=dev)
    dist.all_gather_into_tensor(out, x)
    return out


def scatter():
    out = torch.empty(n // world, device=dev)
    dist.reduce_scatter_tensor(out, x)
    return out


def to_all():
    out = torch.empty(n, device=dev)
    dist.all_to_all_single(out, x)
    return out


def amax():
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX)
    return y


def isum():
    y = torch.full((n,), rank + 1, dtype=torch.int32, device=dev)
    dist.all_reduce(y)
    return y


run("all_gather_into_tensor", gather,
    lambda o: bool((o[:n] == 1).all() and (o[n:] == 2).all()))
run("reduce_scatter_tensor", scatter, lambda o: bool((o == 3).all()))
run("all_to_all_single", to_all,
    lambda o: bool((o[:n // 2] == 1).all() and (o[n // 2:] == 2).all()))
run("all_reduce MAX f32", amax, lambda o: bool((o == 2).all()))
run("all_reduce SUM int32", isum, lambda o: bool((o == 3).all()))
"""

FUNCOL_WORKER = r"""
import os, torch
from repro_torch.distributed import multihost, sharding
multihost.initialize(os.environ["REPRO_COORDINATOR"], 2,
                     int(os.environ["REPRO_PROCESS_ID"]), timeout_s=60)
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
if %(route)r:
    sharding.route_cuda_all_gather()
mesh = DeviceMesh("cuda", torch.arange(2), mesh_dim_names=("model",))
x = torch.arange(4 * 6 * 8, dtype=torch.float32, device="cuda").reshape(
    4, 6, 8)
for dim in (0, 2):
    d = distribute_tensor(x, mesh, [Shard(dim)], src_data_rank=None)
    y = d.redistribute(mesh, [Replicate()]).to_local()
    torch.cuda.synchronize()
    assert torch.equal(y, x), f"Shard({dim}) -> Replicate is wrong"
print("RESULT", sharding.CUDA_GATHERS)
"""


def probe_funcol() -> None:
    from repro_torch.distributed import multihost

    for route in (False, True):
        what = ("through c10d (route_cuda_all_gather)" if route
                else "as DTensor issues it")
        try:
            outs = multihost.run_process_group(
                FUNCOL_WORKER % {"route": route}, 2, timeout=120)
            n = [line.split()[1] for o in outs for line in o.splitlines()
                 if line.startswith("RESULT")]
            print(f"[gloo cuda] DTensor Shard -> Replicate {what}: right on "
                  f"both ranks, routed gathers a rank {n}")
        except RuntimeError as err:
            rcs = [line for line in str(err).splitlines()
                   if line.startswith("--- rank")]
            print(f"[gloo cuda] DTensor Shard -> Replicate {what}: failed, "
                  + "; ".join(rcs))


def probe_ops(mib: int) -> None:
    from repro_torch.distributed import multihost

    outs = multihost.run_process_group(OPS_WORKER % {"mib": mib}, 2,
                                       timeout=600)
    for o in outs:
        for line in o.splitlines():
            if line.startswith("RESULT "):
                res = json.loads(line[len("RESULT "):])
                print(f"[gloo cuda {mib} MiB] rank {res.pop('rank')} "
                      f"{res.pop('op')}: " + json.dumps(res))
    probe_funcol()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", default="1,64,592")
    ap.add_argument("--ops", type=int, default=0, metavar="MIB")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.distributed import multihost

    if not torch.cuda.is_available():
        raise SystemExit("collective_probe: needs a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    if args.ops:
        probe_ops(args.ops)
        return
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
