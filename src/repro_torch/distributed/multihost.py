"""Process groups and the global package mesh across them.

Port of `repro.distributed.multihost` on `torch.distributed`.  Scale-out
past one process keeps the fleet's architecture: the package axis is
embarrassingly parallel, the state lives on the devices, and the telemetry
reductions are the only operations that cross lanes.  A process group
(`initialize`) gives every rank its place in ONE global mesh — the ranks'
local meshes in rank order (`process_mesh`, a
`repro_torch.distributed.sharding.ProcessMesh`).  Every rank runs the SAME
program; each feeds only its own contiguous span of package lanes
(`local_lane_range`), which `ShardedBackend.put_trace` turns into its local
partitions with no movement across processes (`assemble_local_slab`).

Where the reference lets GSPMD turn the flush's reductions into collectives,
the port makes ONE collective a flush itself (`gather_spans`): a ``uint8``
sum ``all_reduce`` of a zero-padded buffer in which each rank writes its
own spans.  Every byte is written by one rank, so the sum is an all-gather,
bit for bit, of any dtype; every rank then reduces the whole window with
the one-device code and fetches the same record with its one host sync.
The same call runs on gloo (CPU tensors, and CUDA tensors for
``all_reduce``) and on NCCL (one rank per card — NCCL refuses two ranks on
one card).

Bootstrap: `initialize` (or `bootstrap_from_env` in a worker that
`run_process_group` started) runs before any engine is built; the CLI
(`repro_torch.launch.serve --distributed`) calls it first.  A group's
collectives time out after ``timeout_s``, so a rank that dies cannot hold
the others forever, and `run_process_group` kills every rank as soon as one
fails or its clock runs out.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import subprocess
import sys
import threading
import time

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (ProcessMesh, Sharded, _leaves,
                                              _map, as_device, gather, spans,
                                              to_device)

__all__ = ["ProcessTopology", "initialize", "bootstrap_from_env",
           "topology", "is_multiprocess", "spans_processes",
           "local_lane_range", "free_port", "run_process_group",
           "assemble_local_slab", "process_mesh", "local_device_pool",
           "group_counts", "gather_spans", "assemble", "COUNTS"]

# collectives `gather_spans` made in this process, and the bytes their
# buffers held (each rank sends and receives about that many)
COUNTS = {"collectives": 0, "bytes": 0}


@dataclasses.dataclass(frozen=True)
class ProcessTopology:
    """This process's view of the group (every field after `initialize`)."""

    process_id: int
    num_processes: int
    local_devices: int
    global_devices: int

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1

    def describe(self) -> str:
        return (f"process {self.process_id}/{self.num_processes} "
                f"({self.local_devices} local / {self.global_devices} "
                f"global devices)")


# set by `initialize`: the devices a rank's mesh takes by default (None: its
# visible cards) and the group's device counts, gathered once
_LOCAL_DEVICES: int | None = None
_DEVICE_COUNTS: tuple[int, ...] | None = None


def _visible_devices() -> int:
    if _LOCAL_DEVICES is not None:
        return _LOCAL_DEVICES
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def _coordinator_url(coordinator: str) -> str:
    return (coordinator if coordinator.startswith("tcp://")
            else f"tcp://{coordinator}")


def initialize(coordinator: str = "127.0.0.1:8476", num_processes: int = 1,
               process_id: int = 0, *, local_devices: int | None = None,
               backend: str = "gloo",
               timeout_s: float = 300.0) -> ProcessTopology:
    """Join (or create) the process group; idempotent per process.

    ``coordinator`` is rank 0's ``host:port`` (a ``tcp://`` init method).
    ``local_devices`` makes this rank's default device pool that many
    entries of its one device (the mesh backends' stand-in for many cards,
    as an explicit ``device_pool`` may be); None keeps every visible card.
    gloo, the default, runs on the CPU and takes CUDA tensors for the
    flush's ``all_reduce``; ``backend="nccl"`` needs one rank per card.
    Collectives raise after ``timeout_s`` seconds.  One small collective
    here gathers every rank's device count for `topology`.
    """
    global _LOCAL_DEVICES, _DEVICE_COUNTS
    if local_devices is not None:
        if local_devices < 1:
            raise ValueError(f"local_devices={local_devices} must be >= 1")
        _LOCAL_DEVICES = int(local_devices)
    if num_processes > 1 and not dist.is_initialized():
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process_id={process_id} outside a group of "
                             f"{num_processes}")
        dist.init_process_group(
            backend, init_method=_coordinator_url(coordinator),
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=timeout_s))
        _DEVICE_COUNTS = tuple(group_counts(_visible_devices()))
    return topology()


def bootstrap_from_env() -> ProcessTopology:
    """`initialize` from the variables `run_process_group` plants —
    REPRO_COORDINATOR, REPRO_NUM_PROCESSES, REPRO_PROCESS_ID and
    REPRO_LOCAL_DEVICES — the first line of every worker.  A bare
    environment is a group of one (no process group is made)."""
    local = os.environ.get("REPRO_LOCAL_DEVICES")
    return initialize(
        coordinator=os.environ.get("REPRO_COORDINATOR", "127.0.0.1:8476"),
        num_processes=int(os.environ.get("REPRO_NUM_PROCESSES", "1")),
        process_id=int(os.environ.get("REPRO_PROCESS_ID", "0")),
        local_devices=int(local) if local else None)


def is_multiprocess() -> bool:
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def topology() -> ProcessTopology:
    local = _visible_devices()
    if not is_multiprocess():
        return ProcessTopology(0, 1, local, local)
    counts = _DEVICE_COUNTS or (local,) * dist.get_world_size()
    return ProcessTopology(dist.get_rank(), dist.get_world_size(), local,
                           sum(counts))


def local_device_pool(home: torch.device):
    """The device pool a mesh backend on ``home`` takes by default: the
    rank's one device repeated as often as `initialize` was told
    (``local_devices``), the one host device on the CPU, else None (every
    visible card)."""
    home = as_device(home)
    if _LOCAL_DEVICES is not None:
        return (home,) * _LOCAL_DEVICES
    return (home,) if home.type != "cuda" else None


def _collective_device() -> torch.device:
    """Where a small collective's tensor lives: the current card under
    NCCL, the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def group_counts(n_local: int) -> list[int]:
    """Every rank's ``n_local`` in rank order (one small all-gather; every
    rank calls it at the same point of its program)."""
    mine = torch.tensor([n_local], dtype=torch.int64,
                        device=_collective_device())
    out = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(out, mine)
    return [int(x) for x in out]


def process_mesh(devices, counts) -> ProcessMesh:
    """The global mesh from this rank's ``devices`` and every rank's
    device count (``counts``, rank order): the ranks' local meshes in rank
    order, this rank's partitions contiguous."""
    owners = [r for r, c in enumerate(counts) for _ in range(c)]
    return ProcessMesh(devices, owners, dist.get_rank())


def spans_processes(obj) -> bool:
    """True when a mesh, or a partitioned leaf's mesh, holds the devices of
    more than one process — what tells the single-process placement paths
    from the process-local-slab ones."""
    if isinstance(obj, Sharded):
        obj = obj.mesh
    if isinstance(obj, ProcessMesh):
        return len(set(obj.owners)) > 1
    if isinstance(obj, tuple):
        return False
    raise TypeError(f"expected a mesh or a Sharded leaf, got {type(obj)}")


def local_lane_range(n_packages: int, mesh) -> tuple[int, int]:
    """[lo, hi) span of the global package axis this process's devices own.

    ``mesh`` is a `ProcessMesh` (or anything with ``owners`` — the rank of
    each global partition in order — and ``rank``); a one-process mesh owns
    every lane.  The span must be contiguous: that is what lets a rank cut
    its slab out of a global trace with one basic slice.
    """
    owners = getattr(mesh, "owners", None)
    if owners is None:
        owners, pid = (0,) * len(mesh), 0
    else:
        pid = mesh.rank
    d = len(owners)
    if n_packages % d:
        raise ValueError(f"n_packages={n_packages} must divide the mesh's "
                         f"{d} devices for a process-local lane span")
    per = n_packages // d
    mine = [i for i, o in enumerate(owners) if o == pid]
    if not mine:
        raise ValueError(f"process {pid} owns no devices of the mesh — it "
                         f"cannot take part in the group's program")
    if mine != list(range(mine[0], mine[-1] + 1)):
        raise ValueError(f"process {pid}'s mesh devices are not contiguous "
                         f"({mine}); build the mesh with process_mesh() "
                         f"(the ranks' local meshes in rank order)")
    return mine[0] * per, (mine[-1] + 1) * per


def assemble_local_slab(mesh: ProcessMesh, local_slab: torch.Tensor,
                        global_shape, dim: int | None = None) -> Sharded:
    """This rank's slab of a global tensor as its local partitions of
    ``mesh`` — no movement across processes.

    ``local_slab`` holds exactly the rows of ``global_shape`` along ``dim``
    (default: the package dim of a trace, just before the tile axis) that
    `local_lane_range` gives this rank; each partition is taken from it on
    the device and placed on its own.
    """
    if dim is None:
        dim = max(len(global_shape) - 2, 0)
    lo, hi = local_lane_range(global_shape[dim], mesh)
    want = tuple(global_shape[:dim]) + (hi - lo,) + tuple(
        global_shape[dim + 1:])
    if tuple(local_slab.shape) != want:
        raise ValueError(f"local slab of shape {tuple(local_slab.shape)} "
                         f"for lanes [{lo}, {hi}) of {tuple(global_shape)}: "
                         f"want {want}")
    return Sharded([to_device(local_slab.narrow(dim, a, b - a), dev)
                    for (a, b), dev in zip(spans(hi - lo, len(mesh)), mesh)],
                   dim, mesh)


# ------------------------------------------------- the flush's collective
_ALIGN = 16


def _layout_order(t: torch.Tensor) -> list[int]:
    """``t``'s dims from the outermost in memory (a size-1 dim inside its
    ties) — the order `sharding.gather` concatenates in."""
    return sorted(range(t.ndim), key=lambda k: (-t.stride(k), t.shape[k] == 1))


def gather_spans(pieces, device) -> list[torch.Tensor]:
    """Whole tensors from every rank's spans, in ONE collective.

    ``pieces`` lists ``(slab, dim, offset, total)``: this rank's ``slab`` of
    a whole tensor whose dimension ``dim`` has ``total`` entries, at
    ``offset``.  Every rank passes the same list (dtypes, shapes outside
    ``dim``, totals) with its own offsets, and the ranks' spans tile each
    tensor.  Each whole tensor comes back on ``device``, laid out in its
    slab's memory order (a permuted slab gives a permuted whole, so a
    reduction over it runs in the order it runs in on one device).

    The buffer is ``uint8``, zero but for this rank's spans, summed across
    the group: each byte has one writer, so the sum is the gather, bit for
    bit, whatever the dtype.
    """
    device = as_device(device)
    layout, size = [], 0
    for slab, dim, offset, total in pieces:
        shape = list(slab.shape)
        shape[dim] = total
        order = _layout_order(slab)
        nbytes = slab.element_size() * int(torch.Size(shape).numel())
        layout.append((size, nbytes, shape, order, slab.dtype))
        size += -(-nbytes // _ALIGN) * _ALIGN
    buf = torch.zeros(size, dtype=torch.uint8, device=device)
    wholes = []
    for (slab, dim, offset, _), (at, nbytes, shape, order, dtype) in zip(
            pieces, layout):
        flat = buf[at:at + nbytes].view(dtype)
        whole = flat.view([shape[k] for k in order]).permute(
            [order.index(k) for k in range(len(shape))])
        whole.narrow(dim, offset, slab.shape[dim]).copy_(slab)
        wholes.append(whole)
    dist.all_reduce(buf)
    COUNTS["collectives"] += 1
    COUNTS["bytes"] += size
    return wholes


def assemble(tree, device):
    """``tree`` whole on ``device`` on every rank: every leaf partitioned
    across processes gathered from all ranks in ONE collective
    (`gather_spans`); whole leaves pass through.  A collective: every rank
    calls it with the same tree at the same point of its program."""
    pieces = []
    for x in _leaves(tree):
        if isinstance(x, Sharded) and x.pmesh is not None:
            pieces.append((gather(x, device, local=True), x.dim,
                           x.spans()[0][0], x.shape[x.dim]))
    if not pieces:
        return gather(tree, device)
    wholes = iter(gather_spans(pieces, device))

    def leaf(x, _):
        if isinstance(x, Sharded) and x.pmesh is not None:
            return next(wholes)
        return gather(x, device)
    return _map(leaf, tree, None)


# ------------------------------------------------- local process groups
def free_port() -> int:
    """An OS-assigned free TCP port for a local coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_process_group(code: str, num_processes: int, *,
                      local_devices: int = 1, timeout: float = 540.0,
                      env: dict | None = None) -> list[str]:
    """Run ``code`` in ``num_processes`` fresh interpreters wired to one
    local coordinator — the process-group harness of the tests and
    `chip_smoke.py` (a deployment starts one `serve --distributed` per
    host instead).

    Each worker gets REPRO_COORDINATOR / REPRO_NUM_PROCESSES /
    REPRO_PROCESS_ID and REPRO_LOCAL_DEVICES (its mesh's default pool: its
    one device ``local_devices`` times), which `bootstrap_from_env` reads,
    and this checkout's ``src`` on its path.  Returns each rank's combined
    stdout and stderr in rank order.  As soon as one rank exits non-zero,
    or ``timeout`` seconds pass, every rank is killed and this raises with
    every rank's output (a group's failure often explains itself on one
    rank only).
    """
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
    base = dict(os.environ)
    base.update(env or {})
    base["REPRO_COORDINATOR"] = f"127.0.0.1:{free_port()}"
    base["REPRO_NUM_PROCESSES"] = str(num_processes)
    base["REPRO_LOCAL_DEVICES"] = str(local_devices)
    base["PYTHONPATH"] = src + os.pathsep + base.get("PYTHONPATH", "")
    procs, outs, readers = [], [], []

    def drain(pipe, sink: list) -> None:
        sink.append(pipe.read())
        pipe.close()

    deadline = time.monotonic() + timeout
    timed_out = False
    try:
        for pid in range(num_processes):
            p = subprocess.Popen(
                [sys.executable, "-c", code],
                env=dict(base, REPRO_PROCESS_ID=str(pid)), text=True,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            procs.append(p)
            outs.append([])
            readers.append(threading.Thread(target=drain,
                                            args=(p.stdout, outs[-1]),
                                            daemon=True))
            readers[-1].start()
        while True:
            rcs = [p.poll() for p in procs]
            if any(rc not in (None, 0) for rc in rcs) or all(
                    rc is not None for rc in rcs):
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.02)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for r in readers:
            r.join()
    text = ["".join(o) for o in outs]
    if timed_out or any(p.returncode for p in procs):
        why = (f"timed out after {timeout:.0f} s" if timed_out
               else "a rank failed")
        report = "\n".join(f"--- rank {i} (rc={p.returncode}) ---\n{o}"
                           for i, (p, o) in enumerate(zip(procs, text)))
        raise RuntimeError(f"process group {why}:\n{report}")
    return text
