"""Crash-consistent checkpointing with async save and auto-resume.

Port of `repro.checkpoint.manager`, writing the reference's on-disk layout
so that a snapshot directory crosses between the two packages:

    <dir>/step_00001234.tmp/...      (in-flight write)
    <dir>/step_00001234/             (atomic rename on completion)
        manifest.json                (leaf count, shapes, dtypes, "complete")
        arr_00000.npy ...            (one file per leaf, host arrays)

Leaves are numbered in the reference's pytree order (`tree_leaves`):
NamedTuple fields in order, dict entries by sorted key, list and tuple
items in order, ``None`` holding no leaf.  A `SchedulerState` of the port
therefore writes the same ``arr_NNNNN.npy`` files as the reference's —
the shared clocks (``step``, the filtration ``ptr``) included — and a
snapshot the JAX service wrote restores into the port's state template.

Contract:

  * atomic: readers only see fully renamed step directories whose
    manifest says complete; a crash mid-save never corrupts the latest;
  * async: `save()` copies every leaf to host memory BEFORE the writer
    thread starts (the port's backends may update state in place, and a
    background write must not race the next tick), then writes on the
    thread;
  * auto-resume: `restore_latest()` finds the newest complete step;
  * ``keep_n`` GC; the manifest's ``extra`` dict carries a service's host
    bookkeeping atomically with its arrays;
  * on a mesh: `save` of a tree holding DTensors gathers each one onto
    the mesh's first rank alone (one leaf at a time, before the writer
    thread starts: collectives cannot run there), which alone writes;
    a blocking save, and `wait` after an async one, return on every rank
    of the mesh only once that rank has renamed the step.
    `restore(..., shardings=)` places each leaf by its `NamedSharding` on
    whatever mesh the new job runs — the elastic re-mesh — and a DTensor
    template leaf is placed as that leaf.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch


def tree_leaves(tree) -> list:
    """The tensor leaves of a state pytree in the reference's order (see
    the module docstring)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in tree_leaves(item)]
    return [tree]


def tree_unflatten(template, leaves: list):
    """``template``'s structure with its leaves replaced, in order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(template)


def _to_host(x: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf as a host numpy array and its dtype's name (bf16 as its raw
    16-bit pattern, the reference's convention)."""
    t = x.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._mesh = None        # the mesh of a distributed save in flight

    # ------------------------------------------------------------- saving --
    def save(self, step: int, state, blocking: bool = False,
             extra: dict | None = None) -> None:
        """Snapshot ``state`` (a pytree of tensors) at ``step``;
        write asynchronously unless ``blocking``.

        ``extra``: an optional JSON-serialisable dict merged into the
        manifest (read back through ``manifest(step)["extra"]``) — how a
        service persists its host bookkeeping atomically WITH the arrays."""
        self.wait()                      # one in-flight save at a time
        leaves = tree_leaves(state)
        meshes = {x.device_mesh for x in leaves if _is_distributed(x)}
        if len(meshes) > 1:
            raise ValueError(f"save: the leaves lie on {len(meshes)} meshes")
        mesh = meshes.pop() if meshes else None
        writer = mesh is None or not any(mesh.get_coordinate())
        host, dtypes = [], []
        for leaf in leaves:
            if _is_distributed(leaf):
                leaf = _gather_to_first(leaf)
            if writer:                   # on a mesh its first rank alone
                arr, dt = _to_host(leaf)
                host.append(arr)
                dtypes.append(dt)
        self._mesh = mesh
        if not writer:
            if blocking:
                self.wait()
            return
        spec = {"treedef": f"{type(state).__name__}, {len(host)} leaves",
                "n_leaves": len(host),
                "shapes": [list(h.shape) for h in host],
                "dtypes": dtypes, "step": step, "complete": True}
        if extra is not None:
            spec["extra"] = json.loads(json.dumps(extra))  # fail fast, copy

        def write():
            try:
                tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
                fin = os.path.join(self.dir, f"step_{step:08d}")
                os.makedirs(tmp, exist_ok=True)
                for i, h in enumerate(host):
                    np.save(os.path.join(tmp, f"arr_{i:05d}.npy"), h)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(spec, f)
                    f.flush()
                    os.fsync(f.fileno())
                if os.path.exists(fin):
                    shutil.rmtree(fin)
                os.rename(tmp, fin)
                self._gc()
            except BaseException as e:   # noqa: BLE001 — re-raised by wait()
                self._error = e

        if blocking:
            write()
            self.wait()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Block until the save in flight is on disk; after a save on a
        mesh, on every rank of it (a collective: every rank calls it)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh is not None:
            mesh, self._mesh = self._mesh, None
            _mesh_barrier(mesh)
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {e}") from e

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------ loading --
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                man = os.path.join(self.dir, name, "manifest.json")
                try:
                    with open(man) as f:
                        if json.load(f).get("complete"):
                            out.append(int(name.split("_")[1]))
                except (OSError, ValueError, json.JSONDecodeError):
                    continue
        return sorted(out)

    def manifest(self, step: int) -> dict:
        """The manifest dict of a complete checkpoint (with any ``extra``)."""
        path = os.path.join(self.dir, f"step_{step:08d}", "manifest.json")
        with open(path) as f:
            return json.load(f)

    def restore(self, step: int, template, shardings=None):
        """Restore into the structure of ``template``: each leaf takes the
        template leaf's dtype and device (a host clock stays on the host),
        and must have its shape.  ``shardings``: an optional congruent tree
        of `sharding.NamedSharding`s — each leaf is then placed on its mesh
        by its spec (every rank reads the whole array and keeps its own
        slice); a DTensor template leaf is placed as that leaf."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        man = self.manifest(step)
        leaves = tree_leaves(template)
        places = (tree_leaves(shardings) if shardings is not None
                  else [None] * len(leaves))
        if len(places) != len(leaves):
            raise ValueError(f"restore: {len(places)} shardings for "
                             f"{len(leaves)} leaves")
        if man["n_leaves"] != len(leaves):
            raise ValueError(f"checkpoint step {step} holds "
                             f"{man['n_leaves']} leaves, the template "
                             f"{len(leaves)}")
        out = []
        for i, leaf in enumerate(leaves):
            a = np.load(os.path.join(path, f"arr_{i:05d}.npy"))
            if tuple(a.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint leaf {i} has shape "
                                 f"{a.shape}, the template "
                                 f"{tuple(leaf.shape)}")
            t = torch.from_numpy(np.array(a, order="C"))
            if man["dtypes"][i] == "bfloat16":
                t = t.view(torch.bfloat16)
            out.append(_place(t, leaf, places[i]))
        return tree_unflatten(template, out)

    def restore_latest(self, template, shardings=None):
        """(state, step) from the newest complete checkpoint, or (None, -1)."""
        steps = self.steps()
        if not steps:
            return None, -1
        return self.restore(steps[-1], template, shardings), steps[-1]


def _is_distributed(x) -> bool:
    from repro_torch.distributed.sharding import is_distributed
    return is_distributed(x)


def _gather_to_first(x):
    """DTensor ``x`` whole on its mesh's first rank, None on every other.
    The mesh's axes are taken from the last: each gathers its shards
    (``dist.gather``) onto coordinate 0 of that axis, and a rank off
    coordinate 0 is done after it, so only the first rank ever holds the
    whole.  Over gloo the shards travel in host memory.  A leaf an axis
    does not divide evenly raises (its shards would differ in size)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(mesh, [Replicate() if p.is_partial() else p
                                  for p in x.placements])
    for dim in range(x.ndim):
        parts = 1
        for i, p in enumerate(x.placements):
            parts *= mesh.size(i) if p.is_shard(dim) else 1
        if x.shape[dim] % parts:
            raise ValueError(f"save: a leaf of shape {tuple(x.shape)} is "
                             f"split unevenly ({x.placements})")
    coord = mesh.get_coordinate()
    t = x.to_local()
    for i in reversed(range(mesh.ndim)):
        p = x.placements[i]
        if p.is_shard():
            group = mesh.get_group(i)
            part = t.contiguous()
            if dist.get_backend(group) == "gloo":
                part = part.cpu()
            parts = ([torch.empty_like(part) for _ in range(mesh.size(i))]
                     if coord[i] == 0 else None)
            dist.gather(part, parts, dst=dist.get_global_rank(group, 0),
                        group=group)
            if coord[i] == 0:
                t = torch.cat(parts, dim=p.dim)
        if coord[i] != 0:
            return None
    return t


def _mesh_barrier(mesh) -> None:
    """Every rank of ``mesh`` waits here until its first rank has come:
    a barrier on each axis's groups in turn, the first axis first."""
    import torch.distributed as dist

    for i in range(mesh.ndim):
        dist.barrier(group=mesh.get_group(i))


def _place(t: torch.Tensor, leaf, sharding) -> torch.Tensor:
    """A restored host tensor in ``leaf``'s dtype, placed by ``sharding``
    (a `NamedSharding`), as ``leaf`` when that is a DTensor, else on
    ``leaf``'s device."""
    from repro_torch.distributed import sharding as shd

    t = t.to(dtype=leaf.dtype)
    if sharding is not None:
        mesh, pls = sharding.mesh, sharding.placements
    elif _is_distributed(leaf):
        mesh, pls = leaf.device_mesh, leaf.placements
    else:
        return t.to(device=leaf.device)
    return shd.distribute_leaf(t.to(mesh.device_type), mesh, pls)
