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
    bookkeeping atomically with its arrays.
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

    # ------------------------------------------------------------- saving --
    def save(self, step: int, state, blocking: bool = False,
             extra: dict | None = None) -> None:
        """Snapshot ``state`` (a pytree of tensors) at ``step``;
        write asynchronously unless ``blocking``.

        ``extra``: an optional JSON-serialisable dict merged into the
        manifest (read back through ``manifest(step)["extra"]``) — how a
        service persists its host bookkeeping atomically WITH the arrays."""
        self.wait()                      # one in-flight save at a time
        host, dtypes = [], []
        for leaf in tree_leaves(state):
            arr, dt = _to_host(leaf)
            host.append(arr)
            dtypes.append(dt)
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
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
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

    def restore(self, step: int, template):
        """Restore into the structure of ``template``: each leaf takes the
        template leaf's dtype and device (a host clock stays on the host),
        and must have its shape."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        man = self.manifest(step)
        leaves = tree_leaves(template)
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
            out.append(t.to(device=leaf.device, dtype=leaf.dtype))
        return tree_unflatten(template, out)

    def restore_latest(self, template):
        """(state, step) from the newest complete checkpoint, or (None, -1)."""
        steps = self.steps()
        if not steps:
            return None, -1
        return self.restore(steps[-1], template), steps[-1]
