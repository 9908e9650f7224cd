"""The benchmark's engine: finds a cell's configuration, traffic, kind module and
metric readers by name, times set-up and the measured window, reads the
trace, runs the cell's correctness comparison and prints the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own (``configs/``, ``traffic/``,
``kinds/``, ``metrics/``); this module names none of them.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(Exception):
    """The run cannot produce a result (no card, too few cards, a bad
    cell name); exits non-zero and prints no result line."""


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is the JAX stack
    or the JAX package (whole names: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def percentile(values, q: float) -> float:
    """Linear-interpolated percentile (numpy's default rule)."""
    v = sorted(values)
    pos = q / 100.0 * (len(v) - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


class Tracer:
    """The profiler around the traced part of the window (a no-op when the
    run is not traced).  The kind calls `begin` when its window starts and
    `end` when its traced part is over; spans are the benchmark's own
    ``record_function`` ranges, named ``portbench.<what>``."""

    def __init__(self, on: bool, out: Path):
        self.on, self.out = on, out
        self.prof = self._win = None
        self.done = False

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(f"portbench.{name}")

    def begin(self) -> None:
        if not self.on or self.prof is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self._win = torch.profiler.record_function("portbench.window")
        self._win.__enter__()

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.done

    def end(self) -> None:
        if not self.active:
            return
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._win.__exit__(None, None, None)
        self.prof.stop()
        self.done = True

    def read(self):
        from portbench.trace import Trace
        self.end()
        if self.prof is None:
            return None
        self.out.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.out))
        self.prof = None
        tr = Trace.load(self.out)
        self.out.unlink()
        return tr


class Context:
    """What a kind module and a metric reader see of a run."""

    def __init__(self, root: Path, cell: dict, config: dict, traffic: dict,
                 seed: int, seconds: float, trace: bool):
        self.root, self.cell = root, cell
        self.config, self.traffic = config, traffic
        self.seed, self.seconds = seed, seconds
        self.tracer = Tracer(trace, root / "build" / "portbench" /
                             f"trace-{cell['name']}.json")
        self.device = None
        self.e2e: dict[str, float] = {}        # end-to-end metrics
        self.counters: dict = {}               # host-clock and counted facts
        self.trace = None                      # the parsed trace
        self.attempted = self.failed = 0


def prepare(root: Path, workload: str, seed: int, seconds: float,
            trace: bool, device: str = "cuda",
            overrides: dict | None = None):
    """(manifest, the cell's kind module, its context) for one run.  ``device``
    other than "cuda" and ``overrides`` (merged into the traffic file) are
    for the tests, which skip the look for a card and shrink the cell."""
    bench = manifest(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"unknown workload {workload!r}; known: "
                      f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[cell["config"]]["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    traffic.update(overrides or {})

    import torch
    if device == "cuda":
        if not torch.cuda.is_available():
            raise Refused("no CUDA device: the benchmark measures the card "
                          "and never falls back to the CPU")
        if torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"{workload} needs {cell['chips']} cards, "
                          f"{torch.cuda.device_count()} visible")
    kind = load_module(HERE / "kinds" / f"{traffic['kind']}.py",
                         f"portbench_kind_{traffic['kind']}")
    ctx = Context(root, cell, config, traffic, seed, seconds, trace)
    ctx.device = torch.device(device)
    return bench, kind, ctx


def run(root: Path, workload: str, seed: int, seconds: float,
        trace: bool, t_start: float, device: str = "cuda",
        overrides: dict | None = None) -> dict:
    """One run of one cell; returns the result line's object."""
    import torch
    bench, kind, ctx = prepare(root, workload, seed, seconds, trace,
                               device, overrides)
    kind.setup(ctx)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    kind.window(ctx)
    ctx.trace = ctx.tracer.read()
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if device == "cuda" else 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = kind.check(ctx)
    correct = all(v <= lim for _, v, lim in checks)

    if trace:
        metrics = {}
        for m in bench["per_layer"]:
            if not applies(m, workload):
                continue
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 f"portbench_metric_{len(metrics)}")
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {}
        for m in bench["end_to_end"]:
            if not applies(m, workload):
                continue
            v = setup_s if m["name"] == "setup_s" else ctx.e2e[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(ctx.device)
                    if device == "cuda" else device),
           "count": ctx.cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": ctx.attempted,
              "failed": ctx.failed, "metrics": metrics, "device": dev}
    if ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s()
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.device_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    result["compared"] = {n: {"value": v, "limit": lim}
                          for n, v, lim in checks}
    found = forbidden_modules()
    if found:
        raise Refused(f"modules of the JAX stack or package loaded: {found}")
    return result
