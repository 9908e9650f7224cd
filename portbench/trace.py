"""Reading a `torch.profiler` trace (its Chrome-trace export) into the
quantities the per-layer metrics and the breakdown need: device activity by
kernel, the device's busy time within the traced window, the idle gaps
labelled by what the host was doing, and the host ranges (the benchmark's
own spans and the program's ``record_function`` ranges)."""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "portbench.window"


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _top_level(ops):
    """Per thread, the ops no other op of that thread encloses."""
    by_tid = defaultdict(list)
    for e in ops:
        by_tid[e["tid"]].append(e)
    top = []
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        end = -1.0
        for e in evs:
            if e["ts"] >= end:
                top.append(e)
                end = e["ts"] + e["dur"]
    top.sort(key=lambda e: e["ts"])
    return top


class Trace:
    """Times in seconds; ``window`` is the span the benchmark opened around
    the traced part of its measured window."""

    def __init__(self, events: list[dict]):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        for e in xs:
            e["ts"], e["dur"] = float(e["ts"]), float(e["dur"])
        self.device = [e for e in xs if e.get("cat") in DEVICE_CATS]
        self.ranges = [e for e in xs if e.get("cat") == "user_annotation"]
        self.spans = [e for e in self.ranges
                      if e["name"].startswith("portbench.")]
        self.cpu_ops = [e for e in xs if e.get("cat") == "cpu_op"]
        win = [e for e in self.spans if e["name"] == WINDOW_SPAN]
        if not win:
            raise ValueError("the trace holds no window span")
        w = max(win, key=lambda e: e["dur"])
        self.t0, self.t1 = w["ts"], w["ts"] + w["dur"]
        self.window_s = w["dur"] * 1e-6
        self.device = [e for e in self.device
                       if e["ts"] < self.t1 and e["ts"] + e["dur"] > self.t0]
        self.spans.sort(key=lambda e: e["ts"])
        self._busy = _merge((max(e["ts"], self.t0),
                             min(e["ts"] + e["dur"], self.t1))
                            for e in self.device)

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    # ---------------------------------------------------------------- device
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy) * 1e-6

    def kernels(self, name_part: str | None = None) -> list[dict]:
        return [e for e in self.device if e.get("cat") == "kernel"
                and (name_part is None or name_part in e["name"])]

    def memcpy(self, kind: str) -> list[dict]:
        """Copies whose name holds ``kind`` ("HtoD", "DtoH", "DtoD")."""
        return [e for e in self.device if e.get("cat") == "gpu_memcpy"
                and kind in e["name"]]

    @staticmethod
    def seconds(events) -> float:
        return sum(e["dur"] for e in events) * 1e-6

    def spans_named(self, name: str) -> list[dict]:
        return [s for s in self.ranges if s["name"] == name]

    def cpu_op_seconds(self, name: str) -> float:
        """Host seconds in outermost ``name`` ops within the window."""
        evs = [e for e in self.cpu_ops if e["name"] == name
               and self.t0 <= e["ts"] < self.t1]
        return self.seconds(_top_level(evs))

    # ------------------------------------------------------------- breakdown
    def device_ops(self, top: int = 10) -> list[list]:
        acc = defaultdict(float)
        for e in self.device:
            acc[short_name(e["name"])] += e["dur"] * 1e-6
        return [[k, v] for k, v in sorted(acc.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """Idle time within the window summed by what the host was doing:
        the innermost benchmark span and the outermost host op overlapping
        each gap the most ("python" where no op ran)."""
        gaps, prev = [], self.t0
        for a, b in self._busy:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if prev < self.t1:
            gaps.append((prev, self.t1))
        ops = _top_level([e for e in self.cpu_ops
                          if e["ts"] < self.t1
                          and e["ts"] + e["dur"] > self.t0])
        starts = [e["ts"] for e in ops]
        span_starts = [s["ts"] for s in self.spans]
        acc = defaultdict(float)
        for a, b in gaps:
            i = max(bisect.bisect_right(starts, a) - 1, 0)
            best, most = "python", 0.0
            while i < len(ops) and ops[i]["ts"] < b:
                e = ops[i]
                ov = min(b, e["ts"] + e["dur"]) - max(a, e["ts"])
                if ov > most:
                    best, most = e["name"], ov
                i += 1
            mid = 0.5 * (a + b)
            span = None
            j = bisect.bisect_right(span_starts, mid)
            for s in reversed(self.spans[max(j - 64, 0):j]):
                if s["ts"] + s["dur"] >= mid and s["name"] != WINDOW_SPAN:
                    if span is None or s["dur"] < span["dur"]:
                        span = s
            label = best if span is None else f"{span['name']}/{best}"
            acc[label] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(acc.items(),
                                          key=lambda kv: -kv[1])[:top]]


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    argument list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = name.find("(")
    return (name if cut < 0 else name[:cut])[:120]
