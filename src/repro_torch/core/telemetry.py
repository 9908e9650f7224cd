"""§5.3 — UCIe sideband telemetry budget and the host-side telemetry log.

Port of `repro.core.telemetry`.  Paper budget: a 64-byte per-tile packet at
1 Mbps ⇒ 512 µs transfer, well inside the 20 ms look-ahead minimum; hint
dispatch reuses the management channel in reverse.  `budget()` reproduces
that arithmetic (and the §7.1 overhead rows); `TelemetryLog` is a bounded
host-side ring of per-step (or per-flush) scheduler records.
"""
from __future__ import annotations

import dataclasses
import json
from collections import deque
from typing import Any

import numpy as np

from repro_torch.core.fingerprint import FINGERPRINT, Fingerprint


def budget(n_tiles: int = 8, fp: Fingerprint = FINGERPRINT) -> dict:
    """UCIe sideband timing/overhead budget (paper §5.3, §7.1)."""
    bits = fp.telemetry_packet_bytes * 8
    per_packet_us = bits / fp.telemetry_link_mbps          # 512 µs @ 64 B, 1 Mbps
    round_trip_us = 2 * per_packet_us                      # telemetry + hint
    lookahead_us = fp.lookahead_min_ms * 1e3
    return {
        "packet_bytes": fp.telemetry_packet_bytes,
        "link_mbps": fp.telemetry_link_mbps,
        "per_packet_us": per_packet_us,
        "round_trip_us": round_trip_us,
        "n_tiles": n_tiles,
        "fits_lookahead": round_trip_us < lookahead_us,
        "lookahead_margin_x": lookahead_us / round_trip_us,
        "mgmt_channel_overhead_mbps": fp.telemetry_link_mbps,   # §7.1
        "density_cpu_overhead_frac": (0.001, 0.003),            # 0.1–0.3 %/tile
    }


def _jsonable(v: Any) -> Any:
    """A telemetry field as a host value: scalars (numbers, one-element
    arrays or tensors) become floats, larger tensors lists.  A larger numpy
    array is kept as it is — the control plane's flush chunks (~49 M f32
    values a flush at 4,096 packages × 47 tiles × 256 steps) would not fit
    as Python floats — and `TelemetryLog.dump_jsonl` writes it as a list."""
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, np.ndarray) and v.size > 1:
        return v
    if hasattr(v, "detach"):               # torch tensor, on any device
        v = v.detach().cpu().numpy()
    if getattr(v, "shape", None) is not None:
        arr = np.asarray(v)
        return float(arr.reshape(-1)[0]) if arr.size == 1 else arr.tolist()
    if hasattr(v, "item"):                 # other numpy-like scalars
        return float(v)
    return v


@dataclasses.dataclass
class TelemetryLog:
    """Bounded host-side telemetry ring (1 record / step)."""

    capacity: int = 100_000
    _rows: deque = dataclasses.field(default_factory=deque, repr=False)

    def record(self, step: int, **fields: Any) -> None:
        self._rows.append({"step": step, **{k: _jsonable(v)
                                            for k, v in fields.items()}})
        while len(self._rows) > self.capacity:
            self._rows.popleft()

    def __len__(self) -> int:
        return len(self._rows)

    def rows(self) -> list[dict]:
        return list(self._rows)

    def last(self) -> dict:
        return self._rows[-1]

    def dump_jsonl(self, path: str) -> None:
        """Write the ring as JSON lines (one record per row; kept numpy
        arrays as lists)."""
        with open(path, "w") as f:
            for r in self._rows:
                f.write(json.dumps(r, default=_array_list) + "\n")

    # the reference's alias (its launch/train.py --telemetry-out calls dump)
    dump = dump_jsonl


def _array_list(v: Any) -> Any:
    if isinstance(v, np.ndarray):
        return v.tolist()
    raise TypeError(f"{type(v).__name__} is not JSON serializable")
