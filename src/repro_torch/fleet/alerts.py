"""Per-tenant alerting — window statistics on the device + host-side edge latch.

Port of `repro.fleet.alerts`.  Two halves, split at the single host sync
per flush:

  * `tenant_window_stats` runs inside the control plane's flush
    (`repro_torch.fleet.service`), on the fleet's device: segment
    reductions over the lane axis (`segment_sum`'s fixed-order sums,
    ``scatter_reduce`` maxima and minima) collapse the [T, capacity, tiles] temperature /
    frequency traces of one flush window into dense ``[max_tenants]``
    per-tenant statistics, and compare them with the registry's threshold
    arrays to give alarm booleans — so evaluating every tenant's rules
    costs no extra host sync and editing a threshold changes values only.
    Free (inactive) lanes are routed to a DUMP SEGMENT (``tenant_ids ==
    M``, cf. `FleetRegistry.tenant_lane_ids`) that is sliced off before
    return, so padded capacity-pool lanes cannot trip an alarm.

  * `AlertEngine` runs on the host AFTER the flush record is fetched: a
    rising-edge latch per (tenant, alarm kind) turns the per-flush alarm
    levels into fire-ONCE-per-crossing events (re-armed only when the
    condition clears), fanned out to pluggable sinks — `LogSink` (stdout /
    in-memory), `JsonlSink` (append to a JSONL audit file), `WebhookSink`
    (HTTP POST with bounded retries; collects payloads when no URL is
    given, so tests and offline runs need no network).

Alarm kinds (keys of the alarms dict / the event's ``kind``):

  * ``t_crit``    — window-peak junction temperature over the tenant's
                    packages crossed the tenant's `t_crit_c` threshold.
  * ``at_risk``   — the tenant's straggler fraction (tile-steps under the
                    fleet straggler threshold) exceeded `at_risk_limit`.
  * ``cpo_drift`` — worst per-tile junction-temperature excursion in the
                    window, scaled by the fingerprint's κ→nm slope
                    (`repro_torch.core.cpo`), exceeded `drift_budget_nm`.
  * ``degraded``  — lanes of the tenant on the reactive degraded-mode
                    fallback at the end of the window exceeded the
                    tenant's `degraded_limit`.

Each crossing yields exactly one ``"event": "fired"`` record on the rising
edge and one matching ``"event": "cleared"`` record on the falling edge.
"""
from __future__ import annotations

import json
import sys
import time
from typing import NamedTuple

import torch

__all__ = ["TenantWindowStats", "tenant_window_stats", "segment_sum",
           "AlertEngine", "LogSink", "JsonlSink", "WebhookSink",
           "ALARM_KINDS"]

ALARM_KINDS = ("t_crit", "at_risk", "cpo_drift", "degraded")


class TenantWindowStats(NamedTuple):
    """Dense per-tenant reductions for one flush window; every leaf is
    ``[max_tenants]`` (empty slots carry identity values: 0 lanes, −inf
    peaks, +inf minima)."""

    n_lanes: torch.Tensor       # int32 — attached packages per tenant
    temp_peak_c: torch.Tensor   # max junction temp over (steps, lanes, tiles)
    freq_min: torch.Tensor      # worst frequency multiplier in the window
    freq_mean: torch.Tensor     # mean frequency over the tenant's tile-steps
    at_risk_frac: torch.Tensor  # fraction of tile-steps under straggler thr.
    events: torch.Tensor        # int32 — event counter delta over the window
    drift_nm: torch.Tensor      # worst per-tile CPO drift excursion [nm]
    degraded_lanes: torch.Tensor  # int32 — lanes on the reactive fallback


def segment_sum(x: torch.Tensor, ids: torch.Tensor,
                n_segments: int) -> torch.Tensor:
    """``[n_segments]`` sums of ``x`` [lanes] by segment id (the
    counterpart of ``jax.ops.segment_sum``: ids outside [0, n_segments),
    such as the free lanes' dump segment, drop out).

    Each segment's lanes are summed along a dense segment × lane mask, one
    row reduction per segment, so the order of the additions is the same on
    every run and every device — ``index_add_`` is float atomics on a
    card, whose order, and so whose rounding, changes from run to run.  The
    mask costs n_segments × lanes: tenants are few beside lanes.
    """
    seg = torch.arange(n_segments, device=x.device)
    return torch.where(ids[None, :] == seg[:, None], x[None, :],
                       torch.zeros((), dtype=x.dtype, device=x.device)
                       ).sum(dim=1)


def tenant_window_stats(temps: torch.Tensor, freqs: torch.Tensor,
                        events0: torch.Tensor, events1: torch.Tensor,
                        active: torch.Tensor, tenant_ids: torch.Tensor,
                        n_tenants: int, straggler_threshold: float,
                        kappa_to_nm_per_c: float,
                        thresholds: dict[str, torch.Tensor],
                        degraded: torch.Tensor | None = None,
                        ) -> tuple[TenantWindowStats,
                                   dict[str, torch.Tensor]]:
    """Collapse one flush window into per-tenant stats + alarm levels.

    temps / freqs: [T, capacity, tiles] traces of the window.  events0 /
    events1: [capacity] per-lane cumulative event counters before / after
    the window.  active: [capacity] bool.  tenant_ids: [capacity] int slot
    per lane (free lanes = ``n_tenants``, the dump segment).  thresholds:
    the registry's dense ``{"t_crit_c", "at_risk_limit",
    "drift_budget_nm", "degraded_limit"}`` tensors, ``[n_tenants]`` each,
    +inf on empty slots.  degraded: optional [capacity] bool per-lane
    fallback flags at the END of the window (None: counted as zero).

    Every reduction has a fixed output size and reads no value on the
    host, so it never waits on the device.
    """
    nseg = n_tenants + 1                       # + dump segment for free lanes
    ids = torch.where(active, tenant_ids.long(), n_tenants)
    dev, f32 = temps.device, temps.dtype

    def seg_sum(x):
        return segment_sum(x, ids, n_tenants)

    def seg_reduce(x, how, fill):
        return torch.full((nseg,), fill, dtype=x.dtype, device=dev
                          ).scatter_reduce_(0, ids, x, how)[:-1]

    tile_steps = float(temps.shape[0] * temps.shape[2])
    lane_peak = temps.amax(dim=(0, 2))                       # [capacity]
    lane_fmin = freqs.amin(dim=(0, 2))
    lane_fsum = freqs.sum(dim=(0, 2))
    lane_risk = (freqs < straggler_threshold).sum(dim=(0, 2)).to(f32)
    # CPO drift basis: worst per-TILE temperature excursion in the window
    # (max − min over steps), then the worst tile per lane — ΔT·κ in nm
    lane_dt = (temps.amax(dim=0) - temps.amin(dim=0)).amax(dim=-1)
    lane_ev = (events1 - events0).to(torch.float32)
    lane_deg = (torch.zeros_like(lane_peak) if degraded is None
                else degraded.to(torch.float32))

    n_lanes = seg_sum(torch.ones_like(lane_peak)).to(torch.int32)
    denom = n_lanes.to(f32).clamp(min=1) * tile_steps
    stats = TenantWindowStats(
        n_lanes=n_lanes,
        temp_peak_c=seg_reduce(lane_peak, "amax", -torch.inf),
        freq_min=seg_reduce(lane_fmin, "amin", torch.inf),
        freq_mean=seg_sum(lane_fsum) / denom,
        at_risk_frac=seg_sum(lane_risk) / denom,
        events=seg_sum(lane_ev).to(torch.int32),
        drift_nm=seg_reduce(lane_dt, "amax", -torch.inf) * kappa_to_nm_per_c,
        degraded_lanes=seg_sum(lane_deg).to(torch.int32),
    )
    occupied = n_lanes > 0                     # empty slots can't alarm
    alarms = {
        "t_crit": occupied & (stats.temp_peak_c > thresholds["t_crit_c"]),
        "at_risk": occupied & (stats.at_risk_frac
                               > thresholds["at_risk_limit"]),
        "cpo_drift": occupied & (stats.drift_nm
                                 > thresholds["drift_budget_nm"]),
        "degraded": occupied & (stats.degraded_lanes.to(torch.float32)
                                > thresholds["degraded_limit"]),
    }
    return stats, alarms


# ---------------------------------------------------------------- host side
class LogSink:
    """Print one line per alert (and keep them in `.events`)."""

    def __init__(self, stream=None):
        self.stream = stream
        self.events: list[dict] = []

    def emit(self, event: dict) -> None:
        self.events.append(event)
        out = self.stream or sys.stdout
        rel = ">" if event.get("event", "fired") == "fired" else "<="
        tag = ("alert" if event.get("event", "fired") == "fired"
               else "alert cleared")
        print(f"[{tag}] flush={event['flush']} tenant={event['tenant']} "
              f"{event['kind']}: {event['value']:.4g} {rel} "
              f"{event['limit']:.4g}", file=out)


class JsonlSink:
    """Append each alert as one JSON line — the audit-trail sink."""

    def __init__(self, path):
        self.path = path

    def emit(self, event: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(event) + "\n")


class WebhookSink:
    """POST each alert as JSON to `url`; with no URL it only collects
    payloads (`.sent`) — the offline/test stub.

    Delivery is best-effort with BOUNDED retries: a failed POST is retried
    up to ``retries`` more times with exponential backoff (``backoff_s``
    doubling per attempt, capped at ``max_backoff_s``) and a per-attempt
    ``timeout``.  Every failed attempt is recorded in `.errors`; an alert
    exhausting all attempts lands in `.dropped`.  Nothing is ever raised
    into the serving loop, and the worst-case stall per alert is the
    bounded Σ(timeout + backoff) — an unreachable endpoint cannot wedge
    the flush cadence indefinitely.  ``sleep`` is injectable so tests can
    cover the backoff schedule without real waits.
    """

    def __init__(self, url: str | None = None, timeout: float = 2.0, *,
                 retries: int = 3, backoff_s: float = 0.2,
                 max_backoff_s: float = 5.0, sleep=None):
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        self.url = url
        self.timeout = timeout
        self.retries = retries
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self._sleep = sleep if sleep is not None else time.sleep
        self.sent: list[dict] = []
        self.delivered: list[dict] = []
        self.dropped: list[dict] = []
        self.errors: list[str] = []

    def _post(self, event: dict) -> None:
        from urllib.request import Request, urlopen
        req = Request(self.url, data=json.dumps(event).encode(),
                      headers={"Content-Type": "application/json"})
        urlopen(req, timeout=self.timeout).close()

    def emit(self, event: dict) -> None:
        self.sent.append(event)
        if not self.url:
            return
        delay = self.backoff_s
        for attempt in range(self.retries + 1):
            try:
                self._post(event)
                self.delivered.append(event)
                return
            except Exception as e:   # noqa: BLE001 — serving must not die
                self.errors.append(
                    f"attempt {attempt + 1}/{self.retries + 1}: "
                    f"{type(e).__name__}: {e}")
                if attempt < self.retries:
                    self._sleep(min(delay, self.max_backoff_s))
                    delay *= 2.0
        self.dropped.append(event)


class AlertEngine:
    """Edge latch over per-flush alarm levels: each (tenant, kind) emits one
    ``"event": "fired"`` record when its alarm goes False→True and cannot
    fire again until the level clears — a chunked soak whose condition
    persists across many flush windows (including a shorter tail window)
    produces ONE event, not one per flush.  The falling edge emits one
    matching ``"event": "cleared"`` record, so every incident is a
    fired/cleared pair and a resolved alarm is distinguishable from one
    that is still firing."""

    def __init__(self, sinks=()):
        self.sinks = list(sinks)
        self.history: list[dict] = []
        self._latched: dict[tuple[str, str], bool] = {}

    _VALUE_FIELD = {"t_crit": "temp_peak_c", "at_risk": "at_risk_frac",
                    "cpo_drift": "drift_nm", "degraded": "degraded_lanes"}
    _LIMIT_FIELD = {"t_crit": "t_crit_c", "at_risk": "at_risk_limit",
                    "cpo_drift": "drift_budget_nm",
                    "degraded": "degraded_limit"}

    def process(self, *, flush: int, step: int, slot_names, stats,
                alarms, thresholds) -> list[dict]:
        """Evaluate one flush's host-side alarm levels; returns the events
        emitted (rising-edge ``fired`` and falling-edge ``cleared``).
        `stats`/`alarms`/`thresholds` are host values (numpy arrays /
        dicts, as fetched in the flush's single copy)."""
        emitted = []
        for kind in ALARM_KINDS:
            flags = alarms[kind]
            values = stats[self._VALUE_FIELD[kind]]
            limits = thresholds[self._LIMIT_FIELD[kind]]
            for slot, name in enumerate(slot_names):
                if name is None:
                    continue
                level = bool(flags[slot])
                key = (name, kind)
                prev = self._latched.get(key, False)
                if level != prev:
                    emitted.append({
                        "flush": int(flush), "step": int(step),
                        "tenant": name, "kind": kind,
                        "event": "fired" if level else "cleared",
                        "value": float(values[slot]),
                        "limit": float(limits[slot]),
                    })
                self._latched[key] = level
        for ev in emitted:
            self.history.append(ev)
            for sink in self.sinks:
                sink.emit(ev)
        return emitted

    def reset(self) -> None:
        self._latched.clear()
