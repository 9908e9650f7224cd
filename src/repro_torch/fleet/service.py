"""Fleet control plane — a resident multi-tenant serving service.

Port of `repro.fleet.service`.  `FleetService` keeps a `FleetEngine`
resident on the device and serves a DYNAMIC fleet: packages attach and
detach at runtime, every tenant gets its own alert thresholds, and an
operator watches and steers it over a plain HTTP/JSON API.

The reference promises zero XLA recompiles after `warmup`.  The port has no
tracer; its counted and gated analogue is that, after `warmup`, `tick`,
attach / detach within the warmed range, `canary`, `set_mode` and a restore
build no kernel library and load none (`kernels._build.COUNTS`), and each
`tick` makes exactly ONE device→host copy (`host_syncs`).  The same design
carries both:

  * **Capacity pools** (`repro_torch.fleet.registry.FleetRegistry`): state
    is padded to power-of-two capacity buckets, so the engine sees
    O(log max_fleet) shapes, every one of them run by `warmup` (which
    loads every kernel library the flush path launches).
  * **Membership is a mask**: attach / detach flip bits of a [capacity]
    bool mask (`FleetEngine`'s ``active``), uploaded each flush — a value
    change, never a shape change.  Padded lanes still step, but the masked
    telemetry and the per-tenant segment reductions cannot see them.
  * **State surgery** — writing a fresh lane in place (`_attach_op`),
    growing to the next bucket (`_grow_op`, copy to the front of a cached
    fresh template) and compacting into a smaller one (`_shrink_op`, a
    gather by the registry's permutation) — is plain tensor indexing on
    the device: host lane indices, permutations uploaded from pinned
    memory, nothing read back.
  * **Thresholds are operands**: per-tenant t_crit / at-risk / CPO-drift /
    degraded budgets live in dense [max_tenants] arrays
    (`FleetRegistry.threshold_arrays`) read on the device by
    `repro_torch.fleet.alerts.tenant_window_stats`.

Each `tick()` is ONE flush: assemble the next [K, capacity, tiles] density
chunk on the host, upload it (pinned, asynchronous), advance the window
(engine `block_traces`: on the ``fused`` backend one `fleet_step` launch),
reduce the masked window telemetry and the per-tenant stats and alarms on
the device, pack them into one vector and copy it to the host ONCE, append
a replayable record to the `TelemetryLog`, and push alarm edges through
the `AlertEngine` sinks.  `replay()` re-drives a recorded JSONL stream
through the `HintQueue` ingest path — capacity transitions included, via
each flush record's surgery journal — and returns the reproduced
telemetry.

**Synthetic workloads.**  Every attached package runs its own workload
kind: its chunk of flush ``f`` is `core.workload.make_trace` drawn on the
HOST (a CPU `torch.Generator`, so a package's stream is the same on every
device) from the integer seed `trace_seed(seed + key, f)`, where ``key``
is the package's attach counter.  A package's stream therefore depends on
(service seed, package key, flush) only — not on the fleet's membership —
which is what lets `restore` and `replay` regenerate lost windows exactly.
The streams are the port's, not the reference's (``jax.random`` cannot be
reproduced); parity with the reference feeds explicit chunks
(``tick(chunk=...)``) or `/ingest`.

**The flush record's ``rho``** is the chunk as an f32 numpy array in the
in-memory log; `TelemetryLog.dump_jsonl` writes it as a list, which
`replay` (the port's or the reference's) reads back.

Robustness: ``snapshot_dir=...`` + ``snapshot_every=N`` takes
crash-consistent async snapshots (engine state through
`repro_torch.checkpoint.CheckpointManager`, in the reference's on-disk
layout; host bookkeeping — still-queued `/ingest` chunks included — in the
manifest) and journals every membership / threshold / ingest op to
``journal.jsonl``; `FleetService.restore()` resumes a killed service
≤1e-5-equivalent to an uninterrupted run, and restores a snapshot the
reference's service wrote.  A snapshot flush copies the state to the host
as well (before its writer thread starts).  ``heartbeat_timeout_s`` arms a
stalled-flush watchdog surfaced at GET /healthz.

**On a device mesh** (``backend="sharded"`` / ``"sharded_fused"``, with
``devices`` / ``device_pool`` as `FleetEngine` takes them) the state is
partitioned over the mesh: an attach or a node row writes the owning
partition in place (`distributed.sharding.lane_at`); grow and shrink —
rare, O(capacity) anyway — run on the gathered state and re-place it on
the mesh the backend resolves for the new capacity, the new lanes and the
ctrl-mode plane partitioned like the state; a flush gathers the window's
traces onto the engine's device for the reductions (still one copy to
the host); a snapshot writes the gathered state and a restore re-places
it.

Threads: HTTP handler threads, the heartbeat watchdog and the snapshot
writer touch the service's tensors only under its re-entrant lock (the
writer only ever sees host copies).

The HTTP surface (stdlib `http.server`) is the reference's:

    GET  /healthz /telemetry /fleet /alerts /dashboard
    POST /attach /detach /thresholds /ingest /replay /shutdown
    POST /canary /mode           (per-lane controller-mode rollout)
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from repro_torch.core.fingerprint import FINGERPRINT, Fingerprint
from repro_torch.core.scheduler import SchedulerConfig, SchedulerState
from repro_torch.core.telemetry import TelemetryLog
from repro_torch.core.workload import KINDS, make_trace
from repro_torch.distributed import sharding
from repro_torch.fleet.alerts import (ALARM_KINDS, AlertEngine,
                                      TenantWindowStats, tenant_window_stats)
from repro_torch.fleet.engine import FleetEngine, FleetTelemetry
from repro_torch.fleet.ingest import HintQueue, merge_sources
from repro_torch.fleet.registry import FleetRegistry, LaneProfile, next_pow2

__all__ = ["FleetService", "serve_http", "trace_seed"]

_INT_TELEMETRY = ("n_packages", "degraded_count")
_INT_STATS = ("n_lanes", "events", "degraded_lanes")


def trace_seed(base: int, flush: int) -> int:
    """The integer seed of one package's synthetic chunk in one flush: the
    first 7 bytes of blake2b("<base>:<flush>") as a little-endian integer
    (``base`` = service seed + package key).  Distinct (base, flush) pairs
    give unrelated streams, and the seed fits `make_trace`'s generator."""
    digest = hashlib.blake2b(f"{int(base)}:{int(flush)}".encode(),
                             digest_size=7).digest()
    return int.from_bytes(digest, "little")


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of a state NamedTuple (None stays)."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x, *(r[i] for r in rest))
                            for i, x in enumerate(tree)))
    return fn(tree, *rest)


def _per_lane(a, cap: int) -> bool:
    """A leaf with the capacity axis first (whole or partitioned over a
    mesh).  The broadcast layouts' shared clocks are 0-dim host tensors and
    are never touched by surgery (an attached lane joins the running
    fleet's clock); vmap's per-lane clocks are [capacity] and are (the lane
    restarts its own)."""
    return ((torch.is_tensor(a) or isinstance(a, sharding.Sharded))
            and a.ndim >= 1 and a.shape[0] == cap)


class FleetService:
    """Resident control plane over one `FleetEngine`.

    All public methods are thread-safe (one re-entrant lock serialises
    membership surgery, threshold edits and flushes against the HTTP
    handler threads).  The engine state is owned by the service.  The
    engine runs on ``device`` (CUDA unless the caller asks for the CPU).
    """

    def __init__(self, cfg: SchedulerConfig | None = None,
                 fp: Fingerprint = FINGERPRINT,
                 backend: str = "broadcast", *,
                 min_capacity: int = 4, max_tenants: int = 8,
                 flush_every: int = 50, pad_rho: float = 1.0,
                 sinks=(), log_capacity: int = 4096, seed: int = 0,
                 feed_capacity: int = 4,
                 snapshot_dir: str | None = None, snapshot_every: int = 0,
                 heartbeat_timeout_s: float = 0.0, debug_nan: bool = False,
                 device=None, devices: int | None = None, device_pool=None):
        self.engine = FleetEngine(cfg, fp, backend=backend, device=device,
                                  debug_nan=debug_nan, devices=devices,
                                  device_pool=device_pool)
        if self.engine._spans_processes():
            # lane surgery and the per-tenant reductions read every lane
            raise ValueError(
                "FleetService runs on one process's devices; a mesh "
                "spanning processes streams through "
                "fleet.distributed_stream")
        self.cfg, self.fp = self.engine.cfg, fp
        self.device = self.engine.device
        self.backend_name = backend
        self.registry = FleetRegistry(min_capacity=min_capacity,
                                      max_tenants=max_tenants)
        self.alerts = AlertEngine(sinks=sinks)
        self.log = TelemetryLog(capacity=log_capacity)
        self.flush_every = int(flush_every)
        self.pad_rho = float(pad_rho)
        self.feed_capacity = int(feed_capacity)
        self._feeds: dict[str, HintQueue] = {}  # tenant -> queued chunks
        self.lock = threading.RLock()
        self.flushes = 0
        self.steps = 0            # host mirror of the fleet clock
        # device→host copies made by tick(): one a flush is the contract
        self.host_syncs = 0
        # host milliseconds of the last tick by stage (chunk assembly, the
        # surgery since the previous tick, the flush's launches, the single
        # copy — which waits for the device — and alerts plus record)
        self.last_tick_ms: dict[str, float] = {}
        self._surgery_ms = 0.0
        self._seed = seed
        self._kind_of: dict[str, str] = {}      # package -> workload kind
        self._pkg_key: dict[str, int] = {}      # package -> key counter base
        self._next_key = 0
        self._attached_since_flush: list[int] = []
        self._surgery_since_flush: list[dict] = []   # ordered per-flush ops
        self._templates: dict[int, SchedulerState] = {}
        self._node_rows: dict[str, object] = {}
        self._shutdown = threading.Event()
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = int(snapshot_every)
        self._ckpt = None
        self._journal_seq = 0
        self._restoring = False    # suppresses journaling during replay
        self._warmed_max = 0
        self.last_degraded = 0     # degraded-lane count of the last flush
        if snapshot_dir is not None:
            from repro_torch.checkpoint.manager import CheckpointManager
            self._ckpt = CheckpointManager(snapshot_dir)
            self._journal_path = os.path.join(snapshot_dir, "journal.jsonl")
        self.heartbeat = None
        if heartbeat_timeout_s > 0:
            from repro_torch.distributed.fault_tolerance import Heartbeat
            self.heartbeat = Heartbeat(timeout_s=heartbeat_timeout_s)
        self.state = self.engine.init(self.registry.capacity)

    # ------------------------------------------------------------ templates
    def _template(self, capacity: int) -> SchedulerState:
        """Cached fresh state per capacity — the scatter source for
        attaches and the target skeleton for grows."""
        tpl = self._templates.get(capacity)
        if tpl is None:
            tpl = self._templates[capacity] = self.engine.init(capacity)
        return tpl

    def _put(self, arr) -> torch.Tensor:
        """A host array on the device: staged in pinned memory and copied
        asynchronously on the current stream on a card (no host sync)."""
        host = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host

    # -------------------------------------------------------- state surgery
    @staticmethod
    def _attach_op(state, template, lane: int):
        """The template's lane written into ``state`` IN PLACE (one small
        copy a leaf, not a copy of the state: attaching n packages costs
        O(n), not O(n²)) — on a mesh into the partition that owns the
        lane.  The service owns its state; the snapshot writer only ever
        holds host copies."""
        cap = state.freq.shape[0]

        def scatter(a, b):
            if _per_lane(a, cap):
                (pa, i), (pb, j) = (sharding.lane_at(a, lane),
                                    sharding.lane_at(b, lane))
                pa[i] = pb[j].to(pa.device)
            return a
        return _tree_map(scatter, state, template)

    def _whole(self, op, state, *rest):
        """``op`` on a whole state: a partitioned one is gathered first and
        the result re-placed on the mesh the backend resolves for its
        capacity."""
        if not sharding.is_sharded(state):
            return op(state, *rest)
        eng = self.engine
        return eng.backend_impl.place(
            op(eng.gather(state), *map(eng.gather, rest)))

    def _grow_op(self, state, template):
        return self._whole(self._grow_whole, state, template)

    def _shrink_op(self, state, perm: torch.Tensor):
        return self._whole(self._shrink_whole, state, perm)

    @staticmethod
    def _grow_whole(state, template):
        old = state.freq.shape[0]

        def grow(a, b):
            if torch.is_tensor(a) and a.ndim >= 1 and b.shape[0] != old:
                b = b.clone()
                b[:old] = a
                return b
            return a
        return _tree_map(grow, state, template)

    @staticmethod
    def _node_op(state, row, lane: int):
        """Scatter one node bank's `PackageParams` row (batch 1) into the
        heterogeneous per-lane draws at ``lane`` (its partition's, on a
        mesh)."""
        def put(a, b):
            pa, i = sharding.lane_at(a, lane)
            pa[i] = b[0].to(pa.device)
            return a
        return state._replace(pkg=_tree_map(put, state.pkg, row))

    @staticmethod
    def _shrink_whole(state, perm: torch.Tensor):
        old = state.freq.shape[0]
        return _tree_map(lambda a: a.index_select(0, perm)
                         if _per_lane(a, old) else a, state)

    def _perm(self, perm) -> torch.Tensor:
        return self._put(np.asarray(perm, np.int64))

    def _apply_plan(self, plan) -> None:
        if plan.kind == "grow":
            self.state = self._grow_op(self.state,
                                       self._template(plan.new_capacity))
            self._surgery_since_flush.append(
                {"op": "grow", "old": plan.old_capacity,
                 "new": plan.new_capacity})
        elif plan.kind == "shrink":
            self.state = self._shrink_op(self.state, self._perm(plan.perm))
            self._surgery_since_flush.append(
                {"op": "shrink", "old": plan.old_capacity,
                 "new": plan.new_capacity,
                 "perm": [int(p) for p in plan.perm]})

    # ----------------------------------------------------------- journaling
    def _journal(self, entry: dict) -> None:
        """Append one membership / threshold / ingest op to the journal,
        with a monotonic ``seq`` and the flush count it happened AFTER, so
        `restore()` re-drives exactly the post-snapshot suffix."""
        if self._ckpt is None or self._restoring:
            return
        entry = {"seq": self._journal_seq, "flush": self.flushes, **entry}
        self._journal_seq += 1
        with open(self._journal_path, "a") as f:
            f.write(json.dumps(entry) + "\n")
            f.flush()
            os.fsync(f.fileno())

    # ---------------------------------------------------- per-lane profiles
    def _node_row(self, node: str):
        """Cached single-lane `PackageParams` row for ``node``."""
        row = self._node_rows.get(node)
        if row is None:
            from repro_torch.core.nodebank import fleet_package_params
            row = self._node_rows[node] = fleet_package_params(
                self.engine.sched, [node])
        return row

    def _profile_for(self, node: str, mode: str,
                     plant: str | None) -> LaneProfile:
        """Validate one attach's profile against the service config: node
        names must exist, non-base nodes need a heterogeneous fleet,
        reactive pins need `mixed_mode`, and the resident engine serves
        exactly ONE plant group (a fidelity mix runs through
        `repro_torch.fleet.groups.GroupedFleetEngine`)."""
        from repro_torch.core.nodebank import available_nodes, get_node
        get_node(node)                       # raises on unknown names
        if node != "base" and not self.cfg.heterogeneous:
            raise ValueError(
                f"node {node!r} needs SchedulerConfig(heterogeneous=True) "
                f"— a homogeneous fleet carries no per-lane parameter rows "
                f"(available nodes: {', '.join(available_nodes())})")
        if mode == "reactive_poll" and not self.cfg.mixed_mode:
            raise ValueError(
                "pinning mode='reactive_poll' needs "
                "SchedulerConfig(mixed_mode=True) — the fleet carries no "
                "ctrl_mode plane otherwise")
        plant = self.cfg.plant if plant is None else plant
        if plant != self.cfg.plant:
            raise ValueError(
                f"this service steps plant group {self.cfg.plant!r}; "
                f"got plant={plant!r} — run a fidelity mix through "
                f"repro_torch.fleet.groups.GroupedFleetEngine")
        return LaneProfile(node=node, mode=mode, plant=plant)

    def _refresh_ctrl(self) -> None:
        """Re-derive the ctrl_mode plane from the registry's profiles: a
        value upload into one state leaf."""
        if self.state.ctrl_mode is not None:
            mask = self._put(self.registry.ctrl_mode_mask())
            mesh = sharding.mesh_of(self.state)     # partitioned like it
            self.state = self.state._replace(
                ctrl_mode=mask if mesh is None
                else sharding.place(mask, mesh, 0))

    def canary(self, reactive_frac: float) -> dict:
        """Canary rollout: pin the first ``round(frac·n_active)`` packages
        (sorted-id order — monotone and idempotent, see
        `FleetRegistry.canary`) to reactive_poll, the rest back to v24,
        live."""
        with self.lock:
            if not self.cfg.mixed_mode:
                raise ValueError(
                    "canary rollout needs SchedulerConfig(mixed_mode=True)")
            out = self.registry.canary(float(reactive_frac))
            self._refresh_ctrl()
            self._journal({"op": "canary", "frac": float(reactive_frac)})
            return out

    def set_mode(self, package: str, mode: str) -> dict:
        """Pin ONE package's controller mode (v24 ↔ reactive_poll)."""
        with self.lock:
            if mode == "reactive_poll" and not self.cfg.mixed_mode:
                raise ValueError(
                    "pinning mode='reactive_poll' needs "
                    "SchedulerConfig(mixed_mode=True)")
            pr = self.registry.set_mode(package, mode)
            self._refresh_ctrl()
            self._journal({"op": "mode", "package": package, "mode": mode})
            return {"package": package, "node": pr.node, "mode": pr.mode,
                    "plant": pr.plant}

    # ------------------------------------------------------------ membership
    def attach(self, package: str, tenant: str = "default",
               kind: str = "inference", *, node: str = "base",
               mode: str = "v24", plant: str | None = None) -> dict:
        """Attach a package: bucket surgery if occupancy crosses a boundary,
        then scatter a fresh lane state in.  ``node`` / ``mode`` / ``plant``
        pin the lane's `LaneProfile`."""
        if kind not in KINDS:
            raise ValueError(f"unknown workload kind {kind!r}; "
                             f"want one of {KINDS}")
        profile = self._profile_for(node, mode, plant)
        with self.lock:
            t0 = time.perf_counter()
            lane, plan = self.registry.attach(package, tenant,
                                              profile=profile)
            self._apply_plan(plan)
            self.state = self._attach_op(
                self.state, self._template(self.registry.capacity), lane)
            if node != "base":
                self.state = self._node_op(self.state, self._node_row(node),
                                           lane)
            self._refresh_ctrl()
            self._kind_of[package] = kind
            self._pkg_key[package] = self._next_key
            self._next_key += 1
            self._attached_since_flush.append(lane)
            self._surgery_since_flush.append({"op": "attach", "lane": lane})
            self._journal({"op": "attach", "package": package,
                           "tenant": tenant, "workload": kind,
                           "profile": {"node": node, "mode": mode,
                                       "plant": profile.plant}})
            self._surgery_ms += (time.perf_counter() - t0) * 1e3
            return {"package": package, "tenant": tenant, "kind": kind,
                    "lane": lane, "capacity": self.registry.capacity,
                    "plan": plan.kind, "node": profile.node,
                    "mode": profile.mode, "plant": profile.plant}

    def detach(self, package: str) -> dict:
        with self.lock:
            t0 = time.perf_counter()
            lane, plan = self.registry.detach(package)
            self._apply_plan(plan)
            self._kind_of.pop(package, None)
            self._pkg_key.pop(package, None)
            if plan.kind == "shrink":
                remap = {old: new for new, old in enumerate(plan.perm)}
                self._attached_since_flush = [
                    remap[l] for l in self._attached_since_flush
                    if l in remap]
            else:
                self._attached_since_flush = [
                    l for l in self._attached_since_flush if l != lane]
            self._refresh_ctrl()    # departed pin + any capacity change
            self._journal({"op": "detach", "package": package})
            self._surgery_ms += (time.perf_counter() - t0) * 1e3
            return {"package": package, "lane": lane,
                    "capacity": self.registry.capacity, "plan": plan.kind}

    def set_thresholds(self, tenant: str, **kw) -> dict:
        with self.lock:
            t = self.registry.set_thresholds(tenant, **kw)
            self._journal({"op": "thresholds", "tenant": tenant,
                           "kw": {k: float(v) for k, v in kw.items()
                                  if v is not None}})
            return {"tenant": t.name, "t_crit_c": t.t_crit_c,
                    "at_risk_limit": t.at_risk_limit,
                    "drift_budget_nm": t.drift_budget_nm,
                    "degraded_limit": t.degraded_limit}

    # ---------------------------------------------------------------- ingest
    def ingest(self, tenant: str, chunk) -> dict:
        """Queue one POSTed density chunk for ``tenant``'s packages.

        ``chunk`` is [flush_every, n_tiles] (or [flush_every], broadcast
        over tiles): the density every package of the tenant runs for one
        upcoming flush window.  Chunks queue in a per-tenant bounded
        `HintQueue` (``feed_capacity``) and are consumed one per `tick()`,
        routed through `merge_sources` onto the tenant's lanes; lanes with
        no queued feed keep their synthetic workloads.  A full queue
        REFUSES the chunk (``accepted: false`` / HTTP 429)."""
        with self.lock:
            if tenant not in self.registry.tenants:
                raise ValueError(f"unknown tenant {tenant!r}; attach a "
                                 f"package for it first")
            arr = np.asarray(chunk, np.float32)
            if arr.ndim == 1:
                arr = np.repeat(arr[:, None], self.cfg.n_tiles, axis=1)
            if arr.shape != (self.flush_every, self.cfg.n_tiles):
                raise ValueError(
                    f"chunk must be [{self.flush_every}, "
                    f"{self.cfg.n_tiles}] (one flush window), got "
                    f"{tuple(arr.shape)}")
            if not np.all(np.isfinite(arr)) or arr.min() < 0:
                raise ValueError("chunk must be finite and non-negative")
            q = self._feeds.get(tenant)
            if q is None:
                q = self._feeds[tenant] = HintQueue(self.feed_capacity)
            accepted = q.offer(arr)
            if accepted:
                # tenant-POSTed density is real data: journal the accepted
                # chunk so a crash between accept and flush cannot swap it
                # for a synthetic workload
                self._journal({"op": "ingest", "tenant": tenant,
                               "chunk": arr.tolist()})
            return {"tenant": tenant, "accepted": bool(accepted),
                    "queued": len(q),
                    "lookahead_ms": q.lookahead_ms(self.flush_every,
                                                   self.cfg.step_ms)}

    # ----------------------------------------------------------------- flush
    def _flush(self, state, chunk, active, tenant_ids, thresholds):
        """Advance the window and reduce, on the device: the masked window
        telemetry, the per-tenant stats and the alarm levels, packed into
        ONE f64 vector (telemetry fields, stats [8, M], alarms [4, M]) so
        that a single copy carries them to the host.  On a mesh the traces
        and the per-lane leaves read here are gathered onto the engine's
        device first."""
        lanes0 = self.engine.lanes(state)
        ev0 = torch.where(active, lanes0.events, 0).sum(dtype=torch.int32)
        state, temps, freqs = self.engine.block_traces(state, chunk)
        lanes = self.engine.lanes(state)
        telem = self.engine.window_telemetry(
            chunk, temps, freqs, ev0, lanes0, active).reduce()
        stats, alarms = tenant_window_stats(
            temps, freqs, lanes0.events, lanes.events, active, tenant_ids,
            self.registry.max_tenants, self.cfg.straggler_threshold,
            self.fp.kappa_to_nm_per_c, thresholds, degraded=lanes.degraded)
        f64 = torch.float64
        packed = torch.cat([
            torch.stack([v.reshape(()).to(f64) for v in telem]),
            torch.stack([v.to(f64) for v in stats]).reshape(-1),
            torch.stack([alarms[k].to(f64) for k in ALARM_KINDS]
                        ).reshape(-1)])
        return state, packed

    def _fetch(self, packed: torch.Tensor) -> np.ndarray:
        """The flush's single device→host copy (counted)."""
        self.host_syncs += 1
        return packed.cpu().numpy()

    def _unpack(self, host: np.ndarray):
        m = self.registry.max_tenants
        nt, ns = len(FleetTelemetry._fields), len(TenantWindowStats._fields)
        tdict = {k: (int(v) if k in _INT_TELEMETRY else float(v))
                 for k, v in zip(FleetTelemetry._fields, host[:nt])}
        rows = host[nt:nt + ns * m].reshape(ns, m)
        stats = {}
        for k, row in zip(TenantWindowStats._fields, rows):
            stats[k] = (row.astype(np.int32) if k in _INT_STATS
                        else row.astype(np.float32))
        al = host[nt + ns * m:].reshape(len(ALARM_KINDS), m) > 0.5
        return tdict, stats, dict(zip(ALARM_KINDS, al))

    def _chunk(self, n_steps: int) -> tuple[np.ndarray, list[str]]:
        """Assemble the next [n_steps, capacity, tiles] density chunk on the
        host: each attached package runs its synthetic workload (see the
        module docstring), EXCEPT lanes of a tenant with a queued `ingest`
        feed — those take the head chunk of the tenant's HintQueue,
        assembled onto their lanes by `merge_sources`.  Free lanes idle at
        ``pad_rho``.  Returns the chunk and the tenants fed this flush."""
        cap, tiles = self.registry.capacity, self.cfg.n_tiles
        chunk = np.full((n_steps, cap, tiles), self.pad_rho, np.float32)
        fed: dict[str, np.ndarray] = {}
        for tenant, q in self._feeds.items():
            if len(q) and tenant in self.registry.tenants:
                fed[tenant] = q.take()
        fed_lanes: dict[int, object] = {}
        tenants = self.registry.tenants
        for tname, rho in fed.items():
            for pkg in tenants[tname].packages:
                fed_lanes[self.registry.lane(pkg)] = iter([rho])
        merged = (next(merge_sources(fed_lanes, cap, tiles,
                                     pad_rho=self.pad_rho))
                  if fed_lanes else None)
        for pkg, lane in self.registry.packages.items():
            if merged is not None and lane in fed_lanes:
                chunk[:, lane, :] = merged[:, lane, :]
                continue
            seed = trace_seed(self._seed + self._pkg_key[pkg], self.flushes)
            chunk[:, lane, :] = make_trace(seed, n_steps, self._kind_of[pkg],
                                           tiles, device="cpu").numpy()
        return chunk, sorted(fed)

    def tick(self, chunk=None) -> dict | None:
        """One flush: step the fleet `flush_every` steps (or an explicit
        [K, capacity, tiles] chunk), copy the results to the host ONCE,
        record, and run alerts.  Returns the flush record (None when the
        fleet is empty)."""
        with self.lock:
            if self.registry.n_active == 0 and chunk is None:
                return None
            t0 = time.perf_counter()
            fed: list[str] = []
            if chunk is None:
                chunk, fed = self._chunk(self.flush_every)
            chunk = np.asarray(chunk, np.float32)
            cap = self.registry.capacity
            if chunk.ndim != 3 or chunk.shape[1:] != (cap, self.cfg.n_tiles):
                raise ValueError(
                    f"chunk must be [K, {cap}, {self.cfg.n_tiles}], "
                    f"got {chunk.shape}")
            t1 = time.perf_counter()
            step0 = self.steps
            active_np = self.registry.active_mask()
            th_np = self.registry.threshold_arrays()
            self.state, packed = self._flush(
                self.state, self._put(chunk), self._put(active_np),
                self._put(self.registry.tenant_lane_ids()),
                {k: self._put(v) for k, v in th_np.items()})
            t2 = time.perf_counter()
            tdict, sdict, alarms = self._unpack(self._fetch(packed))
            t3 = time.perf_counter()
            names = self.registry.slot_names()
            fired = self.alerts.process(
                flush=self.flushes, step=step0, slot_names=names,
                stats=sdict, alarms=alarms, thresholds=th_np)
            record = {
                "kind": "flush", "flush": self.flushes,
                "capacity": cap,
                "active": active_np.astype(int).tolist(),
                "attached": [int(l) for l in self._attached_since_flush],
                "surgery": list(self._surgery_since_flush),
                "telemetry": tdict,
                "tenants": {
                    names[s]: {k: (int(v[s]) if k in _INT_STATS
                                   else float(v[s]))
                               for k, v in sdict.items()}
                    for s in range(self.registry.max_tenants)
                    if names[s] is not None and sdict["n_lanes"][s] > 0},
                "alerts": fired,
                "ingest_fed": fed,
                "rho": chunk,
            }
            self.log.record(step0, **record)
            self._attached_since_flush = []
            self._surgery_since_flush = []
            self.flushes += 1
            self.steps += chunk.shape[0]
            self.last_degraded = tdict.get("degraded_count", 0)
            if self.heartbeat is not None:
                self.heartbeat.beat()
            t4 = time.perf_counter()
            self.last_tick_ms = {
                "chunk_ms": (t1 - t0) * 1e3,
                "surgery_ms": self._surgery_ms,
                "flush_ms": (t2 - t1) * 1e3,
                "sync_ms": (t3 - t2) * 1e3,
                "alerts_record_ms": (t4 - t3) * 1e3}
            self._surgery_ms = 0.0
            if (self._ckpt is not None and self.snapshot_every
                    and not self._restoring
                    and self.flushes % self.snapshot_every == 0):
                self.save_snapshot(blocking=False)
            return record

    # ---------------------------------------------------------------- warmup
    def warmup(self, max_packages: int) -> int:
        """Run every operation steady-state serving can need up to
        ``max_packages`` occupancy once: per capacity bucket a flush (on a
        card this builds and loads every kernel library the flush path
        launches), the attach scatter, the node-row scatter, grow and
        shrink surgery and the templates.  After this, attach / detach / tick cycles within the warmed range
        build and load no kernel library (gated in
        tests/test_torch_service.py and `chip_smoke.py` Phase J).  Returns
        the number of buckets."""
        with self.lock:
            self._warmed_max = max(self._warmed_max, int(max_packages))
            caps = []
            c = self.registry.min_capacity
            top = max(self.registry.min_capacity, next_pow2(max_packages))
            while c <= top:
                caps.append(c)
                c *= 2
            tiles = self.cfg.n_tiles
            m = self.registry.max_tenants
            th = {k: self._put(np.full(m, np.inf, np.float32))
                  for k in self.registry.threshold_arrays()}
            for cap in caps:
                tpl = self._template(cap)
                st = self._attach_op(self.engine.init(cap), tpl, 0)
                if self.cfg.heterogeneous:
                    st = self._node_op(st, self._node_row("base"), 0)
                chunk = torch.full((self.flush_every, cap, tiles),
                                   self.pad_rho, device=self.device)
                self._flush(st, chunk, self._put(np.ones(cap, bool)),
                            self._put(np.zeros(cap, np.int32)), th)
            for small, big in zip(caps, caps[1:]):
                st = self._grow_op(self.engine.init(small), self._template(big))
                self._shrink_op(st, self._perm(np.arange(small)))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return len(caps)

    # ------------------------------------------------------------- snapshots
    def save_snapshot(self, blocking: bool = False) -> int:
        """Snapshot the WHOLE service: the engine state through
        `CheckpointManager` (copied to the host here, written on its thread
        unless ``blocking``) with every piece of host bookkeeping in the
        manifest's ``extra`` dict.  Returns the snapshot's step id."""
        if self._ckpt is None:
            raise ValueError("snapshots need FleetService(snapshot_dir=...)")
        with self.lock:
            r = self.registry
            meta = {
                "cfg": dataclasses.asdict(self.cfg),
                "backend": self.backend_name,
                "service": {"min_capacity": r.min_capacity,
                            "max_tenants": r.max_tenants,
                            "flush_every": self.flush_every,
                            "pad_rho": self.pad_rho,
                            "seed": self._seed,
                            "feed_capacity": self.feed_capacity,
                            "snapshot_every": self.snapshot_every},
                "registry": {
                    "capacity": r.capacity,
                    "lane_of": dict(r._lane_of),
                    "tenant_of": dict(r._tenant_of),
                    "profiles": {p: [pr.node, pr.mode, pr.plant]
                                 for p, pr in r._profile_of.items()},
                    "free": list(r._free),     # pop ORDER matters
                    "tenants": {t.name: {
                        "slot": t.slot, "t_crit_c": t.t_crit_c,
                        "at_risk_limit": t.at_risk_limit,
                        "drift_budget_nm": t.drift_budget_nm,
                        "degraded_limit": t.degraded_limit,
                        "packages": sorted(t.packages)}
                        for t in r._tenants.values()},
                },
                "kind_of": dict(self._kind_of),
                # queued-but-unflushed /ingest chunks ride the manifest
                # (journal entries before the snapshot are not replayed)
                "feeds": {t: [c.tolist() for c in q._q]
                          for t, q in self._feeds.items() if len(q)},
                "pkg_key": dict(self._pkg_key),
                "next_key": self._next_key,
                "flushes": self.flushes, "steps": self.steps,
                "journal_seq": self._journal_seq,
                "latched": [[name, kind] for (name, kind), v
                            in self.alerts._latched.items() if v],
                "warmed_max": self._warmed_max,
            }
            self._ckpt.save(self.steps, self.engine.gather(self.state),
                            blocking=blocking, extra=meta)
            return self.steps

    def wait_snapshots(self) -> None:
        """Block until an in-flight async snapshot is on disk (raises if
        its write failed)."""
        if self._ckpt is not None:
            self._ckpt.wait()

    @classmethod
    def restore(cls, snapshot_dir: str, *, sinks=(),
                debug_nan: bool = False, heartbeat_timeout_s: float = 0.0,
                fp: Fingerprint = FINGERPRINT, device=None,
                device_pool=None) -> "FleetService":
        """Resume a killed service from its newest snapshot + journal.

        Rebuilds the service from the manifest (config, backend, registry
        membership, counters, alert latches), restores the engine state —
        from the port's snapshots or the reference's, which share the
        layout — re-runs `warmup` to the snapshot's horizon, then re-drives
        every journaled op recorded AFTER the snapshot, interleaved with
        re-synthesised flushes at the journal's flush cursors (the
        per-package seeds make them identical to the lost originals).
        ``device`` / ``device_pool`` place the restored service as the
        constructor does (a mesh backend's state is written whole and
        re-placed on the mesh resolved here)."""
        from repro_torch.checkpoint.manager import CheckpointManager
        from repro_torch.fleet.registry import Tenant
        ckpt = CheckpointManager(snapshot_dir)
        steps = ckpt.steps()
        if not steps:
            raise FileNotFoundError(
                f"no complete snapshot under {snapshot_dir!r}")
        step = steps[-1]
        meta = ckpt.manifest(step).get("extra")
        if meta is None:
            raise ValueError(
                f"snapshot step {step} carries no service metadata "
                f"(was it written by FleetService.save_snapshot?)")
        svc = cls(SchedulerConfig(**meta["cfg"]), fp,
                  backend=meta["backend"], sinks=sinks,
                  snapshot_dir=snapshot_dir, debug_nan=debug_nan,
                  heartbeat_timeout_s=heartbeat_timeout_s, device=device,
                  device_pool=device_pool, **meta["service"])
        r, reg = svc.registry, meta["registry"]
        r.capacity = int(reg["capacity"])
        r._lane_of = {p: int(l) for p, l in reg["lane_of"].items()}
        r._tenant_of = dict(reg["tenant_of"])
        r._profile_of = {
            p: (LaneProfile(*reg["profiles"][p])
                if p in reg.get("profiles", {})
                else LaneProfile(plant=svc.cfg.plant))
            for p in r._lane_of}
        r._free = [int(l) for l in reg["free"]]
        r._tenants = {
            name: Tenant(name=name, slot=int(t["slot"]),
                         t_crit_c=float(t["t_crit_c"]),
                         at_risk_limit=float(t["at_risk_limit"]),
                         drift_budget_nm=float(t["drift_budget_nm"]),
                         degraded_limit=float(t.get("degraded_limit",
                                                    float("inf"))),
                         packages=set(t["packages"]))
            for name, t in reg["tenants"].items()}
        svc._kind_of = dict(meta["kind_of"])
        for tenant, chunks in meta.get("feeds", {}).items():
            q = svc._feeds[tenant] = HintQueue(svc.feed_capacity)
            for c in chunks:
                q.offer(np.asarray(c, np.float32))
        svc._pkg_key = {p: int(k) for p, k in meta["pkg_key"].items()}
        svc._next_key = int(meta["next_key"])
        svc.flushes = int(meta["flushes"])
        svc.steps = int(meta["steps"])
        svc._journal_seq = int(meta["journal_seq"])
        svc._warmed_max = int(meta.get("warmed_max", 0))
        for name, kind in meta.get("latched", []):
            svc.alerts._latched[(name, kind)] = True
        eng = svc.engine
        svc.state = eng.backend_impl.place(ckpt.restore(
            step, template=eng.gather(eng.init(r.capacity))))
        svc._refresh_ctrl()        # ctrl plane re-derived from profiles
        if svc._warmed_max:        # every warmed shape back before stepping
            svc.warmup(svc._warmed_max)
        svc._replay_journal()
        return svc

    def _replay_journal(self) -> None:
        """Apply journal entries with ``seq >= journal_seq``: tick to each
        entry's flush cursor, then re-apply the op.  Journaling and
        snapshots are suppressed meanwhile (the entries are on disk)."""
        path = getattr(self, "_journal_path", None)
        if path is None or not os.path.exists(path):
            return
        entries = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    e = json.loads(line)
                    if e["seq"] >= self._journal_seq:
                        entries.append(e)
        if not entries:
            return
        self._restoring = True
        try:
            for e in sorted(entries, key=lambda x: x["seq"]):
                while self.flushes < e["flush"]:
                    self.tick()
                if e["op"] == "attach":
                    self.attach(e["package"], e["tenant"], e["workload"],
                                **e.get("profile", {}))
                elif e["op"] == "detach":
                    self.detach(e["package"])
                elif e["op"] == "thresholds":
                    self.set_thresholds(e["tenant"], **e["kw"])
                elif e["op"] == "canary":
                    self.canary(e["frac"])
                elif e["op"] == "mode":
                    self.set_mode(e["package"], e["mode"])
                elif e["op"] == "ingest":
                    self.ingest(e["tenant"], e["chunk"])
                else:
                    raise ValueError(f"unknown journal op {e['op']!r}")
                self._journal_seq = e["seq"] + 1
        finally:
            self._restoring = False

    # ---------------------------------------------------------------- replay
    def replay(self, path: str) -> list[dict]:
        """Re-drive a recorded telemetry stream (`TelemetryLog.dump_jsonl`
        of flush records, the port's or the reference's) through the
        HintQueue ingest path against a fresh fleet, and return the
        reproduced flush records.  Each record's ordered surgery ops
        (attach scatters, grow / shrink transitions) are re-applied before
        its window, so recordings that cross bucket boundaries reproduce.
        Legacy recordings without a ``surgery`` key replay their
        ``attached`` lane lists and must keep ONE capacity throughout."""
        rows = []
        with open(path) as f:
            for line in f:
                row = json.loads(line)
                if row.get("kind") == "flush":
                    rows.append(row)
        if not rows:
            raise ValueError(f"no flush records in {path}")
        legacy = any("surgery" not in r for r in rows)
        if legacy:
            caps = {int(r["capacity"]) for r in rows}
            if len(caps) != 1:
                raise ValueError(
                    f"replaying a legacy (no surgery journal) recording "
                    f"needs a fixed capacity, got capacities "
                    f"{sorted(caps)}; re-record with the current service")
            cap0 = caps.pop()
        else:
            # boot capacity: what the state held BEFORE the first recorded
            # capacity transition (the first row's when none occur)
            cap0 = int(rows[0]["capacity"])
            for row in rows:
                trans = [o for o in row["surgery"]
                         if o["op"] in ("grow", "shrink")]
                if trans:
                    cap0 = int(trans[0]["old"])
                    break
        eng = self.engine
        state = self.engine.init(cap0)
        queue = HintQueue(capacity=2)
        out = []
        for row in rows:
            if "surgery" in row:
                for op in row["surgery"]:
                    if op["op"] == "grow":
                        state = self._grow_op(
                            state, self._template(int(op["new"])))
                    elif op["op"] == "shrink":
                        state = self._shrink_op(state, self._perm(op["perm"]))
                    else:      # attach scatter at the CURRENT capacity
                        state = self._attach_op(
                            state, self._template(state.freq.shape[0]),
                            int(op["lane"]))
            else:
                tpl = self._template(cap0)
                for lane in row["attached"]:
                    state = self._attach_op(state, tpl, int(lane))
            active = np.asarray(row["active"], bool)
            queue.offer(np.asarray(row["rho"], np.float32))
            chunk = queue.take()
            state, telem = eng.run_block(state, chunk, active=active)
            out.append({"flush": row["flush"],
                        "telemetry": telem.as_dict()})
        return out

    # ----------------------------------------------------------------- intro
    def snapshot(self, last: int = 1) -> dict:
        with self.lock:
            recs = self.log.rows()[-last:]
            return {"flushes": self.flushes,
                    "capacity": self.registry.capacity,
                    "n_active": self.registry.n_active,
                    "records": [{k: v for k, v in r.items() if k != "rho"}
                                for r in recs]}

    def shutdown(self) -> None:
        self._shutdown.set()

    @property
    def shutting_down(self) -> bool:
        return self._shutdown.is_set()


# --------------------------------------------------------------- dashboard
_BLOCKS = " ▁▂▃▄▅▆▇█"


def _spark(values, width: int = 60, lo=None, hi=None) -> str:
    """Unicode block sparkline of a numeric series."""
    values = [float(v) for v in values]
    if not values:
        return ""
    n = min(width, len(values))
    pick = [values[round(i * (len(values) - 1) / max(n - 1, 1))]
            for i in range(n)]
    lo = min(pick) if lo is None else lo
    hi = max(pick) if hi is None else hi
    span = max(hi - lo, 1e-9)
    return "".join(
        _BLOCKS[int(min(max((x - lo) / span, 0.0), 1.0) * (len(_BLOCKS) - 1))]
        for x in pick)


def _dashboard_html(svc: FleetService, last: int = 60) -> str:
    """One self-contained page for GET /dashboard: fleet vitals, flush-
    history sparklines, per-tenant stats, lane profiles and the recent
    alert feed, with a 2-second meta-refresh."""
    import html as _html

    esc = _html.escape
    snap = svc.snapshot(last=last)
    with svc.lock:
        alerts = list(svc.alerts.history)[-10:]
        backend = svc.engine.backend_impl.describe()
        stalled = (svc.heartbeat.stalled if svc.heartbeat is not None
                   else False)
        degraded = int(svc.last_degraded)
        lanes = svc.registry.describe()["packages"]
    recs = [r for r in snap["records"] if r.get("kind") == "flush"]
    series = lambda k: [r["telemetry"][k] for r in recs]
    rows = [
        ("T_p99 (°C)", _spark(series("temp_p99_c"))),
        ("T_max (°C)", _spark(series("temp_max_c"))),
        ("f_mean", _spark(series("freq_mean"), lo=0.5, hi=1.0)),
        ("at-risk", _spark(series("at_risk_frac"), lo=0.0, hi=1.0)),
        ("released MTPS", _spark(series("released_mtps"))),
    ] if recs else []
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        "<meta http-equiv='refresh' content='2'>",
        "<title>fleet dashboard</title>",
        "<style>body{font-family:monospace;background:#111;color:#ddd;"
        "margin:2em}h1{font-size:1.1em}table{border-collapse:collapse}"
        "td,th{padding:2px 10px;text-align:left}.spark{color:#6cf}"
        ".bad{color:#f66}.ok{color:#6f6}</style></head><body>",
        f"<h1>fleet control plane — {esc(svc.backend_name)} backend on "
        f"{esc(str(svc.device))}, plant <b>{esc(svc.cfg.plant)}</b></h1>",
        f"<p>engine {esc(backend)} · capacity {snap['capacity']} · "
        f"{snap['n_active']} active · {snap['flushes']} flushes · "
        f"degraded {degraded} · health "
        + ("<span class='bad'>STALLED</span>" if stalled
           else "<span class='ok'>ok</span>") + "</p>",
    ]
    if recs:
        parts.append(f"<p>flushes {int(recs[0]['flush'])}.."
                     f"{int(recs[-1]['flush'])} ({len(recs)} shown)</p>")
        parts.append("<table>")
        for label, line in rows:
            parts.append(f"<tr><td>{esc(label)}</td>"
                         f"<td class='spark'>{esc(line)}</td></tr>")
        parts.append("</table>")
        tenants = recs[-1].get("tenants", {})
        if tenants:
            parts.append("<h1>tenants (last flush)</h1><table>"
                         "<tr><th>tenant</th><th>pkgs</th><th>peak °C</th>"
                         "<th>f_min</th><th>drift nm</th>"
                         "<th>degraded</th></tr>")
            for name, st in sorted(tenants.items()):
                parts.append(
                    f"<tr><td>{esc(name)}</td><td>{int(st['n_lanes'])}</td>"
                    f"<td>{st['temp_peak_c']:.1f}</td>"
                    f"<td>{st['freq_min']:.3f}</td>"
                    f"<td>{st['drift_nm']:.3f}</td>"
                    f"<td>{int(st.get('degraded_lanes', 0))}</td></tr>")
            parts.append("</table>")
    else:
        parts.append("<p>(no flushes recorded yet — attach a package and "
                     "wait one flush)</p>")
    if lanes:
        parts.append("<h1>lane profiles</h1><table>"
                     "<tr><th>package</th><th>lane</th><th>tenant</th>"
                     "<th>node</th><th>mode</th><th>plant</th></tr>")
        for pkg, row in sorted(lanes.items()):
            parts.append(
                f"<tr><td>{esc(pkg)}</td><td>{int(row['lane'])}</td>"
                f"<td>{esc(str(row['tenant']))}</td>"
                f"<td>{esc(str(row['node']))}</td>"
                f"<td>{esc(str(row['mode']))}</td>"
                f"<td>{esc(str(row['plant']))}</td></tr>")
        parts.append("</table>")
    parts.append(f"<h1>alerts (last {len(alerts)})</h1>")
    if alerts:
        parts.append("<table>")
        for ev in alerts:
            parts.append(
                f"<tr><td>flush {int(ev['flush'])}</td>"
                f"<td>{esc(str(ev['tenant']))}</td>"
                f"<td class='bad'>{esc(str(ev['kind']))}</td>"
                f"<td>{ev['value']:.4g} &gt; {ev['limit']:.4g}</td></tr>")
        parts.append("</table>")
    else:
        parts.append("<p class='ok'>none fired</p>")
    parts.append("</body></html>")
    return "".join(parts)


# ------------------------------------------------------------------- HTTP
class _Handler(BaseHTTPRequestHandler):
    """JSON over stdlib http.server; the service rides on the server
    object.  Errors map to 4xx with a JSON body — the serving loop itself
    can never be crashed from the API."""

    server_version = "FleetService/1.0"

    def log_message(self, fmt, *args):      # silence per-request stderr
        pass

    def _send(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_html(self, code: int, body: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b""
        return json.loads(raw) if raw else {}

    @staticmethod
    def _last(query: str, default: int) -> int:
        for part in query.split("&"):
            if part.startswith("last="):
                return max(1, int(part[5:]))
        return default

    def do_GET(self):          # noqa: N802 — http.server API
        svc: FleetService = self.server.service
        path, _, query = self.path.partition("?")
        if path == "/healthz":
            stalled = (svc.heartbeat.stalled if svc.heartbeat is not None
                       else False)
            self._send(200, {"ok": not stalled, "flushes": svc.flushes,
                             "capacity": svc.registry.capacity,
                             "n_active": svc.registry.n_active,
                             "stalled": stalled,
                             "degraded_count": int(svc.last_degraded)})
        elif path == "/telemetry":
            self._send(200, svc.snapshot(last=self._last(query, 1)))
        elif path == "/fleet":
            with svc.lock:
                self._send(200, svc.registry.describe())
        elif path == "/alerts":
            with svc.lock:
                self._send(200, {"alerts": list(svc.alerts.history)})
        elif path == "/dashboard":
            self._send_html(200, _dashboard_html(
                svc, last=self._last(query, 60)))
        else:
            self._send(404, {"error": f"unknown path {path!r}"})

    def do_POST(self):         # noqa: N802 — http.server API
        svc: FleetService = self.server.service
        try:
            body = self._body()
            if self.path == "/attach":
                self._send(200, svc.attach(
                    body["package"], body.get("tenant", "default"),
                    body.get("kind", "inference"),
                    node=body.get("node", "base"),
                    mode=body.get("mode", "v24"),
                    plant=body.get("plant")))
            elif self.path == "/detach":
                self._send(200, svc.detach(body["package"]))
            elif self.path == "/canary":
                self._send(200, svc.canary(body["reactive_frac"]))
            elif self.path == "/mode":
                self._send(200, svc.set_mode(body["package"],
                                             body["mode"]))
            elif self.path == "/thresholds":
                tenant = body.pop("tenant")
                allowed = {"t_crit_c", "at_risk_limit", "drift_budget_nm",
                           "degraded_limit"}
                bad = set(body) - allowed
                if bad:
                    raise ValueError(f"unknown threshold field(s) "
                                     f"{sorted(bad)}; want {sorted(allowed)}")
                self._send(200, svc.set_thresholds(tenant, **body))
            elif self.path == "/ingest":
                out = svc.ingest(body["tenant"], body["chunk"])
                # a refused chunk is back-pressure, not an error: 429 tells
                # the poster to retry after a flush drains the queue
                self._send(200 if out["accepted"] else 429, out)
            elif self.path == "/replay":
                self._send(200, {"replayed": svc.replay(body["path"])})
            elif self.path == "/shutdown":
                svc.shutdown()
                self._send(200, {"ok": True})
            else:
                self._send(404, {"error": f"unknown path {self.path!r}"})
        except (KeyError, ValueError, FileNotFoundError) as e:
            self._send(400, {"error": f"{type(e).__name__}: {e}"})


def serve_http(service: FleetService, host: str = "127.0.0.1",
               port: int = 0) -> tuple[ThreadingHTTPServer, threading.Thread]:
    """Start the control / telemetry API in a daemon thread; returns the
    server (``server.server_address[1]`` is the bound port — port 0 gets
    an ephemeral one) and its thread.  Call ``server.shutdown()`` to stop."""
    server = ThreadingHTTPServer((host, port), _Handler)
    server.service = service
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread
