"""sharded backend — the package axis partitioned over a 1-D device mesh.

Port of `repro.fleet.backends.sharded`.  The fleet's package axis is
embarrassingly parallel, so `update` runs the broadcast layout's
`ThermalScheduler.update` on each device's package partition, on that
device, with no cross-partition operation inside a step; only the engine's
telemetry reductions cross partitions, and they run on the traces gathered
onto the mesh's first device (`repro_torch.fleet.engine`).  The state is
partitioned at birth: `init` builds each partition with the scheduler of
its own device, so the full fleet never materialises on one device.  The
state's per-package leaves are `distributed.sharding.Sharded`, laid out by
`ThermalScheduler.state_pspecs`; the shared ``step`` / ``ptr`` host clocks
stay whole and must come back equal from every partition.

Graceful degradation, as in the reference: a ``devices`` budget larger than
the pool, or a fleet size the mesh does not divide, falls back to the
largest compatible mesh (down to one device, where sharded ≡ broadcast bit
for bit).  The fallback is LOUD: a `RuntimeWarning` names the requested and
actual device counts and the cause, and `describe()` always carries the
actual mesh size.  A mesh never moves a partition to another device type.

``device_pool`` is the set of devices the mesh may take (default: every
visible CUDA device; on an engine asked onto the CPU, that one CPU
device; in a process group, the rank's device as many times as
`multihost.initialize` was told).  Its entries may repeat one device: four
partitions of one card.

In a process group (`repro_torch.distributed.multihost`) the mesh spans
every rank's pool, the ranks' local meshes in rank order (a
`ProcessMesh`), and the SAME backend runs on every rank, each stepping
only its own partitions.  Degradation is then an error, not a warning — a
shrunken mesh would leave some rank out of the group's collectives — so an
indivisible fleet size, or a ``devices`` budget other than the global
count, raises ValueError.  `put_trace` takes a second chunk shape there: a
chunk whose package dim is this rank's lane span
(`multihost.local_lane_range`) becomes its local partitions with no
movement across processes (the per-rank ingest of
`repro_torch.fleet.distributed_ingest`); a global chunk is cut to the span.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.core.scheduler import (SchedulerOutput, SchedulerState,
                                        ThermalScheduler)
from repro_torch.distributed import multihost
from repro_torch.distributed.sharding import (FLEET_AXIS, ProcessMesh,
                                              Sharded, as_device, fleet_mesh,
                                              fleet_shard_map,
                                              fleet_trace_spec, join,
                                              mesh_of, mesh_spans, on_device,
                                              place, to_device)
from repro_torch.fleet.backends.base import FleetBackend, register


@register
class ShardedBackend(FleetBackend):
    name = "sharded"
    accepts_devices = True

    def __init__(self, sched: ThermalScheduler, devices: int | None = None,
                 device_pool=None):
        super().__init__(sched)
        self._requested = devices
        home = as_device(sched.device)
        if device_pool is None:
            device_pool = multihost.local_device_pool(home)
        self._pool = fleet_mesh(None, device_pool)
        if any(d.type != home.type for d in self._pool):
            raise ValueError(
                f"{self.name} fleet backend: device pool "
                f"{[str(d) for d in self._pool]} mixes device types with "
                f"the engine's {home} (a mesh never moves a partition to "
                f"another device type)")
        self.mesh = fleet_mesh(devices, self._pool)
        # the global fleet size, set when the mesh is resolved for it: a
        # process-spanning put_trace tells a local slab from a global chunk
        # by it
        self.n_global = None
        # every rank's pool size (one small collective, made here on every
        # rank at the same point), and the global mesh over them
        self._counts = None
        if multihost.is_multiprocess():
            self._counts = multihost.group_counts(len(self._pool))
            self.mesh = multihost.process_mesh(self._pool, self._counts)
        self._scheds = {home: sched}
        self._state_specs = sched.state_pspecs(batch_axes=(FLEET_AXIS,))
        self._out_specs = sched.output_pspecs(batch_axes=(FLEET_AXIS,))

    def _sched_on(self, device: torch.device) -> ThermalScheduler:
        """The scheduler whose constants live on ``device`` (one per
        distinct device of the pool)."""
        device = as_device(device)
        s = self._scheds.get(device)
        if s is None:
            s = self._scheds[device] = ThermalScheduler(
                self.sched.cfg, self.sched.fp, device=device)
        return s

    # -- state ------------------------------------------------------------
    def _resolve_mesh(self, n_packages: int) -> None:
        """Re-derive the mesh from the requested budget for this fleet size
        (on every init, so a divisible fleet after an indivisible one gets
        the full budget back); any downgrade warns with the requested and
        actual counts and the cause.

        In a process group a downgrade is an error: every rank must run
        the same program over the whole global mesh, and a mesh without
        some rank's devices would leave it out of the collectives."""
        self.n_global = n_packages
        if self._counts is not None:
            total = sum(self._counts)
            if self._requested and self._requested != total:
                raise ValueError(
                    f"{self.name} fleet backend: devices={self._requested} "
                    f"in a {len(self._counts)}-process group — the mesh must "
                    f"span all {total} global devices (pass devices=None/0)")
            if n_packages % total:
                raise ValueError(
                    f"{self.name} fleet backend: n_packages={n_packages} "
                    f"must divide the {total} global devices in "
                    f"multi-process mode (no silent mesh degradation "
                    f"across processes)")
            return
        visible = len(self._pool)
        requested = self._requested or visible
        clamped = len(fleet_mesh(self._requested, self._pool))
        budget = clamped
        if n_packages % budget:
            # the largest divisor of n_packages the budget covers
            budget = max(d for d in range(1, budget + 1)
                         if n_packages % d == 0)
        if budget != requested:
            causes = []
            if clamped < requested:
                causes.append(f"only {visible} devices visible")
            if budget < clamped:
                causes.append(f"n_packages={n_packages} must divide "
                              f"the mesh")
            what = (f"requested {requested} devices but running on {budget}"
                    if self._requested else
                    f"using {budget} of {visible} visible devices")
            warnings.warn(
                f"{self.name} fleet backend: {what} "
                f"({'; '.join(causes)}) — check describe() before "
                f"trusting scaling numbers", RuntimeWarning, stacklevel=3)
        self.mesh = fleet_mesh(budget, self._pool)

    def init(self, n_packages: int, pkg=None,
             filtration_fill=None) -> SchedulerState:
        """Each partition's state built on its own device by its own
        scheduler; per-package draws and an [n, tiles] fill are split the
        same way (a scalar or per-tile fill broadcasts)."""
        self._resolve_mesh(n_packages)
        fill = filtration_fill
        per_package = (fill is not None and np.ndim(fill) == 2
                       and len(fill) == n_packages)
        if per_package and not torch.is_tensor(fill):
            fill = torch.from_numpy(np.asarray(fill, np.float32))
        parts = []
        for (lo, hi), dev in zip(mesh_spans(n_packages, self.mesh),
                                 self.mesh):
            cut = lambda x: to_device(x.narrow(0, lo, hi - lo), dev)
            with on_device(dev):
                parts.append(self._sched_on(dev).init(
                    batch_shape=(hi - lo,),
                    pkg=None if pkg is None else type(pkg)(*map(cut, pkg)),
                    filtration_fill=cut(fill) if per_package else fill))
        return join(parts, self._state_specs, self.mesh)

    def place(self, state: SchedulerState) -> SchedulerState:
        """A whole (or differently partitioned) state on the mesh this
        backend resolves for its fleet size."""
        self._resolve_mesh(state.freq.shape[0])
        return place(state, self.mesh, self._state_specs)

    def update(self, state: SchedulerState, rho
               ) -> tuple[SchedulerState, SchedulerOutput]:
        """One step: `ThermalScheduler.update` on each partition, on its
        own device; ``rho`` [n, tiles] partitioned or whole."""
        fn = fleet_shard_map(
            lambda st, r: self._sched_on(st.freq.device).update(st, r),
            mesh_of(state), in_specs=(self._state_specs, 0),
            out_specs=(self._state_specs, self._out_specs))
        return fn(state, rho)

    # -- placement --------------------------------------------------------
    def spans_processes(self) -> bool:
        """True when the mesh holds the devices of more than one rank."""
        return multihost.spans_processes(self.mesh)

    def _split(self, x: torch.Tensor, dim: int):
        """A whole tensor in the mesh's spans along ``dim``, each on its
        own device (a view where that is ``x``'s device); None when the
        mesh does not divide it (the caller keeps it whole — replicated,
        as the reference places it)."""
        if x.shape[dim] % len(self.mesh):
            return None
        return Sharded([to_device(x.narrow(dim, lo, hi - lo), dev)
                        for (lo, hi), dev in zip(
                            mesh_spans(x.shape[dim], self.mesh), self.mesh)],
                       dim)

    def put_trace(self, trace):
        """Upload a density chunk with each package partition landing on its
        own device: [n, t] chunks split dim 0, [T, n, t] dim 1, pre-chunked
        [C, K, n, t] dim 2.  The host chunk goes up whole in one pinned,
        asynchronous copy to the mesh's first device, as the single-device
        backends upload it, and each partition is taken from there: a view
        on that device, a device-to-device copy onto another (splitting on
        the host would cost a strided host copy a partition a flush).

        On a process-spanning mesh the chunk is either global (its package
        dim the global fleet size: this rank's span is cut from it) or this
        rank's slab (its package dim the span's size), uploaded the same
        way and split into this rank's partitions
        (`multihost.assemble_local_slab`); any other size raises, and so
        does a chunk before `init`, which fixes the global size."""
        if isinstance(trace, Sharded):
            return trace
        if self.spans_processes():
            return self._put_trace_group(trace)
        whole = super().put_trace(trace)
        pdim = fleet_trace_spec(whole.ndim, package_dim=max(whole.ndim - 2,
                                                             0))
        part = self._split(whole, pdim)
        return whole if part is None else part

    def _put_trace_group(self, trace):
        if self.n_global is None:
            raise RuntimeError(f"{self.name}: init() must run before "
                               f"put_trace on a multi-process mesh (the "
                               f"global fleet size tells a local slab from "
                               f"a global chunk)")
        pdim = max(trace.ndim - 2, 0)
        lo, hi = multihost.local_lane_range(self.n_global, self.mesh)
        n_in = trace.shape[pdim]
        if n_in == self.n_global:
            trace = trace[(slice(None),) * pdim + (slice(lo, hi),)]
        elif n_in != hi - lo:
            raise ValueError(
                f"{self.name}: chunk package dim {n_in} is neither the "
                f"global fleet size {self.n_global} nor this process's "
                f"local span {hi - lo} (lanes [{lo}, {hi}))")
        slab = super().put_trace(trace)
        gshape = (tuple(slab.shape[:pdim]) + (self.n_global,)
                  + tuple(slab.shape[pdim + 1:]))
        return multihost.assemble_local_slab(self.mesh, slab, gshape, pdim)

    def put_mask(self, mask):
        """An active-lane mask partitioned like the state's package axis;
        an indivisible capacity stays whole (replicated), as `put_trace`'s
        fallback.  On a process-spanning mesh every rank passes the same
        GLOBAL mask, kept whole: the flush's reductions read it whole."""
        whole = super().put_mask(mask)
        if self.spans_processes():
            return whole
        part = self._split(whole, 0)
        return whole if part is None else part

    # -- introspection ----------------------------------------------------
    def n_devices(self) -> int:
        """Devices of the mesh: across every rank on a process-spanning
        one."""
        if isinstance(self.mesh, ProcessMesh):
            return self.mesh.size
        return len(self.mesh)

    def _mesh_tag(self) -> str:
        if self.spans_processes():
            return (f"{self.n_devices()}dev/"
                    f"{len(set(self.mesh.owners))}proc")
        return f"{self.n_devices()}dev"

    def describe(self) -> str:
        return f"{self.name}[{self._mesh_tag()}]"
