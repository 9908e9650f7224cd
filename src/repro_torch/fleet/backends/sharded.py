"""sharded backend — the package axis partitioned over a 1-D device mesh.

Port of `repro.fleet.backends.sharded` in one process.  The fleet's package
axis is embarrassingly parallel, so `update` runs the broadcast layout's
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
device).  Its entries may repeat one device: four partitions of one card.

The reference's multi-process branches (a mesh spanning a
``jax.distributed`` group, per-host ingest slabs) are not here: they wait
for the multi-process step (ROADMAP queue 1 step 9b).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.core.scheduler import (SchedulerOutput, SchedulerState,
                                        ThermalScheduler)
from repro_torch.distributed.sharding import (FLEET_AXIS, Sharded, as_device,
                                              fleet_mesh, fleet_shard_map,
                                              fleet_trace_spec, join,
                                              mesh_of, on_device, place,
                                              spans, to_device)
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
        if device_pool is None and home.type != "cuda":
            device_pool = (home,)
        self._pool = fleet_mesh(None, device_pool)
        if any(d.type != home.type for d in self._pool):
            raise ValueError(
                f"{self.name} fleet backend: device pool "
                f"{[str(d) for d in self._pool]} mixes device types with "
                f"the engine's {home} (a mesh never moves a partition to "
                f"another device type)")
        self.mesh = fleet_mesh(devices, self._pool)
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
        actual counts and the cause."""
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
        for (lo, hi), dev in zip(spans(n_packages, len(self.mesh)),
                                 self.mesh):
            cut = lambda x: to_device(x.narrow(0, lo, hi - lo), dev)
            with on_device(dev):
                parts.append(self._sched_on(dev).init(
                    batch_shape=(hi - lo,),
                    pkg=None if pkg is None else type(pkg)(*map(cut, pkg)),
                    filtration_fill=cut(fill) if per_package else fill))
        return join(parts, self._state_specs)

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
    def _split(self, x: torch.Tensor, dim: int):
        """A whole tensor in the mesh's spans along ``dim``, each on its
        own device (a view where that is ``x``'s device); None when the
        mesh does not divide it (the caller keeps it whole — replicated,
        as the reference places it)."""
        if x.shape[dim] % len(self.mesh):
            return None
        return Sharded([to_device(x.narrow(dim, lo, hi - lo), dev)
                        for (lo, hi), dev in zip(
                            spans(x.shape[dim], len(self.mesh)), self.mesh)],
                       dim)

    def put_trace(self, trace):
        """Upload a density chunk with each package partition landing on its
        own device: [n, t] chunks split dim 0, [T, n, t] dim 1, pre-chunked
        [C, K, n, t] dim 2.  The host chunk goes up whole in one pinned,
        asynchronous copy to the mesh's first device, as the single-device
        backends upload it, and each partition is taken from there: a view
        on that device, a device-to-device copy onto another (splitting on
        the host would cost a strided host copy a partition a flush)."""
        if isinstance(trace, Sharded):
            return trace
        whole = super().put_trace(trace)
        pdim = fleet_trace_spec(whole.ndim, package_dim=max(whole.ndim - 2,
                                                             0))
        part = self._split(whole, pdim)
        return whole if part is None else part

    def put_mask(self, mask):
        """An active-lane mask partitioned like the state's package axis;
        an indivisible capacity stays whole (replicated), as `put_trace`'s
        fallback."""
        whole = super().put_mask(mask)
        part = self._split(whole, 0)
        return whole if part is None else part

    # -- introspection ----------------------------------------------------
    def n_devices(self) -> int:
        return len(self.mesh)

    def describe(self) -> str:
        return f"{self.name}[{self.n_devices()}dev]"
