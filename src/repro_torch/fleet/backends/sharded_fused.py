"""sharded_fused backend — the `fleet_step` kernel over a device mesh.

Port of `repro.fleet.backends.sharded_fused` in one process.  It composes
the two fleet fast paths:

  * `sharded` partitions the package axis over a 1-D device mesh (the
    state born partitioned, laid out by `ThermalScheduler.state_pspecs`);
  * `fused` advances a whole [T, n_packages, n_tiles] window in ONE
    `fleet_step` call.

`run_block` calls `FusedBackend.run_block` on each partition, on that
partition's device: one `fleet_step` launch per partition per window, its
grid sized for the partition's packages, the launches queued one after the
other with no host synchronisation between them.  Each device has its own
`FusedBackend` (its kernel constants and Γ rows live there).  The streamed
temperature and frequency traces come back partitioned; the engine gathers
them onto the mesh's first device for the telemetry reductions, which stay
one device→host copy a flush.

Per-step `update`, the mesh and its loud degradation, `put_trace` and
`put_mask` are `ShardedBackend`'s.  A plant with no fused path (the grid)
leaves `run_block` None, as the reference's route rule does: the engine then
steps it through the sharded per-step `update`.

Each partition keeps `fused`'s conventions (the ring rolled to ptr = 0, the
sliding statistics re-derived exactly on entry and exit), so every lane is
bit-equal to the `fused` backend's at every partition count.
"""
from __future__ import annotations

import torch

from repro_torch.core.scheduler import SchedulerState, ThermalScheduler
from repro_torch.distributed.sharding import (as_device, fleet_shard_map,
                                              fleet_trace_spec, mesh_of)
from repro_torch.fleet.backends.base import register
from repro_torch.fleet.backends.fused import FusedBackend
from repro_torch.fleet.backends.sharded import ShardedBackend
from repro_torch.kernels.fleet_step import layout


@register
class ShardedFusedBackend(ShardedBackend):
    name = "sharded_fused"

    def __init__(self, sched: ThermalScheduler, devices: int | None = None,
                 device_pool=None):
        super().__init__(sched, devices=devices, device_pool=device_pool)
        home = FusedBackend(sched)
        self._fused = {as_device(sched.device): home}
        if home.run_block is None:
            # a grid-family plant: the kernel declines it, so shadow ours
            # and the engine steps the fleet through the sharded `update`
            self.run_block = None
            self.block_packages = None
        elif home.device.type == "cuda":
            # packages a kernel block: a warp of 32 in the packed layout,
            # one in the wide one (the launcher's `fleet_step_layout`)
            self.block_packages = (32 if layout(sched.cfg.n_tiles,
                                                home.params) == "packed"
                                   else 1)
        else:
            self.block_packages = "plain"   # the plain version steps it all

    def _fused_on(self, device: torch.device) -> FusedBackend:
        device = as_device(device)
        f = self._fused.get(device)
        if f is None:
            f = self._fused[device] = FusedBackend(self._sched_on(device))
        return f

    def run_block(self, state: SchedulerState, rho_trace):
        """Advance T steps: one `fleet_step` per partition, on its device.

        rho_trace: [T, n, tiles], partitioned (`put_trace`) or whole.
        Returns (state', temps, freqs), the traces [T, n, tiles]
        partitioned over packages like the state."""
        tspec = fleet_trace_spec(3, package_dim=1)
        fn = fleet_shard_map(
            lambda st, rho: self._fused_on(st.freq.device).run_block(st, rho),
            mesh_of(state), in_specs=(self._state_specs, tspec),
            out_specs=(self._state_specs, tspec, tspec))
        return fn(state, rho_trace)

    def describe(self) -> str:
        return (f"{self.name}[{self.n_devices()}dev,"
                f"blk={self.block_packages}]")
