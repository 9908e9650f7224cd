"""Fault-tolerance runtime pieces of the port (`fault_tolerance`).

The reference's `repro.distributed` also holds the mesh and multi-host
modules (`sharding`, `multihost`) and `fault_tolerance.reshard_state`; they
wait for the multi-GPU step (ROADMAP queue 1 step 9) and are not exported
here.
"""
from repro_torch.distributed.fault_tolerance import Heartbeat, PreemptionGuard

__all__ = ["Heartbeat", "PreemptionGuard"]
