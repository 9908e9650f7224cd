"""Pluggable fleet execution backends.

Importing this package registers every backend of the reference:
``broadcast``, ``fused``, ``vmap`` and the device-mesh ones, ``sharded``
and ``sharded_fused`` (in one process, or on a mesh spanning the ranks of
a process group).
"""
from repro_torch.fleet.backends.base import (FleetBackend, available_backends,
                                             backend_class, get_backend,
                                             register)
from repro_torch.fleet.backends.broadcast import BroadcastBackend
from repro_torch.fleet.backends.fused import FusedBackend
from repro_torch.fleet.backends.sharded import ShardedBackend
from repro_torch.fleet.backends.sharded_fused import ShardedFusedBackend
from repro_torch.fleet.backends.vmap import VmapBackend

__all__ = ["FleetBackend", "available_backends", "backend_class",
           "get_backend", "register", "BroadcastBackend", "FusedBackend",
           "ShardedBackend", "ShardedFusedBackend", "VmapBackend"]
