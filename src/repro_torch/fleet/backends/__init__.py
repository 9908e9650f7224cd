"""Pluggable fleet execution backends.

Importing this package registers the ported backends (``broadcast``,
``fused``, ``vmap``); the reference's ``sharded`` and ``sharded_fused`` are
not ported yet (ROADMAP queue 1 step 9).
"""
from repro_torch.fleet.backends.base import (FleetBackend, available_backends,
                                             backend_class, get_backend,
                                             register)
from repro_torch.fleet.backends.broadcast import BroadcastBackend
from repro_torch.fleet.backends.fused import FusedBackend
from repro_torch.fleet.backends.vmap import VmapBackend

__all__ = ["FleetBackend", "available_backends", "backend_class",
           "get_backend", "register", "BroadcastBackend", "FusedBackend",
           "VmapBackend"]
