"""Pluggable fleet execution backends.

Importing this package registers the ported backends (``broadcast``,
``fused``); the reference's ``vmap``, ``sharded`` and ``sharded_fused`` are
not ported yet (ROADMAP queue 1 steps 3 and 9).
"""
from repro_torch.fleet.backends.base import (FleetBackend, available_backends,
                                             backend_class, get_backend,
                                             register)
from repro_torch.fleet.backends.broadcast import BroadcastBackend
from repro_torch.fleet.backends.fused import FusedBackend

__all__ = ["FleetBackend", "available_backends", "backend_class",
           "get_backend", "register", "BroadcastBackend", "FusedBackend"]
