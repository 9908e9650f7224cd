"""Fleet backend protocol + registry.

Port of `repro.fleet.backends.base`.  A *backend* owns the fleet's state
layout and how one scheduler step maps over the package axis.  `FleetEngine`
is backend-agnostic: it asks the backend to build state (`init`), advance it
(`update`, or a whole window through `run_block` where the backend has a
fused kernel), and place host density chunks on the device (`put_trace`,
used by the streaming ingest loop).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.scheduler import (SchedulerOutput, SchedulerState,
                                        ThermalScheduler)

_REGISTRY: dict[str, type["FleetBackend"]] = {}


def register(cls: type["FleetBackend"]) -> type["FleetBackend"]:
    """Class decorator: make a backend constructible by name."""
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a non-empty .name")
    _REGISTRY[cls.name] = cls
    return cls


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


def backend_class(name: str) -> type["FleetBackend"]:
    """Resolve a registered backend class by name (no instantiation)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown fleet backend {name!r}; "
                         f"available: {available_backends()}") from None


def get_backend(name: str, sched: ThermalScheduler, **kwargs) -> "FleetBackend":
    """Instantiate a registered backend by name (kwargs are backend-specific)."""
    return backend_class(name)(sched, **kwargs)


class FleetBackend:
    """One strategy for stepping N packages' schedulers at once."""

    name: str = ""
    # device-mesh backends (sharded / sharded_fused) take a ``devices=``
    # budget and a ``device_pool`` in their constructor; `FleetEngine`
    # forwards its own only to backends that declare this
    accepts_devices: bool = False

    def __init__(self, sched: ThermalScheduler):
        self.sched = sched
        self.device = sched.device

    # -- state ------------------------------------------------------------
    def init(self, n_packages: int, pkg=None,
             filtration_fill=None) -> SchedulerState:
        """Fleet state with a leading [n_packages] axis on per-package leaves."""
        return self.sched.init(batch_shape=(n_packages,), pkg=pkg,
                               filtration_fill=filtration_fill)

    def update(self, state: SchedulerState, rho: torch.Tensor
               ) -> tuple[SchedulerState, SchedulerOutput]:
        """Advance every package one step.  rho: [n_packages, n_tiles]."""
        return self.sched.update(state, rho)

    # -- fused fast path ---------------------------------------------------
    # A backend that advances a whole [T, n_packages, n_tiles] window in one
    # fused call overrides this with `(state, rho_trace) -> (state, temps,
    # freqs)`; ``None`` ⇒ the engine loops over `update`.
    run_block = None

    # -- placement --------------------------------------------------------
    def put_trace(self, trace) -> torch.Tensor:
        """Place a host density chunk [..., n_packages, n_tiles] on the device.

        On CUDA the chunk is staged in pinned host memory and copied with
        ``non_blocking=True`` on the current stream, so the streaming loop
        uploads the next chunk while the current one computes; the copy is
        ordered before any kernel that later reads it on that stream.
        """
        if torch.is_tensor(trace):
            return trace.to(device=self.device, dtype=torch.float32,
                            non_blocking=True)
        arr = np.ascontiguousarray(trace, dtype=np.float32)
        if not arr.flags.writeable:
            arr = arr.copy()
        host = torch.from_numpy(arr)
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host

    def put_mask(self, mask) -> torch.Tensor:
        """Place an [n_packages] bool active-lane mask on the device (it
        partitions like the package axis of the state: whole here, one
        partition per mesh position under the mesh backends)."""
        if torch.is_tensor(mask):
            return mask.to(self.device)
        return torch.as_tensor(np.asarray(mask), device=self.device)

    def place(self, state: SchedulerState) -> SchedulerState:
        """A whole-fleet state (a restored snapshot, a resized one) in
        this backend's layout: as it is for the single-device backends."""
        return state

    # -- introspection ----------------------------------------------------
    def n_devices(self) -> int:
        return 1

    def describe(self) -> str:
        return self.name
