"""Fault-tolerance runtime pieces: heartbeat watchdog and preemption handling.

Port of `repro.distributed.fault_tolerance` (host-side, no device code).
The resident control plane (`repro_torch.fleet.service`) arms a
`Heartbeat` as its stalled-flush watchdog, and `serve --serve` holds a
`PreemptionGuard` so that SIGTERM takes one final blocking snapshot;
checkpoint atomicity lives in `repro_torch.checkpoint`.  `reshard_state`
(elastic re-mesh) re-places a fleet state from one device mesh onto
another with a different partition count.
"""
from __future__ import annotations

import signal
import threading
import time
from typing import Callable

from repro_torch.distributed import sharding


class Heartbeat:
    """Watchdog: trips if the training loop stops advancing for `timeout_s`.

    On real clusters the callback would page the controller / trigger an
    elastic restart; in-process we surface a flag the loop can act on.
    """

    def __init__(self, timeout_s: float = 300.0,
                 on_stall: Callable[[], None] | None = None):
        self.timeout_s = timeout_s
        self.on_stall = on_stall
        self._last = time.monotonic()
        self._stalled = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def beat(self) -> None:
        self._last = time.monotonic()

    @property
    def stalled(self) -> bool:
        return self._stalled

    def _watch(self):
        while not self._stop.wait(min(self.timeout_s / 4, 5.0)):
            if time.monotonic() - self._last > self.timeout_s:
                self._stalled = True
                if self.on_stall:
                    self.on_stall()
                self._last = time.monotonic()

    def close(self):
        self._stop.set()


class PreemptionGuard:
    """SIGTERM/SIGINT → set a flag; the training loop checkpoints and exits.

    Usage:
        guard = PreemptionGuard()
        for step in ...:
            if guard.should_exit: ckpt.save(step, state, blocking=True); break
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self.should_exit = False
        self._prev = {}
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:        # non-main thread (tests)
                pass

    def _handler(self, signum, frame):
        self.should_exit = True

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


def reshard_state(state, new_mesh, spec_tree):
    """Elastic re-mesh: every partitioned leaf of ``state`` re-placed on
    ``new_mesh`` (a `distributed.sharding.fleet_mesh`) by the congruent
    pspecs ``spec_tree`` (`ThermalScheduler.state_pspecs`) — each new
    partition assembled from the old partitions that hold its packages,
    nothing gathered whole; a whole state is split; shared leaves (the host
    clocks) stay as they are.  Pure data movement: every lane keeps its
    bits."""
    return sharding.place(state, new_mesh, spec_tree)
