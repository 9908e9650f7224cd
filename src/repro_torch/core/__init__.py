"""Core library — the paper's firmware physics, in PyTorch.

Layer map (paper → module), the slice ported so far:
  §4.1 fingerprint constants      → fingerprint
  §4.2 ρ density metric           → density
  §4.2 thermal convolution        → thermal
  §4.2 PDU gate / η               → pdu_gate
  §5.1 N×N coupling matrix Γ      → coupling
  plant fidelity ladder           → plant
  integration layer               → scheduler
  §10 Monte-Carlo population      → montecarlo (draws, run, run_reference)
  §3.4 guard-band liberation      → guardband
  per-technology-node banks       → nodebank
"""
from repro_torch.core.fingerprint import FINGERPRINT, Fingerprint
from repro_torch.core.scheduler import (SchedulerConfig, SchedulerOutput,
                                        SchedulerState, ThermalScheduler)

__all__ = [
    "FINGERPRINT", "Fingerprint",
    "ThermalScheduler", "SchedulerConfig", "SchedulerState", "SchedulerOutput",
]
