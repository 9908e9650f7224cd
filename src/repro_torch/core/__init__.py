"""Core library — the paper's firmware physics, in PyTorch.

Layer map (paper → module), the slice ported so far:
  §4.1 fingerprint constants      → fingerprint
  §4.2 ρ density metric           → density
  §4.2 thermal convolution        → thermal
  §4.2 PDU gate / η               → pdu_gate
  §5.1 N×N coupling matrix Γ      → coupling
  plant fidelity ladder           → plant (pole rung)
  integration layer               → scheduler
"""
from repro_torch.core.fingerprint import FINGERPRINT, Fingerprint
from repro_torch.core.scheduler import (SchedulerConfig, SchedulerOutput,
                                        SchedulerState, ThermalScheduler)

__all__ = [
    "FINGERPRINT", "Fingerprint",
    "ThermalScheduler", "SchedulerConfig", "SchedulerState", "SchedulerOutput",
]
