"""Crash-consistent checkpoints of the port's state pytrees (`manager`)."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
