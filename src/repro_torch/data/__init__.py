"""The port's copy of the synthetic LM data pipeline (`pipeline`)."""
from repro_torch.data.pipeline import DataConfig, SyntheticLMData

__all__ = ["SyntheticLMData", "DataConfig"]
