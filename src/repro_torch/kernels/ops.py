"""Public entry to the port's thermal kernel.

Port of the thermal part of `repro.kernels.ops`: `thermal_conv` is
`repro_torch.kernels.thermal_conv.thermal_conv`, which runs the
hand-written CUDA kernel for CUDA tensors and the plain PyTorch version for
CPU tensors — the device of ``power`` decides, nothing else (there is no
environment switch).  A failed build or launch raises; it never falls back
to the plain version.
"""
from repro_torch.kernels.thermal_conv import thermal_conv

__all__ = ["thermal_conv"]
