"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``fleet_step`` (csrc/fleet_step.cu) replaces the TPU kernel
`repro.kernels.fleet_step.fleet_step`.  Kernels build at first use
(`_build`); importing this package needs neither ``nvcc`` nor a card.
"""
