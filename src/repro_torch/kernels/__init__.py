"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``fleet_step`` (csrc/fleet_step.cu) replaces the TPU kernel
`repro.kernels.fleet_step.fleet_step`.  Kernels build at first use
(`_build`); importing this package needs neither ``nvcc`` nor a card.
"""
import torch


def call_op(op, impl, *args):
    """The kernel entry ``op`` (a ``torch.library.custom_op`` made from
    ``impl``) on ``args``.  A real tensor with no dispatch mode active
    calls ``impl`` itself, so the dispatcher's cost per call stays off the
    paths whose kernels are timed; fake tensors, ``FlopCounterMode`` and
    the census go through the op, its shape rule and its flop formula."""
    if (type(args[0]) is torch.Tensor
            and torch._C._len_torch_dispatch_stack() == 0):
        return impl(*args)
    return op(*args)
