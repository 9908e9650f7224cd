"""Error-feedback int8 gradient compression for the data-parallel
all-reduce.

Port of `repro.optim.compression`, with its arithmetic.  Each rank of a
mesh axis holds its own gradient contribution (a plain tensor per leaf);
per leaf:

    gl    = g (as f32) + e                       the carried residual e
    scale = max over the axis of max(|gl|, 1e-12) / 127   (MAX all-reduce)
    q     = clip(round(gl / scale), −127, 127) as int8    (half to even)
    e'    = gl − q·scale                          the new residual
    tot   = Σ over the axis of q, as int32        (SUM all-reduce)
    mean  = tot·scale / n

The residual is carried to the next step, so the compression error is
unbiased over time.  The shared scale keeps the integer payloads
commensurable, so the int32 sum dequantises exactly.

What the reference's code moves is not what its docstring claims: the sum
runs over int32 (``psum`` of ``q.astype(jnp.int32)``), four bytes an
element, as many as f32, where the docstring counts int8's one.  The port
keeps the reference's arithmetic and payload, and `allreduce_bytes` says
what a call moves; it invents no int8 wire format.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import tree_leaves, tree_unflatten


class CompressionState(NamedTuple):
    error: Any          # residual buffers (f32), congruent with the grads


def compress_grads_init(grads_like) -> CompressionState:
    """Zero f32 residuals beside each gradient leaf."""
    return CompressionState(error=tree_unflatten(grads_like, [
        torch.zeros_like(g, dtype=torch.float32)
        for g in tree_leaves(grads_like)]))


def _group(mesh, axis: str):
    names = mesh.mesh_dim_names
    if axis not in names:
        raise ValueError(f"compressed_allreduce: axis {axis!r} is not one "
                         f"of the mesh's {names}")
    return mesh.get_group(names.index(axis)), mesh.size(names.index(axis))


def compressed_allreduce(local_grads, state: CompressionState, mesh,
                         axis: str = "data"):
    """Mean over ``mesh``'s ``axis`` of each rank's gradient tree, in int8
    with error feedback.  ``local_grads``: this rank's contribution (plain
    tensors; the same on every rank of the other axes).  Returns
    (mean_grads f32, new state); every rank of the axis gets the same
    mean.  Two collectives a leaf: a MAX all-reduce of its scale and a SUM
    all-reduce of its int32 payload."""
    group, n = _group(mesh, axis)
    means, errors = [], []
    for g, e in zip(tree_leaves(local_grads), tree_leaves(state.error)):
        gl = g.float() + e
        scale = torch.clamp(gl.abs().max(), min=1e-12) / 127.0
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        q = torch.clamp(torch.round(gl / scale), -127, 127).to(torch.int8)
        errors.append(gl - q.float() * scale)
        tot = q.to(torch.int32)
        dist.all_reduce(tot, op=dist.ReduceOp.SUM, group=group)
        means.append(tot.float() * scale / n)
    return (tree_unflatten(local_grads, means),
            CompressionState(error=tree_unflatten(state.error, errors)))


def allreduce_bytes(local_grads) -> int:
    """Bytes one rank hands the two all-reduces of one
    `compressed_allreduce` call: a 4-byte scale and a 4-byte int32 element
    for each gradient element — as many as an f32 all-reduce's."""
    return sum(4 + 4 * g.numel() for g in tree_leaves(local_grads))
