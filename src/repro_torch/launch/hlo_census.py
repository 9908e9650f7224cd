"""Collective census of one step, recorded as its ops are dispatched.

Port of `repro.launch.hlo_census`, whose name it keeps so a reader finds
the counterpart.  There is no HLO in the port: PyTorch runs eagerly, so
instead of parsing a compiled module this records the collectives as they
are dispatched, with a ``TorchDispatchMode`` that sees the functional
collectives (``_c10d_functional.*``, DTensor's) and the c10d ones
(``c10d.*``: ``torch.distributed.all_reduce`` and friends), on real or
fake tensors.

The result is the reference's dict — ``{"by_kind": {kind: bytes}, "ops":
[{"kind", "bytes", "mult", "comp"}], "total_bytes"}`` — plus ``"counts"``
(collectives by kind), ``"op_kinds"`` (every op dispatched, by name:
the stand-in for the reference's HLO op list) and ``"kernels"`` (each of
the port's kernel ops, ``repro_torch::*``, with the distinct argument
signatures it met: a tensor as [shape, dtype]).  Kinds use the reference's
spelling; bytes are the output payload a rank, as the reference reads an
instruction's result shape; ``mult`` is 1, since nothing is scanned (an
eager loop dispatches each iteration), ``comp`` names the op, and each op
also keeps its outputs' local ``shape``s.

Counting rules:

  * an op with a DTensor argument is handed back to DTensor first, so the
    census sees the local ops and collectives DTensor issues for it, and
    not the global-shape ops DTensor runs in a fake mode of its own to
    work out placements (`in_propagation`);
  * a collective issued while another is being dispatched counts once,
    as the outer one (a mode is not active inside its own dispatch): the
    all-gather a card's gloo mesh routes through c10d
    (`sharding.route_cuda_all_gather`), or a c10d op inside a functional
    one.
"""
from __future__ import annotations

import collections

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# op name (no namespace, no overload) → kind
_KIND = {
    # _c10d_functional (DTensor, funcol)
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    # c10d (torch.distributed's own calls)
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "c10d")


def in_propagation() -> bool:
    """Whether a fake mode is active inside the dispatch: DTensor works
    out an op's output placement by running it on global-shape fake
    tensors in a mode of its own.  Those ops are bookkeeping, not the
    step's (the step's fake tensors carry their mode; none is active)."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def collective_kind(func) -> str | None:
    """The reference's kind of a collective op overload, else None."""
    ns = getattr(func, "namespace", None)
    if ns not in _NAMESPACES:
        return None
    return _KIND.get(func._schema.name.split("::")[-1])


def _tensors(x) -> list:
    return [t for t in torch.utils._pytree.tree_leaves(x)
            if isinstance(t, torch.Tensor)]


def _outputs(func, args, kwargs, out) -> list:
    """The output tensors of one collective on this rank: a functional
    op's result, a c10d op's tensors written in place (its schema's
    mutable arguments)."""
    if func.namespace == "_c10d_functional":
        outs = _tensors(out)
    else:
        schema = func._schema
        bound = dict(zip((a.name for a in schema.arguments), args))
        bound.update(kwargs)
        outs = _tensors([bound[a.name] for a in schema.arguments
                         if a.alias_info is not None
                         and a.alias_info.is_write and a.name in bound])
    return outs


class Census(TorchDispatchMode):
    """Records every collective (and every op, by name) dispatched while
    it is active; `result` gives the reference's dict."""

    def __init__(self):
        super().__init__()
        self.ops: list[dict] = []
        self.op_kinds: collections.Counter = collections.Counter()
        self.kernels: dict[str, list] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if in_propagation():
            return out
        name = str(func.overloadpacket)
        self.op_kinds[name] += 1
        if func.namespace == "repro_torch":
            sig = [[list(a.shape), str(a.dtype).split(".")[-1]]
                   if isinstance(a, torch.Tensor) else a for a in args]
            calls = self.kernels.setdefault(name, [])
            if sig not in calls:
                calls.append(sig)
        kind = collective_kind(func)
        if kind is not None:
            outs = _outputs(func, args, kwargs, out)
            self.ops.append({
                "kind": kind, "mult": 1, "comp": name,
                "bytes": sum(t.numel() * t.element_size() for t in outs),
                "shape": [list(t.shape) for t in outs]})
        return out

    def result(self) -> dict:
        by_kind: dict[str, int] = collections.defaultdict(int)
        counts: dict[str, int] = collections.defaultdict(int)
        for op in self.ops:
            by_kind[op["kind"]] += op["bytes"] * op["mult"]
            counts[op["kind"]] += 1
        return {"by_kind": dict(by_kind), "ops": list(self.ops),
                "total_bytes": int(sum(by_kind.values())),
                "counts": dict(counts), "op_kinds": dict(self.op_kinds),
                "kernels": dict(self.kernels)}

