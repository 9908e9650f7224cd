"""Device meshes for training on many devices: the production meshes and
small test meshes.

Port of `repro.launch.mesh`.  A mesh is a
`torch.distributed.device_mesh.DeviceMesh` with named dimensions over the
ranks of the current process group — the counterpart of ``jax.make_mesh``.
Building one is a collective: every rank of the group calls the same
function with the same arguments.  The meshes live on the card unless the
caller asks for the CPU (``device_type="cpu"``, as the tests do).

`MeshShape` is the counterpart of ``jax.sharding.AbstractMesh``: axis names
and sizes with no devices behind them.  The spec functions of
`repro_torch.distributed.sharding` take it or a `DeviceMesh` alike, so a
spec can be asked for the production meshes without a process group.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist


class MeshShape(NamedTuple):
    """Axis ``names`` and their ``sizes``, major axis first."""
    sizes: tuple[int, ...]
    names: tuple[str, ...]

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_mesh_compat(shape, axes, device_type: str | None = None):
    """A `DeviceMesh` of ``shape`` named ``axes`` over the first
    prod(shape) ranks of the process group, in rank order (row-major).

    Every rank of the group must call it; a rank outside the mesh gets a
    mesh on which it has no coordinate.  ``device_type`` is "cuda" unless
    given.  A card's mesh over gloo routes the functional all-gather
    through c10d (`sharding.route_cuda_all_gather`).
    """
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axis names {axes} differ "
                         f"in length")
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n > world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                         f"ranks, the process group has {world}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh_compat: no process group; call "
                           "repro_torch.distributed.multihost.initialize "
                           "first")
    device_type = device_type or "cuda"
    if device_type == "cuda" and dist.get_backend() == "gloo":
        from repro_torch.distributed.sharding import route_cuda_all_gather
        route_cuda_all_gather()
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def production_shape(multi_pod: bool = False) -> MeshShape:
    """16×16 (data, model) or 2×16×16 (pod, data, model)."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """The 16×16 single-pod (256 ranks) or 2×16×16 two-pod (512 ranks)
    mesh.  The process group must have exactly that many ranks."""
    want = production_shape(multi_pod)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != want.size:
        raise ValueError(f"the {'x'.join(map(str, want.sizes))} production "
                         f"mesh needs a process group of {want.size} ranks, "
                         f"got {world}")
    return make_mesh_compat(want.sizes, want.names, device_type)


def make_test_mesh(data: int = 2, model: int = 4, pod: int = 0,
                   device_type: str | None = None):
    """A small (data, model) or (pod, data, model) mesh for tests."""
    if pod:
        return make_mesh_compat((pod, data, model), ("pod", "data", "model"),
                                device_type)
    return make_mesh_compat((data, model), ("data", "model"), device_type)
