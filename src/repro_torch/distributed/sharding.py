"""The fleet's device mesh: the package axis over devices, in one process
or across the ranks of a process group.

Port of the fleet half of `repro.distributed.sharding` (`FLEET_AXIS`,
`fleet_mesh`, `fleet_trace_spec`, `to_shardings`, `fleet_shard_map`).  The
reference's model half (parameter, batch and cache specs, activation
constraints) belongs to training on the mesh and is not here.

In one process a mesh is an ordered tuple of `torch.device`s, and a tensor
partitioned over it is a `Sharded`: contiguous, equal package spans, span
``i`` on mesh position ``i``.  A *pspec* is a tree congruent with the value
it describes (a `SchedulerState`, a `SchedulerOutput`, a trace) whose
leaves name each leaf's package dimension — an ``int`` — or ``None`` for a
shared leaf, which stays whole and is the same object on every partition
(the fleet's host clocks ``step`` and ``ptr``).

  * `place` (the counterpart of ``device_put(x, to_shardings(mesh, spec))``)
    splits a tree into partitions, each on its own device, and re-places an
    already partitioned tree onto another mesh without gathering it;
  * `fleet_shard_map` applies a function to each partition on its own
    device (inside ``torch.cuda.device`` there, so each launch goes to that
    card's current stream) and reassembles the outputs by their pspecs; a
    shared output must come back equal from every partition;
  * `gather` concatenates partitions onto one device — the engine's
    telemetry reductions, which cross lanes, run on the gathered traces.

The reference's tests emulate a many-device host with an XLA flag.  Here
the same is one explicit argument: ``fleet_mesh(n, devices=...)`` with a
pool whose entries repeat one device (``[torch.device("cpu")] * 4`` in the
tests, ``[torch.device("cuda:0")] * 4`` on one card).

Across processes (`repro_torch.distributed.multihost`) the mesh is a
`ProcessMesh`: this rank's devices, plus the rank that owns each partition
of the global mesh (the ranks' local meshes in rank order).  A leaf
partitioned over it holds only this rank's partitions, but its ``shape``
and ``spans()`` are global.  Nothing here crosses processes: `gather` of
such a leaf refuses unless asked for this rank's lanes (``local=True``),
and `multihost.assemble` gathers it from every rank in one collective.
"""
from __future__ import annotations

import contextlib

import torch

FLEET_AXIS = "packages"


def as_device(d) -> torch.device:
    """``d`` as a `torch.device` with its index (``cuda`` → the current
    card), so that two names of one device compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def fleet_mesh(n_devices: int | None = None,
               devices=None) -> tuple[torch.device, ...]:
    """1-D mesh over the fleet's package axis: the first ``n_devices`` of
    ``devices`` (default: every visible CUDA device, ``cuda:0`` first).

    ``n_devices`` of None or 0 takes the whole pool (the CLI's
    ``--fleet-devices 0``); a request larger than the pool clamps to it.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "fleet_mesh: no CUDA device is visible; pass devices=... "
                "(e.g. [torch.device('cpu')]) to build a mesh on the host")
        pool = tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    else:
        pool = tuple(as_device(d) for d in devices)
    if not pool:
        raise ValueError("fleet_mesh: the device pool is empty")
    n = len(pool) if not n_devices else max(1, min(int(n_devices), len(pool)))
    return pool[:n]


def fleet_trace_spec(ndim: int, axis: str | None = FLEET_AXIS,
                     package_dim: int = 0) -> int | None:
    """The pspec of a density trace: its package dimension (``package_dim``:
    0 for [n, tiles] chunks, 1 for [T, n, tiles], 2 for pre-chunked
    [C, K, n, tiles] — the package axis sits just before the tile axis), or
    None (replicated) when ``axis`` is None."""
    if not 0 <= package_dim < ndim:
        raise ValueError(f"package_dim {package_dim} outside a {ndim}-d "
                         f"trace")
    return package_dim if axis is not None else None


def spans(n: int, parts: int) -> list[tuple[int, int]]:
    """``parts`` contiguous, equal package spans of ``n`` packages."""
    if n % parts:
        raise ValueError(f"{n} packages do not split into {parts} equal "
                         f"partitions")
    size = n // parts
    return [(i * size, (i + 1) * size) for i in range(parts)]


class ProcessMesh(tuple):
    """A mesh spanning the ranks of a process group: this rank's devices
    (the tuple's entries, one per local partition), ``owners`` — the rank
    owning each partition of the global mesh, in global order — and this
    rank's ``rank``.  Its partitions are contiguous in the global mesh."""

    def __new__(cls, devices, owners, rank: int):
        self = super().__new__(cls, (as_device(d) for d in devices))
        self.owners, self.rank = tuple(int(o) for o in owners), int(rank)
        mine = [i for i, o in enumerate(self.owners) if o == self.rank]
        if len(mine) != len(self) or (
                mine and mine != list(range(mine[0], mine[-1] + 1))):
            raise ValueError(f"rank {rank} owns partitions {mine} of the "
                             f"global mesh {self.owners}, not its {len(self)}"
                             f" devices in one contiguous run")
        return self

    @property
    def size(self) -> int:
        """Partitions of the global mesh."""
        return len(self.owners)

    @property
    def first(self) -> int:
        """The global index of this rank's first partition."""
        return self.owners.index(self.rank)

    def __eq__(self, other) -> bool:
        return (isinstance(other, ProcessMesh) and tuple.__eq__(self, other)
                and (self.owners, self.rank) == (other.owners, other.rank))

    def __ne__(self, other) -> bool:
        return not self == other

    def __hash__(self) -> int:
        return hash((tuple(self), self.owners, self.rank))

    def __repr__(self) -> str:
        return (f"ProcessMesh(rank {self.rank}: {[str(d) for d in self]}, "
                f"owners={list(self.owners)})")


def mesh_spans(n: int, mesh) -> list[tuple[int, int]]:
    """The global package spans of ``mesh``'s own partitions, one per
    device of ``mesh``: every span of a one-process mesh, this rank's of a
    `ProcessMesh`."""
    if isinstance(mesh, ProcessMesh):
        return spans(n, mesh.size)[mesh.first:mesh.first + len(mesh)]
    return spans(n, len(mesh))


def on_device(device: torch.device):
    """Make ``device`` the current CUDA device inside the block (a no-op
    context for the CPU)."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def to_device(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``: unchanged where it already is; a host tensor
    staged in pinned memory and copied asynchronously onto a card."""
    if x.device == device:
        return x
    if x.device.type == "cpu" and device.type == "cuda":
        return x.contiguous().pin_memory().to(device, non_blocking=True)
    return x.to(device, non_blocking=True)


class Sharded:
    """A tensor partitioned over a fleet mesh along its package dimension
    ``dim``: ``parts[i]`` holds packages ``spans()[i]`` on ``mesh[i]``.
    Over a `ProcessMesh` (``mesh=``) the parts are this rank's partitions
    of equal size, and ``shape`` and ``spans()`` are global.

    Only what the fleet's code paths read is offered: the global ``shape``
    and ``ndim``, and indexing/iteration over a leading axis that
    is not the package axis (a trace's time axis), which yields the
    partitioned step."""

    __slots__ = ("parts", "dim", "pmesh")

    def __init__(self, parts, dim: int, mesh=None):
        self.parts = tuple(parts)
        self.dim = int(dim)
        self.pmesh = mesh if isinstance(mesh, ProcessMesh) else None
        if not self.parts:
            raise ValueError("Sharded needs at least one partition")

    @property
    def shape(self) -> torch.Size:
        s = list(self.parts[0].shape)
        if self.pmesh is None:
            s[self.dim] = sum(p.shape[self.dim] for p in self.parts)
        else:
            s[self.dim] *= self.pmesh.size
        return torch.Size(s)

    @property
    def ndim(self) -> int:
        return self.parts[0].ndim

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    @property
    def mesh(self) -> tuple[torch.device, ...]:
        if self.pmesh is not None:
            return self.pmesh
        return tuple(p.device for p in self.parts)

    def spans(self) -> list[tuple[int, int]]:
        """The global package span of each part."""
        out = []
        lo = (0 if self.pmesh is None
              else self.pmesh.first * self.parts[0].shape[self.dim])
        for p in self.parts:
            out.append((lo, lo + p.shape[self.dim]))
            lo += p.shape[self.dim]
        return out

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, k):
        if self.dim == 0:
            raise IndexError("Sharded: index the package axis through "
                             "lane_at, not []")
        if isinstance(k, slice):
            return Sharded([p[k] for p in self.parts], self.dim, self.pmesh)
        return Sharded([p[k] for p in self.parts], self.dim - 1, self.pmesh)

    def __iter__(self):
        for k in range(len(self)):
            yield self[k]

    def __repr__(self) -> str:
        return (f"Sharded(shape={tuple(self.shape)}, dim={self.dim}, "
                f"mesh={[str(d) for d in self.mesh]})")


def _is_nt(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree, spec):
    """(children of ``tree``, the congruent specs): an int / None spec
    covers the whole subtree."""
    if isinstance(spec, tuple):
        return zip(tree, spec)
    return ((c, spec) for c in tree)


def _rebuild(tree, children):
    return type(tree)(*children) if _is_nt(tree) else tuple(children)


def _map(fn, tree, spec):
    """``fn(leaf, leaf_spec)`` over a tree of tensors (NamedTuples and
    tuples descended; None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return _rebuild(tree, [_map(fn, c, s) for c, s in
                               _children(tree, spec)])
    return fn(tree, spec)


def _leaves(tree):
    if tree is None:
        return
    if isinstance(tree, tuple):
        for c in tree:
            yield from _leaves(c)
    else:
        yield tree


def is_sharded(tree) -> bool:
    return any(isinstance(x, Sharded) for x in _leaves(tree))


def mesh_of(tree) -> tuple[torch.device, ...] | None:
    """The mesh of the first partitioned leaf of ``tree`` (None: whole)."""
    for x in _leaves(tree):
        if isinstance(x, Sharded):
            return x.mesh
    return None


def _take(x: Sharded, lo: int, hi: int, device) -> torch.Tensor:
    """Packages [lo, hi) of ``x`` as one tensor on ``device``, from the
    partitions that hold them (no gather of the rest); lanes that another
    rank holds raise."""
    pieces, got = [], 0
    for p, (a, b) in zip(x.parts, x.spans()):
        s, e = max(a, lo), min(b, hi)
        if s < e:
            pieces.append(to_device(p.narrow(x.dim, s - a, e - s), device))
            got += e - s
    if got != hi - lo:
        raise ValueError(f"packages [{lo}, {hi}) are not all on this rank "
                         f"(it holds {x.spans()}): moving lanes between "
                         f"processes is not supported")
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, x.dim)


def place(tree, mesh, specs):
    """``tree`` partitioned over ``mesh`` by its pspecs: a whole leaf is
    split into equal package spans, a partitioned one re-placed span by
    span (the counterpart of ``device_put`` under `to_shardings`); shared
    leaves stay whole.  Over a `ProcessMesh` a whole leaf is the global one
    and this rank keeps its own spans."""
    if not isinstance(mesh, ProcessMesh):
        mesh = tuple(mesh)

    def leaf(x, dim):
        if dim is None:
            return x
        if not (torch.is_tensor(x) or isinstance(x, Sharded)):
            raise TypeError(f"place: a partitioned leaf must be a tensor, "
                            f"got {type(x).__name__}")
        return Sharded([_take(x, lo, hi, dev) if isinstance(x, Sharded)
                        else to_device(x.narrow(dim, lo, hi - lo), dev)
                        for (lo, hi), dev in zip(
                            mesh_spans(x.shape[dim], mesh), mesh)], dim, mesh)
    return _map(leaf, tree, specs)


def _cat(parts, dim: int) -> torch.Tensor:
    """``parts`` concatenated along ``dim`` in the memory layout they share:
    partitions of a permuted output (the fused kernel's [T, n, tiles] views
    of [T, tiles, n] planes) give the whole fleet's output in the same
    layout, so reductions over it run in the single-device order."""
    p0 = parts[0]
    # outermost first; a size-1 dim (a one-package partition) has no
    # stride of its own and goes inside its ties
    order = sorted(range(p0.ndim),
                   key=lambda k: (-p0.stride(k), p0.shape[k] == 1))
    if order == sorted(order) or not all(
            p.permute(order).is_contiguous() for p in parts):
        return torch.cat(parts, dim)
    whole = torch.cat([p.permute(order) for p in parts], order.index(dim))
    return whole.permute([order.index(k) for k in range(p0.ndim)])


def gather(tree, device=None, local: bool = False):
    """``tree`` with every partitioned leaf concatenated onto ``device``
    (default: the mesh's first device); whole leaves pass through.

    A leaf partitioned across processes is whole on no rank: it raises,
    unless ``local`` asks for this rank's lanes (its parts concatenated).
    `multihost.assemble` gathers it from every rank (a collective)."""
    def leaf(x, _):
        if not isinstance(x, Sharded):
            return x
        if x.pmesh is not None and not local:
            raise ValueError(
                "gather: this leaf is partitioned across processes; "
                "multihost.assemble gathers it from every rank (a "
                "collective), gather(..., local=True) gives this rank's "
                "lanes")
        dev = x.device if device is None else as_device(device)
        if len(x.parts) == 1:
            return to_device(x.parts[0], dev)
        return _cat([to_device(p, dev) for p in x.parts], x.dim)
    return _map(leaf, tree, None)


def lane_at(x, lane: int) -> tuple[torch.Tensor, int]:
    """(the tensor holding package ``lane`` of ``x``, its index there): the
    owning partition and the lane's local index, or ``x`` itself.  A lane
    another rank holds raises IndexError."""
    if not isinstance(x, Sharded):
        return x, lane
    if x.dim != 0:
        raise ValueError("lane_at: the package axis must lead")
    for p, (lo, hi) in zip(x.parts, x.spans()):
        if lo <= lane < hi:
            return p, lane - lo
    raise IndexError(f"lane {lane} is not held here (spans {x.spans()} of "
                     f"[0, {x.shape[0]}))")


def _partition(tree, spec, i: int, mesh, n: int | None):
    """Partition ``i`` of ``tree``: a `Sharded` leaf's part (taken span by
    span from its own partitions where it lies on another mesh — a chunk
    placed for the backend's mesh beside a resharded state), a whole leaf
    with a package spec narrowed to span ``i`` on ``mesh[i]``, anything
    else as it is."""
    def leaf(x, dim):
        if isinstance(x, Sharded):
            if x.mesh == mesh:
                return x.parts[i]
            lo, hi = mesh_spans(x.shape[x.dim], mesh)[i]
            return _take(x, lo, hi, mesh[i])
        if dim is None or not torch.is_tensor(x):
            return x
        if n is not None and x.shape[dim] != n:
            raise ValueError(f"a whole leaf of {x.shape[dim]} packages "
                             f"beside a fleet of {n}")
        lo, hi = mesh_spans(x.shape[dim], mesh)[i]
        return to_device(x.narrow(dim, lo, hi - lo), mesh[i])
    return _map(leaf, tree, spec)


def join(outs: list, spec, mesh=None):
    """Per-partition outputs reassembled by ``spec``: a package leaf as a
    `Sharded` (over ``mesh`` when that is a `ProcessMesh`), a shared leaf
    from partition 0 after checking that every partition returned the same
    value where that costs no device read (host tensors and numbers)."""
    o0 = outs[0]
    if o0 is None:
        return None
    if isinstance(o0, tuple):
        specs = spec if isinstance(spec, tuple) else (spec,) * len(o0)
        return _rebuild(o0, [join([o[k] for o in outs], s, mesh)
                             for k, s in enumerate(specs)])
    if spec is None:
        for o in outs[1:]:
            if torch.is_tensor(o) and o.device.type != "cpu":
                continue                     # comparing would read the card
            if not (torch.equal(o, o0) if torch.is_tensor(o) else o == o0):
                raise RuntimeError(
                    f"a shared leaf differs across partitions: {o} vs {o0}")
        return o0
    return Sharded(outs, spec, mesh)


def fleet_shard_map(f, mesh, in_specs, out_specs):
    """``f`` applied to each package partition on its own device.

    The returned function takes arguments partitioned over ``mesh``
    (`Sharded` leaves) or whole (split into ``mesh``'s spans on the fly) and
    returns ``f``'s outputs reassembled by ``out_specs``.  ``mesh`` None
    returns ``f`` itself: a whole fleet on one device.  The partitions are
    launched one after the other with no host synchronisation between
    them.  Over a `ProcessMesh` each rank maps its own partitions: no
    operation crosses processes."""
    if mesh is None:
        return f
    if not isinstance(mesh, ProcessMesh):
        mesh = tuple(mesh)

    def mapped(*args):
        n = next((x.shape[x.dim] for x in _leaves(args)
                  if isinstance(x, Sharded)), None)
        outs = []
        for i, dev in enumerate(mesh):
            part = [_partition(a, s, i, mesh, n)
                    for a, s in zip(args, in_specs)]
            with on_device(dev):
                outs.append(f(*part))
        return join(outs, out_specs, mesh)
    return mapped
