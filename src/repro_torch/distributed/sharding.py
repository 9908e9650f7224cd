"""Sharding: the fleet's device mesh, and the model's specs on a
(pod, data, model) mesh.

Port of `repro.distributed.sharding`, both halves, kept apart under
distinct names in this file:

  * the fleet half (`FLEET_AXIS`, `fleet_mesh`, `fleet_trace_spec`,
    `place`, `fleet_shard_map`, `gather`): the package axis over devices,
    in one process or across the ranks of a process group.  Its *pspec*
    names one int package dimension per leaf (below);
  * the model half (`param_specs`, `batch_spec`, `state_specs`,
    `cache_specs`, `to_shardings`, `distribute`, `full`, `axis_env`,
    `constrain`, `constrain_heads`, and the kernels' and the LM head's
    local routes): training and serving on a mesh of named axes, whose
    spec is a `PartitionSpec` — see "The model's mesh" further down.

In one process a mesh is an ordered tuple of `torch.device`s, and a tensor
partitioned over it is a `Sharded`: contiguous, equal package spans, span
``i`` on mesh position ``i``.  A *pspec* is a tree congruent with the value
it describes (a `SchedulerState`, a `SchedulerOutput`, a trace) whose
leaves name each leaf's package dimension — an ``int`` — or ``None`` for a
shared leaf, which stays whole and is the same object on every partition
(the fleet's host clocks ``step`` and ``ptr``).

  * `place` (the counterpart of ``device_put`` onto the package mesh)
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
import dataclasses
import sys

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
    span (the counterpart of ``device_put`` onto the package mesh); shared
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


# =========================================================== the model's mesh
# Port of the reference's model half (its lines 33–186 and 247–318).  The
# mesh is a `torch.distributed.device_mesh.DeviceMesh` with named axes
# (`repro_torch.launch.mesh`), or a `MeshShape` where only the names and
# sizes matter.  A tensor placed on it is a
# `torch.distributed.tensor.DTensor`, the counterpart of an array under a
# `NamedSharding`:
#
#   device_put(x, NamedSharding(mesh, spec))  ↔  `distribute` (every rank
#       draws the same full value and keeps its own slice: nothing crosses
#       the wire);
#   a spec entry naming axes                  ↔  ``Shard(dim)`` on each of
#       those mesh axes (a tuple ("pod", "data"): both, major axis first);
#   None, or an axis the spec does not name   ↔  ``Replicate()``;
#   with_sharding_constraint                  ↔  ``DTensor.redistribute``.
#
# Parallelism map, as the reference's: DP — the batch over ("pod",
# "data"); TP — the "model" axis over attention heads and projections, MLP
# width and the vocabulary; EP — the routed experts over "model" when
# n_experts % model == 0 (else TP inside each expert's FFN); FSDP — weights
# and optimizer state over "data" on a second dim above FSDP_THRESHOLD
# parameters or in the EP-only mode.  Specs shard only dims the axes
# divide; a helper downgrades the rest to replicated.
#
# The model code runs unchanged on DTensors: its ops propagate placements,
# and `constrain` / `constrain_heads` pin the activations the reference
# pins.  Where GSPMD lays tensors out by itself, the port says so: a block
# gathers its FSDP weights (`gather_dp`), the residual stream settles its
# partial sums both ways after each add (`settle`), a projection is split
# into heads only where its shards allow it (`split_heads`).  The
# hand-written kernels launch through ``ctypes`` on a tensor's
# ``data_ptr()``, which a DTensor does not have, so `local_attention` and
# `local_ssd` run them on each rank's local shard (``local_map``); the
# embedding lookup and the LM head's cross entropy run vocab-parallel
# (`vocab_parallel_embedding`, `vocab_parallel_nll`).

# Parameter count above which FSDP weight sharding turns on.
FSDP_THRESHOLD = 20e9


class PartitionSpec(tuple):
    """One entry per tensor dim: None, an axis name or a tuple of names,
    normalised as ``jax.sharding.PartitionSpec`` normalises them (a
    one-name tuple is the name, an empty one None), so that a spec equals
    ``tuple()`` of the reference's."""

    def __new__(cls, *entries):
        def norm(ax):
            if isinstance(ax, (tuple, list)):
                ax = tuple(ax)
                return None if not ax else ax[0] if len(ax) == 1 else ax
            return ax
        return super().__new__(cls, (norm(a) for a in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size}, major axis first, of a `DeviceMesh` or a
    `MeshShape`."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(zip(mesh.names, mesh.sizes))


def dp_axes(mesh) -> tuple:
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def use_fsdp(cfg) -> bool:
    return cfg.param_count() > FSDP_THRESHOLD


def _axes(ax) -> tuple:
    return () if ax is None else ax if isinstance(ax, tuple) else (ax,)


def _div(n: int, sizes: dict, axis) -> bool:
    size = 1
    for a in _axes(axis):
        size *= sizes[a]
    return n % size == 0


def _spec(sizes: dict, shape, *axes) -> PartitionSpec:
    """A spec with the per-dim divisibility downgrade."""
    return P(*(ax if _div(dim, sizes, ax) else None
               for dim, ax in zip(shape, axes)))


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, NamedTuples, lists and
    tuples; ``path`` holds the dict keys and indices down to the leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if _is_nt(tree):
        return type(tree)(*(map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _zip_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree`` and the congruent spec tree (a
    spec covers the one leaf at its place)."""
    if _is_spec(specs) or tree is None:
        return None if tree is None else fn(tree, specs)
    if isinstance(specs, dict):
        return {k: _zip_specs(fn, tree[k], specs[k]) for k in tree}
    if _is_nt(tree):
        return type(tree)(*(_zip_specs(fn, t, s)
                            for t, s in zip(tree, specs)))
    return type(tree)(_zip_specs(fn, t, s) for t, s in zip(tree, specs))


def param_specs(cfg, params, mesh, *, tp_attention: bool = True):
    """Spec tree congruent with ``params`` (tensors, or fake tensors that
    hold no memory: only shapes are read).

    ``tp_attention=False`` is the EP-only mode: the "model" axis shards
    only the expert weights; attention, MLP and embedding weights shard
    over the FSDP ("data") axis and replicate over "model".
    """
    sizes = axis_sizes(mesh)
    fsdp = "data" if ((use_fsdp(cfg) or not tp_attention)
                      and "data" in sizes) else None
    ep = cfg.is_moe and cfg.n_experts % sizes["model"] == 0
    tp_ax = "model" if tp_attention else None
    out_sharded = ("wq", "wk", "wv", "wg", "wr", "w_up", "w_gate",
                   "ws_up", "ws_gate", "in_proj", "ck", "w_uk", "w_uv")
    in_sharded = ("wo", "w_down", "ws_down", "out_proj", "cv")

    def leaf(path, x) -> PartitionSpec:
        name = path[-1] if path else ""
        shape = tuple(x.shape)
        nd = len(shape)
        if nd <= 1:
            return P()                               # norms, biases
        if name == "embed":
            return _spec(sizes, shape, tp_ax, fsdp)
        if name == "lm_head":
            return _spec(sizes, shape, fsdp, tp_ax)
        if isinstance(name, str) and name.startswith("we_"):
            if ep:                                   # [L, E, D, F]
                ax = [None] * (nd - 3) + ["model", fsdp, None]
            elif name == "we_down":
                ax = [None] * (nd - 3) + [None, "model", fsdp]
            else:
                ax = [None] * (nd - 3) + [None, fsdp, "model"]
            return _spec(sizes, shape, *ax)
        if name in out_sharded:
            return _spec(sizes, shape, *([None] * (nd - 2) + [fsdp, tp_ax]))
        if name in in_sharded:
            return _spec(sizes, shape, *([None] * (nd - 2) + [tp_ax, fsdp]))
        return P()                 # router, w_dkv, bcdt_proj, conv_w, ...

    return map_with_path(leaf, params)


def batch_spec(mesh, ndim: int = 2, batch: int | None = None
               ) -> PartitionSpec:
    """tokens / labels [B, S(, D)]: the batch over the DP axes, or
    replicated when ``batch`` is given and the DP axes do not divide it
    (a batch-1 long-context cell shards its state instead)."""
    dp = dp_axes(mesh)
    if batch is not None and dp:
        sizes = axis_sizes(mesh)
        n = 1
        for a in dp:
            n *= sizes[a]
        if batch % n:
            return P(*([None] * ndim))
    return P(dp, *([None] * (ndim - 1)))


def state_specs(cfg, opt_state, params_specs):
    """Optimizer state inherits the parameter specs (m, v congruent)."""
    from repro_torch.optim.adamw import AdamWState
    return AdamWState(m=params_specs, v=params_specs, count=P())


def cache_specs(cfg, cache, mesh):
    """Decode-cache specs: the batch over the DP axes, heads or latent over
    "model" (a head count "model" does not divide shards head_dim)."""
    sizes = axis_sizes(mesh)
    dp = dp_axes(mesh)

    def leaf(path, x) -> PartitionSpec:
        name = path[-1] if path else ""
        shape = tuple(x.shape)
        if name in ("k", "v", "ks", "vs"):          # [L, B, S, KV, dh|1]
            sp = _spec(sizes, shape, None, dp, None, "model", None)
            if sp[3] is None:
                sp = _spec(sizes, shape, None, dp, None, None, "model")
            return sp
        if name == "c":                             # MLA latent [L, B, S, r]
            return _spec(sizes, shape, None, dp, None, "model")
        if name == "kr":
            return _spec(sizes, shape, None, dp, None, None)
        if name == "pos":
            return _spec(sizes, shape, None, dp, None)
        if name == "h":                             # [L, B, H, N, P]
            return _spec(sizes, shape, None, dp, "model", None, None)
        if name == "conv":                          # [L, B, 3, di]
            return _spec(sizes, shape, None, dp, None, "model")
        if name in ("prev_t", "prev_c"):            # [L, B, 1, D]
            return _spec(sizes, shape, None, dp, None, None)
        return P()

    return map_with_path(leaf, cache)


def placements(mesh, spec) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: one per mesh axis,
    ``Shard(dim)`` where the spec names the axis at ``dim``, else
    ``Replicate()``.  A tuple entry must list its axes in the mesh's order
    (major first), the order DTensor splits them in."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        idx = [names.index(a) for a in _axes(ax)]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes {ax} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec} names axis {names[i]} twice")
            out[i] = Shard(dim)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``
    (`restore`'s ``shardings``); a leaf of a tree, as the reference's is."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> list:
        return placements(self.mesh, self.spec)


def new_placed(like, shape, dtype, mesh, spec, value):
    """A DTensor of global ``shape`` placed on ``mesh`` by ``spec``, every
    element ``value``: each rank makes only its own shard, with
    ``like.new_full`` (``like`` a local tensor: its device, and a fake
    tensor's mode in the dry run).  The spec's shards must divide their
    dims, as the spec functions' do."""
    from torch.distributed.tensor import DTensor

    pls = placements(mesh, spec)
    local = list(shape)
    for i, p in enumerate(pls):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    t = like.new_full(local, value, dtype=dtype)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(t, mesh, pls, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def to_shardings(mesh, specs):
    """A spec tree as a congruent tree of `NamedSharding`s on ``mesh``."""
    return _zip_specs(lambda _, s: NamedSharding(mesh, s), specs, specs)


def distribute_leaf(x, mesh, pls):
    """One tensor as a DTensor with placements ``pls`` on ``mesh``;
    every rank passes the same full value and keeps its own slice (no
    collective), in storage of its own: a slice that is a view of the
    full value is copied, so the full value is freed with the caller's
    last reference.  A DTensor is redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if is_distributed(x):
        return x.redistribute(mesh, pls)
    d = distribute_tensor(x, mesh, pls, src_data_rank=None)
    local = d.to_local()
    if local.untyped_storage().nbytes() > local.numel() * local.element_size():
        d = DTensor.from_local(local.clone(), mesh, d.placements,
                               run_check=False, shape=d.shape,
                               stride=d.stride())
    return d


def distribute(tree, mesh, specs):
    """``tree``'s tensor leaves as DTensors placed on ``mesh`` by the
    congruent ``specs`` (the counterpart of ``device_put`` under
    `to_shardings`); every rank passes the same full values."""
    def leaf(x, spec):
        if not torch.is_tensor(x):
            return x
        return distribute_leaf(x, mesh, placements(mesh, spec))
    return _zip_specs(leaf, tree, specs)


def is_distributed(x) -> bool:
    """Whether ``x`` is a DTensor (a tensor placed on a mesh).  No DTensor
    exists before `torch.distributed.tensor` is imported, so this looks
    the class up in ``sys.modules`` and never imports the module itself;
    the model half's other functions import it only once they have met a
    DTensor."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def full(tree):
    """``tree`` with every DTensor leaf gathered whole on every rank
    (``full_tensor``, a collective); other leaves as they are."""
    def leaf(_, x):
        return x.full_tensor() if is_distributed(x) else x
    return map_with_path(leaf, tree)


def replicate(x):
    """A DTensor redistributed to ``Replicate()`` on every mesh axis
    (partial sums reduced); anything else as it is."""
    if not is_distributed(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def _settled(x):
    if not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


class _SettleGrad(torch.autograd.Function):
    """The identity, whose backward reduces its gradient's partial sums."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _settled(g)


def settle(x):
    """A DTensor with its pending partial sums reduced (``Partial`` →
    ``Replicate``; its shards kept), and its gradient's likewise in the
    backward; anything else as it is.  The residual stream passes through
    it after each add — Megatron's pair of all-reduces, one each way: a
    partial sum left pending there makes DTensor gather the next matmul's
    weight, or scatter a gradient as wide as the MLP, instead."""
    if not is_distributed(x):
        return x
    return _SettleGrad.apply(_settled(x))


def gather_dp(tree):
    """``tree`` with every DTensor leaf's shards over the DP axes ("pod",
    "data": FSDP's) gathered, its "model" shards kept: the weights a
    layer computes with, each rank holding its batch shard.  Its gradient
    comes back reduced and scattered onto the shards.  A tree without
    DTensors as it is."""
    def leaf(_, x):
        if not is_distributed(x):
            return x
        from torch.distributed.tensor import Replicate
        names = x.device_mesh.mesh_dim_names
        pl = [Replicate() if (p.is_shard() and names[i] in ("pod", "data"))
              else p for i, p in enumerate(x.placements)]
        return x if pl == list(x.placements) else x.redistribute(
            x.device_mesh, pl)
    return map_with_path(leaf, tree)


def on_local(fn, *args):
    """``fn`` on the local values of replicated DTensor arguments (every
    rank holds the whole value), its tensor outputs placed back as
    replicated on the same mesh; with no DTensor among ``args``, ``fn(*
    args)``.  The path of state every rank keeps whole — the train
    state's thermal scheduler, whose kernels take plain tensors."""
    from repro_torch.checkpoint.manager import tree_leaves

    meshes = [x.device_mesh for x in tree_leaves(args) if is_distributed(x)]
    if not meshes:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate
    mesh = meshes[0]

    def down(_, x):
        if not is_distributed(x):
            return x
        if any(not p.is_replicate() for p in x.placements):
            raise ValueError(f"on_local: an argument is placed "
                             f"{x.placements}, not replicated")
        return x.to_local()

    def up(_, x):
        if not torch.is_tensor(x) or is_distributed(x):
            return x
        return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return map_with_path(up, fn(*map_with_path(down, args)))


# ------------------------------------------ gloo's all-gather on the card --
# Ranks that share one card cannot use NCCL (it refuses two ranks on one
# device), so the card's meshes run on gloo, which takes CUDA tensors.
# gloo runs every collective DTensor issues on them through the c10d API,
# but the functional all-gather (``_c10d_functional.all_gather_into_tensor``,
# DTensor's Shard → Replicate) crashes the process in its wait (torch
# 2.11 on the H100 machine, `scripts/collective_probe.py --ops`).  On such
# a mesh that one op is routed through c10d's own
# ``all_gather_into_tensor`` — the same gloo collective, synchronous — and
# counted in ``CUDA_GATHERS`` (reported per step by `chip_smoke.py`).
CUDA_GATHERS = 0
_GATHER_LIB = None


def route_cuda_all_gather() -> None:
    """Route the functional all-gather of CUDA tensors through c10d's
    ``all_gather_into_tensor`` (see above); idempotent."""
    global _GATHER_LIB
    if _GATHER_LIB is not None:
        return
    import warnings

    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    def gather(inp, group_size: int, group_name: str):
        global CUDA_GATHERS
        CUDA_GATHERS += 1
        out = inp.new_empty((group_size * inp.shape[0], *inp.shape[1:]))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, inp.contiguous(),
                                        group=_resolve_process_group(
                                            group_name))
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        lib.impl("all_gather_into_tensor", gather, "CUDA")
    _GATHER_LIB = lib


# ------------------------------------------------- activation constraints --
# Model code runs unsharded (tests, one device) and on a mesh.
# `axis_env(mesh)` publishes the mesh's axis roles; `constrain(x, roles)`
# then pins an activation's placements.  Outside an `axis_env` both return
# their argument itself.  On a `DeviceMesh` the env also turns on
# DTensor's implicit replication: a plain tensor meeting a DTensor in an op
# (RoPE's tables, the position ids, a host scalar) counts as replicated, as
# an unannotated constant does under GSPMD.
_AXIS_ENV: dict | None = None


@contextlib.contextmanager
def axis_env(mesh, tp_activations: bool = True):
    """``tp_activations=False`` (the EP-only mode) turns off the "tp" role
    of attention and MLP activations; the "ep" role (expert tensors) keeps
    the model axis."""
    global _AXIS_ENV
    prev = _AXIS_ENV
    sizes = axis_sizes(mesh)
    _AXIS_ENV = {"dp": tuple(a for a in ("pod", "data") if a in sizes),
                 "tp": ("model" if "model" in sizes and tp_activations
                        else None),
                 "ep": "model" if "model" in sizes else None,
                 "sizes": sizes}
    if hasattr(mesh, "mesh_dim_names"):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        replication = implicit_replication()
    else:
        replication = contextlib.nullcontext()
    try:
        with replication:
            yield
    finally:
        _AXIS_ENV = prev


def _role_axes(role):
    env = _AXIS_ENV
    if role is None or env is None:
        return None, 1
    if role == "dp":
        axes = env["dp"]
        n = 1
        for a in axes:
            n *= env["sizes"][a]
        return (axes if axes else None), n
    if role in ("tp", "ep"):
        ax = env[role]
        return ax, env["sizes"].get("model", 1) if ax else 1
    raise ValueError(role)


def with_sharding_constraint(x, spec):
    """A DTensor redistributed to ``spec`` on its mesh; a plain tensor as
    it is (one device, or a `MeshShape` env).  On an axis of size 1 a
    shard and a replica are the same bytes, so there x keeps its own
    placement (a partial sum settled): DTensor picks its strategies by
    placement, and a tensor that changed only in name there would meet
    its neighbours under another one."""
    if not is_distributed(x):
        return x
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    pls = [(Replicate() if p.is_partial() else p) if mesh.size(i) == 1
           else want for i, (p, want) in enumerate(
               zip(x.placements, placements(mesh, spec)))]
    return x.redistribute(mesh, pls)


def split_heads(x, shape):
    """``x.reshape(shape)``, splitting x's last dim into the last two of
    ``shape`` (heads, head_dim).  On a mesh a shard of that dim whose axis
    does not divide the head count is gathered first: DTensor cannot
    split an unevenly sharded dim (GSPMD re-lays it out itself)."""
    if is_distributed(x):
        from torch.distributed.tensor import Replicate
        mesh, last = x.device_mesh, x.ndim - 1
        pl = [Replicate() if (p.is_shard() and p.dim == last
                              and shape[-2] % mesh.size(i)) else p
              for i, p in enumerate(x.placements)]
        if pl != list(x.placements):
            x = x.redistribute(mesh, pl)
    return x.reshape(shape)


def first_row(x):
    """``x[0]`` of a tensor whose rows are all equal (a decode cache's
    positions: every batch row is written at the same slot), as a plain
    tensor: on a mesh the local shard's first row, with no collective."""
    return (x.to_local() if is_distributed(x) else x)[0]


class _MergeHeads(torch.autograd.Function):
    """[..., H, dh] → [..., H·dh]; the gradient goes back through
    `split_heads`, which gathers a shard of the merged dim whose axis does
    not divide H (DTensor cannot unflatten it)."""

    @staticmethod
    def forward(ctx, x):
        ctx.shape = x.shape
        return x.reshape(*x.shape[:-2], -1)

    @staticmethod
    def backward(ctx, g):
        return split_heads(g, ctx.shape)


def merge_heads(x):
    """``x`` [..., H, dh] as [..., H·dh]: a reshape, whose gradient on a
    mesh is split by `split_heads`.  On a mesh a shard of dh (MQA, whose
    heads the axis does not divide) is gathered first: merged, it would be
    a strided shard of H·dh, for which DTensor plans every later
    redistribution by a search that takes minutes on a three-axis mesh."""
    if is_distributed(x):
        from torch.distributed.tensor import Replicate
        last = x.ndim - 1
        pl = [Replicate() if p.is_shard() and p.dim == last else p
              for p in x.placements]
        if pl != list(x.placements):
            x = x.redistribute(x.device_mesh, pl)
        return _MergeHeads.apply(x)
    return x.reshape(*x.shape[:-2], -1)


def constrain(x, roles):
    """Pin ``x``'s placements by a role per dim: None | "dp" | "tp" |
    "ep".  The identity outside an `axis_env`; a dim the role's axes do
    not divide stays replicated."""
    if _AXIS_ENV is None:
        return x
    spec = []
    for dim, role in zip(x.shape, roles):
        ax, n = _role_axes(role)
        spec.append(ax if (ax and dim % n == 0 and n > 1) else None)
    if all(s is None for s in spec):
        return x
    return with_sharding_constraint(x, P(*spec))


def constrain_heads(x):
    """[B, S|T, H, dh]: the heads over "tp" when it divides them, else
    head_dim (MQA)."""
    if _AXIS_ENV is None:
        return x
    _, n = _role_axes("tp")
    if n > 1 and x.shape[2] % n == 0:
        return constrain(x, ("dp", None, "tp", None))
    return constrain(x, ("dp", None, None, "tp"))


# ------------------------------------------- kernels on each rank's shard --
def _keep(pls, dims) -> list:
    """Placements with every ``Shard`` not on one of ``dims`` (and every
    partial sum) replaced by ``Replicate()``."""
    from torch.distributed.tensor import Replicate
    return [p if p.is_shard() and p.dim in dims else Replicate()
            for p in pls]


def _coordinate(mesh, i: int) -> int:
    return mesh.get_coordinate()[i]


def local_attention(fn, q, k, v):
    """``fn(q, k, v)`` — the flash wrapper on plain tensors — run on each
    rank's local shard of DTensor q [B, Tq, H, d], k, v [B, Tk, KV, d(v)]
    (``local_map``), returned as a DTensor placed as q.

    q keeps its batch (dim 0) and head (dim 2) shards; K and V follow it,
    with whole head dims.  Where q's heads are split over an axis that
    does not divide KV (MQA: Gemma-2B's one key head), K and V are
    replicated over that axis — their gradient comes back as a partial sum
    over it — and each rank passes the kernel the key heads its query
    heads read.
    """
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    H, KV = q.shape[2], k.shape[2]
    qp = _keep(q.placements, (0, 2))
    kvp, kvg, split = [], [], None
    for i, p in enumerate(qp):
        if p == Shard(2) and KV % mesh.size(i):
            if split is not None:
                raise ValueError(f"local_attention: q's heads split over "
                                 f"two mesh axes {q.placements} with KV "
                                 f"{KV}")
            split = i
            kvp.append(Replicate())
            kvg.append(Partial())
        else:
            kvp.append(p)
            kvg.append(p)
    q = q.redistribute(mesh, qp)
    k, v = k.redistribute(mesh, kvp), v.redistribute(mesh, kvp)

    def local(ql, kl, vl):
        if split is not None:
            hl, G = ql.shape[2], H // KV
            off = _coordinate(mesh, split) * hl
            lo, hi = off // G, (off + hl - 1) // G + 1
            if hl % (hi - lo) or any(
                    (off + j) // G - lo != j // (hl // (hi - lo))
                    for j in range(hl)):
                raise ValueError(f"local_attention: {hl} local query "
                                 f"heads at {off} do not map onto key "
                                 f"heads [{lo}, {hi}) of {KV}")
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        return fn(ql.contiguous(), kl.contiguous(), vl.contiguous())

    return local_map(local, out_placements=qp, in_placements=(qp, kvp, kvp),
                     in_grad_placements=(qp, kvg, kvg),
                     device_mesh=mesh)(q, k, v)


def local_ssd(fn, d, b, x, c, u=None, h0=None):
    """``fn(d, b, x, c, u, h0)`` — the ssd wrapper on plain tensors — run
    on each rank's local shard of DTensors d, b, c [B, T, H, N], x [B, T,
    H, P] (batch and head shards, x's), u [H, N] and h0 [B, H, N, P];
    returns (y, hT) as DTensors.  u is split with the heads, and its
    gradient is a partial sum over the axes that split the batch."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    xp = _keep(x.placements, (0, 2))
    up = [Shard(0) if p == Shard(2) else Replicate() for p in xp]
    ug = [Partial() if p == Shard(0) else q for p, q in zip(xp, up)]
    hp = [Shard(1) if p == Shard(2) else p for p in xp]
    d, b, x, c = (t.redistribute(mesh, xp) for t in (d, b, x, c))
    u = None if u is None else u.redistribute(mesh, up)
    h0 = None if h0 is None else h0.redistribute(mesh, hp)

    def local(dl, bl, xl, cl, ul, hl):
        con = lambda t: None if t is None else t.contiguous()
        return fn(*(con(t) for t in (dl, bl, xl, cl, ul, hl)))

    opt = lambda t, pl: None if t is None else pl
    return local_map(
        local, out_placements=(xp, hp),
        in_placements=(xp, xp, xp, xp, opt(u, up), opt(h0, hp)),
        in_grad_placements=(xp, xp, xp, xp, opt(u, ug), opt(h0, hp)),
        device_mesh=mesh)(d, b, x, c, u, h0)


def local_ssd_decode(fn, d, b, x, c, u=None, h=None):
    """``fn(d, b, x, c, u, h)`` — one token of the recurrence on plain
    tensors — run on each rank's local shard of DTensors d, b, c [B, H,
    N], x [B, H, P], u [H, N] and h [B, H, N, P] (batch and head shards,
    x's; u split with the heads); returns (y, h_next) as DTensors."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    xp = _keep(x.placements, (0, 1))
    up = [Shard(0) if p == Shard(1) else Replicate() for p in xp]
    d, b, x, c = (t.redistribute(mesh, xp) for t in (d, b, x, c))
    u = None if u is None else u.redistribute(mesh, up)
    h = None if h is None else h.redistribute(mesh, xp)
    opt = lambda t, pl: None if t is None else pl
    return local_map(
        fn, out_placements=(xp, xp),
        in_placements=(xp, xp, xp, xp, opt(u, up), opt(h, xp)),
        device_mesh=mesh)(d, b, x, c, u, h)


def vocab_parallel_embedding(table, tokens):
    """``F.embedding(tokens, table)`` for a DTensor table [V, D] whose
    vocabulary may be split over a mesh axis, and DTensor token ids: each
    rank looks up the ids its shard holds (zeros elsewhere), and the rows
    come back replicated over that axis (one all-reduce).  Written out
    because DTensor's own lookup leaves a masked partial sum whose
    gradient some torch releases cannot place."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    wp = _keep(table.placements, (0,))
    vocab = [i for i, p in enumerate(wp) if p == Shard(0)]
    if len(vocab) > 1:
        raise ValueError(f"vocab_parallel_embedding: the vocabulary is "
                         f"split over {len(vocab)} mesh axes")
    tp = [p if (p == Shard(0) and i not in vocab) else Replicate()
          for i, p in enumerate(tokens.placements)]
    outp = [Partial() if i in vocab else p for i, p in enumerate(tp)]
    # the table's gradient sums over the batch's shards
    wg = [Partial() if t == Shard(0) else p for t, p in zip(tp, wp)]
    table, tokens = table.redistribute(mesh, wp), tokens.redistribute(mesh, tp)
    V = table.shape[0]

    def local(w, ids):
        if not vocab:
            return torch.nn.functional.embedding(ids, w)
        lo = _coordinate(mesh, vocab[0]) * -(-V // mesh.size(vocab[0]))
        idx = ids.long() - lo
        inside = (idx >= 0) & (idx < w.shape[0])
        rows = torch.nn.functional.embedding(torch.where(inside, idx, 0), w)
        return torch.where(inside[..., None], rows, 0)

    return settle(local_map(local, out_placements=outp,
                            in_placements=(wp, tp), in_grad_placements=(
                                wg, tp), device_mesh=mesh)(table, tokens))


class _VocabParallelNLL(torch.autograd.Function):
    """Σ (logsumexp − gold logit) over the rows of one rank's logits
    [B, C, V_local] f32 whose vocabulary runs from ``lo``; ``group`` the
    process group the vocabulary is split over (None: whole).  Forward:
    the local max, a MAX all-reduce, the local Σexp and the gold logit
    where this shard holds the label, one SUM all-reduce of both.  The
    backward needs no collective: softmax − one-hot on the local shard."""

    @staticmethod
    def forward(ctx, logits, labels, lo, group):
        import torch.distributed as dist

        Vl = logits.shape[-1]
        m = logits.amax(-1)
        if group is not None:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        s = torch.exp(logits - m[..., None]).sum(-1)
        idx = labels.long() - lo
        inside = (idx >= 0) & (idx < Vl)
        idx = torch.where(inside, idx, 0)
        gold = torch.gather(logits, -1, idx[..., None])[..., 0]
        gold = torch.where(inside, gold, 0.0)
        if group is not None:
            both = torch.stack([s, gold])
            dist.all_reduce(both, op=dist.ReduceOp.SUM, group=group)
            s, gold = both[0], both[1]
        ctx.save_for_backward(logits, m, s, idx, inside)
        return (torch.log(s) + m - gold).sum()

    @staticmethod
    def backward(ctx, g):
        logits, m, s, idx, inside = ctx.saved_tensors
        p = torch.exp(logits - m[..., None]) / s[..., None]
        p.scatter_add_(-1, idx[..., None],
                       -inside[..., None].to(p.dtype))
        return p * g, None, None, None


def vocab_parallel_nll(logits, labels):
    """Σ over positions of (logsumexp − gold logit) of DTensor logits
    [B, C, V] f32 and labels [B, C], as a DTensor scalar (a partial sum
    over the axes that split the batch).  The vocabulary stays split over
    the axis that splits it: no collective gathers the logits."""
    import torch.distributed as dist
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    lp = _keep(logits.placements, (0, 2))
    vocab = [i for i, p in enumerate(lp) if p == Shard(2)]
    if len(vocab) > 1:
        raise ValueError(f"vocab_parallel_nll: the vocabulary is split over "
                         f"{len(vocab)} mesh axes")
    labp = [p if p == Shard(0) else Replicate() for p in lp]
    outp = [Partial() if p == Shard(0) else Replicate() for p in lp]
    logits = logits.redistribute(mesh, lp)
    labels = labels.redistribute(mesh, labp)
    group = mesh.get_group(vocab[0]) if vocab else None
    if group is not None and dist.get_world_size(group) == 1:
        group = None

    V = logits.shape[-1]

    def local(ll, yl):
        # torch.chunk's split, as DTensor's: ceil(V / n) a shard
        lo = (_coordinate(mesh, vocab[0]) * -(-V // mesh.size(vocab[0]))
              if vocab else 0)
        return _VocabParallelNLL.apply(ll, yl, lo, group)

    return local_map(local, out_placements=outp, in_placements=(lp, labp),
                     in_grad_placements=(lp, labp),
                     device_mesh=mesh)(logits, labels)
