"""Multi-pod dry run: every (arch × shape × mesh) cell's step, run once on
fake tensors over a fake process group.

Run it as a module:

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--mesh single|multi|both]
        [--out results/dryrun_torch.json] [--force]
        [--variant int8kv|mbN|tpN|eponly] [--device cuda|cpu]

Port of `repro.launch.dryrun`.  The reference lowers and compiles each
cell against 16×16 and 2×16×16 meshes of fake host devices; the port runs
each cell's step eagerly on fake tensors (``FakeTensorMode``: shapes,
dtypes and strides, no memory, no arithmetic).  First the process starts
a fake process group of 256 or 512 ranks (torch's ``fake`` backend: the
collectives return at once), as the reference sets ``XLA_FLAGS`` first;
then it builds the production mesh (`launch.mesh.make_production_mesh`)
and the train state, parameters or cache under the fake mode, places them
by `steps.train_state_specs` / `sharding.param_specs` /
`steps.batch_shardings` and runs the cell's step once under
`sharding.axis_env`.  The kernels run as their shape rules
(`kernels/flash_attention.py`, `kernels/ssm_scan.py`, `fma_f32`); the
routed MoE takes its static form (`layers._moe_routed`).

Each cell records, for rank 0 of the mesh (every rank runs the same
program on its own shards):

  * ``memory``: ``argument_bytes`` (the local shards of the state and
    inputs), ``output_bytes`` (of the step's outputs; ``alias_bytes`` of
    them are argument storages the step updated in place) and
    ``peak_bytes``, the most bytes of live tensor storage during the step,
    arguments included — counted by a dispatch mode over the storages the
    local ops create and free (`LiveBytes`), not an allocator's figure;
  * ``flops``: the local ops' flops by ``FlopCounterMode``'s formulas
    (``torch.utils.flop_counter.flop_registry``: GEMMs and the kernels'
    registered formulas), with the ops that have no formula left out;
  * ``collectives``: `hlo_census` of the step;
  * ``roofline``: `roofline.analytic(...).as_dict()`;
  * ``lower_s`` (building and placing the state) and ``run_s``.

Results are written to the JSON file after each cell; cells already done
are kept unless ``--force``.  A failed cell is written with ``"ok":
false`` and its error, and the run exits 1.  ``--device`` is "cuda" unless
asked: the CPU build of torch cannot place a fake "cuda" tensor, so the
tests use "cpu".
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.checkpoint.manager import tree_leaves
from repro_torch.configs import get_arch, get_shape, live_cells
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch import hlo_census, roofline, steps
from repro_torch.launch.mesh import make_mesh_compat, make_production_mesh

# a real tensor this large inside a dry-run step is a fault: some factory
# allocated memory the cell's fake tensors stand in for
REAL_BYTES_LIMIT = 256 << 20


def parse_variant(variant: str) -> dict:
    """Variant string: '+'-joined knobs (§Perf hillclimb levers):
       int8kv | mbN (N microbatches) | tpN (mesh data=256/N, model=N) |
       eponly (no Megatron TP on attention/MLP — model axis = experts only)
    """
    opts = {"kv_int8": False, "n_microbatches": 1, "tp": None,
            "tp_attention": True}
    for part in filter(None, variant.split("+")):
        if part == "int8kv":
            opts["kv_int8"] = True
        elif part.startswith("mb"):
            opts["n_microbatches"] = int(part[2:])
        elif part.startswith("tp"):
            opts["tp"] = int(part[2:])
        elif part == "eponly":
            opts["tp_attention"] = False
        else:
            raise ValueError(f"unknown variant knob {part!r}")
    return opts


# ========================================================== fake group ==
@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks, this process rank 0: the
    process's only group, destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group already exists; the "
                           "fake group must be the process's only one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ================================================== what a step uses ==
def _storages(tree) -> list:
    """The distinct storages of ``tree``'s tensors (a DTensor's local
    shard), in order."""
    seen, out = set(), []
    for x in tree_leaves(tree):
        if not torch.is_tensor(x):
            continue
        if shd.is_distributed(x):
            x = x.to_local()
        st = x.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            out.append(st)
    return out


def local_bytes(tree) -> int:
    """Bytes of ``tree``'s tensor storages on this rank (each DTensor's
    local shard), each storage once."""
    return sum(st.nbytes() for st in _storages(tree))


class LiveBytes(TorchDispatchMode):
    """Live tensor storage bytes while active, and their peak.  Storages
    given to `hold` (the step's arguments) count from the start; each
    storage an op creates counts until Python frees it.  Ops on DTensors
    are handed back to DTensor first, so the local ops are the ones
    counted (not DTensor's own, `hlo_census.in_propagation`).  A real
    (not fake) output over `REAL_BYTES_LIMIT` raises."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._held = WeakIdKeyDictionary()

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def hold(self, st) -> bool:
        if st in self._held:
            return False
        n = st.nbytes()
        self._held[st] = weakref.ref(st, lambda _, n=n: self._free(n))
        self.live += n
        self.peak = max(self.peak, self.live)
        return True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import is_fake
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if hlo_census.in_propagation():
            return out
        for t in torch.utils._pytree.tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.device.type != "meta"
                    and self.hold(t.untyped_storage())):
                n = t.untyped_storage().nbytes()
                if n > REAL_BYTES_LIMIT and not is_fake(t):
                    raise RuntimeError(f"dryrun: {func} made a real tensor "
                                       f"of {n} bytes")
        return out


class LocalFlops(TorchDispatchMode):
    """Flops of the local ops by ``FlopCounterMode``'s formulas
    (``flop_registry``, which holds the kernels' own); DTensor ops are
    handed back to DTensor, so each local op counts once."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if hlo_census.in_propagation():
            return out
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        return out


# ============================================================ one cell ==
@dataclasses.dataclass
class Cell:
    """A built cell: its step, the placed arguments, the mesh and the
    meta the record needs."""
    step: object
    args: tuple
    mesh: object
    cfg: ArchConfig
    shape: ShapeConfig
    opts: dict


def _generator(device: str) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, *, opts=None,
               n_tiles: int | None = None, device: str = "cuda") -> Cell:
    """The cell's state (train) or parameters (prefill, decode), and its
    inputs, as fake tensors on ``device`` placed on ``mesh`` by their
    specs, and the step that takes them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    opts = {**parse_variant(""), **(opts or {})}
    if opts["kv_int8"]:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    n_tiles = mesh.size() if n_tiles is None else n_tiles
    tp_attn = opts["tp_attention"]
    dev = torch.device(device)
    with FakeTensorMode(allow_non_fake_inputs=True):
        ins = steps.input_specs(cfg, shape, n_tiles=n_tiles)
        if dev.type != "cpu":
            ins = {k: _to(v, dev) for k, v in ins.items()}
        bspecs = steps.batch_shardings(cfg, shape, mesh)
        if shape.kind == "train":
            state = steps.init_train_state(_generator(device), cfg, n_tiles)
            sspecs = steps.train_state_specs(cfg, state, mesh,
                                             tp_attention=tp_attn)
            state = shd.distribute(state, mesh, sspecs)
            batch = shd.distribute(ins, mesh, bspecs)
            step = steps.make_train_step(
                cfg, n_tiles, n_microbatches=opts["n_microbatches"],
                device=dev)
            args = (state, batch)
        else:
            from repro_torch.models import transformer as tf
            params = tf.init_params(_generator(device), cfg)
            pspecs = shd.param_specs(cfg, params, mesh, tp_attention=tp_attn)
            params = shd.distribute(params, mesh, pspecs)
            placed = shd.distribute(ins, mesh, bspecs)
            if shape.kind == "prefill":
                step = steps.make_prefill_step(cfg, shape.seq_len)
                args = (params, placed["tokens"])
            else:
                step = steps.make_decode_step(cfg)
                args = (params, placed["cache"], placed["token"],
                        placed["pos"])
    return Cell(step=step, args=args, mesh=mesh, cfg=cfg, shape=shape,
                opts=opts)


def _to(tree, dev):
    if torch.is_tensor(tree):
        return tree.to(dev)
    return shd.map_with_path(
        lambda _, x: x.to(dev) if torch.is_tensor(x) else x, tree)


def run_step(cell: Cell) -> dict:
    """The cell's step once, under `sharding.axis_env` and the three
    recorders: {"memory", "flops", "collectives", "run_s"}.  The fake
    mode is not active during the step (its tensors carry it): DTensor's
    own bookkeeping then runs on real host values."""
    mem = LiveBytes()
    for st in _storages(cell.args):
        mem.hold(st)
    arg_bytes = mem.live
    flops = LocalFlops()
    census = hlo_census.Census()
    t0 = time.perf_counter()
    with shd.axis_env(cell.mesh, tp_activations=cell.opts["tp_attention"]):
        with mem, flops, census:
            out = cell.step(*cell.args)
    run_s = time.perf_counter() - t0
    held = {id(st) for st in _storages(cell.args)}
    outs = _storages(out)
    out_bytes = sum(st.nbytes() for st in outs)
    alias = sum(st.nbytes() for st in outs if id(st) in held)
    del out
    return {"memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                       "alias_bytes": alias, "peak_bytes": mem.peak},
            "flops": flops.flops, "collectives": census.result(),
            "run_s": run_s}


def cell_mesh(multi_pod: bool, opts: dict, device: str):
    """The production mesh, or the ``tpN`` variant's (data 256/N, model
    N), over the current (fake) group."""
    if opts["tp"] is None:
        return make_production_mesh(multi_pod=multi_pod, device_type=device)
    tp = opts["tp"]
    if multi_pod:
        return make_mesh_compat((2, 256 // tp, tp), ("pod", "data", "model"),
                                device)
    return make_mesh_compat((256 // tp, tp), ("data", "model"), device)


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               variant: str = "", device: str = "cuda") -> Cell:
    """Build one cell on the production mesh (the reference's
    ``lower_cell``; nothing is lowered: the step runs eagerly)."""
    opts = parse_variant(variant)
    mesh = cell_mesh(multi_pod, opts, device)
    return build_cell(get_arch(arch), get_shape(shape_name), mesh, opts=opts,
                      device=device)


def record(cell: Cell, lower_s: float) -> dict:
    """Run the built cell and return its record (as the reference's,
    with the port's memory and flops; the op list cut to 40, as the
    reference cuts it)."""
    rec = run_step(cell)
    cen = rec["collectives"]
    if len(cen["ops"]) > 40:
        cen["ops"] = cen["ops"][:40] + [
            {"kind": "...truncated", "bytes": 0, "mult": 0, "comp": ""}]
    mesh_shape = dict(zip(cell.mesh.mesh_dim_names, cell.mesh.shape))
    rl = roofline.analytic(cell.cfg, cell.shape, mesh_shape, opts=cell.opts)
    return {"lower_s": round(lower_s, 2), "run_s": round(rec["run_s"], 2),
            "memory": rec["memory"], "flops": rec["flops"],
            "collectives": cen, "roofline": rl.as_dict()}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             variant: str = "", device: str = "cuda") -> dict:
    """One cell on the current fake group of 256 (single pod) or 512
    (multi pod) ranks: its record."""
    t0 = time.perf_counter()
    cell = lower_cell(arch, shape_name, multi_pod, variant, device)
    lower_s = time.perf_counter() - t0
    rec = record(cell, lower_s)
    print(f"== {arch} × {shape_name} × "
          f"{'multi' if multi_pod else 'single'}-pod"
          f"{' [' + variant + ']' if variant else ''} ==")
    print("memory:", rec["memory"])
    print("flops:", rec["flops"], "collectives:",
          rec["collectives"]["counts"], rec["collectives"]["by_kind"])
    return {"arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16", "variant": variant,
            "device": device, "ok": True, **rec}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="",
                    help="'+'-joined knobs: int8kv|mbN|tpN|eponly (§Perf)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the fake tensors claim to live (the CPU "
                         "build of torch cannot place fake cuda tensors)")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results: dict[str, dict] = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = live_cells()
    if args.arch:
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]

    failures = []
    for mp in meshes:
        todo = []
        for arch, shape in cells:
            key = f"{arch}|{shape}|{'multi' if mp else 'single'}"
            if args.variant:
                key += f"|{args.variant}"
            if key in results and results[key].get("ok") and not args.force:
                continue
            todo.append((key, arch, shape))
        if not todo:
            continue
        with fake_group(512 if mp else 256):
            for key, arch, shape in todo:
                try:
                    results[key] = run_cell(arch, shape, mp,
                                            variant=args.variant,
                                            device=args.device)
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    results[key] = {"arch": arch, "shape": shape,
                                    "mesh": "multi" if mp else "single",
                                    "variant": args.variant, "ok": False,
                                    "error": f"{type(e).__name__}: {e}"}
                    failures.append(key)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    done = sum(1 for r in results.values() if r.get("ok"))
    print(f"\ndry-run: {done} cells ok, {len(failures)} failed this run")
    if failures:
        print("failed:", failures)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
