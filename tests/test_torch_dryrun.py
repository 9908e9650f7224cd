"""PyTorch port: the dry-run tooling (`launch/dryrun.py`, `roofline.py`).

  * `roofline.analytic` against `repro.launch.roofline.analytic` for
    every live cell on both production meshes and six variants: every
    formula term equal to a relative 1e-12 (only the hardware constants,
    and so the times, differ); `parse_variant` word for word, its error
    too.
  * The per-rank argument bytes of the train state placed on 16×16 (fake
    tensors over a fake group of 256 ranks), for five families at full
    width (the depth cut to 7 layers), equal to the sum over the
    reference's leaves of their shard shape × itemsize under the
    reference's specs.
  * The routed MoE's static form (the one fake tensors take: a buffer for
    every expert of the share) gives y and aux bit for bit as the form
    real tensors take (buffers for the experts some token routes to).
  * `dryrun` ends every cell ``ok`` for a reduced config of each family
    (dense, MoE, MLA, SSM, hybrid, stub frontend) × train, prefill and
    decode on fake 2×4 and 2×2×2 meshes, with the reference's record keys.

The fake groups run in subprocesses (a process holds one group), all
started together.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import ALL_ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.launch import dryrun as JD
from repro.launch import roofline as JR
from repro.launch import steps as JS

from repro_torch.configs import ALL_ARCHS, SHAPES, get_arch, live_cells, reduced
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.models import layers as Lm

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
VARIANTS = ("", "int8kv", "mb4", "tp8", "eponly", "grad_compress")
BYTES_ARCHS = ("gemma-2b", "mixtral-8x7b", "zamba2-7b", "rwkv6-1.6b",
               "deepseek-v2-236b")
BYTES_LAYERS = 7        # full width, the depth cut (Zamba2: one shared block)
FAMILIES = {"dense": "granite-3-2b", "moe": "mixtral-8x7b",
            "mla": "deepseek-v2-236b", "ssm": "rwkv6-1.6b",
            "hybrid": "zamba2-7b", "stub": "musicgen-large"}

# the argument bytes of each arch's train state on 16×16, rank 0
BYTES_WORKER = r"""
import dataclasses, json
import torch
torch.set_num_threads(1)
from repro_torch.configs import get_arch, get_shape
from repro_torch.launch import dryrun as D
out = {}
with D.fake_group(256):
    mesh = D.cell_mesh(False, D.parse_variant(""), "cpu")
    for arch in ARCHS:
        cfg = dataclasses.replace(get_arch(arch), n_layers=LAYERS)
        cell = D.build_cell(cfg, get_shape("train_4k"), mesh, device="cpu")
        out[arch] = D.local_bytes(cell.args[0])
print("RESULT " + json.dumps(out))
"""

# some families × every kind through the dry run on one small mesh of a
# fake group of eight
CELLS_WORKER = r"""
import json
import torch
torch.set_num_threads(1)
from repro_torch.configs import ShapeConfig, get_arch, reduced
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_mesh_compat
out = {}
with D.fake_group(8):
    mesh = make_mesh_compat(SHAPE, NAMES, "cpu")
    for fam, arch in FAMILIES.items():
        cfg = reduced(get_arch(arch), n_layers=2, vocab_size=256)
        for kind in ("train", "prefill", "decode"):
            cell = D.build_cell(cfg, ShapeConfig(kind, 16, 8, kind), mesh,
                                n_tiles=4, device="cpu")
            rec = D.record(cell, 0.0)
            out[f"{MESH} {fam} {kind}"] = {
                "keys": sorted(rec), "memory": rec["memory"],
                "flops": rec["flops"],
                "counts": rec["collectives"]["counts"],
                "bottleneck": rec["roofline"]["bottleneck"]}
print("RESULT " + json.dumps(out))
"""


def _start(code: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _result(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=600)
    lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, err[-4000:]
    return json.loads(lines[-1][len("RESULT "):])


MESH_AXES = {"2x4": ((2, 4), ("data", "model")),
             "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


# the (mesh, families) each process runs.  DTensor caches each op's
# placement strategies by its shapes, and the reduced configs share most
# shapes, so a family's first step on a mesh makes the next families'
# steps there cheap (one process on 2×4 runs all six); on three axes a
# cold train step costs ~17 s of placement search on the CPU and a cold
# decode ~9 s, and the MLA and hybrid families share fewest shapes with
# the rest, so the three-axis mesh has three processes
GROUPS = (("2x2x2", ("dense", "stub", "moe")), ("2x2x2", ("mla",)),
          ("2x2x2", ("ssm", "hybrid")), ("2x4", tuple(FAMILIES)))


@pytest.fixture(scope="module")
def workers():
    """The fake-group runs, all started together."""
    procs = [_start(f"ARCHS = {BYTES_ARCHS!r}\nLAYERS = {BYTES_LAYERS}\n"
                    + BYTES_WORKER)]
    for mesh, fams in GROUPS:
        shape, names = MESH_AXES[mesh]
        procs.append(_start(
            f"FAMILIES = {({f: FAMILIES[f] for f in fams})!r}\n"
            f"MESH = {mesh!r}\nSHAPE = {shape!r}\nNAMES = {names!r}\n"
            + CELLS_WORKER))
    out = {"bytes": _result(procs[0])}
    for proc in procs[1:]:
        out.update(_result(proc))
    return out


# ---------------------------------------------------------------- roofline --
def _ref_opts(variant):
    if variant == "grad_compress":
        return {"grad_compress": True}
    return JD.parse_variant(variant)


def _mesh_shape(mesh, variant):
    opts = D.parse_variant("" if variant == "grad_compress" else variant)
    if opts["tp"] is None:
        return dict(MESHES[mesh])
    tp = opts["tp"]
    shape = {"data": 256 // tp, "model": tp}
    return {"pod": 2, **shape} if mesh == "multi" else shape


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_roofline_matches_reference(mesh, variant):
    """Every term of the port's analytic roofline equals the reference's
    (flops, HBM bytes, collective bytes, model flops, chips, per-chip HBM
    bytes) for every live cell."""
    fields = ("flops", "hbm_bytes", "collective_bytes", "model_flops",
              "chips", "per_chip_hbm_bytes")
    for arch, shape in live_cells():
        ms = _mesh_shape(mesh, variant)
        opts = (R.DEFAULT_OPTS | {"grad_compress": True}
                if variant == "grad_compress" else D.parse_variant(variant))
        got = R.analytic(ALL_ARCHS[arch], SHAPES[shape], ms, opts=opts)
        want = JR.analytic(J_ARCHS[arch], J_SHAPES[shape], ms,
                           opts=_ref_opts(variant))
        for f in fields:
            a, b = getattr(got, f), getattr(want, f)
            assert a == pytest.approx(b, rel=1e-12, abs=0.0), \
                (arch, shape, mesh, variant, f, a, b)
        assert got.bottleneck in ("compute", "memory", "collective")


def test_roofline_constants_are_the_h100s():
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 50e9)
    assert (R.PEAK_F32_FLOPS, R.PEAK_TF32_FLOPS) == (67e12, 495e12)
    r = R.analytic(get_arch("gemma-2b"), SHAPES["train_4k"], MESHES["single"])
    assert r.t_compute == r.flops / (256 * 989e12)
    assert r.as_dict().keys() == JR.analytic(
        J_ARCHS["gemma-2b"], J_SHAPES["train_4k"],
        MESHES["single"]).as_dict().keys()


@pytest.mark.parametrize("variant", ["", "int8kv", "mb4", "tp8", "eponly",
                                     "int8kv+mb2+tp4+eponly", "mb1+tp16"])
def test_parse_variant_matches_reference(variant):
    assert D.parse_variant(variant) == JD.parse_variant(variant)


def test_parse_variant_rejects_an_unknown_knob_as_the_reference():
    with pytest.raises(ValueError) as got:
        D.parse_variant("int8kv+fp4")
    with pytest.raises(ValueError) as want:
        JD.parse_variant("int8kv+fp4")
    assert str(got.value) == str(want.value)


# ------------------------------------------------------- argument bytes --
def _ref_state_bytes(arch: str) -> int:
    import dataclasses
    cfg = dataclasses.replace(J_ARCHS[arch], n_layers=BYTES_LAYERS)
    mesh = jax.sharding.AbstractMesh((16, 16), ("data", "model"))
    state = jax.eval_shape(lambda k: JS.init_train_state(k, cfg, 256),
                           jax.ShapeDtypeStruct((2,), jnp.uint32))
    specs = JS.train_state_specs(cfg, state, mesh)
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    leaves = jax.tree.leaves(state)
    spec_leaves = jax.tree.leaves(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for x, spec in zip(leaves, spec_leaves):
        shard = list(x.shape)
        for dim, ax in enumerate(spec):
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None:
                    assert shard[dim] % sizes[a] == 0
                    shard[dim] //= sizes[a]
        total += int(np.prod(shard)) * x.dtype.itemsize
    return total


@pytest.mark.parametrize("arch", BYTES_ARCHS)
def test_argument_bytes_match_the_reference_shards(workers, arch):
    """The train state's local shards on rank 0 of 16×16 hold exactly the
    bytes of the reference's shards under its specs."""
    assert workers["bytes"][arch] == _ref_state_bytes(arch)


# ------------------------------------------------------------------- MoE --
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-236b"])
def test_static_moe_form_is_bit_equal(arch):
    """The static form (every expert of the share a buffer) against the
    form real tensors take (the routed experts alone), on real tensors: the
    whole layer and an expert-parallel share (experts [2, 4) of 4), with
    drops (capacity factor 1)."""
    cfg = reduced(get_arch(arch), moe_capacity_factor=1.0)
    gen = torch.Generator().manual_seed(0)
    p = Lm.moe_init(gen, cfg)
    x = torch.randn(4 * 64, cfg.d_model, generator=gen)
    opts = Lm.MoEOptions(capacity_factor=1.0, group_size=64)
    for e0, share in ((0, slice(None)), (2, slice(2, 4))):
        ws = [p[n][share] for n in ("we_gate", "we_up", "we_down")]
        y0, a0 = Lm._moe_routed(x, p["router"], *ws, cfg, opts, e0,
                                static=False)
        y1, a1 = Lm._moe_routed(x, p["router"], *ws, cfg, opts, e0,
                                static=True)
        assert torch.equal(y0, y1) and torch.equal(a0, a1), (arch, e0)


# ------------------------------------------------------------ the cells --
@pytest.mark.parametrize("mesh", ["2x4", "2x2x2"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dryrun_cell_ends_ok(workers, mesh, kind, family):
    """Each family's step runs on fake tensors over the fake group and
    records memory, flops, collectives and the roofline: arguments held,
    a peak at least the arguments, flops counted."""
    rec = workers[f"{mesh} {family} {kind}"]
    assert rec["keys"] == sorted(["lower_s", "run_s", "memory", "flops",
                                  "collectives", "roofline"])
    m = rec["memory"]
    assert 0 < m["argument_bytes"] <= m["peak_bytes"]
    assert rec["flops"] > 0
    if kind == "train":
        assert m["alias_bytes"] > 0          # the state updated in place
        assert rec["counts"].get("all-reduce", 0) > 0
