"""PyTorch port: the model's specs on a mesh against the reference's.

`repro_torch.distributed.sharding` (`param_specs` in both TP modes,
`cache_specs`) and `repro_torch.launch.steps` (`batch_shardings`,
`input_specs`) against `repro.distributed.sharding` / `repro.launch.steps`
on the production meshes (16×16 and 2×16×16), every architecture at full
width.  The port's parameters are fake tensors (no memory: DeepSeek-V2
is 236 B parameters), the reference's ``jax.eval_shape`` structs; a port
spec is a tuple, so it equals ``tuple()`` of the reference's
``PartitionSpec`` leaf for leaf.  No process group is made: the specs
take a `MeshShape`, as the reference's take an ``AbstractMesh``.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from repro.configs import ALL_ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.distributed import sharding as jshd
from repro.launch import steps as JS
from repro.models import transformer as jtf

from repro_torch.checkpoint.manager import tree_leaves
from repro_torch.configs import ALL_ARCHS, SHAPES
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as S
from repro_torch.models import transformer as tf

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
CACHE_ARCHS = ("gemma-2b", "mixtral-8x7b", "rwkv6-1.6b", "zamba2-7b",
               "deepseek-v2-236b")


def _abstract(shape, names):
    return jax.sharding.AbstractMesh(shape, names)


@functools.lru_cache(maxsize=None)
def _fake_params(arch):
    with FakeTensorMode():
        return tf.init_params(torch.Generator(), ALL_ARCHS[arch])


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jax.eval_shape(lambda k: jtf.init_params(k, J_ARCHS[arch]),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))


def _ref_flat(tree):
    """[(key path as a tuple of dict keys, spec tuple)] of a reference
    spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    return [(tuple(k.key for k in path), tuple(spec)) for path, spec in flat]


def _spec_items(specs, path=()):
    """[(key path, spec)] of every spec in a port spec tree, in order."""
    if isinstance(specs, shd.PartitionSpec):
        return [(path, specs)]
    if isinstance(specs, dict):
        items = specs.items()
    elif isinstance(specs, tuple) and hasattr(specs, "_fields"):
        items = zip(specs._fields, specs)
    elif isinstance(specs, (list, tuple)):
        items = enumerate(specs)
    else:
        return []
    return [it for k, v in items for it in _spec_items(v, path + (k,))]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("tp_attention", [True, False])
@pytest.mark.parametrize("mesh_shape,names", MESHES)
@pytest.mark.parametrize("arch", sorted(ALL_ARCHS))
def test_param_specs_match_reference(arch, mesh_shape, names, tp_attention):
    """Every leaf's spec equals the reference's, every sharded dim divides
    (the reference's `test_param_specs_divisible`), and the parameters
    behind them hold no memory."""
    params = _fake_params(arch)
    assert all(isinstance(x, FakeTensor) for x in tree_leaves(params))
    specs = shd.param_specs(ALL_ARCHS[arch], params,
                            M.MeshShape(mesh_shape, names),
                            tp_attention=tp_attention)
    want = _ref_flat(jshd.param_specs(J_ARCHS[arch], _ref_params(arch),
                                      _abstract(mesh_shape, names),
                                      tp_attention=tp_attention))
    assert len(want) == len(tree_leaves(params))
    sizes = dict(zip(names, mesh_shape))
    for path, spec in want:
        got = _at(specs, path)
        assert got == spec, (arch, path, got, spec)
        for dim, ax in zip(_at(params, path).shape, got):
            n = 1
            for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
                n *= sizes[a]
            assert dim % n == 0, (arch, path, got)


def test_eponly_specs_replicate_attention_over_model():
    """The reference's EP-only assertions (`test_perf_features.py`) on the
    port's specs: experts keep "model", attention / MLP / head weights
    shard over "data" instead."""
    specs = shd.param_specs(ALL_ARCHS["deepseek-v2-236b"],
                            _fake_params("deepseek-v2-236b"),
                            M.MeshShape((16, 16), ("data", "model")),
                            tp_attention=False)
    seen = set()
    for path, spec in _spec_items(specs):
        name = str(path[-1])
        if "we_" in name:
            assert "model" in spec, (name, spec)
            seen.add("we_")
        elif any(w in name for w in ("wq", "wo", "w_up", "lm_head")):
            assert "model" not in spec and "data" in spec, (name, spec)
            seen.add(name)
    assert {"we_", "wq", "wo", "lm_head"} <= seen


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
def test_batch_and_cache_specs_match_reference(shape_name):
    """`batch_shardings` (with the decode cells' `cache_specs`) equals the
    reference's for the five architectures of its
    `test_cache_and_batch_specs`."""
    mesh = M.MeshShape((16, 16), ("data", "model"))
    jmesh = _abstract((16, 16), ("data", "model"))
    for arch in CACHE_ARCHS:
        cfg = ALL_ARCHS[arch]
        if shape_name == "long_500k" and not cfg.sub_quadratic:
            continue
        got = S.batch_shardings(cfg, SHAPES[shape_name], mesh)
        want = JS.batch_shardings(J_ARCHS[arch], J_SHAPES[shape_name], jmesh)
        assert sorted(got) == sorted(want)
        for key in want:
            if key == "cache":
                flat = _ref_flat(want["cache"])
                assert len(flat) == len(_spec_items(got["cache"]))
                for path, spec in flat:
                    assert _at(got["cache"], path) == spec, (arch, path)
            else:
                assert got[key] == tuple(want[key]), (arch, key)


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
def test_input_specs_match_reference(shape_name):
    """`input_specs`: the reference's shapes and dtypes, as fake tensors
    (the decode cache from `init_cache` under the fake mode)."""
    for arch in CACHE_ARCHS + ("musicgen-large",):
        cfg = ALL_ARCHS[arch]
        if shape_name == "long_500k" and not cfg.sub_quadratic:
            continue
        got = S.input_specs(cfg, SHAPES[shape_name], n_tiles=16)
        want = JS.input_specs(J_ARCHS[arch], J_SHAPES[shape_name],
                              n_tiles=16)
        assert sorted(got) == sorted(want)
        for key, ref in want.items():
            if key == "pos":
                # a Python int in the port (`make_decode_step` takes one):
                # the cache's last position; the reference's an int32 ()
                assert got[key] == SHAPES[shape_name].seq_len - 1
                assert tuple(ref.shape) == () and str(ref.dtype) == "int32"
                continue
            ref_flat = jax.tree_util.tree_flatten_with_path(ref)[0]
            leaves = tree_leaves(got[key])
            assert len(leaves) == len(ref_flat)
            for (path, r), t in zip(ref_flat, leaves):
                if path:
                    t = _at(got[key], tuple(k.key for k in path))
                assert isinstance(t, FakeTensor), (arch, key, path)
                assert tuple(t.shape) == tuple(r.shape), (arch, key, path)
                assert str(t.dtype).split(".")[-1] == str(r.dtype), \
                    (arch, key, path, t.dtype, r.dtype)


def test_constrain_is_the_identity_outside_an_axis_env():
    x = torch.randn(2, 4, 8, 16)
    assert shd.constrain(x, ("dp", None, "tp", None)) is x
    assert shd.constrain_heads(x) is x
    assert shd.gather_dp({"w": x})["w"] is x
    assert shd.replicate(x) is x and shd.settle(x) is x
    # a plain tensor under an env of names and sizes stays as it is
    with shd.axis_env(M.MeshShape((2, 2), ("data", "model"))):
        assert shd.constrain(x, ("dp", None, "tp", None)) is x
    assert shd._AXIS_ENV is None


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = M.MeshShape((2, 2, 2), ("pod", "data", "model"))
    assert shd.placements(mesh, shd.P(("pod", "data"), None, "model")) == [
        Shard(0), Shard(0), Shard(2)]
    assert shd.placements(mesh, shd.P()) == [Replicate()] * 3
    assert shd.P(("data",), None) == ("data", None)
    with pytest.raises(ValueError, match="order"):
        shd.placements(mesh, shd.P(("data", "pod")))
    specs = {"a": shd.P("data"), "b": {"c": shd.P(None, "model")}}
    sh = shd.to_shardings(mesh, specs)
    assert sh["b"]["c"].mesh is mesh and sh["b"]["c"].spec == (None, "model")
    assert sh["b"]["c"].placements == [Replicate(), Replicate(), Shard(1)]


def test_production_mesh_names_the_world_size_it_needs():
    assert M.production_shape().size == 256
    assert M.production_shape(multi_pod=True).sizes == (2, 16, 16)
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"{n} ranks, got 1"):
            M.make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def test_train_state_specs_inherit_the_parameter_specs():
    cfg = ALL_ARCHS["granite-3-2b"]
    with FakeTensorMode():
        state = S.init_train_state(torch.Generator(), cfg, 4)
    mesh = M.MeshShape((2, 16, 16), ("pod", "data", "model"))
    specs = S.train_state_specs(cfg, state, mesh)
    assert specs.opt.m == specs.params == specs.opt.v
    assert specs.params == shd.param_specs(cfg, state.params, mesh)
    assert specs.step == () and specs.opt.count == ()
    assert all(s == () for _, s in _spec_items(specs.sched))

