"""PyTorch port, the fleet's device mesh in one process
(`repro_torch.distributed.sharding`, `fleet/backends/sharded.py`).

The reference's tests emulate a many-device host with an XLA flag; here one
explicit argument does it: a device pool of repeated CPU devices
(``device_pool=[cpu] * 4``).  The `sharded` backend at 1, 2 and 4
partitions is held to the port's single-partition parents, `broadcast` and
`vmap` — per lane bit for bit (the step has no cross-lane operation) — and
to the reference's single-device engine within `torch_parity`'s bounds
(the reference's own sharded tests fail on this tree, ROADMAP queue 3).
Also: the loud degradation and `describe()`, `put_trace` at every chunk
rank, `put_mask` with an indivisible capacity, heterogeneous and
reactive_poll fleets, the placement hooks and `devices=` refused where it
does not apply.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from torch_parity import (assert_state_close, assert_telemetry_close, np_,
                          trace)

from repro.core.scheduler import SchedulerConfig as JCfg
from repro.fleet import FleetEngine as JEngine
from repro_torch.core.nodebank import available_nodes, fleet_package_params
from repro_torch.core.scheduler import SchedulerConfig as TCfg
from repro_torch.distributed import Sharded, fleet_mesh, gather
from repro_torch.distributed.sharding import (FLEET_AXIS, fleet_shard_map,
                                              fleet_trace_spec, lane_at,
                                              mesh_of)
from repro_torch.fleet import FleetEngine, available_backends, stream
from repro_torch.fleet.ingest import chunk_source
from repro_torch.launch import serve

jax.config.update("jax_platform_name", "cpu")

CPU = torch.device("cpu")
POOL = [CPU] * 4
OUTPUTS = ("freq", "temp_c", "hint_w", "at_risk", "balance")


def _mesh_engine(cfg, backend="sharded", devices=None, pool=POOL, **kw):
    return FleetEngine(cfg, backend=backend, device="cpu", devices=devices,
                       device_pool=pool, **kw)


def assert_states_equal(a, b, where=""):
    """Two fleet states (either layout), leaf for leaf, bit for bit."""
    a, b = gather(a), gather(b)
    for name, x in a._asdict().items():
        y = getattr(b, name)
        if isinstance(x, tuple):
            for f, u in x._asdict().items():
                assert torch.equal(u, getattr(y, f)), f"{where} {name}.{f}"
        elif x is None:
            assert y is None, f"{where} {name}"
        else:
            assert torch.equal(x, y), f"{where} {name}"


def test_registry_and_the_mesh():
    assert {"sharded", "sharded_fused"} <= set(available_backends())
    assert fleet_mesh(None, POOL) == tuple(POOL)
    assert fleet_mesh(0, POOL) == tuple(POOL)
    assert fleet_mesh(2, POOL) == (CPU, CPU)
    assert fleet_mesh(64, POOL) == tuple(POOL)       # clamps to the pool
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fleet_mesh()
    assert fleet_trace_spec(3, package_dim=1) == 1
    assert fleet_trace_spec(2, axis=None) is None


@pytest.mark.parametrize("nd", [1, 2, 4])
def test_sharded_bitmatches_broadcast_and_vmap(nd):
    """The reference test's shape ([12, 16, 4]): every step's outputs are
    bit-equal to broadcast's and vmap's, the telemetry within the bounds
    (exactly equal to broadcast's here), the final state bit-equal."""
    cfg = TCfg(n_tiles=4, mode="v24")
    tr = trace(12, 16, 4, seed=0)
    eb = FleetEngine(cfg, backend="broadcast", device="cpu")
    ev = FleetEngine(cfg, backend="vmap", device="cpu")
    es = _mesh_engine(cfg, devices=nd)
    sb, sv, ss = eb.init(16), ev.init(16), es.init(16)
    assert es.backend_impl.n_devices() == nd
    assert es.backend_impl.describe() == f"sharded[{nd}dev]"
    assert len(ss.freq.parts) == nd and ss.freq.shape == (16, 4)
    for t in range(12):
        sb, ob, tb = eb.step(sb, tr[t])
        sv, ov, tv = ev.step(sv, tr[t])
        ss, os_, ts = es.step(ss, tr[t])
        for f in OUTPUTS:
            assert torch.equal(getattr(os_, f), getattr(ob, f)), (t, f)
            assert torch.equal(getattr(os_, f), getattr(ov, f)), (t, f)
        assert_telemetry_close(tv, ts, f"step {t} vs vmap")
        for f in tb._fields:
            assert torch.equal(getattr(ts, f), getattr(tb, f)), (t, f)
    assert_states_equal(ss, sb, f"{nd} partitions")
    assert torch.equal(gather(ss.events), sv.events)


@pytest.mark.parametrize("nd", [2, 4])
def test_sharded_matches_the_reference_single_device_engine(nd):
    """Against the reference's single-device vmap engine: per step, then a
    chunked run with a tail window — ≤1e-5, events exact."""
    tr = trace(40, 16, 4, seed=nd)
    je = JEngine(JCfg(n_tiles=4, mode="v24"), backend="vmap")
    es = _mesh_engine(TCfg(n_tiles=4, mode="v24"), devices=nd)
    js, ss = je.init(16), es.init(16)
    for t in range(6):
        js, jo, jt = je.step(js, jnp.asarray(tr[t]))
        ss, so, st = es.step(ss, tr[t])
        for f in OUTPUTS:
            np.testing.assert_allclose(np_(getattr(so, f)),
                                       np_(getattr(jo, f)), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{t} {f}")
        assert_telemetry_close(jax.device_get(jt), st, f"step {t}")
    js, jred = je.run_chunked(js, jnp.asarray(tr[6:]), 16)
    ss, sred = es.run_chunked(ss, tr[6:], 16)
    assert_telemetry_close(jax.device_get(jred), sred, "chunked")
    ref = jax.device_get(js)
    ref = ref._replace(step=ref.step[0],
                       filtration=ref.filtration._replace(
                           ptr=ref.filtration.ptr[0]))
    assert_state_close(ref, gather(ss), "chunked")


def test_odd_partitions_and_the_streaming_loop():
    """Six packages on two partitions of three, through `stream` (each
    chunk placed by `put_trace`) and `run` (per-step telemetry) — bit-equal
    to broadcast, one host sync a flush."""
    cfg = TCfg(n_tiles=4, mode="v24")
    tr = trace(44, 6, 4, seed=3)
    eb = FleetEngine(cfg, backend="broadcast", device="cpu")
    es = _mesh_engine(cfg, devices=2)
    sb, fb, _ = stream(eb, eb.init(6), chunk_source(tr, 16))
    ss, fs_, stats = stream(es, es.init(6), chunk_source(tr, 16))
    assert [p.shape[0] for p in ss.freq.parts] == [3, 3]
    assert stats.flushes == stats.host_syncs == 3
    assert fs_ == fb
    assert_states_equal(ss, sb, "stream")
    sb, tb = eb.run(sb, tr[:8])
    ss, ts = es.run(ss, tr[:8])
    for f in tb._fields:
        assert torch.equal(getattr(ts, f), getattr(tb, f)), f


def test_degradation_is_loud_and_describe_carries_the_mesh():
    """An indivisible fleet or an over-large budget falls back to the
    largest compatible mesh with a RuntimeWarning naming the requested and
    actual counts; a divisible size recovers the budget silently."""
    cfg = TCfg(n_tiles=4, mode="v24")

    def init(eng, n):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            st = eng.init(n)
        return st, [str(x.message) for x in w
                    if issubclass(x.category, RuntimeWarning)]

    eng = _mesh_engine(cfg, devices=4)
    st, msgs = init(eng, 6)
    assert eng.backend_impl.n_devices() == 3
    assert eng.backend_impl.describe() == "sharded[3dev]"
    assert any("requested 4 devices but running on 3" in m
               and "n_packages=6 must divide the mesh" in m for m in msgs)
    st, _, telem = eng.step(st, np.full((6, 4), 1.8, np.float32))
    assert telem.as_dict()["n_packages"] == 6
    st, msgs = init(eng, 8)
    assert not msgs and eng.backend_impl.n_devices() == 4
    assert len(st.freq.parts) == 4
    big = _mesh_engine(cfg, devices=64)
    _, msgs = init(big, 8)
    assert big.backend_impl.n_devices() == 4
    assert any("requested 64 devices" in m and "only 4 devices visible" in m
               for m in msgs)
    whole = _mesh_engine(cfg)                       # budget: the whole pool
    _, msgs = init(whole, 6)
    assert any("using 3 of 4 visible devices" in m for m in msgs)
    fused = _mesh_engine(cfg, backend="sharded_fused", devices=4)
    _, msgs = init(fused, 6)
    assert fused.backend_impl.n_devices() == 3
    assert fused.backend_impl.describe() == "sharded_fused[3dev,blk=plain]"
    assert any(m.startswith("sharded_fused fleet backend") for m in msgs)
    one = _mesh_engine(cfg, devices=2, pool=None)   # the CPU engine's pool
    _, msgs = init(one, 8)
    assert one.backend_impl.describe() == "sharded[1dev]"
    assert any("only 1 devices visible" in m for m in msgs)


@pytest.mark.parametrize("shape,pdim", [((16, 4), 0), ((5, 16, 4), 1),
                                        ((3, 5, 16, 4), 2)])
def test_put_trace_lands_each_partition_on_its_device(shape, pdim):
    """[n, t], [T, n, t] and [C, K, n, t] chunks split on the package axis,
    just before the tiles; an indivisible package count stays whole."""
    eng = _mesh_engine(TCfg(n_tiles=4), devices=4)
    eng.init(16)
    x = np.random.default_rng(1).random(shape).astype(np.float32)
    put = eng.backend_impl.put_trace(x)
    assert isinstance(put, Sharded) and put.dim == pdim
    assert put.shape == shape and len(put.parts) == 4
    for i, p in enumerate(put.parts):
        want = np.take(x, np.arange(4 * i, 4 * i + 4), axis=pdim)
        np.testing.assert_array_equal(p.numpy(), want)
    assert eng.backend_impl.put_trace(put) is put
    odd = np.take(x, np.arange(6), axis=pdim)
    whole = eng.backend_impl.put_trace(odd)
    assert torch.is_tensor(whole) and whole.shape == odd.shape


def test_put_mask_partitions_like_the_state_and_masked_telemetry():
    """The mask splits like the state's package axis (an indivisible
    capacity stays whole); masked telemetry over the gathered traces equals
    broadcast's — percentiles over the whole active fleet."""
    cfg = TCfg(n_tiles=4, mode="v24")
    es = _mesh_engine(cfg, devices=4)
    ss = es.init(8)
    mask = np.arange(8) % 3 != 1
    put = es.backend_impl.put_mask(mask)
    assert isinstance(put, Sharded) and [len(p) for p in put.parts] == [2] * 4
    whole = es.backend_impl.put_mask(np.ones(6, bool))
    assert torch.is_tensor(whole) and whole.shape == (6,)
    eb = FleetEngine(cfg, backend="broadcast", device="cpu")
    tr = trace(24, 8, 4, seed=9)
    sb, tb = eb.run_block(eb.init(8), tr, active=mask)
    ss, ts = es.run_block(ss, tr, active=mask)
    for f in tb._fields:
        assert torch.equal(getattr(ts, f), getattr(tb, f)), f
    assert int(ts.n_packages) == int(mask.sum())
    sb, _, tb = eb.step(sb, tr[0], active=mask)
    ss, _, ts = es.step(ss, tr[0], active=mask)
    for f in tb._fields:
        assert torch.equal(getattr(ts, f), getattr(tb, f)), f


@pytest.mark.parametrize("kind", ["heterogeneous", "reactive_poll"])
def test_heterogeneous_and_reactive_poll_fleets(kind):
    """Per-package draws partition with their packages (four node banks,
    one per lane in turn); reactive_poll's latch and its sensor phase on
    the shared clock — bit-equal to broadcast on two partitions."""
    n = 8
    if kind == "heterogeneous":
        cfg = TCfg(n_tiles=4, mode="v24", heterogeneous=True)
    else:
        cfg = TCfg(n_tiles=4, mode="reactive_poll")
    eb = FleetEngine(cfg, backend="broadcast", device="cpu")
    es = _mesh_engine(cfg, devices=2)
    pkg = None
    if kind == "heterogeneous":
        nodes = available_nodes()
        pkg = fleet_package_params(eb.sched,
                                   [nodes[i % len(nodes)] for i in range(n)])
    sb, ss = eb.init(n, pkg=pkg), es.init(n, pkg=pkg)
    if pkg is not None:
        assert isinstance(ss.pkg.decay, Sharded)
        assert torch.equal(gather(ss.pkg.decay), sb.pkg.decay)
    tr = trace(40, n, 4, seed=4) * 1.3
    sb, tb = eb.run_chunked(sb, tr, 16)
    ss, ts = es.run_chunked(ss, tr, 16)
    for f in tb._fields:
        assert torch.equal(getattr(ts, f), getattr(tb, f)), f
    assert_states_equal(ss, sb, kind)
    if kind == "reactive_poll":
        assert int(tb.events_total[-1]) > 0


def test_placement_hooks_are_congruent_with_the_state():
    """`state_pspecs` names the package dimension of every per-package
    leaf (every plane switched on) and None for the shared clocks;
    `output_pspecs` shares η; `ThermalPlant.state_pspec` follows the batch
    axes; with no mesh axis every spec is None."""
    cfg = TCfg(n_tiles=3, mode="v24", heterogeneous=True,
               degraded_fallback=True, mixed_mode=True)
    eng = FleetEngine(cfg, backend="broadcast", device="cpu")
    st = eng.init(5)
    specs = eng.sched.state_pspecs(batch_axes=(FLEET_AXIS,))

    def walk(x, s, name):
        if x is None:
            assert s is None, name
        elif isinstance(x, tuple):
            for f in x._fields:
                walk(getattr(x, f), getattr(s, f), f"{name}.{f}")
        elif name.endswith(("step", "ptr")):
            assert s is None and x.ndim == 0, name
        else:
            assert s == 0 and x.shape[0] == 5, name
    walk(st, specs, "state")
    out = eng.sched.output_pspecs(batch_axes=(FLEET_AXIS,))
    assert out.eta is None and out.freq == 0
    assert eng.sched.plant.state_pspec((None, FLEET_AXIS)) == 1
    assert eng.sched.plant.state_pspec((None,)) is None
    none = eng.sched.state_pspecs()
    assert none.freq is None and none.filtration.buf is None


def test_shard_map_and_lanes_route_by_partition():
    """`fleet_shard_map` splits whole arguments into the mesh's spans and
    refuses one that does not match the fleet; `lane_at` finds a lane's
    partition; a shared output must agree across partitions."""
    mesh = (CPU, CPU)
    x = Sharded([torch.arange(3.0), torch.arange(3.0, 6.0)], 0)
    add = fleet_shard_map(lambda a, b: a + b, mesh, (0, 0), 0)
    out = add(x, torch.ones(6))
    assert torch.equal(gather(out), torch.arange(6.0) + 1)
    assert mesh_of(out) == mesh
    with pytest.raises(ValueError, match="beside a fleet of 6"):
        add(x, torch.ones(4))
    part, i = lane_at(x, 4)
    assert part is x.parts[1] and i == 1
    clock = fleet_shard_map(lambda a: torch.tensor(int(a[0])), mesh, (0,),
                            None)
    with pytest.raises(RuntimeError, match="shared leaf differs"):
        clock(x)
    assert fleet_shard_map(len, None, (0,), None) is len


def test_devices_refused_where_it_does_not_apply():
    cfg = TCfg(n_tiles=2)
    for backend in ("broadcast", "fused", "vmap"):
        with pytest.raises(ValueError, match="device-mesh backends"):
            FleetEngine(cfg, backend=backend, device="cpu", devices=2)
        with pytest.raises(ValueError, match="device-mesh backends"):
            FleetEngine(cfg, backend=backend, device="cpu",
                        device_pool=POOL)
    with pytest.raises(ValueError, match="device-mesh backends"):
        serve.main(["--stream", "--fleet", "4", "--device", "cpu",
                    "--fleet-backend", "fused", "--fleet-devices", "2"])


def test_serve_stream_on_the_mesh_equals_broadcast():
    """``serve --stream --fleet-backend sharded --fleet-devices 0``: the
    CPU engine's pool is its one device, so the mesh is one partition and
    every flush equals broadcast's."""
    args = ["--stream", "--fleet", "24", "--waves", "2", "--gen", "20",
            "--device", "cpu", "--seed", "3"]
    rs = serve.main(args + ["--fleet-backend", "sharded",
                            "--fleet-devices", "0"])
    rb = serve.main(args + ["--fleet-backend", "broadcast"])
    assert rs["flushes"] == rs["host_syncs"] == 2
    assert rs["stream"] == rb["stream"]
