"""PyTorch port, the `fleet_step` kernel over the device mesh
(`fleet/backends/sharded_fused.py`), on the CPU through the kernel's plain
version, partitions on a pool of repeated CPU devices.

`sharded_fused` at 1, 2 and 4 partitions is held bit for bit to `fused`
(its single-partition parent: each partition keeps `fused`'s conventions,
so the fresh-lane statistics of ROADMAP queue 3 match too), and to the
reference's `fused` in interpret mode within `torch_parity`'s bounds.
Also: the degraded-fallback, mixed-mode and wide (past 128 tiles) fleets,
`run_survey` and `montecarlo.run` on the mesh, `FleetService` on
`sharded_fused` against the same service on `fused` (grow, canary, shrink,
snapshot and restore), `reshard_state` from 4 partitions to 2, and the grid
plant's per-step route.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from torch_parity import assert_state_close, assert_telemetry_close, trace

from repro.core import pdu_gate as jpg
from repro.core.scheduler import SchedulerConfig as JCfg
from repro.fleet import FleetEngine as JEngine
from repro_torch.core import montecarlo
from repro_torch.core.scheduler import SchedulerConfig as TCfg
from repro_torch.distributed import (FLEET_AXIS, Sharded, fleet_mesh, gather,
                                     reshard_state)
from repro_torch.fleet import FleetEngine, FleetService

jax.config.update("jax_platform_name", "cpu")

CPU = torch.device("cpu")
POOL = [CPU] * 4


def _pair(cfg, nd, parent="fused", backend="sharded_fused"):
    return (FleetEngine(cfg, backend=parent, device="cpu"),
            FleetEngine(cfg, backend=backend, device="cpu", devices=nd,
                        device_pool=POOL))


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


def assert_records_equal(a, b, where=""):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f"{where} {f}"


@pytest.mark.parametrize("nd", [1, 2, 4])
def test_sharded_fused_bitmatches_fused(nd):
    """Windows of 16 with a tail of 8, then one window's traces: every lane
    bit-equal to `fused`, telemetry equal, one window per partition."""
    cfg = TCfg(n_tiles=4, mode="v24", filtration_window=16)
    ef, es = _pair(cfg, nd)
    tr = trace(40, 16, 4, seed=nd)
    sf, rf = ef.run_chunked(ef.init(16), tr, 16)
    ss, rs = es.run_chunked(es.init(16), tr, 16)
    assert es.backend_impl.describe() == f"sharded_fused[{nd}dev,blk=plain]"
    assert len(ss.thermal.parts) == nd
    assert_records_equal(rf, rs, "chunked")
    assert_states_equal(ss, sf, f"{nd} partitions")
    chunk = trace(16, 16, 4, seed=9)
    sf, tf, ff = ef.backend_impl.run_block(sf, ef.backend_impl.put_trace(
        chunk))
    ss, ts, fs_ = es.backend_impl.run_block(ss, es.backend_impl.put_trace(
        chunk))
    assert isinstance(ts, Sharded) and ts.dim == 1
    assert torch.equal(gather(ts), tf) and torch.equal(gather(fs_), ff)
    assert_states_equal(ss, sf, "window")


def test_sharded_fused_matches_the_reference_fused_kernel():
    """Against the reference's `fused` (its Pallas kernel in interpret
    mode) on a short trace, on three partitions of three (not a multiple of
    the warp's 32): ≤1e-5, events exact, the statistics as the fused
    backends re-derive them."""
    tr = trace(40, 9, 4, seed=5)
    je = JEngine(JCfg(n_tiles=4, mode="v24", filtration_window=16),
                 backend="fused")
    es = FleetEngine(TCfg(n_tiles=4, mode="v24", filtration_window=16),
                     backend="sharded_fused", device="cpu", devices=3,
                     device_pool=POOL)
    js, jred = je.run_chunked(je.init(9), jnp.asarray(tr), 16)
    ss, sred = es.run_chunked(es.init(9), tr, 16)
    assert [p.shape[0] for p in ss.freq.parts] == [3, 3, 3]
    assert_telemetry_close(jax.device_get(jred), sred, "reference fused")
    assert_state_close(jax.device_get(js), gather(ss), "reference fused",
                       exact_stats=jpg.exact_stats)


@pytest.mark.parametrize("plane", ["fallback", "mixed", "wide"])
def test_per_package_planes_partition_with_their_packages(plane):
    """The degraded fallback (NaN and inf spans in the density), operator
    pins (the ctrl_mode plane placed by `put_mask`) and a 130-tile
    coupled fleet — the kernel's wide layout on a card — bit-equal to
    `fused` on two partitions, masked flushes included."""
    n = 6
    kw = dict(mode="v24", filtration_window=16)
    if plane == "fallback":
        cfg = TCfg(n_tiles=2, degraded_fallback=True, stale_limit_steps=4,
                   recover_steps=8, **kw)
    elif plane == "mixed":
        cfg = TCfg(n_tiles=2, mixed_mode=True, **kw)
    else:
        cfg = TCfg(n_tiles=130, degraded_fallback=True, **kw)
    tiles = cfg.n_tiles
    ef, es = _pair(cfg, 2)
    tr = trace(24 if plane == "wide" else 48, n, tiles, seed=6) * 1.3
    if plane != "mixed":
        tr[5:14, 1, :] = np.nan
        tr[20:23, 4, 0] = np.inf
    sf, ss = ef.init(n), es.init(n)
    if plane == "mixed":
        pins = np.array([True, False, True, True, False, False])
        sf = sf._replace(ctrl_mode=ef.backend_impl.put_mask(pins))
        ss = ss._replace(ctrl_mode=es.backend_impl.put_mask(pins))
        assert isinstance(ss.ctrl_mode, Sharded)
    active = np.array([True, True, False, True, True, True])
    sf, rf = ef.run_chunked(sf, tr, 16, active=active)
    ss, rs = es.run_chunked(ss, tr, 16, active=active)
    assert_records_equal(rf, rs, plane)
    assert_states_equal(ss, sf, plane)
    if plane == "fallback":
        assert int(rf.degraded_count.max()) > 0


@pytest.mark.parametrize("backend,parent", [("sharded_fused", "fused"),
                                            ("sharded", "broadcast")])
def test_run_survey_on_the_mesh(backend, parent):
    """Per-lane accumulators partitioned like the state (blocks of 16 on
    the kernel, per step on `sharded`), the survey gathered: equal to the
    single-partition parent's; the returned state stays partitioned."""
    cfg = TCfg(n_tiles=4, mode="v24", filtration_window=16)
    ep, es = _pair(cfg, 4, parent=parent, backend=backend)
    tr = trace(40, 8, 4, seed=7) * 1.3
    sp, vp = ep.run_survey(ep.init(8), tr, burn_in=10, chunk=16)
    ss, vs = es.run_survey(es.init(8), tr, burn_in=10, chunk=16)
    for f in vp._fields:
        assert torch.equal(getattr(vs, f), getattr(vp, f)), f
    assert isinstance(ss.freq, Sharded) and len(ss.freq.parts) == 4
    assert_states_equal(ss, sp, "survey")
    assert float(vp.exceed_frac.max()) > 0.0


def test_montecarlo_run_on_the_mesh():
    """`montecarlo.run` with ``backend="sharded_fused"`` on two partitions
    (the trials packed 8 a package): every per-trial statistic equal to
    the `fused` run's."""
    kw = dict(seed=3, n_trials=32, n_steps=500, burn_in=100, device="cpu")
    got = montecarlo.run(backend="sharded_fused", devices=2,
                         device_pool=POOL, **kw)
    want = montecarlo.run(backend="fused", **kw)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.stats() == want.stats()


def _service(backend, **kw):
    cfg = TCfg(n_tiles=2, mode="v24", filtration_window=16,
               mixed_mode=True, heterogeneous=True)
    mesh = (dict(device_pool=POOL) if backend == "sharded_fused" else {})
    return FleetService(cfg, backend=backend, min_capacity=4, flush_every=16,
                        device="cpu", seed=7, **mesh, **kw)


def _drive(svc, k):
    """The scenario's membership op before flush ``k``."""
    if k == 0:
        for i in range(3):
            svc.attach(f"p{i}", "acme", node="n5" if i % 2 else "base")
        svc.set_thresholds("acme", t_crit_c=70.0)
    elif k == 2:                                   # 3 + 4 > 4: grow to 8
        for i in range(3, 7):
            svc.attach(f"p{i}", "zeta", "training")
    elif k == 3:
        svc.canary(0.5)
    elif k == 5:                                   # 2 left: shrink to 4
        for i in range(5):
            svc.detach(f"p{i}")


def test_service_on_sharded_fused_matches_fused(tmp_path):
    """The resident service on four partitions against the same service on
    `fused` (same seed, so the same synthetic chunks): every flush record
    equal through grow, canary and shrink, one host copy a flush; the
    ctrl-mode plane and node rows partitioned like the state; a snapshot
    restored onto the mesh (its journal re-driven, the lost windows
    re-synthesised) reaches the uninterrupted service's state and goes on
    with it."""
    a = _service("sharded_fused", snapshot_dir=str(tmp_path))
    b = _service("fused")
    for k in range(7):
        for s in (a, b):
            _drive(s, k)
        ra, rb = a.tick(), b.tick()
        assert ra["telemetry"] == rb["telemetry"], k
        assert ra["tenants"] == rb["tenants"], k
        assert ra["capacity"] == rb["capacity"], k
        assert isinstance(a.state.ctrl_mode, Sharded)
        if k == 3:
            a.save_snapshot(blocking=True)
    assert a.host_syncs == b.host_syncs == 7
    assert a.engine.backend_impl.describe() == "sharded_fused[4dev,blk=plain]"
    assert_states_equal(a.state, b.state, "service")
    r = FleetService.restore(str(tmp_path), device="cpu", device_pool=POOL)
    assert 3 < r.flushes <= a.flushes    # the journal re-driven past it
    while r.flushes < a.flushes:         # the windows after the last op
        r.tick()
    assert len(r.state.freq.parts) == 4
    assert_states_equal(r.state, a.state, "restored")
    for s in (a, b, r):
        s.attach("q", "vega")
    ra, rb, rr = a.tick(), b.tick(), r.tick()
    assert ra["telemetry"] == rb["telemetry"] == rr["telemetry"]


def test_reshard_state_from_four_partitions_to_two():
    """`reshard_state` re-places a running fleet from 4 partitions onto 2
    (and a whole state onto 4); each continues bit-equal to `fused`."""
    cfg = TCfg(n_tiles=4, mode="v24", filtration_window=16,
               degraded_fallback=True)
    ef, es = _pair(cfg, 4)
    tr = trace(64, 8, 4, seed=8)
    sf, _ = ef.run_chunked(ef.init(8), tr[:32], 16)
    ss, _ = es.run_chunked(es.init(8), tr[:32], 16)
    specs = es.sched.state_pspecs(batch_axes=(FLEET_AXIS,))
    two = reshard_state(ss, fleet_mesh(2, POOL), specs)
    assert [p.shape[0] for p in two.thermal.parts] == [4, 4]
    assert two.step is ss.step                      # shared clocks stay
    assert_states_equal(two, ss, "resharded")
    four = reshard_state(sf, fleet_mesh(4, POOL), specs)
    assert len(four.freq.parts) == 4
    sf, rf = ef.run_chunked(sf, tr[32:], 16)
    for st in (two, four):
        st, rs = es.run_chunked(st, tr[32:], 16)
        assert_records_equal(rf, rs, "after reshard")
        assert_states_equal(st, sf, "after reshard")


def test_grid_plant_takes_the_sharded_per_step_route():
    """The grid plant has no fused path: `run_block` is None, as on
    `fused`, and the fleet steps through the sharded `update` — equal to
    `fused`'s own per-step route."""
    cfg = TCfg(n_tiles=2, mode="v24", plant="grid", filtration_window=16)
    ef, es = _pair(cfg, 2)
    assert es.backend_impl.run_block is None
    assert ef.backend_impl.run_block is None
    assert es.backend_impl.describe() == "sharded_fused[2dev,blk=None]"
    tr = trace(20, 4, 2, seed=10)
    sf, rf = ef.run_chunked(ef.init(4), tr, 10)
    ss, rs = es.run_chunked(es.init(4), tr, 10)
    assert_records_equal(rf, rs, "grid")
    assert_states_equal(ss, sf, "grid")
