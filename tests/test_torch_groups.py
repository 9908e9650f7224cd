"""PyTorch port, the vmap backend, profile-group dispatch and the registry:
the gates of tests/test_fleet_groups.py, plus the port's ``vmap`` and
`GroupedFleetEngine` against the JAX reference on the same numpy inputs.

Bounds are `torch_parity`'s (traces and state ≤1e-5, counters exact,
``freq_min`` / ``at_risk_frac`` ≤1e-3); a grouped fleet against per-group
oracles inside the port is bitwise, since grouping only re-blocks the lane
axis.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import TOL, assert_telemetry_close, np_, trace

from repro.core import nodebank as jnodebank
from repro.core.scheduler import SchedulerConfig as JConfig
from repro.fleet import FleetEngine as JEngine
from repro.fleet import FleetRegistry as JRegistry
from repro.fleet import GroupedFleetEngine as JGrouped
from repro.fleet import LaneProfile as JProfile
from repro_torch.convert import package_params_from_numpy
from repro_torch.core import nodebank
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.fleet import (FleetEngine, FleetRegistry, GroupedFleetEngine,
                               LaneProfile, available_backends)

TILES, T, W = 2, 96, 16
POLE_N, GRID_N = 6, 4
NODES = ["base", "n7", "n5", "n3", "base", "n5"]
BACKENDS = ["broadcast", "fused", "vmap"]
CPU = "cpu"


def _cfg(**kw):
    kw.setdefault("n_tiles", TILES)
    kw.setdefault("mode", "v24")
    kw.setdefault("filtration_window", W)
    return SchedulerConfig(**kw)


def _jcfg(**kw):
    kw.setdefault("n_tiles", TILES)
    kw.setdefault("mode", "v24")
    kw.setdefault("filtration_window", W)
    return JConfig(**kw)


# ------------------------------------------------------------ vmap backend
def test_vmap_is_registered_beside_broadcast_and_fused():
    assert available_backends() == BACKENDS[:1] + [
        "fused", "sharded", "sharded_fused", "vmap"]


@pytest.mark.parametrize("kw", [
    dict(mode="v24"), dict(mode="reactive_poll"),
    dict(mode="v24", filtration_impl="ring"),
    dict(mode="v24", mixed_mode=True),
    dict(mode="v24", degraded_fallback=True, stale_limit_steps=4,
         recover_steps=8)],
    ids=["v24", "reactive_poll", "ring", "mixed", "fallback"])
def test_vmap_matches_reference_vmap(kw):
    """Per-lane clocks: records per window, state and the [n] step / ptr
    counters equal the reference's vmapped lanes, with lanes whose clocks
    were restarted at different steps (a fresh lane scattered in)."""
    n = 6
    je, te = (JEngine(_jcfg(**kw), backend="vmap"),
              FleetEngine(_cfg(**kw), backend="vmap", device=CPU))
    tr = trace(40, n, TILES, seed=3)
    if kw.get("degraded_fallback"):
        tr[10:20, 2, :] = np.nan
    js, ts = je.init(n), te.init(n)
    if kw.get("mixed_mode"):
        pin = np.array([1, 0, 1, 0, 0, 1], bool)
        js = js._replace(ctrl_mode=jnp.asarray(pin))
        ts = ts._replace(ctrl_mode=torch.from_numpy(pin))
    js, jt = je.run_chunked(js, jnp.asarray(tr[:19]), W)
    ts, tt = te.run_chunked(ts, tr[:19], W)
    assert_telemetry_close(jax.device_get(jt), tt, "vmap")
    # restart lanes 1 and 4 from a fresh state (the service's attach)
    fj, ft = je.init(n), te.init(n)
    lanes = np.array([1, 4])
    js = jax.tree_util.tree_map(
        lambda a, b: a.at[lanes].set(b[lanes]) if a.ndim else a, js, fj)
    ts = ts._replace(
        step=torch.where(torch.isin(torch.arange(n), torch.from_numpy(lanes)),
                         ft.step, ts.step),
        filtration=ts.filtration._replace(
            ptr=torch.where(torch.isin(torch.arange(n),
                                       torch.from_numpy(lanes)),
                            ft.filtration.ptr, ts.filtration.ptr)))
    for f in ("thermal", "freq"):
        getattr(ts, f)[lanes] = getattr(ft, f)[lanes]
    ts.filtration.buf[lanes] = ft.filtration.buf[lanes]
    for f in ("wsum", "csum", "rsum"):
        if hasattr(ts.filtration, f):
            getattr(ts.filtration, f)[lanes] = getattr(ft.filtration,
                                                       f)[lanes]
    js, jt = je.run_chunked(js, jnp.asarray(tr[19:]), W)
    ts, tt = te.run_chunked(ts, tr[19:], W)
    assert_telemetry_close(jax.device_get(jt), tt, "vmap after restart")
    np.testing.assert_array_equal(np_(ts.step), np.asarray(js.step))
    np.testing.assert_array_equal(np_(ts.filtration.ptr),
                                  np.asarray(js.filtration.ptr))
    assert len(set(np_(ts.step).tolist())) == 2
    for f in ("thermal", "freq"):
        np.testing.assert_allclose(np_(getattr(ts, f)),
                                   np.asarray(getattr(js, f)), **TOL)
    np.testing.assert_array_equal(np_(ts.events), np.asarray(js.events))


# ------------------------------------------------- per-lane controller mode
def test_mode_pins_match_per_mode_oracles_bitwise():
    n = 8
    tr = torch.from_numpy(trace(T, n, TILES))
    pin = torch.zeros(n, dtype=torch.bool)
    pin[::2] = True
    em = FleetEngine(_cfg(mixed_mode=True), device=CPU)
    _, tm, fm = em.block_traces(em.init(n)._replace(ctrl_mode=pin), tr)
    oracles = {}
    for mode in ("v24", "reactive_poll"):
        e = FleetEngine(_cfg(mode=mode), device=CPU)
        oracles[mode] = e.block_traces(e.init(n), tr)[1:]
    for lane in range(n):
        want_t, want_f = oracles["reactive_poll" if pin[lane] else "v24"]
        assert torch.equal(tm[:, lane], want_t[:, lane]), lane
        assert torch.equal(fm[:, lane], want_f[:, lane]), lane


@pytest.mark.parametrize("backend", BACKENDS)
def test_mixed_mode_backends_agree(backend):
    n = 8
    tr = torch.from_numpy(trace(T, n, TILES, seed=3))
    pin = torch.zeros(n, dtype=torch.bool)
    pin[1::2] = True

    def run(be):
        e = FleetEngine(_cfg(mixed_mode=True), backend=be, device=CPU)
        st, temps, freqs = e.block_traces(e.init(n)._replace(ctrl_mode=pin),
                                          tr)
        return st, temps, freqs

    s0, t0, f0 = run("broadcast")
    s1, t1, f1 = run(backend)
    torch.testing.assert_close(t1, t0, **TOL)
    torch.testing.assert_close(f1, f0, **TOL)
    assert torch.equal(s1.events, s0.events)
    assert torch.equal(s1.ctrl_mode, pin)


# --------------------------------------------------- profile-group dispatch
def _grouped(backend):
    cfg = _cfg(mixed_mode=True, heterogeneous=True)
    ge = GroupedFleetEngine(cfg, backend=backend, groups=("pole", "grid"),
                            device=CPU)
    pkg = {"pole": nodebank.fleet_package_params(ge.engines["pole"].sched,
                                                 NODES)}
    states = ge.init({"pole": POLE_N, "grid": GRID_N}, pkg=pkg)
    pins = {"pole": torch.tensor([0, 1, 0, 1, 1, 0], dtype=torch.bool),
            "grid": torch.tensor([1, 0, 0, 1], dtype=torch.bool)}
    for g in ge.groups:
        states[g] = states[g]._replace(ctrl_mode=pins[g])
    return ge, states, pins, pkg


@pytest.mark.parametrize("backend", BACKENDS)
def test_grouped_matches_per_group_oracles_bitwise(backend):
    ge, states, pins, pkg = _grouped(backend)
    tr = torch.from_numpy(trace(T, POLE_N + GRID_N, TILES, seed=11))
    _, temps, freqs = ge.block_traces(states, tr)
    sl = ge.lane_slices(states)
    for g in ge.groups:
        eng = FleetEngine(ge.engines[g].cfg, backend=backend, device=CPU)
        st = eng.init(sl[g].stop - sl[g].start, pkg=pkg.get(g))
        _, tg, fg = eng.block_traces(st._replace(ctrl_mode=pins[g]),
                                     tr[:, sl[g]])
        assert torch.equal(temps[:, sl[g]], tg), g
        assert torch.equal(freqs[:, sl[g]], fg), g


@pytest.mark.parametrize("backend", BACKENDS)
def test_grouped_matches_reference(backend):
    """A pole + grid fleet with node banks, pins and a lane mask: each
    merged flush record and one merged step equal the reference's
    `GroupedFleetEngine` on the same chunks."""
    kw = dict(mixed_mode=True, heterogeneous=True)
    jg = JGrouped(_jcfg(**kw), backend=backend, groups=("pole", "grid"))
    tg = GroupedFleetEngine(_cfg(**kw), backend=backend,
                            groups=("pole", "grid"), device=CPU)
    jpkg = jnodebank.fleet_package_params(jg.engines["pole"].sched, NODES)
    counts = {"pole": POLE_N, "grid": GRID_N}
    js = jg.init(counts, pkg={"pole": jpkg})
    ts = tg.init(counts, pkg={"pole": package_params_from_numpy(
        jax.device_get(jpkg), device=CPU)})
    pins = {"pole": np.array([0, 1, 0, 1, 1, 0], bool),
            "grid": np.array([1, 0, 0, 1], bool)}
    for g in ("pole", "grid"):
        js[g] = js[g]._replace(ctrl_mode=jnp.asarray(pins[g]))
        ts[g] = ts[g]._replace(ctrl_mode=torch.from_numpy(pins[g]))
    tr = trace(3 * W, POLE_N + GRID_N, TILES, seed=11)
    act = np.ones(POLE_N + GRID_N, bool)
    act[[0, POLE_N]] = False
    js, jt = jg.run_chunked(js, jnp.asarray(tr), W, active=jnp.asarray(act))
    ts, tt = tg.run_chunked(ts, tr, W, active=act)
    assert_telemetry_close(jax.device_get(jt), tt, f"grouped {backend}")
    _, jo, jtel = jg.step(js, jnp.asarray(tr[0]))
    _, to, ttel = tg.step(ts, tr[0])
    assert_telemetry_close(jax.device_get(jtel), ttel, "grouped step")
    np.testing.assert_allclose(np_(to.temp_c), np.asarray(jo.temp_c), **TOL)


def test_grouped_merged_flush_record():
    ge, states, _, _ = _grouped("broadcast")
    n = POLE_N + GRID_N
    tr = trace(T, n, TILES, seed=13)
    states, telems = ge.run_chunked(states, tr, W)
    assert int(telems.n_packages[-1]) == n
    want = sum(int(states[g].events.sum()) for g in ge.groups)
    assert int(telems.events_total[-1]) == want
    ge2, states2, _, _ = _grouped("broadcast")
    active = np.ones(n, bool)
    active[[0, POLE_N]] = False
    _, telems2 = ge2.run_chunked(states2, tr, W, active=active)
    assert int(telems2.n_packages[-1]) == n - 2


def test_grouped_lane_order_stable_across_group_resize():
    cfg = _cfg(mixed_mode=True, heterogeneous=True)
    trace_pole = trace(T, POLE_N, TILES, seed=17)

    def run(grid_n):
        ge = GroupedFleetEngine(cfg, groups=("pole", "grid"), device=CPU)
        pkg = {"pole": nodebank.fleet_package_params(
            ge.engines["pole"].sched, NODES)}
        states = ge.init({"pole": POLE_N, "grid": grid_n}, pkg=pkg)
        sl = ge.lane_slices(states)
        assert sl["pole"] == slice(0, POLE_N)
        assert sl["grid"] == slice(POLE_N, POLE_N + grid_n)
        tr = np.concatenate([trace_pole, trace(T, grid_n, TILES,
                                               seed=19 + grid_n)], axis=1)
        _, temps, _ = ge.block_traces(states, tr)
        return temps[:, sl["pole"]]

    assert torch.equal(run(4), run(8))


def test_grouped_validation():
    cfg = _cfg()
    with pytest.raises(ValueError, match="unique"):
        GroupedFleetEngine(cfg, groups=("pole", "pole"), device=CPU)
    ge = GroupedFleetEngine(cfg, groups=("pole", "grid"), device=CPU)
    with pytest.raises(ValueError, match="counts"):
        ge.init({"pole": 4})
    states = ge.init(4)
    with pytest.raises(ValueError, match="lane axis"):
        ge.run_block(states, np.zeros((8, 3, TILES), np.float32))
    assert ge.describe() == "groups[pole,grid]@broadcast"


def test_fused_groups_take_the_kernel_and_grid_steps():
    """On ``fused`` the pole and ROM groups keep the whole-window path and
    the grid group the per-step one (`FusedBackend` drops it)."""
    ge = GroupedFleetEngine(_cfg(), backend="fused",
                            groups=("pole", "rom", "grid"), device=CPU)
    assert ge.engines["pole"].backend_impl.run_block is not None
    assert ge.engines["rom"].backend_impl.run_block is not None
    assert ge.engines["grid"].backend_impl.run_block is None


# ------------------------------------- registry surgery keeps profiles/lanes
def _registry_invariants(reg):
    mask = reg.ctrl_mode_mask()
    act = reg.active_mask()
    for pkg, lane in reg.packages.items():
        assert act[lane]
        assert mask[lane] == (reg.profile(pkg).mode == "reactive_poll")
    assert act.sum() == reg.n_active
    assert mask[~act].sum() == 0


def test_profiles_follow_lanes_across_grow_and_shrink():
    reg = FleetRegistry(min_capacity=4)
    for i in range(10):
        reg.attach(f"p{i}", profile=LaneProfile(
            node=NODES[i % len(NODES)],
            mode="reactive_poll" if i % 3 == 0 else "v24"))
        _registry_invariants(reg)
    assert reg.capacity == 16
    for i in range(2, 10):
        reg.detach(f"p{i}")
        _registry_invariants(reg)
    assert reg.capacity < 16
    assert reg.profile("p0").mode == "reactive_poll"
    assert reg.profile("p1").mode == "v24"
    assert reg.profile("p1").node == NODES[1]


def test_canary_monotone_and_idempotent():
    reg = FleetRegistry(min_capacity=4)
    for i in range(8):
        reg.attach(f"p{i}")
    pinned = set()
    for frac in (0.0, 0.25, 0.5, 0.5, 0.75, 1.0):
        out = reg.canary(frac)
        now = {p for p in reg.packages
               if reg.profile(p).mode == "reactive_poll"}
        assert len(now) == out["pinned_reactive"] == round(frac * 8)
        if len(now) >= len(pinned):
            assert pinned <= now
        pinned = now
        _registry_invariants(reg)
    assert reg.canary(0.5)["changed"] == 4
    with pytest.raises(ValueError, match="reactive_frac"):
        reg.canary(1.5)


def test_registry_matches_reference_on_random_churn():
    """The host bookkeeping is the reference's word for word: a seeded
    sequence of attaches, detaches, canary shifts and threshold edits
    gives the same lanes, plans, permutations, masks, ids and arrays."""
    rng = np.random.default_rng(21)
    ref, port = JRegistry(min_capacity=4, max_tenants=3), FleetRegistry(
        min_capacity=4, max_tenants=3)
    for _ in range(300):
        op, i = rng.integers(0, 4), int(rng.integers(0, 24))
        name, tenant = f"p{i}", ("acme", "zeta", "orion")[i % 3]
        if op <= 1 and name not in ref.packages:
            mode = "reactive_poll" if i % 2 else "v24"
            a = ref.attach(name, tenant, profile=JProfile(mode=mode))
            b = port.attach(name, tenant, profile=LaneProfile(mode=mode))
        elif op == 2 and name in ref.packages:
            a, b = ref.detach(name), port.detach(name)
        else:
            frac = float(rng.uniform())
            a, b = ref.canary(frac), port.canary(frac)
            ref.set_thresholds(tenant, t_crit_c=60 + i)
            port.set_thresholds(tenant, t_crit_c=60 + i)
        if isinstance(a, tuple):
            assert a[0] == b[0]
            assert (a[1].kind, a[1].old_capacity, a[1].new_capacity,
                    a[1].perm) == (b[1].kind, b[1].old_capacity,
                                   b[1].new_capacity, b[1].perm)
        else:
            assert a == b
        assert ref.describe() == port.describe()
        for f in ("active_mask", "ctrl_mode_mask", "tenant_lane_ids",
                  "slot_names"):
            np.testing.assert_array_equal(getattr(port, f)(),
                                          getattr(ref, f)())
        for k, v in ref.threshold_arrays().items():
            np.testing.assert_array_equal(port.threshold_arrays()[k], v)
