"""PyTorch port, fault injection and the per-package reactive planes: the
port's `FaultPlan` against the reference's word for word, the degraded
fallback (staleness counter, hysteresis latch, held ρ) and the operator's
mixed-mode pins on both backends against the reference's engine, and
`fleet_step`'s ``fb0`` / ``mode0`` planes against the Pallas kernel in
interpret mode."""
import dataclasses
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np

from torch_parity import (TOL, assert_state_close, assert_telemetry_close,
                          np_)
from test_torch_fleet_step import _case, _torch_inputs

from repro.core.pdu_gate import exact_stats as j_exact_stats
from repro.core.scheduler import SchedulerConfig as JCfg
from repro.fleet import FaultPlan as JPlan
from repro.fleet import FleetEngine as JEngine
from repro.fleet.faults import HintOutage as JOutage
from repro.fleet.faults import SensorFault as JSensor
from repro.kernels.fleet_step import fleet_step as j_fleet_step

from repro_torch.convert import state_from_numpy
from repro_torch.core.scheduler import SchedulerConfig as TCfg
from repro_torch.fleet import (FaultPlan, FleetEngine, HintOutage, HostStall,
                               SensorFault)
from repro_torch.kernels import fleet_step as tfs

jax.config.update("jax_platform_name", "cpu")

BACKENDS = ["broadcast", "fused"]
N_TILES = 2
FB = dict(n_tiles=N_TILES, mode="v24", filtration_window=16,
          degraded_fallback=True, stale_limit_steps=4, recover_steps=8)


def _trace(t, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.9, 2.7, (t, n, N_TILES)).astype(np.float32)


def _plans(seed=3, **kw):
    """The same plan in both packages."""
    sensors = kw.get("sensor_faults", ())
    outages = kw.get("hint_outages", ())
    return (FaultPlan(seed=seed, sensor_faults=tuple(
                SensorFault(*f) for f in sensors),
                hint_outages=tuple(HintOutage(*o) for o in outages)),
            JPlan(seed=seed, sensor_faults=tuple(JSensor(*f)
                                                 for f in sensors),
                  hint_outages=tuple(JOutage(*o) for o in outages)))


ALL_KINDS = dict(hint_outages=((10, 7),),
                 sensor_faults=((1, "corrupt", 20, 30),
                                (2, "noise", 40, 30, 0.3),
                                (3, "dropout", 5, 50),
                                (0, "stuck", 60, 20, 1.7)))


@pytest.mark.parametrize("chunk", [96, 32, 17, 1])
def test_fault_plan_apply_matches_reference(chunk):
    """Every kind, applied in ``chunk``-step pieces, gives exactly the
    reference's words (NaN and ±inf included) and the whole-trace words;
    the input is never mutated."""
    trace = _trace(96, 4)
    pristine = trace.copy()
    plan, jplan = _plans(**ALL_KINDS)
    whole = jplan.apply(trace, 0)
    parts = np.concatenate([plan.apply(trace[i:i + chunk], i)
                            for i in range(0, 96, chunk)])
    np.testing.assert_array_equal(parts, whole)
    np.testing.assert_array_equal(
        np.concatenate(list(plan.chunk_source(trace, chunk))), whole)
    np.testing.assert_array_equal(trace, pristine)


def test_fault_plan_validation_generate_and_stall():
    with pytest.raises(ValueError, match="unknown sensor-fault kind"):
        SensorFault(0, "flaky", 0, 4)
    plan = FaultPlan.generate(seed=7, n_packages=8, n_steps=400)
    jplan = JPlan.generate(seed=7, n_packages=8, n_steps=400)
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    assert plan.faulted_lanes() == jplan.faulted_lanes()
    assert plan.describe() == jplan.describe()
    stall = FaultPlan(host_stalls=(HostStall(1, 0.05),))
    t0 = time.monotonic()
    assert len(list(stall.chunk_source(_trace(32, 2), 16))) == 2
    assert time.monotonic() - t0 >= 0.05


@pytest.mark.parametrize("backend", BACKENDS)
def test_fallback_contains_faults_like_the_reference(backend):
    """Dropout and corruption on two lanes: the port's fleet against the
    reference's (state ≤1e-5; events, counters, latches and the degraded
    count exact), the faulted lanes degrade and recover, every other lane
    bit-matches a fault-free run of the port, debug_nan stays silent."""
    n, t, k = 4, 160, 48
    trace = _trace(t, n, seed=11)
    plan, jplan = _plans(seed=2, sensor_faults=((1, "dropout", 40, 30),
                                                (3, "corrupt", 90, 20)))
    faulted = plan.apply(trace, 0)
    je = JEngine(JCfg(**FB), backend="broadcast")
    js, jtel = je.run_chunked(je.init(n), jnp.asarray(jplan.apply(trace, 0)),
                              k)
    te = FleetEngine(TCfg(**FB), backend=backend, device="cpu",
                     debug_nan=True)
    ts, ttel = te.run_chunked(te.init(n), faulted, k)
    assert_state_close(jax.device_get(js), ts, backend,
                       exact_stats=j_exact_stats if backend == "fused"
                       else None)
    for f in ("stale", "degraded"):
        np.testing.assert_array_equal(np_(getattr(ts, f)),
                                      np.asarray(getattr(js, f)), err_msg=f)
    np.testing.assert_allclose(np_(ts.rho_last), np.asarray(js.rho_last),
                               **TOL)
    assert_telemetry_close(jax.device_get(jtel), ttel, backend)
    dc = np_(ttel.degraded_count)
    assert dc.max() >= 1 and dc[-1] == 0
    clean = FleetEngine(TCfg(**FB), backend=backend, device="cpu")
    s0, _ = clean.run_chunked(clean.init(n), trace, k)
    ok = sorted(set(range(n)) - plan.faulted_lanes())
    for f in ("freq", "thermal", "events", "rho_last", "stale", "degraded"):
        assert torch.equal(getattr(ts, f)[ok], getattr(s0, f)[ok]), f


@pytest.mark.parametrize("backend", BACKENDS)
def test_starvation_degrades_whole_fleet_then_recovers(backend):
    n = 4
    plan, _ = _plans(hint_outages=((64, 20),))
    eng = FleetEngine(TCfg(**FB), backend=backend, device="cpu",
                      debug_nan=True)
    st, tel = eng.run_chunked(eng.init(n), plan.apply(_trace(192, n), 0), 32)
    dc = np_(tel.degraded_count)
    assert dc[64 // 32] == n, dc
    assert dc[-1] == 0 and not bool(st.degraded.any())
    stuck, _ = _plans(sensor_faults=((0, "stuck", 20, 40, 1.5),
                                     (2, "noise", 20, 40, 0.2)))
    _, tel = eng.run_chunked(eng.init(n), stuck.apply(_trace(128, n), 0), 32)
    assert int(np_(tel.degraded_count).max()) == 0   # finite: undetectable


@pytest.mark.parametrize("fallback", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_mixed_mode_pins_match_reference(backend, fallback):
    """Operator pins (the ``ctrl_mode`` plane, half the lanes) against the
    reference, with and without the degraded fallback, under a masked
    flush (active lanes only)."""
    n, t = 6, 96
    cfg = dict(FB, degraded_fallback=fallback, mixed_mode=True)
    pins = np.array([True, False, True, True, False, False])
    active = np.array([True, True, False, True, True, True])
    trace = _trace(t, n, seed=5)
    plan, jplan = _plans(seed=1, sensor_faults=((4, "dropout", 30, 25),))
    je = JEngine(JCfg(**cfg), backend="broadcast")
    js = je.init(n)._replace(ctrl_mode=jnp.asarray(pins))
    te = FleetEngine(TCfg(**cfg), backend=backend, device="cpu")
    ts = state_from_numpy(jax.device_get(js), device="cpu")
    jt = jplan.apply(trace, 0) if fallback else trace
    tt = plan.apply(trace, 0) if fallback else trace
    js, jtel = je.run_chunked(js, jnp.asarray(jt), 32, active=active)
    ts, ttel = te.run_chunked(ts, tt, 32, active=active)
    assert torch.equal(ts.ctrl_mode, torch.from_numpy(pins))
    assert_state_close(jax.device_get(js), ts, f"{backend}/{fallback}",
                       exact_stats=j_exact_stats if backend == "fused"
                       else None)
    assert_telemetry_close(jax.device_get(jtel), ttel, f"{backend}/{fallback}")
    assert int(np_(ttel.events_total)[-1]) > 0


@pytest.mark.parametrize("planes", ["fb0", "mode0", "both"])
def test_plain_fleet_step_reactive_planes_match_pallas_kernel(planes):
    """`fleet_step_reference` with the fallback plane (NaN and ±inf spans in
    some packages' ρ) and / or the pin plane vs the reference kernel in
    interpret mode: traces and state ≤1e-5, events, latch, counters and
    held ρ exact."""
    nt, n, t = 4, 12, 40
    jparams, tparams, inputs, _ = _case("v24", nt, n, t)
    fb, mixed = planes in ("fb0", "both"), planes in ("mode0", "both")
    kw = dict(fallback=fb, mixed=mixed, stale_limit=3, recover=4)
    jparams = dataclasses.replace(jparams, **kw)
    tparams = dataclasses.replace(tparams, **kw)
    rng = np.random.default_rng(len(planes))
    thr0 = (rng.random((nt, n)) < 0.5).astype(np.float32)
    jkw, tkw = {}, {}
    if fb:
        inputs["rho"][5:12, :, 1] = np.nan
        inputs["rho"][7, 0, 2] = np.inf
        inputs["rho"][20:22, 3, 3] = -np.inf
        fb0 = (rng.uniform(0.9, 2.7, (nt, n)).astype(np.float32),
               rng.integers(0, 5, n).astype(np.float32),
               (rng.random(n) < 0.3).astype(np.float32))
        jkw["fb0"] = tuple(jnp.asarray(x) for x in fb0)
        tkw["fb0"] = tuple(torch.from_numpy(x) for x in fb0)
    if mixed:
        pin = (rng.random(n) < 0.5).astype(np.float32)
        jkw["mode0"], tkw["mode0"] = jnp.asarray(pin), torch.from_numpy(pin)
    ref = j_fleet_step(*inputs.values(), jparams, thr0=thr0, step0=3,
                       interpret=True, **jkw)
    out = tfs.fleet_step_reference(*_torch_inputs(inputs).values(), tparams,
                                   thr0=torch.from_numpy(thr0), step0=3,
                                   **tkw)
    for name, a, b in zip(("temps", "freqs", "buf", "th"), out[:4], ref[:4]):
        np.testing.assert_allclose(np_(a), np.asarray(b), err_msg=name, **TOL)
    np.testing.assert_array_equal(np_(out[4]), np.asarray(ref[4]))
    np.testing.assert_array_equal(np_(out[5]), np.asarray(ref[5]))
    if fb:
        for name, a, b in zip(("rho_last", "stale", "degraded"), out[6],
                              ref[6]):
            np.testing.assert_array_equal(np_(a), np.asarray(b),
                                          err_msg=name)
    else:
        assert out[6] is None


def test_debug_nan_guard_names_offending_lane():
    """Fallback off: an injected NaN reaches the state and the guard names
    the faulted lane; with the fallback the same run stays silent."""
    plan, _ = _plans(sensor_faults=((2, "dropout", 8, 24),))
    trace = plan.apply(_trace(32, 4), 0)
    eng = FleetEngine(TCfg(**dict(FB, degraded_fallback=False)),
                      device="cpu", debug_nan=True)
    with pytest.raises(ValueError, match=r"lane\(s\) \[2\]"):
        eng.run_block(eng.init(4), trace)
    eng = FleetEngine(TCfg(**FB), device="cpu", debug_nan=True)
    eng.run_block(eng.init(4), trace)
