"""PyTorch port, fleet engine: the fused backend (plain `fleet_step` on the
CPU) and the broadcast backend against the JAX reference's broadcast engine,
through `run_block`, `run_chunked` with a tail window, `step`, masked
telemetry and the streaming ingest loop; state hand-over between the two
packages (`repro_torch.convert`); the serving entry point."""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np

from torch_parity import (TOL, assert_state_close, assert_telemetry_close,
                          drift_probe, np_, trace)

from repro.core import pdu_gate as jpg
from repro.core.scheduler import SchedulerConfig as JCfg
from repro.core.scheduler import SchedulerState as JState
from repro.fleet import FleetEngine as JEngine
from repro.fleet import stream as j_stream

from repro_torch.convert import (state_from_numpy, state_to_numpy,
                                 telemetry_from_numpy)
from repro_torch.core.scheduler import SchedulerConfig as TCfg
from repro_torch.fleet import FleetEngine as TEngine
from repro_torch.fleet import (HintQueue, chunk_source, merge_sources,
                               stream)
from repro_torch.launch import serve

jax.config.update("jax_platform_name", "cpu")

MODES = ["v24", "reactive", "reactive_poll", "off"]
BACKENDS = ["broadcast", "fused"]


def _engines(mode, n_tiles, **kw):
    je = JEngine(JCfg(n_tiles=n_tiles, mode=mode, **kw), backend="broadcast")
    te = {b: TEngine(TCfg(n_tiles=n_tiles, mode=mode, **kw), backend=b,
                     device="cpu") for b in BACKENDS}
    return je, te


def _assert_state(ref, port, backend, where):
    """The fused backend re-derives its sliding stats exactly at window
    exit (as the reference's fused backend does): compare those with the
    reference's exact recompute of its own ring."""
    assert_state_close(jax.device_get(ref), port, f"{where}/{backend}",
                       exact_stats=(jpg.exact_stats if backend == "fused"
                                    else None))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_tiles,n", [(1, 16), (4, 12), (47, 6)])
def test_run_block_matches_reference(mode, n_tiles, n):
    """One 40-step window (two W = 16 wraparounds plus a partial window)."""
    tr = trace(40, n, n_tiles, seed=n_tiles)
    je, te = _engines(mode, n_tiles)
    js, jt = je.run_block(je.init(n), jnp.asarray(tr))
    for b, e in te.items():
        ts, tt = e.run_block(e.init(n), tr)
        assert_telemetry_close(jt, tt, f"{mode}/{b}")
        _assert_state(js, ts, b, mode)


@pytest.mark.parametrize("mode", ["v24", "reactive_poll"])
def test_run_chunked_with_tail_matches_reference(mode):
    """44 steps in flushes of 16: records for 16, 16 and a 12-step tail."""
    tr = trace(44, 10, 4, seed=7)
    je, te = _engines(mode, 4)
    js, jt = je.run_chunked(je.init(10), jnp.asarray(tr), flush_every=16)
    assert jt.temp_p99_c.shape == (3,)
    for b, e in te.items():
        ts, tt = e.run_chunked(e.init(10), tr, flush_every=16)
        assert tuple(tt.temp_p99_c.shape) == (3,)
        assert_telemetry_close(jt, tt, f"chunked/{b}")
        _assert_state(js, ts, b, "chunked")


def test_stream_matches_reference():
    tr = trace(44, 10, 4, seed=8)
    je, te = _engines("v24", 4)
    js, jflush, jstats = j_stream(je, je.init(10), chunk_source(tr, 16))
    for b, e in te.items():
        seen = []
        ts, tflush, tstats = stream(e, e.init(10), chunk_source(tr, 16),
                                    on_flush=lambda i, d: seen.append(i))
        assert seen == [1, 2, 3]
        assert (tstats.steps, tstats.flushes, tstats.host_syncs) == (44, 3, 3)
        assert tstats.syncs_per_flush == 1.0
        assert tstats.queue_peak == jstats.queue_peak
        assert len(tflush) == len(jflush) == 3
        for jd, td in zip(jflush, tflush):
            assert set(jd) == set(td)
            assert_telemetry_close(
                telemetry_from_numpy(jd, device="cpu"),
                telemetry_from_numpy(td, device="cpu"), f"stream/{b}")
        _assert_state(js, ts, b, "stream")


@pytest.mark.parametrize("backend", BACKENDS)
def test_masked_run_block_matches_reference(backend):
    tr = trace(24, 12, 4, seed=9)
    active = np.arange(12) % 3 != 1
    je, te = _engines("v24", 4)
    js, jt = je.run_block(je.init(12), jnp.asarray(tr),
                          active=jnp.asarray(active))
    ts, tt = te[backend].run_block(te[backend].init(12), tr, active=active)
    assert_telemetry_close(jt, tt, f"masked/{backend}")
    assert int(tt.n_packages) == int(active.sum())


def test_step_telemetry_matches_reference():
    """Per-step records (percentiles by sort + linear interpolation),
    dense and masked, with scalar, per-package and per-tile densities."""
    je, te = _engines("v24", 4)
    e = te["broadcast"]
    js, ts = je.init(9), e.init(9)
    active = np.arange(9) < 7
    for i, rho in enumerate([2.2, np.linspace(1.0, 2.6, 9, dtype=np.float32),
                             trace(1, 9, 4, seed=10)[0]]):
        for mask in (None, active):
            js, jo, jt = je.step(js, rho, None if mask is None
                                 else jnp.asarray(mask))
            ts, to, tt = e.step(ts, rho, mask)
            np.testing.assert_allclose(np_(to.temp_c), np.asarray(jo.temp_c),
                                       **TOL)
            assert_telemetry_close(jt, tt, f"step {i}")
    _assert_state(js, ts, "broadcast", "step")


def test_convert_hand_over_mid_run_continues_identically():
    """A state handed over mid-run continues as the reference would: JAX →
    port after 20 steps, and port → JAX after 20 steps."""
    tr = trace(40, 8, 4, seed=11)
    je, te = _engines("reactive_poll", 4)
    js, _ = je.run_block(je.init(8), jnp.asarray(tr[:20]))
    js_end, jt = je.run_block(js, jnp.asarray(tr[20:]))
    for b, e in te.items():
        ts = state_from_numpy(jax.device_get(js), device="cpu")
        ts_end, tt = e.run_block(ts, tr[20:])
        assert_telemetry_close(jt, tt, f"jax->port/{b}")
        _assert_state(js_end, ts_end, b, "jax->port")
    # port → reference: rebuild the reference's NamedTuples from numpy
    e = te["broadcast"]
    ts, _ = e.run_block(e.init(8), tr[:20])
    ts_end, tt = e.run_block(ts, tr[20:])
    n = state_to_numpy(ts)
    js = JState(thermal=n.thermal, filtration=jpg.FiltrationStats(
        **n.filtration._asdict()), freq=n.freq, step=n.step,
        events=n.events, throttled=n.throttled)
    js_end, jt = je.run_block(jax.tree_util.tree_map(jnp.asarray, js),
                              jnp.asarray(tr[20:]))
    assert_telemetry_close(jt, tt, "port->jax")
    assert_state_close(jax.device_get(js_end), ts_end, "port->jax")


def test_convert_round_trip_is_lossless():
    e = TEngine(TCfg(n_tiles=4, mode="reactive_poll"), device="cpu")
    s, _ = e.run_block(e.init(5), trace(21, 5, 4, seed=12))
    back = state_from_numpy(state_to_numpy(s), device="cpu")
    for a, b in zip(s.filtration, back.filtration):
        assert torch.equal(a, b)
    for f in ("thermal", "freq", "step", "events", "throttled"):
        assert torch.equal(getattr(s, f), getattr(back, f)), f


def test_telemetry_as_dict_matches_reference():
    je, te = _engines("v24", 4)
    tr = trace(16, 6, 4, seed=13)
    _, jt = je.run_block(je.init(6), jnp.asarray(tr))
    _, tt = te["fused"].run_block(te["fused"].init(6), tr)
    jd, td = jt.as_dict(), tt.as_dict()
    assert list(jd) == list(td)
    assert isinstance(td["n_packages"], int)
    assert isinstance(td["degraded_count"], int)
    for k in jd:
        assert td[k] == pytest.approx(jd[k], rel=1e-5, abs=1e-5), k


def test_engine_guards():
    e = TEngine(TCfg(n_tiles=4), backend="fused", device="cpu",
                debug_nan=True)
    s = e.init(4)
    with pytest.raises(ValueError, match="empty density trace"):
        e.run_block(s, np.zeros((0, 4, 4), np.float32))
    with pytest.raises(ValueError, match="active mask"):
        e.run_block(s, trace(4, 4, 4), active=np.ones(3, bool))
    bad = trace(4, 4, 4)
    bad[2, 1, 0] = np.nan
    with pytest.raises(ValueError, match="debug_nan"):
        e.run_block(s, bad)
    with pytest.raises(ValueError, match="burn_in"):
        e.run_survey(s, trace(4, 4, 4), burn_in=4)
    with pytest.raises(ValueError, match="empty density trace"):
        e.run_survey(s, np.zeros((0, 4, 4), np.float32))
    with pytest.raises(ValueError, match="unknown fleet backend"):
        TEngine(TCfg(), backend="pmap", device="cpu")


def test_fleet_engine_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("needs a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TEngine()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--stream", "--fleet", "4", "--waves", "1", "--gen", "4"])


def test_ingest_queue_and_sources():
    q = HintQueue(2)
    assert q.offer(np.zeros((5, 2, 1))) and q.offer(np.zeros((3, 2, 1)))
    assert not q.offer(np.zeros((5, 2, 1))) and q.full
    assert q.lookahead_ms(5, 2.0) == 16.0
    assert q.take().shape[0] == 5 and len(q) == 1
    with pytest.raises(ValueError):
        HintQueue(0)
    chunks = list(chunk_source(np.zeros((10, 2, 1)), 4))
    assert [c.shape[0] for c in chunks] == [4, 4, 2]
    merged = list(merge_sources({1: [np.ones((3, 2))] * 2}, capacity=3,
                                n_tiles=2, pad_rho=0.5))
    assert len(merged) == 2 and merged[0].shape == (3, 3, 2)
    assert (merged[0][:, 1] == 1).all() and (merged[0][:, 0] == 0.5).all()
    with pytest.raises(ValueError, match="disagree"):
        list(merge_sources({0: [np.ones((3, 2))], 1: [np.ones((4, 2))]},
                           capacity=2, n_tiles=2))


def test_serve_stream_runs_on_cpu_and_backends_agree():
    args = ["--stream", "--fleet", "24", "--waves", "3", "--gen", "20",
            "--device", "cpu", "--seed", "3"]
    rf = serve.main(args + ["--fleet-backend", "fused"])
    rb = serve.main(args + ["--fleet-backend", "broadcast"])
    assert rf["flushes"] == rf["host_syncs"] == 3
    assert rf["trace"].shape == (60, 24, 1)
    np.testing.assert_array_equal(rf["trace"], rb["trace"])
    for a, b in zip(rf["stream"], rb["stream"]):
        assert_telemetry_close(telemetry_from_numpy(b, device="cpu"),
                               telemetry_from_numpy(a, device="cpu"),
                               "serve")


@pytest.mark.parametrize("flags,step", [
    (["--stream", "--distributed"], 9)])
def test_serve_unported_paths_exit_nonzero(flags, step):
    with pytest.raises(SystemExit) as exc:
        serve.main(flags + ["--device", "cpu"])
    assert exc.value.code not in (0, None)
    assert f"ROADMAP queue 1 step {step}" in str(exc.value.code)


def test_serve_resident_control_plane_runs_on_cpu():
    """``--serve`` (ROADMAP queue 1 step 8): the resident service warms its
    buckets, attaches the fleet, answers on an ephemeral port and stops
    after the asked flushes, one host copy each."""
    res = serve.main(["--serve", "--serve-flushes", "2", "--port", "0",
                      "--device", "cpu", "--fleet", "3"])
    assert res["flushes"] == res["host_syncs"] == 2
    assert res["n_active"] == 3 and res["port"] > 0
    assert res["preempted"] is False


def test_serve_chaos_soak_passes_on_cpu():
    """``--chaos``: starvation and recovery, sensor-fault containment on
    every backend, the degraded alert's edges and SIGTERM → snapshot →
    restore equivalence, every gate passing."""
    assert serve.main(["--chaos", "--device", "cpu"]) == {"chaos": "ok"}


@pytest.mark.parametrize("flags", [
    ["--montecarlo", "4", "--mc-steps", "500"],
    ["--stream", "--node", "n3", "--fleet", "4", "--waves", "1",
     "--gen", "8"]])
def test_serve_ported_paths_run(flags):
    """The two paths ROADMAP queue 1 step 5 ported: the Monte-Carlo
    population and a node-bank fleet."""
    res = serve.main(flags + ["--device", "cpu"])
    if "--montecarlo" in flags:
        assert res["result"].peak_t_v24.shape == (4,)
        assert all(np.isfinite(v) for v in res["montecarlo"].values())
    else:
        assert res["flushes"] == 1
        assert all(np.isfinite(v) for v in res["stream"][0].values())


# The coupled v24 law's knife edge (ROADMAP queue 3).  Where budget − neigh
# cancels, the summation order of the Γ products alone moves freq past
# 1e-5 on a long, heavily throttled run.  The port sums Γ·p as one FMA chain
# shared with its CUDA kernels.  The reference's compiled dot picks its
# order by shape (`torch_parity.xla_dot_order`): four strided FMA lanes
# (`lane4_coupling`) for 4..100 tiles with enough packages, the FMA chain
# at 3 tiles, 512 tiles or few packages, neither for a 1-D p — so no one
# order matches it at every call site.  With the lane order put into the
# port on this trace's shape the drift still is 6.7e-6 (other compiled
# roundings).  So the port is held to a multiple of the spread between the
# reference's own two engines (fused vs broadcast, which differ in that
# order) on the same trace.
KNIFE_SPREAD_MULTIPLE = 4.0


def test_knife_edge_drift_within_reference_spread():
    """`tests/torch_parity.py`'s probe: 40 packages × 4 tiles, a 60-step
    uniform trace over [0.9, 2.7] (seed 7), stepped one step at a time."""
    rows = np.asarray(drift_probe(), np.float64)
    port_f, port_thr, ref_f, ref_thr = rows[:, 1:].max(axis=0)
    assert ref_f > 0.0 and ref_thr > 0.0       # the trace is on the edge
    assert port_f <= KNIFE_SPREAD_MULTIPLE * ref_f, (port_f, ref_f)
    assert port_thr <= KNIFE_SPREAD_MULTIPLE * ref_thr, (port_thr, ref_thr)
