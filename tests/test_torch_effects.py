"""PyTorch port, the paper's effect models: DVFS (Effect ①), CPO (②), HBM
(③), SerDes (§6), the Appendix-B dataset and the telemetry budget, against
the JAX reference on identical numpy inputs.  The port's own random draws
(`workload.make_trace`, `dataset90k.generate`) come from torch generators
and are checked on statistics only."""
import json

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

from torch_parity import TOL, np_

from repro.core import (coupling as jcoupling, cpo as jcpo,
                        dataset90k as jds, dvfs as jdvfs, hbm as jhbm,
                        serdes as jserdes, telemetry as jtelemetry,
                        thermal as jthermal, workload as jworkload)

from repro_torch.core import (coupling as tcoupling, cpo as tcpo,
                              dataset90k as tds, dvfs as tdvfs, hbm as thbm,
                              serdes as tserdes, telemetry as ttelemetry,
                              thermal as tthermal, workload as tworkload)

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module")
def ref_traces():
    """The reference's effect traces (tests/test_effects.py's fixture)."""
    key = jax.random.PRNGKey(7)
    return {k: np.array(jworkload.make_trace(key, 5000, k))
            for k in jworkload.KINDS}


def _assert_sim_close(ref, port, where):
    for f in ("freq", "temp", "perf", "p99_latency"):
        np.testing.assert_allclose(np_(getattr(port, f)),
                                   np.asarray(getattr(ref, f)),
                                   err_msg=f"{where} {f}", **TOL)
    assert int(port.events) == int(ref.events), where


@pytest.mark.parametrize("kind", ["inference", "training", "vision", "batch"])
def test_released_compute_matches_reference(ref_traces, kind):
    """Released compute per kind equals the reference's on its own traces
    (0.202 / 0.230 / 0.182 / 0.171 at seed 7, 5,000 steps — the reference's
    values, not the paper's 20–30 % band), with traces and events."""
    tr = ref_traces[kind]
    jb, jv = jdvfs.simulate_reactive(jnp.asarray(tr)), \
        jdvfs.simulate_v24(jnp.asarray(tr))
    tb, tv = tdvfs.simulate_reactive(torch.from_numpy(tr)), \
        tdvfs.simulate_v24(torch.from_numpy(tr))
    _assert_sim_close(jb, tb, f"{kind} reactive")
    _assert_sim_close(jv, tv, f"{kind} v24")
    np.testing.assert_allclose(float(tdvfs.released_compute(tb, tv)),
                               float(jdvfs.released_compute(jb, jv)), **TOL)
    assert int(tv.events) == 0


def test_coupled_dvfs_matches_reference():
    """The 8-tile Γ-coupled comparison of examples/multi_tile_sim.py."""
    tr = np.array(jworkload.make_trace(jax.random.PRNGKey(0), 1000,
                                       "inference", n_tiles=8))
    g = jcoupling.coupling_matrix(8, cols=4)
    jg = g / g.sum(1, keepdims=True)
    tg = tcoupling.row_normalise(tcoupling.coupling_matrix(8, cols=4))
    np.testing.assert_array_equal(np_(tg), np.asarray(jg))
    kw_j = dict(gamma=jg, poles=jthermal.two_pole())
    kw_t = dict(gamma=tg, poles=tthermal.two_pole())
    for name in ("simulate_reactive", "simulate_v24"):
        _assert_sim_close(getattr(jdvfs, name)(jnp.asarray(tr), **kw_j),
                          getattr(tdvfs, name)(torch.from_numpy(tr), **kw_t),
                          f"8 tiles {name}")


def test_workload_statistics_and_stress_step():
    """The port's torch-generated traces have the reference's statistics
    (same generator family, different draws); the stress step is exact."""
    for kind in tworkload.KINDS:
        # 16 independent tiles × 6,000 steps a side: enough samples that
        # the bursty kinds' moments settle
        got = np_(tworkload.make_trace(3, 6000, kind, n_tiles=16,
                                       device="cpu"))
        want = np.asarray(jworkload.make_trace(jax.random.PRNGKey(3), 6000,
                                               kind, n_tiles=16))
        assert got.shape == want.shape and got.dtype == np.float32
        assert 0.9 <= got.min() and got.max() <= 2.7
        assert abs(got.mean() - want.mean()) < 0.05, kind
        assert abs(got.std() - want.std()) < 0.05, kind
    again = tworkload.make_trace(3, 500, "vision", device="cpu")
    assert torch.equal(again, tworkload.make_trace(3, 500, "vision",
                                                   device="cpu"))
    with pytest.raises(ValueError, match="unknown workload kind"):
        tworkload.make_trace(0, 10, "crypto", device="cpu")
    np.testing.assert_array_equal(
        np_(tworkload.stress_step(400, 3, device="cpu")),
        np.asarray(jworkload.stress_step(400, 3)))


def test_cpo_matches_reference(ref_traces):
    stress = np.array(jworkload.stress_step(4000))
    jo, to = jcpo.open_loop(jnp.asarray(stress)), \
        tcpo.open_loop(torch.from_numpy(stress))
    tr = ref_traces["inference"][:2000]
    jc, tc = jcpo.closed_loop(jnp.asarray(tr)), \
        tcpo.closed_loop(torch.from_numpy(tr))
    for j, t in ((jo, to), (jc, tc)):
        for f in ("dt_pic", "drift", "max_drift", "budget_fraction"):
            np.testing.assert_allclose(np_(getattr(t, f)),
                                       np.asarray(getattr(j, f)), **TOL)
        assert bool(t.within_channel_spec) == bool(j.within_channel_spec)
    assert float(to.max_drift) > 1.7 and float(tc.max_drift) <= 0.36 + 1e-3
    assert float(tcpo.drift_nm(40.0)) == float(jcpo.drift_nm(40.0))
    assert tcpo.heater_savings() == jcpo.heater_savings()


def test_hbm_matches_reference():
    assert thbm.baseline_by_state() == pytest.approx(
        jhbm.baseline_by_state(), rel=1e-6)
    assert thbm.v24_by_state() == jhbm.v24_by_state()
    assert max(thbm.v24_by_state().values()) < 1.0
    leak = np.linspace(0.0, 200.0, 41, dtype=np.float32)
    np.testing.assert_allclose(
        np_(thbm.refresh_overhead_frac(torch.from_numpy(leak))),
        np.asarray(jhbm.refresh_overhead_frac(jnp.asarray(leak))), **TOL)
    dts = np.linspace(0.0, 40.0, 17, dtype=np.float32)
    np.testing.assert_allclose(
        np_(thbm.leakage_mb_per_hr(torch.from_numpy(dts))),
        np.asarray(jhbm.leakage_mb_per_hr(jnp.asarray(dts))), **TOL)
    for leak in (0.5, 10.0, 40.0, 166.0):
        assert thbm.max_stack_layers(leak) == jhbm.max_stack_layers(leak)


def test_serdes_matches_reference():
    assert tserdes.path_a_improvement() == jserdes.path_a_improvement()
    assert tserdes.path_b_warm_start() == jserdes.path_b_warm_start()
    assert tserdes.vco_drift(4.15) == jserdes.vco_drift(4.15)
    rng = np.random.default_rng(0)
    traffic = np.cumsum(rng.uniform(-0.02, 0.03, (200, 6)), 0).astype(
        np.float32)
    np.testing.assert_array_equal(
        np_(tserdes.lane_saturation_predictor(torch.from_numpy(traffic),
                                              0.8)),
        np.asarray(jserdes.lane_saturation_predictor(jnp.asarray(traffic),
                                                     0.8)))


def test_telemetry_budget_and_log(tmp_path):
    assert ttelemetry.budget(16) == jtelemetry.budget(16)
    log = ttelemetry.TelemetryLog(capacity=10)
    for i in range(25):
        log.record(i, loss=float(i), temps=torch.arange(3.0),
                   peak=torch.tensor([7.5]), frac=np.float32(0.25))
    assert len(log) == 10 and log.last() == {
        "step": 24, "loss": 24.0, "temps": [0.0, 1.0, 2.0], "peak": 7.5,
        "frac": 0.25}
    log.dump_jsonl(str(tmp_path / "t.jsonl"))
    lines = (tmp_path / "t.jsonl").read_text().splitlines()
    assert len(lines) == 10 and json.loads(lines[0])["step"] == 15


def test_telemetry_dump_writes_the_lines_dump_jsonl_writes(tmp_path):
    """`TelemetryLog.dump` is the reference's alias of `dump_jsonl`: the
    same JSON lines, which are the reference log's for the same records."""
    tlog, jlog = ttelemetry.TelemetryLog(capacity=4), \
        jtelemetry.TelemetryLog(capacity=4)
    for i in range(6):
        fields = dict(loss=0.5 * i, temps=np.arange(3.0) + i,
                      frac=np.float32(0.25))
        tlog.record(i, **fields)
        jlog.record(i, **fields)
    tlog.dump(str(tmp_path / "dump.jsonl"))
    tlog.dump_jsonl(str(tmp_path / "dump_jsonl.jsonl"))
    jlog.dump(str(tmp_path / "ref.jsonl"))
    got = (tmp_path / "dump.jsonl").read_text()
    assert got == (tmp_path / "dump_jsonl.jsonl").read_text()
    assert got == (tmp_path / "ref.jsonl").read_text()
    assert [json.loads(x)["step"] for x in got.splitlines()] == [2, 3, 4, 5]


def test_dataset90k_fit_and_summary_match_reference_on_identical_inputs():
    t = jds.generate(n_steps=20_000)
    port = tds.Telemetry(*(torch.from_numpy(np.array(x)) for x in t))
    for got, want in zip(tds.fit_affine(port.rtok, port.dt_junction),
                         jds.fit_affine(t.rtok, t.dt_junction)):
        assert got == pytest.approx(want, rel=1e-5, abs=1e-5)
    ts, js = tds.summary(port), jds.summary(t)
    assert ts.keys() == js.keys()
    for row in js:
        for k in js[row]:
            assert ts[row][k] == pytest.approx(js[row][k], rel=1e-5,
                                               abs=1e-5), (row, k)


def test_ar1_scan_matches_the_sequential_recurrence():
    """The log-depth scan behind `make_trace` and `dataset90k.generate`
    equals the step-by-step recurrence to f32 rounding, at a length that
    is not a power of two and with a per-tile start."""
    rng = np.random.default_rng(4)
    drive = rng.normal(0.0, 0.05, (9_001, 3)).astype(np.float32)
    x0 = np.array([1.2, 1.8, 2.4], np.float32)
    x, want = x0.astype(np.float64), np.empty(drive.shape, np.float64)
    for t in range(drive.shape[0]):
        x = 0.996 * x + drive[t]
        want[t] = x
    got = tworkload.ar1_scan(torch.from_numpy(x0), 0.996,
                             torch.from_numpy(drive))
    np.testing.assert_allclose(np_(got), want, **TOL)


def test_dataset90k_generate_statistics():
    """The port's own 90k-step draw reproduces the §4.1 fit: R² within
    0.002 of 0.9911, α ≈ 63, β ≈ −1256.6, and the B.2 ranges."""
    t = tds.generate(device="cpu")
    assert t.rho.shape == (90_000,) and t.rho.dtype == torch.float32
    a, b, r2 = tds.fit_affine(t.rtok, t.dt_junction)
    assert abs(r2 - 0.9911) <= 0.002
    assert a == pytest.approx(63.0, abs=1.0)
    assert b == pytest.approx(-1256.6, abs=25.0)
    s = tds.summary(t)
    assert s["rho"]["min"] >= 0.9 - 1e-5 and s["rho"]["max"] <= 2.7 + 1e-5
    assert 22.0 <= s["eta_pct"]["min"] <= 23.0
    assert 46.0 <= s["eta_pct"]["max"] <= 47.0
    assert s["drift_nm"]["max"] <= 0.36 + 1e-6
    assert s["rth"]["mean"] == pytest.approx(0.451, abs=0.002)


def test_multi_tile_example_runs_on_cpu(capsys):
    """examples/torch_multi_tile_sim.py end to end on the plain versions:
    V7.0 never trips, releases compute, and the kernel path equals
    `thermal.simulate`."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_multi_tile_sim.py"
    spec = importlib.util.spec_from_file_location("torch_multi_tile_sim",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.main(["--device", "cpu", "--steps", "400"])
    assert res["v24_events"] == 0 and res["released"] > 0.0
    assert res["kernel_err"] == 0.0
    assert "thermal_conv (plain version (CPU))" in capsys.readouterr().out
