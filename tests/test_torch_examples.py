"""PyTorch port: the four examples ported last (examples/torch_fleet_sim.py,
torch_thermal_dashboard.py, torch_quickstart.py, torch_serve_batched.py),
each run through its ``main(["--device", "cpu", ...])`` at a small size and
held against the JAX package on the same numpy inputs.

  * fleet_sim: the port's swell trace through the reference's broadcast
    `FleetEngine` — events exact, temperatures within 1e-5 or else within
    `KNIFE_SPREAD_MULTIPLE` × the reference's own fused-vs-broadcast
    spread on the same trace (the coupled law's knife edge), freq_min
    within 1e-3; ``--stream`` flush records against the reference's
    `stream`;
  * thermal_dashboard: panels 1, 3, 4 and 6 against the reference's
    `fit_affine`, `step_response` and `eta` within 1e-5 relative, panel 5
    against the reference's `block_traces` on the same trace, and the
    ``--url`` mode against a port control plane on port 0;
  * quickstart: Effect ① against the reference's `dvfs` on the same trace
    (1e-5), the train losses against the reference's train step from the
    same weights (`convert.train_state_from_numpy`, 1e-4);
  * serve_batched: admissions as the reference's fleet engine gives them.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from test_torch_engine import KNIFE_SPREAD_MULTIPLE
from test_torch_serve_wave import _ref_admissions

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.core import dataset90k as jdataset
from repro.core import dvfs as jdvfs
from repro.core import nodebank as jnodebank
from repro.core import pdu_gate as jpdu
from repro.core import thermal as jthermal
from repro.core.fingerprint import FINGERPRINT as JFP
from repro.core.scheduler import SchedulerConfig as JCfg
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMData as JData
from repro.fleet import FleetEngine as JEngine
from repro.fleet import chunk_source as jchunk_source
from repro.fleet import stream as jstream
from repro.launch import steps as JS

from repro_torch import convert
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.fleet import FleetService, serve_http
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssm_scan import ssd

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
TOL = dict(rtol=1e-5, atol=1e-5)
FLEET_N = 64


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= TOL["atol"] + TOL["rtol"] * abs(b)


# ------------------------------------------------------------ fleet_sim
def _ref_records(trace, backend: str, at, node: str = "base") -> dict:
    """The reference engine stepped over ``trace``, every lane on the
    ``node`` bank: its records at ``at``."""
    n = trace.shape[1]
    eng = JEngine(JCfg(n_tiles=trace.shape[2], mode="v24",
                       heterogeneous=node != "base"), backend=backend)
    st = eng.init(n) if node == "base" else eng.init(
        n, pkg=jnodebank.fleet_package_params(eng.sched, [node] * n))
    recs = {}
    for i in range(trace.shape[0]):
        if backend == "broadcast":
            st, _, tel = eng.step(st, jnp.asarray(trace[i]))
        else:
            st, tel = eng.run_block(st, jnp.asarray(trace[i:i + 1]))
        if i in at:
            recs[i] = tel.as_dict()
    return recs


def _assert_records_match(res: dict, node: str = "base") -> dict:
    """The example's printed records against the reference's broadcast
    engine on its trace: events and package counts exact, freq_min within
    1e-3, p50 / p99 / max temperature within 1e-5 or else within
    `KNIFE_SPREAD_MULTIPLE` × the reference's own fused-vs-broadcast
    spread.  Returns the reference's records."""
    trace, got = res["trace"], res["records"]
    want = _ref_records(trace, "broadcast", got, node)
    spread = None
    for i, d in got.items():
        w = want[i]
        assert d["events_total"] == w["events_total"], i
        assert d["n_packages"] == w["n_packages"] == trace.shape[1]
        np.testing.assert_allclose(d["freq_min"], w["freq_min"], rtol=1e-3,
                                   atol=1e-3)
        for k in ("temp_p50_c", "temp_p99_c", "temp_max_c"):
            if _close(d[k], w[k]):
                continue
            # the knife edge: the reference's own two engines' spread
            spread = spread or _ref_records(trace, "fused", got, node)
            assert abs(d[k] - w[k]) <= KNIFE_SPREAD_MULTIPLE * abs(
                spread[i][k] - w[k]), (i, k, d[k], w[k])
    assert res["events"] == want[max(want)]["events_total"]
    return want


def test_fleet_sim_matches_the_reference_engine(capsys):
    res = _example("torch_fleet_sim").main(
        ["--device", "cpu", "--packages", str(FLEET_N)])
    trace = res["trace"]
    assert trace.shape == (48, FLEET_N, 4)
    want = _assert_records_match(res)
    assert all(w["events_total"] == 0 for w in want.values())
    assert res["run_events"] == res["events"] == 0
    assert res["run_peak_p99"] == pytest.approx(
        max(d["temp_p99_c"] for d in want.values()), abs=0.5)
    out = capsys.readouterr().out
    assert "scan runner agrees" in out and "backend broadcast" in out


@pytest.mark.parametrize("backend", ["broadcast", "fused"])
def test_fleet_sim_stream_matches_the_reference_stream(backend):
    res = _example("torch_fleet_sim").main(
        ["--device", "cpu", "--packages", str(FLEET_N), "--stream",
         "--backend", backend])
    assert res["flushes"] == res["host_syncs"] == 8 and res["steps"] == 48
    eng = JEngine(JCfg(n_tiles=4, mode="v24"), backend=backend)
    _, want, stats = jstream(eng, eng.init(FLEET_N),
                             jchunk_source(res["trace"], 6))
    assert len(res["flushed"]) == len(want) == stats.flushes
    for d, w in zip(res["flushed"], want):
        assert d.keys() == w.keys()
        for k in d:
            if k in ("n_packages", "events_total", "events_step",
                     "degraded_count"):
                assert d[k] == w[k], k
            elif k in ("freq_min", "at_risk_frac"):
                np.testing.assert_allclose(d[k], w[k], rtol=1e-3, atol=1e-3)
            else:
                np.testing.assert_allclose(d[k], w[k], err_msg=k, **TOL)


@pytest.mark.parametrize("argv", [["--backend", "vmap"],
                                  ["--backend", "sharded_fused"],
                                  ["--node", "n3"]])
def test_fleet_sim_other_paths_match_broadcast(argv):
    """The other backends run the same trace, every backend's last step
    equal to broadcast's within 1e-5; a node-bank fleet's records are held
    to the reference's broadcast engine on the same bank
    (`fleet_package_params`)."""
    ex = _example("torch_fleet_sim")
    small = ["--device", "cpu", "--packages", "16", "--steps", "24"]
    res = ex.main(small + argv)
    assert res["events"] == res["run_events"]
    if "--node" in argv:
        _assert_records_match(res, node=argv[1])
        return
    base = ex.main(small)
    np.testing.assert_allclose(res["temps"], base["temps"], **TOL)
    np.testing.assert_allclose(res["freqs"], base["freqs"], **TOL)
    assert res["events"] == base["events"] == 0


# ---------------------------------------------------- thermal_dashboard
def test_dashboard_panels_match_the_reference(capsys):
    res = _example("torch_thermal_dashboard").main(
        ["--device", "cpu", "--steps", "400"])
    t = res["dataset"]
    a, b, r2 = jdataset.fit_affine(jnp.asarray(t.rtok.numpy()),
                                   jnp.asarray(t.dt_junction.numpy()))
    for got, want in ((res["alpha"], a), (res["beta"], b), (res["r2"], r2)):
        np.testing.assert_allclose(got, float(want), rtol=1e-5)
    sr = jthermal.step_response(jthermal.single_pole(), 400, 100.0)
    np.testing.assert_allclose(res["rth"], float(sr[-1]) / 100.0, rtol=1e-5)
    np.testing.assert_allclose(res["drift_nm"], JFP.kappa_to_nm_per_c * 4.15,
                               rtol=1e-5)
    np.testing.assert_allclose(res["eta20"], float(jpdu.eta(20.)), rtol=1e-5)
    np.testing.assert_allclose(res["eta50"], float(jpdu.eta(50.)), rtol=1e-5)
    # panel 5: the reference's block_traces on the same trace
    trace = jnp.asarray(res["trace"].numpy())[:, None, :]
    for mode, tag in (("v24", "v24"), ("reactive_poll", "base")):
        eng = JEngine(JCfg(n_tiles=1, mode=mode), donate_state=False)
        _, temps, freqs = eng.block_traces(eng.init(1), trace)
        np.testing.assert_allclose(res[f"t_{tag}"].numpy(),
                                   np.asarray(temps)[:, 0, :], **TOL)
        np.testing.assert_allclose(res[f"f_{tag}"].numpy(),
                                   np.asarray(freqs)[:, 0, :], **TOL)
        np.testing.assert_allclose(res[f"perf_{tag}"],
                                   float(freqs.mean()), rtol=1e-5)
    assert res["released"] > 0.0 and res["peak_v24"] < res["peak_base"]
    assert "[7] dρ/dt ramp hint" in capsys.readouterr().out


def test_dashboard_url_mode_renders_a_port_control_plane(capsys):
    svc = FleetService(SchedulerConfig(n_tiles=2), min_capacity=4,
                       flush_every=8, device="cpu")
    svc.attach("p0", tenant="acme")
    svc.attach("p1", tenant="acme")
    svc.tick(np.full((8, 4, 2), 2.7, np.float32))
    svc.tick(np.full((8, 4, 2), 1.2, np.float32))
    server, thread = serve_http(svc, port=0)
    try:
        res = _example("torch_thermal_dashboard").main(
            ["--url", f"http://127.0.0.1:{server.server_address[1]}",
             "--last", "5"])
    finally:
        server.shutdown()
        thread.join(timeout=10)
    assert [int(r["flush"]) for r in res["records"]] == [0, 1]
    out = capsys.readouterr().out
    assert "flushes 0..1 (2 shown)" in out and "tenant acme: 2 pkg" in out


# ----------------------------------------------------------- quickstart
def test_quickstart_matches_the_reference(monkeypatch):
    ex = _example("torch_quickstart")
    jcfg = jreduced(jget_arch("gemma-2b"), n_layers=2)
    cfg = ex.train_config()
    js = JS.init_train_state(jax.random.PRNGKey(0), jcfg, ex.N_TILES)
    ts = convert.train_state_from_numpy(cfg, jax.device_get(js), "cpu")
    # the reference's initial weights in place of the port's own draw
    monkeypatch.setattr(ex.S, "init_train_state", lambda *a, **k: ts)
    res = ex.main(["--device", "cpu", "--steps", "500",
                   "--train-steps", "2"])
    trace = jnp.asarray(res["trace"].numpy())
    base, v24 = jdvfs.simulate_reactive(trace), jdvfs.simulate_v24(trace)
    want = {"base_perf": base.perf, "v24_perf": v24.perf,
            "base_peak": base.temp.max(), "v24_peak": v24.temp.max(),
            "released": jdvfs.released_compute(base, v24),
            "base_p99": base.p99_latency, "v24_p99": v24.p99_latency}
    for k, w in want.items():
        np.testing.assert_allclose(res[k], float(w), err_msg=k, **TOL)
    assert res["base_events"] == int(base.events)
    assert res["v24_events"] == int(v24.events) == 0
    # the reference's train step on the same batches from the same weights
    step = jax.jit(JS.make_train_step(jcfg, ex.N_TILES))
    data = JData(jcfg, JDataConfig(batch=4, seq_len=64))
    losses = []
    try:
        for _ in range(2):
            b = data.next()
            js, m = step(js, {"tokens": jnp.asarray(b["tokens"]),
                              "labels": jnp.asarray(b["labels"]),
                              "rho": jnp.full((ex.N_TILES,), 2.0)})
            losses.append(float(m["loss"]))
    finally:
        data.close()
    np.testing.assert_allclose(res["losses"], losses, rtol=1e-4)
    assert res["train_events"] == int(js.sched.events) == 0


# -------------------------------------------------------- serve_batched
def test_serve_batched_admits_as_the_reference(capsys):
    before = (flash_attention.launches, ssd.launches)
    res = _example("torch_serve_batched").main(["--device", "cpu"])
    assert (flash_attention.launches, ssd.launches) == before  # CPU: plain
    assert res["mixtral"]["admitted"] == _ref_admissions(
        "mixtral-8x7b", 8, 48, 16, 3)
    assert res["rwkv6"]["admitted"] == _ref_admissions(
        "rwkv6-1.6b", 4, 64, 16, 2)
    fleet = res["fleet"]["fleet"]
    assert len(fleet) == 2 and fleet[-1]["events_total"] == 0
    assert all(np.isfinite(v) for d in fleet for v in d.values())
    assert "fleet p99 temp" in capsys.readouterr().out
