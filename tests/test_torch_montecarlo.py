"""PyTorch port, the §10 Monte-Carlo population: `montecarlo.run` on both
backends and `run_reference`, fed the reference's own draws, against the
reference's per trial; the statistics and guard-band report; packing
invariance; the port's own correlated sampler; `nodebank` against the
reference; and the serving entry points (``--montecarlo``, ``--node``)."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import numpy as np

from torch_parity import TOL, np_

from repro.core import guardband as jgb
from repro.core import montecarlo as jmc
from repro.core import nodebank as jnb
from repro.core.fingerprint import FINGERPRINT as JFP
from repro.core.scheduler import SchedulerConfig as JCfg
from repro.core.scheduler import ThermalScheduler as JSched

from repro_torch.core import guardband as tgb
from repro_torch.core import montecarlo as tmc
from repro_torch.core import nodebank as tnb
from repro_torch.core.fingerprint import FINGERPRINT as TFP
from repro_torch.core.scheduler import SchedulerConfig as TCfg
from repro_torch.core.scheduler import ThermalScheduler as TSched
from repro_torch.fleet import FleetEngine
from repro_torch.launch import serve

jax.config.update("jax_platform_name", "cpu")

N_TRIALS, N_STEPS, BURN_IN = 64, 600, 100
FIELDS = jmc.MCResult._fields


@pytest.fixture(scope="module")
def population():
    """The reference's draws for one small population, its fleet-backed
    `run` and its per-trial oracle `run_reference` on them."""
    key = jax.random.PRNGKey(11)
    k_par, k_tr = jax.random.split(key)
    rth, tau, util, poll = jmc.sample_params(k_par, N_TRIALS, JFP)
    traces = jmc._trial_traces(jax.random.split(k_tr, N_TRIALS), util,
                               N_STEPS, "inference", JFP)
    draws = tuple(np.asarray(x) for x in (rth, tau, util, poll, traces))
    run = jmc.run(key, N_TRIALS, N_STEPS, burn_in=BURN_IN)
    ref = jmc.run_reference(key, N_TRIALS, N_STEPS, burn_in=BURN_IN)
    return draws, run, ref


def _close(ref, port, where):
    for f in FIELDS:
        np.testing.assert_allclose(np_(getattr(port, f)),
                                   np.asarray(getattr(ref, f)),
                                   err_msg=f"{where} {f}", **TOL)


@pytest.mark.parametrize("backend", ["broadcast", "fused"])
def test_run_matches_reference_per_trial(population, backend, monkeypatch):
    """The fleet-backed population on the reference's draws: per-trial
    peak T, exceedance and mean frequency ≤1e-5 of the reference's `run`
    (the fused backend in 256-step survey blocks: two and a tail)."""
    draws, jrun, _ = population
    monkeypatch.setattr(FleetEngine, "run_survey", functools.partialmethod(
        FleetEngine.run_survey, chunk=256))
    r = tmc.run(burn_in=BURN_IN, backend=backend, draws=draws, device="cpu")
    _close(jrun, r, backend)


def test_run_reference_matches_reference_per_trial(population):
    """The batched per-trial oracle against the reference's vmapped one."""
    draws, _, jref = population
    _close(jref, tmc.run_reference(burn_in=BURN_IN, draws=draws,
                                   device="cpu"), "run_reference")


def test_stats_and_guardband_match_reference(population):
    """`MCResult.stats()` on the reference's numbers equals the reference's
    (rtol 1e-5), and the guard-band report follows from it the same way."""
    _, jrun, _ = population
    port = tmc.MCResult(*(torch.from_numpy(np.array(getattr(jrun, f)))
                          for f in FIELDS))
    js, ts = jrun.stats(), port.stats()
    assert js.keys() == ts.keys()
    for k in js:
        assert ts[k] == pytest.approx(js[k], rel=1e-5, abs=1e-6), k
    for a, b in zip(jgb.from_montecarlo(js), tgb.from_montecarlo(js)):
        assert a == b
    assert tgb.published() == jgb.published()
    assert tgb.wafer_roi_gain(65.0) == jgb.wafer_roi_gain(65.0)
    assert tgb.derived(6.0, 2.1) == jgb.derived(6.0, 2.1)


def test_packing_invariance(monkeypatch):
    """Trials are independent lanes: packing eight to a package or one
    gives bit-identical per-trial results on both backends."""
    draws = tmc.sample_trials(5, 16, 200, device="cpu")
    packed = {b: tmc.run(burn_in=50, backend=b, draws=draws, device="cpu")
              for b in ("broadcast", "fused")}
    monkeypatch.setattr(tmc, "_TILE_PACK", 1)
    for b, res in packed.items():
        single = tmc.run(burn_in=50, backend=b, draws=draws, device="cpu")
        for f in FIELDS:
            assert torch.equal(getattr(res, f), getattr(single, f)), (b, f)


@pytest.mark.parametrize("corr", [0.0, 0.6])
def test_sample_params_moments_and_neighbour_correlation(corr):
    """The port's own draws (a torch.Generator's stream, not JAX's): over
    20,000 trials the marginal means and spreads match §10.1 (Rth ±8 %,
    τ ±12 %, util 1.02 ± 0.15) within 2 %, every draw is in its clip
    window, and the Rth/τ neighbour correlation is ``corr`` ± 0.03 while
    util stays uncorrelated (|r| < 0.03)."""
    gen = torch.Generator().manual_seed(4)
    rth, tau, util, poll = (np_(x) for x in tmc.sample_params(
        gen, 20_000, TFP, corr=corr))
    assert rth.mean() == pytest.approx(TFP.rth_c_per_w, rel=0.02)
    assert rth.std() / TFP.rth_c_per_w == pytest.approx(0.08, rel=0.05)
    assert tau.mean() == pytest.approx(TFP.tau_ms, rel=0.02)
    assert tau.std() / TFP.tau_ms == pytest.approx(0.12, rel=0.05)
    assert util.mean() == pytest.approx(1.02, rel=0.02)
    assert util.std() == pytest.approx(0.15, rel=0.05)
    assert rth.min() >= 0.25 and rth.max() <= 0.70
    assert tau.min() >= 30.0 and tau.max() <= 160.0
    assert poll.min() >= 15 and poll.max() <= 75
    r = lambda x: np.corrcoef(x[:-1], x[1:])[0, 1]
    assert r(rth) == pytest.approx(corr, abs=0.03)
    assert r(tau) == pytest.approx(corr, abs=0.03)
    assert abs(r(util)) < 0.03
    with pytest.raises(ValueError, match="corr"):
        tmc.sample_params(gen, 4, corr=1.0)


def test_serve_montecarlo_returns_the_stats():
    res = serve.main(["--montecarlo", "16", "--mc-steps", "500",
                      "--device", "cpu"])
    s = res["montecarlo"]
    assert set(s) == {"baseline_mean_c", "baseline_std_c",
                      "baseline_time_above_frac", "v24_mean_c", "v24_std_c",
                      "v24_time_above_frac", "sigma_ratio", "sigma_tighter_x",
                      "uplift_mean", "uplift_p5", "uplift_p95"}
    assert all(np.isfinite(v) for v in s.values())
    assert s["baseline_mean_c"] > s["v24_mean_c"]
    assert res["trials_per_s"] > 0


def test_serve_montecarlo_keeps_the_reference_burn_in():
    """The statistics skip the reference's fixed 400-step burn-in, so a
    trace of 400 steps or fewer raises, as the reference's `run` does."""
    with pytest.raises(ValueError, match="burn_in=400"):
        serve.main(["--montecarlo", "4", "--mc-steps", "400", "--device",
                    "cpu"])


@pytest.mark.parametrize("nodes", [["base"] * 3, ["base", "n7", "n5", "n3"]])
def test_nodebank_fleet_package_params_match_reference(nodes):
    """Node banks scale the scheduler's own poles like the reference's
    (decay / gain / η / poll bit-equal, ΣG to f32 rounding), and the
    ladder's tables agree."""
    cfg = dict(n_tiles=2, heterogeneous=True)
    js, ts = JSched(JCfg(**cfg)), TSched(TCfg(**cfg), device="cpu")
    jp = jnb.fleet_package_params(js, nodes)
    tp = tnb.fleet_package_params(ts, nodes)
    for f in ("decay", "gain", "eta", "poll_ticks"):
        np.testing.assert_array_equal(np_(getattr(tp, f)),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    np.testing.assert_allclose(np_(tp.gain_sum), np.asarray(jp.gain_sum),
                               rtol=1e-7)
    assert tnb.available_nodes() == jnb.available_nodes()
    for name in jnb.available_nodes():
        assert dataclasses.asdict(tnb.get_node(name)) == \
            dataclasses.asdict(jnb.get_node(name))
        assert tnb.get_node(name).dvfs_bounds() == \
            jnb.get_node(name).dvfs_bounds()
    with pytest.raises(ValueError, match="unknown node"):
        tnb.get_node("n999")
    with pytest.raises(ValueError, match="pole-family"):
        tnb.node_poles(TSched(TCfg(n_tiles=2, plant="grid"), device="cpu"),
                       tnb.get_node("n5"))


def test_serve_stream_node_agrees_across_backends():
    """`serve --stream --node n3`: the heterogeneous node-bank fleet on the
    fused backend's kernel (plain version here) and on broadcast."""
    args = ["--stream", "--node", "n3", "--fleet", "12", "--waves", "3",
            "--gen", "16", "--device", "cpu", "--seed", "2"]
    rf = serve.main(args + ["--fleet-backend", "fused"])
    rb = serve.main(args + ["--fleet-backend", "broadcast"])
    base = serve.main(args[:1] + args[3:] + ["--fleet-backend", "fused"])
    assert rf["flushes"] == rb["flushes"] == 3
    for a, b in zip(rf["stream"], rb["stream"]):
        for k in a:
            tol = 1e-3 if k in ("freq_min", "at_risk_frac") else 1e-5
            assert a[k] == pytest.approx(b[k], rel=tol, abs=tol), k
    # n3 runs hotter than the fingerprint bank on the same trace
    assert rf["stream"][-1]["temp_p50_c"] > base["stream"][-1]["temp_p50_c"]
