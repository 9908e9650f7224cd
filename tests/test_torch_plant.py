"""PyTorch port, the thermal-plant ladder: `GridPlant` and `FittedROMPlant`
against the JAX reference (constants, the ROM fit, traces), carried over
with the reference's own constants and with the port's, the ROM-vs-grid
peak gate, and grid / ROM fleets against the reference engine."""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np

from torch_parity import (TOL, assert_state_close, assert_telemetry_close,
                          np_, trace)

from repro.core import thermal as jthermal
from repro.core.fingerprint import FINGERPRINT as JFP
from repro.core.plant import FittedROMPlant as JRom
from repro.core.plant import GridPlant as JGrid
from repro.core.scheduler import SchedulerConfig as JCfg
from repro.fleet import FleetEngine as JEngine

from repro_torch import convert
from repro_torch.core import thermal as tthermal
from repro_torch.core.density import power_from_rho
from repro_torch.core.fingerprint import FINGERPRINT as TFP
from repro_torch.core.plant import (ROM_PEAK_TOL, FittedROMPlant, GridPlant,
                                    PoleBankPlant, available_plants,
                                    plant_class)
from repro_torch.core.scheduler import SchedulerConfig as TCfg
from repro_torch.core.scheduler import ThermalScheduler as TSched
from repro_torch.fleet import FleetEngine as TEngine
from repro_torch.kernels import ops
from repro_torch.launch import serve

jax.config.update("jax_platform_name", "cpu")

CONFIGS = [dict(n_tiles=2), dict(n_tiles=3, grid_substeps=2, grid_contrast=0.0),
           dict(n_tiles=1, grid_cells=4, grid_kappa=0.8, grid_substeps=2)]


@pytest.mark.parametrize("kw", CONFIGS)
def test_grid_constants_match_reference_exactly(kw):
    jg = JGrid(JCfg(plant="grid", **kw), JFP)
    tg = GridPlant(TCfg(plant="grid", **kw), TFP, device="cpu")
    for name in ("ghat", "adj_h", "adj_v", "deg", "eigen_decay"):
        want, got = getattr(jg, name), getattr(tg, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert tg.eta == jg.eta
    assert tg.gain_sum == jg.gain_sum and tg.gain_sum.dtype == np.float32
    for name in ("r", "kappa", "rth"):
        assert getattr(tg, name) == getattr(jg, name), name
    assert tg.describe() == jg.describe()


@pytest.mark.parametrize("kw", CONFIGS)
def test_rom_fit_matches_reference(kw):
    jr = JRom(JCfg(plant="rom", **kw), JFP)
    tr_ = FittedROMPlant(TCfg(plant="rom", **kw), TFP, device="cpu")
    np.testing.assert_array_equal(tr_.poles.decay, jr.poles.decay)
    np.testing.assert_array_equal(tr_.poles.gain, jr.poles.gain)
    assert tr_.poles.gain.shape == (kw["n_tiles"], 3)
    assert tr_.fit_rel_err == jr.fit_rel_err
    assert tr_.eta == jr.eta
    np.testing.assert_array_equal(tr_.gain_sum, jr.gain_sum)
    assert tr_.describe() == jr.describe()


def _power(t, nt, seed):
    return power_from_rho(torch.from_numpy(trace(t, 1, nt, seed)[:, 0]))


def test_rungs_carried_over_with_reference_and_own_constants():
    """Each rung runs on the reference's constants (`convert`) and on the
    port's own derivation: the two agree within 1e-6, and each holds the
    reference's trace to the parity bound."""
    cfg_j, cfg_t = JCfg(n_tiles=2, plant="rom"), TCfg(n_tiles=2, plant="rom")
    power = _power(200, 2, seed=1)
    jp = jnp.asarray(np_(power))
    # grid: the whole-trace path
    jg = JGrid(cfg_j, JFP)
    own = GridPlant(cfg_t, TFP, device="cpu")
    carried = convert.grid_from_numpy(jg, cfg_t, device="cpu")
    want = np.asarray(jg.simulate(jp, interpret=True)[0])
    d_own, d_car = own.simulate(power)[0], carried.simulate(power)[0]
    np.testing.assert_allclose(np_(d_car), np_(d_own), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np_(d_own), want, **TOL)
    assert carried.eta == jg.eta and carried.gain_sum == jg.gain_sum
    # pole banks: the paper's and a fitted ROM's per-tile gains
    for jpoles, tpoles in ((jthermal.two_pole(), tthermal.two_pole()),
                           (JRom(cfg_j, JFP).poles,
                            FittedROMPlant(cfg_t, TFP, device="cpu").poles)):
        want = np.asarray(jthermal.simulate(jpoles, jp)[0])
        got_own = tthermal.simulate(tpoles, power)[0]
        got_car = tthermal.simulate(convert.poles_from_numpy(jpoles),
                                    power)[0]
        np.testing.assert_allclose(np_(got_car), np_(got_own), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(np_(got_own), want, **TOL)
    with pytest.raises(ValueError, match="pole bank shapes"):
        convert.poles_from_numpy(tthermal.PoleParams(
            decay=np.ones(2, np.float32), gain=np.ones(3, np.float32)))


def test_rom_tracks_grid_peak():
    """The ROM_PEAK_TOL gate on a tier-1-length trace (the 90k-step version
    runs on the card in chip_smoke.py): the ROM's peak ΔT — through
    `ops.thermal_conv` with no coupling — within the tolerance of the
    grid's, each peak matching the reference's plant on the same trace."""
    cfg_t, cfg_j = TCfg(n_tiles=2, plant="grid"), JCfg(n_tiles=2, plant="grid")
    power = _power(3000, 2, seed=9)
    grid = GridPlant(cfg_t, TFP, device="cpu")
    rom = FittedROMPlant(cfg_t, TFP, device="cpu")
    pk_grid = float(grid.simulate(power)[0].max())
    pk_rom = float(ops.thermal_conv(power, torch.eye(2), rom.poles.decay,
                                    rom.poles.gain[0])[0].max())
    assert abs(pk_rom - pk_grid) / pk_grid <= ROM_PEAK_TOL
    jp = jnp.asarray(np_(power))
    j_grid = float(jnp.max(JGrid(cfg_j, JFP).simulate(jp, interpret=True)[0]))
    j_rom = float(jnp.max(jthermal.simulate(JRom(cfg_j, JFP).poles, jp)[0]))
    np.testing.assert_allclose([pk_grid, pk_rom], [j_grid, j_rom], **TOL)


def test_grid_multi_exponential():
    """The bridge shadow makes the tile-mean step response multi-exponential
    (a uniform grid's region mean would collapse to the lumped pole)."""
    y = GridPlant(TCfg(n_tiles=1, plant="grid"), TFP,
                  device="cpu").step_response(2048).astype(np.float64)
    want = JGrid(JCfg(n_tiles=1, plant="grid"), JFP).step_response(2048)
    np.testing.assert_array_equal(y, want)
    yinf, t1, t2 = y[-1], 5, 40
    lam = np.log((yinf - y[t1]) / (yinf - y[t2])) / (t2 - t1)
    fit = yinf - (yinf - y[t1]) * np.exp(-lam * (np.arange(2048) - t1))
    assert np.abs(fit - y)[t1:].max() / yinf > 5e-3


# grid on fused hands the fleet to the per-step path; rom runs on broadcast
@pytest.mark.parametrize("plant,backend,mode", [
    ("grid", "broadcast", "v24"), ("grid", "fused", "v24"),
    ("grid", "broadcast", "reactive_poll"), ("rom", "broadcast", "v24"),
    ("rom", "broadcast", "reactive")])
def test_plant_fleets_match_reference(plant, backend, mode):
    n, nt, steps = 8, 3, 40
    tr = trace(steps, n, nt, seed=11)
    je = JEngine(JCfg(n_tiles=nt, plant=plant, mode=mode),
                 backend="broadcast")
    te = TEngine(TCfg(n_tiles=nt, plant=plant, mode=mode), backend=backend,
                 device="cpu")
    if backend == "fused":                   # handed to the per-step path
        assert te.backend_impl.run_block is None
    js, jtel = je.run_chunked(je.init(n), jnp.asarray(tr), flush_every=16)
    ts, ttel = te.run_chunked(te.init(n), tr, flush_every=16)
    assert_state_close(jax.device_get(js), ts, f"{plant}/{backend}")
    assert_telemetry_close(jax.device_get(jtel), ttel, f"{plant}/{backend}")


def test_rom_on_fused_raises_naming_the_roadmap_step():
    with pytest.raises(NotImplementedError, match="queue 1 step 5"):
        TEngine(TCfg(n_tiles=2, plant="rom"), backend="fused", device="cpu")


def test_registry_validation_and_instability():
    assert available_plants() == ["grid", "pole", "rom"]
    assert plant_class("pole") is PoleBankPlant
    with pytest.raises(ValueError, match="unknown plant"):
        plant_class("lava-lamp")
    for kw, match in ((dict(grid_cells=1), "grid_cells"),
                      (dict(grid_contrast=1.0), "grid_contrast"),
                      (dict(grid_substeps=0), "grid_substeps")):
        with pytest.raises(ValueError, match=match):
            GridPlant(TCfg(plant="grid", **kw), TFP, device="cpu")
    with pytest.raises(ValueError, match="grid_substeps"):
        GridPlant(TCfg(plant="grid", grid_kappa=3.0), TFP, device="cpu")
    GridPlant(TCfg(plant="grid", grid_kappa=3.0, grid_substeps=4), TFP,
              device="cpu")
    grid = GridPlant(TCfg(n_tiles=2, plant="grid"), TFP, device="cpu")
    with pytest.raises(ValueError, match="pole-family"):
        grid.step(grid.init_state(()), torch.ones(2),
                  poles=tthermal.two_pole())
    assert grid.init_state((3,)).shape == (3, grid.gy, grid.W)
    sched = TSched(TCfg(n_tiles=2, plant="rom"), device="cpu")
    assert sched.inv_eta_gain.shape == (2,)


@pytest.mark.parametrize("plant", ["grid", "rom"])
def test_serve_stream_runs_each_plant(plant):
    args = ["--stream", "--fleet", "6", "--waves", "2", "--gen", "12",
            "--device", "cpu", "--plant", plant]
    res = serve.main(args + ["--fleet-backend", "broadcast"])
    assert res["flushes"] == res["host_syncs"] == 2
    assert all(np.isfinite(v) for d in res["stream"] for v in d.values())
    if plant == "grid":
        fused = serve.main(args + ["--fleet-backend", "fused"])
        assert fused["stream"] == res["stream"]
    else:
        with pytest.raises(NotImplementedError, match="queue 1 step 5"):
            serve.main(args + ["--fleet-backend", "fused"])
