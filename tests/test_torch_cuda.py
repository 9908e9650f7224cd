"""PyTorch port on the card: the hand-written CUDA kernels (`fleet_step`,
`thermal_conv`, `grid_conv`) against their plain PyTorch versions, and the
fused engine against the broadcast engine.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips with the
reason "needs CUDA" elsewhere.  Imports nothing of JAX, so it also runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from torch_parity import TOL, assert_telemetry_close, np_, trace

from repro_torch.core.coupling import (coupling_matrix, ponte_vecchio_gamma,
                                       row_normalise)
from repro_torch.core.fingerprint import FINGERPRINT
from repro_torch.core.pdu_gate import exact_stats
from repro_torch.core.plant import GridPlant
from repro_torch.core.thermal import two_pole
from repro_torch.core.scheduler import SchedulerConfig, ThermalScheduler
from repro_torch.fleet import FleetEngine, chunk_source, stream
from repro_torch.fleet.backends.fused import FusedBackend
from repro_torch.kernels import fleet_step as tfs
from repro_torch.kernels import thermal_conv as ttc

MODES = ["v24", "reactive", "reactive_poll", "off"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    return torch.device("cuda")


def _inputs(mode, nt, n, t, device, seed=1):
    sched = ThermalScheduler(SchedulerConfig(n_tiles=nt, mode=mode),
                             device=device)
    params = FusedBackend(sched).params
    g = torch.Generator().manual_seed(seed)
    u = lambda lo, hi, *s: (lo + (hi - lo) * torch.rand(s, generator=g)
                            ).to(device)
    buf0 = u(0.9, 2.7, params.window, nt, n)
    args = (u(0.9, 2.7, t, nt, n), buf0, u(5.0, 25.0, params.n_poles, nt, n),
            torch.stack(exact_stats(buf0, 0, axis=0)), u(0.5, 1.0, nt, n),
            torch.zeros(1, n, device=device),
            None if sched.gamma is None else sched.gamma.contiguous())
    thr0 = ((u(0.0, 1.0, nt, n) > 0.5).float() if mode == "reactive_poll"
            else None)
    return params, args, thr0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("nt,n,t", [(4, 200, 64), (47, 64, 48), (1, 300, 40)])
def test_cuda_kernel_matches_plain_version(cuda, mode, nt, n, t):
    params, args, thr0 = _inputs(mode, nt, n, t, cuda)
    before = tfs.fleet_step.launches
    out = tfs.fleet_step(*args, params, thr0=thr0, step0=3)
    torch.cuda.synchronize()
    assert tfs.fleet_step.launches == before + 1
    ref = tfs.fleet_step_reference(*args, params, thr0=thr0, step0=3)
    for a, b in zip(out[:4], ref[:4]):
        np.testing.assert_allclose(np_(a), np_(b), **TOL)
    np.testing.assert_array_equal(np_(out[4]), np_(ref[4]))
    if thr0 is not None:
        np.testing.assert_array_equal(np_(out[5]), np_(ref[5]))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_cuda_fused_engine_matches_broadcast(cuda, mode):
    cfg = SchedulerConfig(n_tiles=4, mode=mode)
    tr = trace(80, 64, 4, seed=2)
    ef = FleetEngine(cfg, backend="fused")
    eb = FleetEngine(cfg, backend="broadcast")
    assert ef.device.type == "cuda"
    sf, rf = ef.run_chunked(ef.init(64), tr, flush_every=32)
    sb, rb = eb.run_chunked(eb.init(64), tr, flush_every=32)
    assert_telemetry_close(rb, rf, mode)
    np.testing.assert_allclose(np_(sf.thermal), np_(sb.thermal), **TOL)
    np.testing.assert_array_equal(np_(sf.events), np_(sb.events))


@pytest.mark.cuda
def test_cuda_stream_launches_once_per_flush(cuda):
    eng = FleetEngine(SchedulerConfig(n_tiles=47), backend="fused")
    tr = trace(100, 32, 47, seed=3)
    before = tfs.fleet_step.launches
    _, flushed, stats = stream(eng, eng.init(32), chunk_source(tr, 32))
    assert tfs.fleet_step.launches - before == stats.flushes == 4
    assert stats.host_syncs == stats.flushes
    assert all(np.isfinite(list(d.values())).all() for d in flushed)


def _gamma(n, device):
    g = ponte_vecchio_gamma() if n == 47 else coupling_matrix(
        n, cols=4 if n == 8 else None)
    return row_normalise(g).to(device).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("n,t", [(8, 4000), (47, 600), (100, 777),
                                 (512, 300)])
def test_cuda_thermal_conv_matches_plain_version(cuda, n, t):
    g = torch.Generator().manual_seed(n)
    power = (80.0 + 40.0 * torch.rand((t, n), generator=g)).to(cuda)
    state0 = (20.0 * torch.rand((n, 2), generator=g)).to(cuda)
    poles = two_pole()
    gamma = _gamma(n, cuda)
    before = ttc.thermal_conv.launches
    out = ttc.thermal_conv(power, gamma, poles.decay, poles.gain, state0)
    torch.cuda.synchronize()
    assert ttc.thermal_conv.launches == before + 1
    ref = ttc.thermal_conv_reference(power, gamma, poles.decay, poles.gain,
                                     state0)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(np_(a), np_(b), **TOL)


@pytest.mark.cuda
def test_cuda_thermal_conv_state_carry(cuda):
    g = torch.Generator().manual_seed(5)
    power = (80.0 + 40.0 * torch.rand((500, 47), generator=g)).to(cuda)
    poles, gamma = two_pole(), _gamma(47, cuda)
    full = ttc.thermal_conv(power, gamma, poles.decay, poles.gain)
    a = ttc.thermal_conv(power[:233].contiguous(), gamma, poles.decay,
                         poles.gain)
    b = ttc.thermal_conv(power[233:].contiguous(), gamma, poles.decay,
                         poles.gain, a[1])
    np.testing.assert_allclose(np_(torch.cat([a[0], b[0]])), np_(full[0]),
                               **TOL)
    np.testing.assert_allclose(np_(b[1]), np_(full[1]), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("nt,substeps,contrast", [
    (1, 1, 0.5), (2, 2, 0.5), (47, 1, 0.0), (47, 2, 0.5)])
def test_cuda_grid_conv_matches_plain_version(cuda, nt, substeps, contrast):
    plant = GridPlant(SchedulerConfig(n_tiles=nt, plant="grid",
                                      grid_substeps=substeps,
                                      grid_contrast=contrast),
                      FINGERPRINT, device=cuda)
    g = torch.Generator().manual_seed(nt)
    power = (80.0 + 40.0 * torch.rand((300, nt), generator=g)).to(cuda)
    state0 = (10.0 * torch.rand((plant.gy, plant.W), generator=g)).to(cuda)
    before = ttc.grid_conv.launches
    out = plant.simulate(power, state0)
    torch.cuda.synchronize()
    assert ttc.grid_conv.launches == before + 1
    ref = ttc.grid_conv_reference(
        power, plant.adj_h, plant.adj_v, plant.deg, plant.ghat, plant.inject,
        plant.readout, state0, r=float(plant.r), kappa=float(plant.kappa),
        substeps=plant.substeps)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(np_(a), np_(b), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("cells", range(2, 17))
def test_cuda_grid_conv_every_patch_edge(cuda, cells):
    """Every patch edge `grid_conv.cu` instantiates (2..16) against the
    plain version, at 5 tiles: 32 // cells tiles share a warp, so the edges
    that do not divide 32 leave masked lanes, and most leave a partly
    filled last warp."""
    plant = GridPlant(SchedulerConfig(n_tiles=5, plant="grid",
                                      grid_cells=cells),
                      FINGERPRINT, device=cuda)
    g = torch.Generator().manual_seed(cells)
    power = (80.0 + 40.0 * torch.rand((300, 5), generator=g)).to(cuda)
    state0 = (10.0 * torch.rand((plant.gy, plant.W), generator=g)).to(cuda)
    before = ttc.grid_conv.launches
    out = plant.simulate(power, state0)
    torch.cuda.synchronize()
    assert ttc.grid_conv.launches == before + 1
    ref = ttc.grid_conv_reference(
        power, plant.adj_h, plant.adj_v, plant.deg, plant.ghat, plant.inject,
        plant.readout, state0, r=float(plant.r), kappa=float(plant.kappa),
        substeps=plant.substeps)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(np_(a), np_(b), **TOL)
