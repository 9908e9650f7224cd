"""PyTorch port on the card: the hand-written CUDA kernels (`fleet_step`,
`thermal_conv`, `grid_conv`, `flash_attention`, `ssd`) against their plain
PyTorch versions, the fused engine against the broadcast engine, and the
serving models' kernel launches.

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
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import fleet_step as tfs
from repro_torch.kernels import ssm_scan as tsm
from repro_torch.kernels import thermal_conv as ttc
from repro_torch.models import transformer as ttf

MODES = ["v24", "reactive", "reactive_poll", "off"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    return torch.device("cuda")


def _inputs(mode, nt, n, t, device, seed=1, **cfg):
    sched = ThermalScheduler(SchedulerConfig(n_tiles=nt, mode=mode, **cfg),
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
        assert torch.equal(a, b)


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
    assert torch.equal(torch.cat([a[0], b[0]]), full[0])
    assert torch.equal(b[1], full[1])


def _same(a, b) -> bool:
    """Bit-equal, NaN equal to NaN."""
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a, nan=0.0),
                            torch.nan_to_num(b, nan=0.0)))


def _conv_case(t, n, cuda, *, gamma=None, n_poles=2, seed=0):
    """(power, Γ, decay, gain, state0) on the card: 80 + 40·U(0,1) W,
    the banded row-normalised Γ unless given, a random pole bank."""
    g = torch.Generator().manual_seed(seed)
    power = (80.0 + 40.0 * torch.rand((t, n), generator=g)).to(cuda)
    decay = torch.sort(0.6 + 0.399 * torch.rand(n_poles, generator=g))[0]
    gain = 0.05 + 0.25 * torch.rand(n_poles, generator=g)
    state0 = (20.0 * torch.rand((n, n_poles), generator=g)).to(cuda)
    if gamma is None:
        gamma = row_normalise(coupling_matrix(n)).to(cuda).contiguous()
    return power, gamma, decay, gain, state0


def _conv_bit_equal(power, gamma, decay, gain, state0):
    """One launch, bit-equal to the plain version (NaN for NaN)."""
    before = ttc.thermal_conv.launches
    out = ttc.thermal_conv(power, gamma, decay, gain, state0)
    torch.cuda.synchronize()
    assert ttc.thermal_conv.launches == before + 1
    ref = ttc.thermal_conv_reference(power, gamma, decay, gain, state0)
    for a, b in zip(out, ref):
        assert _same(a, b)
    return out


@pytest.mark.cuda
def test_cuda_fma_f32_exact_rounds_once_as_on_the_cpu(cuda):
    """`fma_f32` on the card (its kernel, csrc/fma_f32.cu) is the CPU's
    single rounding — the crafted halfway cases (a·b = 2^-24 ± a few 2^-70
    beside c ≈ 1) and small products beside large sums, as a dense Γ's."""
    from repro_torch import fma_f32

    g = torch.Generator().manual_seed(0)
    a = ((2 * torch.rand(20000, generator=g) - 1)
         * 2.0 ** -torch.randint(0, 20, (20000,), generator=g)).float()
    b = 200 * torch.rand(20000, generator=g) - 100
    c = 200 * torch.rand(20000, generator=g) - 100
    big = torch.tensor([2 ** 23 + 2896, 2 ** 23 + 1], dtype=torch.float64)
    small = torch.tensor([2 ** 23 - 2895, 2 ** 23 - 1], dtype=torch.float64)
    a = torch.cat([a, (big * 2.0 ** -35).float()])
    b = torch.cat([b, (small * 2.0 ** -35).float()])
    c = torch.cat([c, torch.tensor([1.0, 1 + 2 ** -23])])
    want = fma_f32(a, b, c)
    got = fma_f32(a.to(cuda), b.to(cuda), c.to(cuda))
    assert torch.equal(got.cpu(), want)
    assert want[-2].item() == 1 + 2 ** -23 and want[-1].item() == 1 + 2 ** -23


def _fma_case(name, cuda):
    """(a, b, c) on the card for one broadcast pattern of the port's call
    sites: scalars, a strided Γ column against a [n, 1] column view, a
    per-package [n, 1] plane, a pole bank over a trailing axis, 0-dim
    tensors, a transposed (non-contiguous) b."""
    g = torch.Generator().manual_seed(7)
    u = lambda lo, hi, *s: (lo + (hi - lo) * torch.rand(s, generator=g)
                            ).to(cuda)
    gamma = row_normalise(coupling_matrix(47)).to(cuda)
    return {
        "scalars": lambda: (0.7217, u(0.9, 2.7, 256, 47), -1256.6),
        "gamma_column": lambda: (gamma[:, 5], u(0, 120, 256, 47)[:, 5:6],
                                 u(0, 900, 256, 47)),
        "per_package": lambda: (-u(0.1, 0.9, 256, 1), u(0, 40, 256, 47),
                                69.0),
        "pole_bank": lambda: (u(0.5, 0.99, 2), u(0, 40, 64, 47, 2),
                              u(0, 1, 64, 47, 2)),
        "zero_dim": lambda: (u(0, 1, 1)[0], u(-5, 5, 33), u(-5, 5, 1)[0]),
        "transposed": lambda: (u(0, 1, 47, 1), u(-5, 5, 256, 47).mT,
                               u(-5, 5, 47, 256)),
        "dense_gamma": lambda: (u(0, 1e-3, 2048), u(80, 120, 64, 1),
                                u(50, 120, 64, 2048)),
    }[name]()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["scalars", "gamma_column", "per_package",
                                  "pole_bank", "zero_dim", "transposed",
                                  "dense_gamma"])
def test_cuda_fma_f32_kernel_bit_equal_one_launch(cuda, name):
    """Every broadcast pattern the port calls `fma_f32` with: one launch of
    the kernel, bit-equal to the plain version on the card and on the CPU,
    broadcast carried as strides (the inputs are not copied)."""
    from repro_torch import fma_f32, fma_f32_reference

    a, b, c = _fma_case(name, cuda)
    before = fma_f32.launches
    out = fma_f32(a, b, c)
    torch.cuda.synchronize()
    assert fma_f32.launches == before + 1
    cpu = lambda x: x.cpu() if torch.is_tensor(x) else x
    assert torch.equal(out, fma_f32_reference(a, b, c))
    assert torch.equal(out.cpu(), fma_f32_reference(cpu(a), cpu(b), cpu(c)))
    assert out.is_contiguous() and out.dtype == torch.float32
    shapes = [x.shape for x in (a, b, c) if torch.is_tensor(x)]
    assert out.shape == torch.broadcast_shapes(*shapes)


@pytest.mark.cuda
def test_cuda_fma_f32_refuses_mixed_devices_and_types(cuda):
    from repro_torch import fma_f32

    b = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="f32 tensors"):
        fma_f32(torch.ones(4), b, 0.0)
    with pytest.raises(ValueError, match="f32 tensors"):
        fma_f32(1.0, b, torch.ones(4, dtype=torch.float64, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("n,t", [(100, 900), (2048, 64)])
def test_cuda_thermal_conv_dense_gamma_bit_equal(cuda, n, t):
    """A dense random Γ: the union is every column (several stages of the
    walk a chunk), at 100 tiles and at the widest the wrapper takes."""
    g = torch.Generator().manual_seed(n)
    dense = torch.rand((n, n), generator=g)
    gamma = (dense / dense.sum(1, keepdim=True)).to(cuda).contiguous()
    _conv_bit_equal(*_conv_case(t, n, cuda, gamma=gamma, seed=n))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [47, 100, 512])
@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_cuda_thermal_conv_non_finite_power_bit_equal(cuda, n, bad):
    """Spans of non-finite power: NaN and ±inf where the plain version's
    dense product has them — in rows whose Γ is zero at the column too."""
    power, gamma, decay, gain, state0 = _conv_case(1200, n, cuda, seed=3)
    if n == 47:
        gamma = _gamma(47, cuda)
    power[100:130, n // 3] = bad
    power[700, n - 1] = bad
    power[701, 0] = -bad
    dts, _ = _conv_bit_equal(power, gamma, decay, gain, state0)
    assert bool(torch.isnan(dts).any())
    assert bool(torch.isfinite(dts[:100]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n_poles", [1, 2, 3, 8])
def test_cuda_thermal_conv_pole_counts_bit_equal(cuda, n_poles):
    _conv_bit_equal(*_conv_case(800, 47, cuda, n_poles=n_poles,
                                seed=n_poles))


@pytest.mark.cuda
@pytest.mark.parametrize("t,n", [(1, 8), (5, 47), (383, 100), (385, 133),
                                 (1001, 37), (769, 531)])
def test_cuda_thermal_conv_short_and_ragged_bit_equal(cuda, t, n):
    """T shorter than one chunk (384 steps) or not a multiple of it, and
    tile counts that leave a ragged last block."""
    _conv_bit_equal(*_conv_case(t, n, cuda, seed=t + n))


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


def _fleet_matches_plain(params, args, thr0, step0=3):
    """One `fleet_step` launch against the plain version: traces and state
    within TOL (NaN where the plain version has NaN), events and latch
    exact."""
    before = tfs.fleet_step.launches
    out = tfs.fleet_step(*args, params, thr0=thr0, step0=step0)
    torch.cuda.synchronize()
    assert tfs.fleet_step.launches == before + 1
    ref = tfs.fleet_step_reference(*args, params, thr0=thr0, step0=step0)
    for a, b in zip(out[:4], ref[:4]):
        np.testing.assert_allclose(np_(a), np_(b), **TOL)
    np.testing.assert_array_equal(np_(out[4]), np_(ref[4]))
    if thr0 is not None:
        np.testing.assert_array_equal(np_(out[5]), np_(ref[5]))
    return out, ref


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_cuda_fleet_step_non_finite_rho_matches_plain_version(cuda, mode,
                                                              bad):
    """A NaN or inf ρ in one tile of a few packages (one at step 0): the
    dense product's 0·inf / 0·NaN terms reach every row of those packages
    in the plain version, and the kernel's sparse Γ walk must give the same
    (it takes the dense walk for that package and step)."""
    params, args, thr0 = _inputs(mode, 47, 64, 40, cuda)
    args[0][0, 5, 9] = bad
    args[0][7, 12, 3] = bad
    args[0][21, 40, 50] = -bad
    _, ref = _fleet_matches_plain(params, args, thr0)
    assert not bool(torch.isfinite(ref[0]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["v24", "reactive"])
def test_cuda_fleet_step_dense_and_diagonal_gamma_rows(cuda, mode):
    """A Γ with one fully dense row, one row with no off-diagonal entry and
    one column with no entry at all: the walk's row lengths run from 1 to
    47."""
    params, args, thr0 = _inputs(mode, 47, 96, 48, cuda)
    g = args[6].clone()
    gen = torch.Generator().manual_seed(3)
    g[3] = (0.01 + 0.02 * torch.rand(47, generator=gen)).to(cuda)
    g[3, 3] = 1.0
    g[11] = 0.0
    g[11, 11] = 1.0
    g[:, 20] = 0.0
    _fleet_matches_plain(params, args[:6] + (g.contiguous(),), thr0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_cuda_fleet_step_at_the_largest_tile_count(cuda, mode):
    """The most tiles the packed layout takes (FS_PACKED_TILES = 128 in
    csrc/fleet_step.cu), where a thread carries the most tiles."""
    params, args, thr0 = _inputs(mode, 128, 40, 36, cuda)
    assert tfs.layout(128, params) == "packed"
    _fleet_matches_plain(params, args, thr0)


def _planes(params, args, device, *, het=0, fallback=False, mixed=False,
            seed=2):
    """(params, args, kwargs) with per-package planes added: het rows with
    a tile axis of ``het`` around the fleet's own bank (τ × 0.7–1.4, gain
    × 0.8–1.2), the fallback plane with NaN / ±inf spans in three packages'
    ρ, the operator pins."""
    import dataclasses

    nt, n = args[4].shape
    g = torch.Generator().manual_seed(seed)
    u = lambda lo, hi, *s: (lo + (hi - lo) * torch.rand(s, generator=g))
    params = dataclasses.replace(params, fallback=fallback, mixed=mixed,
                                 stale_limit=3, recover=4)
    kw = {"step0": 7}
    if params.mode == "reactive_poll" or fallback or mixed:
        kw["thr0"] = (u(0, 1, nt, n) > 0.5).float().to(device)
    if het:
        decay = torch.tensor(params.decay)[:, None, None] ** (
            1.0 / u(0.7, 1.4, 1, het, n))
        gain = torch.tensor(params.gain)[:, None, None] * u(0.8, 1.2, 1, het,
                                                            n)
        kw["het"] = torch.cat([
            decay, gain, (1 - decay[-1] ** params.ahead)[None],
            gain.sum(0)[None],
            torch.randint(1, 7, (1, het, n), generator=g).float()]).to(device)
    if fallback:
        rho = args[0].clone()
        rho[5:12, :, 1] = float("nan")
        rho[7, 0, 2] = float("inf")
        rho[20:22, -1, 3] = -float("inf")
        args = (rho,) + args[1:]
        kw["fb0"] = (u(0.9, 2.7, nt, n).to(device),
                     torch.randint(0, 5, (n,), generator=g).float().to(device),
                     (u(0, 1, n) < 0.3).float().to(device))
    if mixed:
        kw["mode0"] = (u(0, 1, n) < 0.5).float().to(device)
    return params, args, kw


def _planes_match_plain(params, args, kw):
    before = tfs.fleet_step.launches
    out = tfs.fleet_step(*args, params, **kw)
    assert tfs.fleet_step.launches == before + 1
    ref = tfs.fleet_step_reference(*args, params, **kw)
    for name, a, b in zip(("temps", "freqs", "buf", "th"), out[:4], ref[:4]):
        assert bool(torch.isfinite(a).all()), name
        np.testing.assert_allclose(np_(a), np_(b), err_msg=name, **TOL)
    for a, b in zip(out[4:6], ref[4:6]):
        assert (a is None and b is None) or torch.equal(a, b)
    if ref[6] is not None:
        for a, b in zip(out[6], ref[6]):
            assert torch.equal(a, b)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("nt,het", [(1, 1), (8, 8), (8, 1), (47, 47),
                                    (47, 1)])
def test_cuda_fleet_step_het_rows_match_plain_version(cuda, mode, nt, het):
    """Per-tile and per-package het rows in the packed layout."""
    params, args, _ = _inputs(mode, nt, 70, 40, cuda)
    _planes_match_plain(*_planes(params, args, cuda, het=het))


@pytest.mark.cuda
@pytest.mark.parametrize("planes", ["fb0", "mode0", "both"])
@pytest.mark.parametrize("coupled", [False, True])
@pytest.mark.parametrize("nt", [1, 8, 47])
def test_cuda_fleet_step_reactive_planes_match_plain_version(cuda, planes,
                                                             coupled, nt):
    """The fallback plane (NaN / ±inf words held), the pins, and both with
    het rows; uncoupled fleets take the packed layout, coupled ones the
    wide layout."""
    params, args, _ = _inputs("v24", nt, 40, 40, cuda,
                              use_coupling=coupled)
    fb, mixed = planes in ("fb0", "both"), planes in ("mode0", "both")
    params, args, kw = _planes(params, args, cuda, fallback=fb, mixed=mixed,
                               het=nt if planes == "both" else 0)
    assert tfs.layout(nt, params) == ("wide" if coupled and nt > 1
                                      else "packed")
    _planes_match_plain(params, args, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("nt", [129, 200, 512])
def test_cuda_fleet_step_wide_layout_matches_plain_version(cuda, mode, nt):
    """Past the packed layout's 128 tiles: one block per package."""
    params, args, thr0 = _inputs(mode, nt, 12, 36, cuda)
    assert tfs.layout(nt, params) == "wide"
    _fleet_matches_plain(params, args, thr0)


@pytest.mark.cuda
def test_cuda_fleet_step_wide_layout_follows_each_gamma(cuda):
    """Different Γ of one shape, one after the other through the wide
    layout (each freed before the next is made, so the allocator may hand
    out the same block): every launch walks its own Γ's rows, whether the
    wrapper builds them or the caller passes `compact_rows`."""
    params, args, thr0 = _inputs("v24", 200, 24, 40, cuda)
    assert tfs.layout(200, params) == "wide"
    for seed in range(3):
        g = torch.Generator().manual_seed(seed)
        mask = torch.rand((200, 200), generator=g) < 0.03 * (seed + 1)
        gamma = row_normalise(torch.where(
            mask | torch.eye(200, dtype=torch.bool),
            torch.rand((200, 200), generator=g), 0.0)).to(cuda).contiguous()
        a = args[:6] + (gamma,)
        out, ref = _fleet_matches_plain(params, a, thr0)
        given = tfs.fleet_step(*a, params, thr0=thr0, step0=3,
                               rows=tfs.compact_rows(gamma))
        for x, y in zip(given[:5], out[:5]):
            assert torch.equal(x, y)
        del gamma, a, out, ref, given


@pytest.mark.cuda
def test_cuda_montecarlo_fused_matches_broadcast_and_oracle(cuda):
    """A 256-trial population: 2 surveys × 2 blocks = 4 launches on fused,
    per trial within 1e-5 of broadcast and `run_reference`."""
    from repro_torch.core import montecarlo

    draws = montecarlo.sample_trials(3, 256, 1200, device=cuda)
    before = tfs.fleet_step.launches
    rf = montecarlo.run(backend="fused", draws=draws, device=cuda)
    assert tfs.fleet_step.launches == before + 4
    rb = montecarlo.run(backend="broadcast", draws=draws, device=cuda)
    rr = montecarlo.run_reference(draws=draws, device=cuda)
    for other in (rb, rr):
        for f in rf._fields:
            np.testing.assert_allclose(np_(getattr(rf, f)),
                                       np_(getattr(other, f)), err_msg=f,
                                       **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["v24", "reactive"])
@pytest.mark.parametrize("nt", [4, 47])
@pytest.mark.parametrize("exponent", [2.0, 2.5])
def test_cuda_fleet_step_other_power_laws(cuda, mode, nt, exponent):
    """P ∝ f² (x·x) and a non-integer law (powf) run the general kernel
    (<TPT, false>), not the main path's cubic one: its law's one pow and
    P_prev = P_now·f^e, coupled v24 and reactive."""
    params, args, thr0 = _inputs(mode, nt, 96, 48, cuda,
                                 power_exponent=exponent)
    _fleet_matches_plain(params, args, thr0)


@pytest.mark.cuda
def test_cuda_grid_conv_state_carry_is_bit_exact(cuda):
    """Two chained calls (the second from the first's final state) give the
    one call's trace and final state bit for bit."""
    plant = GridPlant(SchedulerConfig(n_tiles=47, plant="grid"), FINGERPRINT,
                      device=cuda)
    g = torch.Generator().manual_seed(11)
    power = (80.0 + 40.0 * torch.rand((1000, 47), generator=g)).to(cuda)
    state0 = (10.0 * torch.rand((plant.gy, plant.W), generator=g)).to(cuda)
    full = plant.simulate(power, state0)
    a = plant.simulate(power[:413].contiguous(), state0)
    b = plant.simulate(power[413:].contiguous(), a[1])
    assert torch.equal(torch.cat([a[0], b[0]]), full[0])
    assert torch.equal(b[1], full[1])


# ----------------------------------------------- the serving slice's kernels
# bounds: the reference's (tests/test_kernels.py) — flash 2e-5 in f32 and
# 2e-2 in bf16, ssd 3e-5; a bf16 ssd output also one bf16 rounding step of
# its value (rtol 2^-7), as kernel and plain version may round either way
FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Tq,Tk,H,KV,d,window,q_offset", [
    (2, 256, 256, 4, 2, 64, 0, 0),
    (1, 256, 256, 8, 1, 128, 0, 0),
    (2, 512, 512, 4, 4, 64, 128, 0),
    (1, 128, 128, 2, 2, 256, 0, 0),
    (2, 100, 100, 4, 2, 112, 0, 0),        # ragged, Zamba2's head_dim
    (1, 96, 160, 4, 1, 64, 32, 64),         # q_offset and window
    (1, 64, 200, 2, 1, 32, 8, 300),         # the window empties every row
])
def test_cuda_flash_matches_plain_version(cuda, dtype, B, Tq, Tk, H, KV, d,
                                          window, q_offset):
    g = torch.Generator().manual_seed(Tq + d)
    q, k, v = (torch.randn(s, generator=g).to(cuda, dtype) for s in (
        (B, Tq, H, d), (B, Tk, KV, d), (B, Tk, KV, d)))
    before = tfa.flash_attention.launches
    out = tfa.flash_attention(q, k, v, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == (B, Tq, H, d)
    ref = tfa.flash_attention_reference(q, k, v, window=window,
                                        q_offset=q_offset)
    np.testing.assert_allclose(np_(out.float()), np_(ref.float()),
                               atol=FLASH_ATOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("B,T,H,N,P,dec_min,inc,use_u,use_h0", [
    (2, 128, 2, 64, 64, 0.90, True, False, False),
    (1, 256, 4, 32, 64, 0.80, False, True, False),
    (2, 128, 2, 16, 32, 0.95, False, True, True),
    (1, 64, 2, 64, 128, 0.70, True, False, True),
    (1, 200, 3, 64, 64, 0.90, True, False, False),    # chunk 8
])
def test_cuda_ssd_matches_plain_version(cuda, mixed, B, T, H, N, P, dec_min,
                                        inc, use_u, use_h0):
    g = torch.Generator().manual_seed(T + N)
    d = (dec_min + (0.999 - dec_min) * torch.rand((B, T, H, N), generator=g)
         ).to(cuda)
    b = (0.2 * torch.randn((B, T, H, N), generator=g)).to(cuda)
    x = torch.randn((B, T, H, P), generator=g).to(cuda)
    c = (0.2 * torch.randn((B, T, H, N), generator=g)).to(cuda)
    if mixed:                          # Mamba2 at bf16: c and x in bf16
        x, c = x.to(torch.bfloat16), c.to(torch.bfloat16)
    u = (0.1 * torch.randn((H, N), generator=g)).to(cuda) if use_u else None
    h0 = torch.randn((B, H, N, P), generator=g).to(cuda) if use_h0 else None
    before = tsm.ssd.launches
    y, hT = tsm.ssd(d, b, x, c, u=u, h0=h0, include_current=inc)
    torch.cuda.synchronize()
    assert tsm.ssd.launches == before + 1
    assert y.dtype == x.dtype and hT.dtype == torch.float32
    ry, rh = tsm.ssd_reference(d, b, x, c, u=u, h0=h0,
                               chunk=tsm.chunk_for(T, 64),
                               include_current=inc)
    np.testing.assert_allclose(np_(y.float()), np_(ry.float()), atol=3e-5,
                               rtol=2.0 ** -7 if mixed else 0)
    np.testing.assert_allclose(np_(hT), np_(rh), atol=3e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Tq,Tk,H,KV,d,causal,window,q_offset", [
    (8, 1024, 1024, 32, 32, 112, True, 0, 0),     # Zamba2-7B prefill
    (8, 1024, 1024, 8, 1, 256, True, 0, 0),       # Gemma-2B prefill
    (1, 300, 300, 6, 6, 64, True, 0, 0),
    (2, 200, 333, 6, 3, 112, True, 48, 133),
    (1, 190, 190, 8, 1, 128, False, 0, 0),
    (2, 130, 257, 4, 2, 256, True, 0, 127),
    (1, 64, 200, 3, 1, 112, True, 8, 300),        # the window empties rows
    (1, 97, 97, 5, 5, 256, True, 16, 0),
])
def test_cuda_flash_tensor_core_route_matches_plain_version(
        cuda, B, Tq, Tk, H, KV, d, causal, window, q_offset):
    """bf16 at every tensor-core head dim, MHA / GQA / MQA, masks and
    ragged edges: one launch, on the tensor-core route, within 2e-2."""
    g = torch.Generator().manual_seed(Tq + d + H)
    q, k, v = (torch.randn(s, generator=g).to(cuda, torch.bfloat16)
               for s in ((B, Tq, H, d), (B, Tk, KV, d), (B, Tk, KV, d)))
    before = dict(tfa.flash_attention.launches_by_route)
    out = tfa.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    torch.cuda.synchronize()
    after = tfa.flash_attention.launches_by_route
    assert after["tensor_core"] == before["tensor_core"] + 1
    assert after["cuda_core"] == before["cuda_core"]
    ref = tfa.flash_attention_reference(q, k, v, causal=causal,
                                        window=window, q_offset=q_offset)
    np.testing.assert_allclose(np_(out.float()), np_(ref.float()),
                               atol=FLASH_ATOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype,d", [
    (torch.float32, torch.float32, 112), (torch.float32, torch.bfloat16, 112),
    (torch.bfloat16, torch.bfloat16, 32), (torch.bfloat16, torch.float32, 64)])
def test_cuda_flash_other_inputs_take_the_cuda_core_route(cuda, q_dtype,
                                                         kv_dtype, d):
    g = torch.Generator().manual_seed(d)
    q = torch.randn((2, 150, 4, d), generator=g).to(cuda, q_dtype)
    k, v = (torch.randn((2, 150, 2, d), generator=g).to(cuda, kv_dtype)
            for _ in range(2))
    before = dict(tfa.flash_attention.launches_by_route)
    out = tfa.flash_attention(q, k, v, window=40)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches_by_route["cuda_core"] == \
        before["cuda_core"] + 1
    assert tfa.flash_attention.launches_by_route["tensor_core"] == \
        before["tensor_core"]
    ref = tfa.flash_attention_reference(q, k, v, window=40)
    np.testing.assert_allclose(np_(out.float()), np_(ref.float()),
                               atol=FLASH_ATOL[q_dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_mla_head_dims_take_the_cuda_core_route(cuda, dtype,
                                                          causal):
    """MLA's q/k head dim 192 with v head dim 128 and its explicit scale:
    one launch on the CUDA-core route, within the reference's bound."""
    g = torch.Generator().manual_seed(192)
    q, k = (torch.randn((2, 300, 8, 192), generator=g).to(cuda, dtype)
            for _ in range(2))
    v = torch.randn((2, 300, 8, 128), generator=g).to(cuda, dtype)
    before = dict(tfa.flash_attention.launches_by_route)
    out = tfa.flash_attention(q, k, v, causal=causal, scale=192 ** -0.5)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches_by_route["cuda_core"] == \
        before["cuda_core"] + 1
    assert out.shape == (2, 300, 8, 128) and out.dtype == dtype
    ref = tfa.flash_attention_reference(q, k, v, causal=causal,
                                        scale=192 ** -0.5)
    np.testing.assert_allclose(np_(out.float()), np_(ref.float()),
                               atol=FLASH_ATOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,N,P,inc,use_u,use_h0,mixed", [
    (1, 7, 2, 6, 6, True, True, True, False),     # element-wise staging
    (1, 96, 3, 20, 36, False, True, True, True),
    (1, 64, 2, 64, 128, True, True, True, True),
    (8, 1024, 112, 64, 64, True, False, False, True),  # Zamba2-7B prefill
    (8, 1024, 32, 64, 64, False, True, False, True),   # RWKV6-1.6B prefill
])
def test_cuda_ssd_staging_paths_match_plain_version(cuda, B, T, H, N, P, inc,
                                                    use_u, use_h0, mixed):
    g = torch.Generator().manual_seed(T + N + P)
    d = (0.9 + 0.099 * torch.rand((B, T, H, N), generator=g)).to(cuda)
    b = (0.2 * torch.randn((B, T, H, N), generator=g)).to(cuda)
    x = torch.randn((B, T, H, P), generator=g).to(cuda)
    c = (0.2 * torch.randn((B, T, H, N), generator=g)).to(cuda)
    if mixed:
        x, c = x.to(torch.bfloat16), c.to(torch.bfloat16)
    u = (0.1 * torch.randn((H, N), generator=g)).to(cuda) if use_u else None
    h0 = torch.randn((B, H, N, P), generator=g).to(cuda) if use_h0 else None
    before = tsm.ssd.launches
    y, hT = tsm.ssd(d, b, x, c, u=u, h0=h0, include_current=inc)
    torch.cuda.synchronize()
    assert tsm.ssd.launches == before + 1
    ry, rh = tsm.ssd_reference(d, b, x, c, u=u, h0=h0,
                               chunk=tsm.chunk_for(T, 64),
                               include_current=inc)
    np.testing.assert_allclose(np_(y.float()), np_(ry.float()), atol=3e-5,
                               rtol=2.0 ** -7 if mixed else 0)
    np.testing.assert_allclose(np_(hT), np_(rh), atol=3e-5)


@pytest.mark.cuda
def test_cuda_kernel_wrappers_raise_on_wrong_device_or_dtype(cuda):
    q = torch.randn(1, 64, 2, 32, device=cuda)
    with pytest.raises(ValueError, match="is on"):
        tfa.flash_attention(q, q.cpu(), q)
    with pytest.raises(TypeError):
        tfa.flash_attention(q.half(), q.half(), q.half())
    d = torch.rand(1, 64, 2, 16, device=cuda)
    x = torch.randn(1, 64, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="is on"):
        tsm.ssd(d, d.cpu(), x, d)
    with pytest.raises(TypeError):
        tsm.ssd(d.double(), d, x, d)
    with pytest.raises(ValueError):
        tsm.ssd(d, d, x, d, h0=torch.zeros(1, 2, 16, 8, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-7b", "gemma-2b", "rwkv6-1.6b",
                                  "mixtral-8x7b", "deepseek-v2-236b",
                                  "chameleon-34b", "musicgen-large"])
def test_cuda_models_launch_kernels_in_prefill_only(cuda, arch):
    """A reduced model on the card: one ssd launch per Mamba2 / RWKV6 layer
    and one flash launch per attention application in prefill, none in
    decode; its logits equal the CPU's (plain versions) within 1e-4."""
    cfg = reduced(get_arch(arch))
    params = ttf.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(2, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(1))
    cpu_last, cpu_cache, _ = ttf.prefill(params, cfg, toks, 80)
    cpu_lg, _ = ttf.decode_step(params, cfg, cpu_cache, toks[:, 0], 64)
    to = lambda t: ({k: to(v) for k, v in t.items()} if isinstance(t, dict)
                    else t.to(cuda))
    gp = to(params)
    n_attn = (sum(1 for gs in ttf._hybrid_group_ids(cfg)
                  if gs == cfg.attn_every) if cfg.family == "hybrid"
              else 0 if cfg.family == "ssm" else cfg.n_layers)
    n_ssd = cfg.n_layers if cfg.family in ("hybrid", "ssm") else 0
    f0, s0 = tfa.flash_attention.launches, tsm.ssd.launches
    last, cache, _ = ttf.prefill(gp, cfg, toks.to(cuda), 80)
    torch.cuda.synchronize()
    assert (tfa.flash_attention.launches - f0, tsm.ssd.launches - s0) == \
        (n_attn, n_ssd)
    lg, _ = ttf.decode_step(gp, cfg, cache, toks[:, 0].to(cuda), 64)
    torch.cuda.synchronize()
    assert (tfa.flash_attention.launches - f0, tsm.ssd.launches - s0) == \
        (n_attn, n_ssd)
    np.testing.assert_allclose(np_(last), np_(cpu_last), atol=1e-4)
    np.testing.assert_allclose(np_(lg), np_(cpu_lg), atol=1e-4)


def _sync_calls(fn):
    """(fn(), the synchronizing CUDA calls it made, by PyTorch's sync debug
    mode)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing CUDA operation" in str(w.message)
                    for w in caught)


@pytest.mark.cuda
def test_cuda_service_one_copy_per_tick_and_no_builds_after_warmup(cuda):
    """The resident service on the card: after `warmup`, attach / detach
    across buckets, canary and ticks build and load no kernel library;
    every tick makes exactly the synchronizing calls of ONE device→host
    copy, and the surgery none; one `fleet_step` launch a tick."""
    from repro_torch.fleet import FleetService
    from repro_torch.kernels import _build

    cfg = SchedulerConfig(n_tiles=4, mixed_mode=True)
    svc = FleetService(cfg, backend="fused", flush_every=32, device=cuda)
    svc.warmup(max_packages=16)
    counts = dict(_build.COUNTS)
    _, per_copy = _sync_calls(lambda: torch.ones(3, device=cuda).cpu())
    assert per_copy >= 1
    for i in range(6):
        _, k = _sync_calls(lambda: svc.attach(f"p{i}", "acme"))
        assert k == 0
    for frac in (0.5, 0.0):
        _, k = _sync_calls(lambda: svc.canary(frac))
        assert k == 0
        before = tfs.fleet_step.launches
        rec, k = _sync_calls(svc.tick)
        assert k == per_copy and tfs.fleet_step.launches == before + 1
        assert rec["capacity"] == 8
    for i in range(5):
        _, k = _sync_calls(lambda: svc.detach(f"p{i}"))
        assert k == 0
    rec, k = _sync_calls(svc.tick)
    assert k == per_copy and rec["capacity"] == 4
    assert _build.COUNTS == counts and svc.host_syncs == 3


@pytest.mark.cuda
def test_cuda_service_flush_records_match_broadcast(cuda):
    """Each fused flush record on the card equals the broadcast service's
    on the same chunk from the same state (statistics re-derived from the
    ring, as the fused backend does on entry)."""
    from repro_torch.fleet import FleetService

    cfg = SchedulerConfig(n_tiles=47, mixed_mode=True)
    fused = FleetService(cfg, backend="fused", flush_every=64, device=cuda)
    plain = FleetService(cfg, backend="broadcast", flush_every=64,
                         device=cuda)
    for s in (fused, plain):
        for i in range(24):
            s.attach(f"p{i}", ("acme", "zeta")[i % 2],
                     ("inference", "training", "vision", "batch")[i % 4])
        s.canary(0.25)
        s.set_thresholds("zeta", t_crit_c=60.0)
    for _ in range(3):
        st = fused.state
        rec = fused.tick()
        ft = st.filtration
        plain.state = st._replace(filtration=ft._replace(**dict(zip(
            ("wsum", "csum", "rsum"), exact_stats(ft.buf, ft.ptr)))))
        want = plain.tick(chunk=rec["rho"])
        for k, v in want["telemetry"].items():
            tol = 1e-3 if k in ("freq_min", "at_risk_frac") else 1e-5
            assert rec["telemetry"][k] == pytest.approx(v, rel=tol,
                                                        abs=tol), k
        assert ([(a["tenant"], a["kind"], a["event"]) for a in rec["alerts"]]
                == [(a["tenant"], a["kind"], a["event"])
                    for a in want["alerts"]])


# ---------------------------------------------------------------- training --
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,Tq,Tk,H,KV,d,dv,window,q_offset", [
    (torch.bfloat16, 2, 256, 256, 8, 1, 256, 256, 0, 0),   # Gemma's MQA
    (torch.bfloat16, 1, 300, 300, 4, 2, 112, 112, 64, 0),  # ragged, window
    (torch.bfloat16, 1, 128, 128, 8, 8, 192, 128, 0, 0),   # MLA's d != dv
    (torch.float32, 2, 200, 200, 10, 5, 64, 64, 0, 0),     # the 100M example
    (torch.float32, 1, 64, 200, 2, 1, 32, 32, 8, 300),     # rows left empty
])
def test_cuda_flash_backward_matches_plain_version(cuda, dtype, B, Tq, Tk,
                                                   H, KV, d, dv, window,
                                                   q_offset):
    """The statistics forward against the plain statistics (its output the
    serving launch's bits) and the backward kernel against the plain
    backward: each gradient within 1e-5 (f32) or 5e-3 (bf16) of its
    largest magnitude, the same bits on two launches."""
    g = torch.Generator(device=cuda).manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)
    q, k, v, do = r(B, Tq, H, d), r(B, Tk, KV, d), r(B, Tk, KV, dv), \
        r(B, Tq, H, dv)
    kw = dict(window=window, q_offset=q_offset)
    out, o, m, l = tfa.flash_attention_stats(q, k, v, **kw)
    assert torch.equal(out, tfa.flash_attention(q, k, v, **kw))
    po, pm, pl = tfa.flash_attention_stats_reference(q, k, v, **kw)
    assert torch.equal(m <= -1e29, pm <= -1e29)
    torch.testing.assert_close(o, po, rtol=0,
                               atol=2e-5 if dtype == torch.float32 else 2e-2)
    torch.testing.assert_close(l, pl, rtol=1e-5, atol=0)
    before = tfa.flash_attention_backward.launches
    g1 = tfa.flash_attention_backward(q, k, v, po, pm, pl, do, **kw)
    g2 = tfa.flash_attention_backward(q, k, v, po, pm, pl, do, **kw)
    assert tfa.flash_attention_backward.launches == before + 2
    want = tfa.flash_attention_backward_reference(q, k, v, po, pm, pl, do,
                                                  **kw)
    bound = 1e-5 if dtype == torch.float32 else 5e-3
    for a, b, w in zip(g1, g2, want):
        assert torch.equal(a, b) and a.dtype == w.dtype
        assert float((a.float() - w.float()).abs().max()) <= bound * float(
            w.float().abs().max())


@pytest.mark.cuda
def test_cuda_flash_attention_with_grad_launches_both_kernels(cuda):
    q, k, v = (torch.randn(1, 128, 4, 64, device=cuda, dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3))
    tfa.reset_launches()
    out = tfa.flash_attention(q, k, v)
    out.float().square().sum().backward()
    assert tfa.flash_attention.launches_by_route["tensor_core"] == 1
    assert tfa.flash_attention_backward.launches == 1
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in (q, k, v))


@pytest.mark.cuda
def test_cuda_ssd_refuses_to_return_an_output_without_a_graph(cuda):
    """The ssd kernel has no backward yet (ROADMAP queue 1 step 10.5b)."""
    d = torch.full((1, 64, 2, 16), 0.9, device=cuda, requires_grad=True)
    b, c = (torch.randn(1, 64, 2, 16, device=cuda) for _ in range(2))
    x = torch.randn(1, 64, 2, 32, device=cuda)
    with pytest.raises(NotImplementedError, match="10.5b"):
        tsm.ssd(d, b, x, c)
    with torch.no_grad():
        y, _ = tsm.ssd(d, b, x, c)
    assert y.shape == x.shape


@pytest.mark.cuda
def test_cuda_train_step_kernels_match_plain_versions(cuda):
    """Reduced Gemma (bf16, head dim 64: the tensor-core route) — one
    step's loss and gradients on the kernels against FlashAttention's plain
    branches: 2 forward launches and 1 backward a layer, each gradient leaf
    within 5e-2 of its largest magnitude (bf16)."""
    from repro_torch.launch import steps as S

    cfg = reduced(get_arch("gemma-2b"), head_dim=64, dtype="bfloat16")
    params = ttf.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    toks = torch.randint(2, cfg.vocab_size, (2, 256), device=cuda)
    labs = torch.randint(2, cfg.vocab_size, (2, 256), device=cuda)
    tfa.reset_launches()
    loss, _, grads = S.loss_and_grads(params, cfg, toks, labs)
    L = cfg.n_layers
    assert tfa.flash_attention.launches_by_route["tensor_core"] == 2 * L
    assert tfa.flash_attention_backward.launches == L
    saved = tfa.flash_attention_stats, tfa.flash_attention_backward
    tfa.flash_attention_stats = lambda q, k, v, **kw: (
        lambda o, m, l: (o.to(q.dtype), o, m, l))(
            *tfa.flash_attention_stats_reference(q, k, v, **kw))
    tfa.flash_attention_backward = \
        lambda q, k, v, o, m, l, do, **kw: \
        tfa.flash_attention_backward_reference(q, k, v, o, m, l,
                                               do.contiguous(), **kw)
    try:
        loss_p, _, grads_p = S.loss_and_grads(params, cfg, toks, labs)
    finally:
        tfa.flash_attention_stats, tfa.flash_attention_backward = saved
    assert float(loss) == pytest.approx(float(loss_p), rel=1e-3)
    for a, b in zip(grads, grads_p):
        a, b = a.float(), b.float()
        assert float((a - b).abs().max()) <= 5e-2 * float(b.abs().max())


@pytest.mark.cuda
def test_cuda_train_driver_refuses_the_ssd_families(cuda):
    from repro_torch.launch import train

    with pytest.raises(SystemExit, match="10.5b"):
        train.main(["--arch", "rwkv6-1.6b", "--reduced", "--steps", "1"])
