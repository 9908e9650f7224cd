"""PyTorch port, heterogeneous fleets (per-package process variation): the
port against itself (identical draws bit-match the homogeneous fleet) and
against the JAX reference (random draws through the reference's
`PackageParams`, carried across by `convert.package_params_from_numpy`),
on both backends, for `fleet_step`'s het rows against the Pallas kernel in
interpret mode, and for the fitted ROM's rows on the fused backend."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np

from torch_parity import (TOL, assert_state_close, assert_telemetry_close,
                          np_, trace)
from test_torch_fleet_step import _case, _torch_inputs

from repro.core import thermal as jth
from repro.core.pdu_gate import exact_stats as j_exact_stats
from repro.core.scheduler import SchedulerConfig as JCfg
from repro.fleet import FleetEngine as JEngine
from repro.kernels.fleet_step import fleet_step as j_fleet_step

from repro_torch.convert import package_params_from_numpy, state_from_numpy
from repro_torch.core.scheduler import SchedulerConfig as TCfg
from repro_torch.core.scheduler import ThermalScheduler as TSched
from repro_torch.fleet import FleetEngine as TEngine
from repro_torch.kernels import fleet_step as tfs

jax.config.update("jax_platform_name", "cpu")

MODES = ["v24", "reactive", "reactive_poll", "off"]
BACKENDS = ["broadcast", "fused"]


def _ref_draws(sched, n, nt, seed):
    """Random per-tile draws through the reference's `package_params`."""
    rng = np.random.default_rng(seed)
    np_poles = sched.poles.decay.shape[0]
    rth = rng.uniform(0.3, 0.6, (n, nt)).astype(np.float32)
    tau = rng.uniform(40.0, 150.0, (n, nt)).astype(np.float32)
    bank = jth.pole_bank(rth, tau, sched.cfg.step_ms)
    bank = jth.PoleParams(
        decay=jnp.repeat(bank.decay, np_poles, -1) ** jnp.arange(
            1, np_poles + 1, dtype=jnp.float32),
        gain=jnp.repeat(bank.gain, np_poles, -1) / np_poles)
    poll = rng.integers(1, 7, (n, nt))
    return sched.package_params(bank, poll_ticks=poll, batch_shape=(n,))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", MODES)
def test_identical_draws_bitmatch_homogeneous(backend, mode):
    """All-identical per-package draws ≡ the homogeneous fleet, bit for
    bit (the het rows carry the same f32 constants, same op order)."""
    cfg = TCfg(n_tiles=4, mode=mode)
    e0 = TEngine(cfg, backend=backend, device="cpu")
    e1 = TEngine(dataclasses.replace(cfg, heterogeneous=True),
                 backend=backend, device="cpu")
    tr = trace(24, 6, 4, seed=1)
    s0, t0 = e0.run_chunked(e0.init(6), tr, flush_every=10)
    s1, t1 = e1.run_chunked(e1.init(6), tr, flush_every=10)
    assert s1.pkg is not None and s0.pkg is None
    for f in ("thermal", "freq", "events"):
        assert torch.equal(getattr(s0, f), getattr(s1, f)), f
    for f in t0._fields:
        assert torch.equal(getattr(t0, f), getattr(t1, f)), f


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", MODES)
def test_het_draws_match_reference(backend, mode):
    """Per-package, per-tile random draws (poles, η, ΣG, poll) against the
    reference's broadcast engine: state ≤1e-5, events exact, telemetry in
    the bound taxonomy."""
    n, nt = 5, 3
    je = JEngine(JCfg(n_tiles=nt, mode=mode, heterogeneous=True),
                 backend="broadcast")
    te = TEngine(TCfg(n_tiles=nt, mode=mode, heterogeneous=True),
                 backend=backend, device="cpu")
    pkg = _ref_draws(je.sched, n, nt, seed=MODES.index(mode))
    js = je.init(n, pkg=pkg)
    ts = te.init(n, pkg=package_params_from_numpy(jax.device_get(pkg),
                                                  device="cpu"))
    tr = trace(36, n, nt, seed=2)
    js, jtel = je.run_chunked(js, jnp.asarray(tr), flush_every=16)
    ts, ttel = te.run_chunked(ts, tr, flush_every=16)
    assert_state_close(jax.device_get(js), ts, f"{backend}/{mode}",
                       exact_stats=j_exact_stats if backend == "fused"
                       else None)
    assert_telemetry_close(jax.device_get(jtel), ttel, f"{backend}/{mode}")


@pytest.mark.parametrize("tile_axis", ["tiles", "one"])
@pytest.mark.parametrize("mode", MODES)
def test_plain_fleet_step_het_rows_match_pallas_kernel(mode, tile_axis):
    """`fleet_step_reference` with het rows [2·np + 3, tiles | 1, n] vs the
    reference kernel in interpret mode: traces and state ≤1e-5, events and
    latch exact."""
    nt, n, t = 4, 12, 36
    jparams, tparams, inputs, thr0 = _case(mode, nt, n, t)
    rng = np.random.default_rng(MODES.index(mode))
    tn = nt if tile_axis == "tiles" else 1
    # process variation around the fleet's own bank: τ × 0.7–1.4, gain ×
    # 0.8–1.2, η = 1 − a_slow^ahead
    a0 = np.asarray(jparams.decay, np.float32)[:, None, None]
    decay = (a0 ** (1.0 / rng.uniform(0.7, 1.4, (1, tn, n)))).astype(
        np.float32)
    gain = (np.asarray(jparams.gain, np.float32)[:, None, None]
            * rng.uniform(0.8, 1.2, (1, tn, n))).astype(np.float32)
    het = np.concatenate([
        decay, gain, (1 - decay[-1] ** np.float32(jparams.ahead))[None],
        gain.sum(0)[None], rng.integers(1, 7, (1, tn, n))]).astype(np.float32)
    assert np.isfinite(het).all()
    ref = j_fleet_step(*inputs.values(), jparams, het=jnp.asarray(het),
                       thr0=thr0, step0=5, interpret=True)
    out = tfs.fleet_step_reference(
        *_torch_inputs(inputs).values(), tparams, het=torch.from_numpy(het),
        thr0=None if thr0 is None else torch.from_numpy(thr0), step0=5)
    for name, a, b in zip(("temps", "freqs", "buf", "th"), out[:4], ref[:4]):
        assert np.isfinite(np_(a)).all(), name
        np.testing.assert_allclose(np_(a), np.asarray(b), err_msg=name, **TOL)
    np.testing.assert_array_equal(np_(out[4]), np.asarray(ref[4]))
    if thr0 is not None:
        np.testing.assert_array_equal(np_(out[5]), np.asarray(ref[5]))


def test_package_params_shape_contract():
    """`package_params` derives η and ΣG like the reference (η bit-equal),
    accepts [n, n_poles] banks, and `init` rejects wrong-rank draws and
    draws on a homogeneous config."""
    cfg = dict(n_tiles=3, mode="v24")
    js = JEngine(JCfg(heterogeneous=True, **cfg)).sched
    ts = TSched(TCfg(heterogeneous=True, **cfg), device="cpu")
    jp = _ref_draws(js, 4, 3, seed=9)
    tp = ts.package_params(
        jth.PoleParams(decay=np.asarray(jp.decay), gain=np.asarray(jp.gain)),
        poll_ticks=np.asarray(jp.poll_ticks), batch_shape=(4,))
    for f in ("decay", "gain", "eta", "poll_ticks"):
        np.testing.assert_array_equal(np_(getattr(tp, f)),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    np.testing.assert_allclose(np_(tp.gain_sum), np.asarray(jp.gain_sum),
                               rtol=1e-7)
    flat = ts.package_params(jth.PoleParams(
        decay=np.asarray(jp.decay)[:, 0], gain=np.asarray(jp.gain)[:, 0]),
        batch_shape=(4,))
    assert tuple(flat.decay.shape) == (4, 1, 2)
    assert tuple(flat.eta.shape) == tuple(flat.poll_ticks.shape) == (4, 1)
    assert int(flat.poll_ticks[0, 0]) == ts.poll_ticks
    default = ts.package_params(batch_shape=(4,))
    assert tuple(default.decay.shape) == (4, 1, 2)
    with pytest.raises(ValueError, match="PackageParams.decay"):
        ts.init((5,), pkg=tp)
    with pytest.raises(ValueError, match="heterogeneous=True"):
        TSched(TCfg(**cfg), device="cpu").init((4,), pkg=tp)
    with pytest.raises(ValueError, match="decay/gain"):
        ts.package_params(jth.PoleParams(decay=np.ones((4, 1, 3)),
                                         gain=np.ones((4, 1, 3))),
                          batch_shape=(4,))


@pytest.mark.parametrize("mode", ["v24", "reactive_poll"])
def test_rom_on_fused_matches_reference(mode):
    """A fitted-ROM fleet on the fused backend (its per-tile bank as het
    rows) against the reference's fused ROM fleet."""
    n, nt = 6, 2
    cfg = dict(n_tiles=nt, mode=mode, plant="rom")
    je = JEngine(JCfg(**cfg), backend="fused")
    te = TEngine(TCfg(**cfg), backend="fused", device="cpu")
    tr = trace(30, n, nt, seed=4)
    js, jtel = je.run_chunked(je.init(n), jnp.asarray(tr), flush_every=16)
    ts, ttel = te.run_chunked(te.init(n), tr, flush_every=16)
    assert_state_close(jax.device_get(js), ts, f"rom/{mode}",
                       exact_stats=j_exact_stats)
    assert_telemetry_close(jax.device_get(jtel), ttel, f"rom/{mode}")


def test_het_state_crosses_over():
    """A heterogeneous reference state (draws included) carried into the
    port steps on to the reference's numbers."""
    n, nt = 4, 2
    je = JEngine(JCfg(n_tiles=nt, mode="v24", heterogeneous=True),
                 backend="broadcast")
    te = TEngine(TCfg(n_tiles=nt, mode="v24", heterogeneous=True),
                 device="cpu")
    js = je.init(n, pkg=_ref_draws(je.sched, n, nt, seed=3))
    tr = trace(20, n, nt, seed=6)
    js, _ = je.run_block(js, jnp.asarray(tr[:10]))
    ts = state_from_numpy(jax.device_get(js), device="cpu")
    assert ts.pkg is not None
    js, _ = je.run_block(js, jnp.asarray(tr[10:]))
    ts, _ = te.run_block(ts, tr[10:])
    assert_state_close(jax.device_get(js), ts, "carried")
