"""PyTorch port, core physics: constants, density, coupling, plant, filtration
and the per-step scheduler, held against the JAX reference on the CPU.

Constants derived from the fingerprint (Γ, pole banks, η) must match the
reference bit for bit; computed values follow the bound taxonomy of
tests/torch_parity.py."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import numpy as np

from torch_parity import TOL, assert_state_close, np_, trace

from repro.configs import ALL_ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.core import coupling as jcp
from repro.core import density as jd
from repro.core import pdu_gate as jpg
from repro.core import thermal as jth
from repro.core.fingerprint import FINGERPRINT as J_FP
from repro.core.scheduler import SchedulerConfig as JCfg
from repro.core.scheduler import ThermalScheduler as JSched

from repro_torch.configs import ALL_ARCHS as T_ARCHS
from repro_torch.configs import SHAPES as T_SHAPES
from repro_torch.core import coupling as tcp
from repro_torch.core import density as td
from repro_torch.core import pdu_gate as tpg
from repro_torch.core import thermal as tth
from repro_torch.core.fingerprint import FINGERPRINT as T_FP
from repro_torch.core.scheduler import SchedulerConfig as TCfg
from repro_torch.core.scheduler import ThermalScheduler as TSched

jax.config.update("jax_platform_name", "cpu")


def test_fingerprint_matches_reference():
    assert dataclasses.asdict(T_FP) == dataclasses.asdict(J_FP)
    assert (T_FP.a1, T_FP.a2, T_FP.a2_frac) == (J_FP.a1, J_FP.a2,
                                                J_FP.a2_frac)
    la = np.asarray([20.0, 35.0, 50.0], np.float32)
    np.testing.assert_allclose(np_(T_FP.eta(la)), np.asarray(J_FP.eta(la)),
                               rtol=1e-6)
    np.testing.assert_allclose(np_(tpg.eta(la)), np.asarray(jpg.eta(la)),
                               rtol=1e-6)


def test_config_literals_and_rho_v24_match_reference():
    assert sorted(T_ARCHS) == sorted(J_ARCHS)
    for name, cfg in T_ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(J_ARCHS[name])
    assert {k: dataclasses.asdict(v) for k, v in T_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    for name, cfg in T_ARCHS.items():
        for s, sh in T_SHAPES.items():
            assert td.rho_raw(cfg, sh) == jd.rho_raw(J_ARCHS[name],
                                                     J_SHAPES[s])
            assert td.rho_v24(cfg, sh) == jd.rho_v24(J_ARCHS[name],
                                                     J_SHAPES[s])


def test_density_chain_matches_reference():
    """ρ → R_tok → ΔT → P rounds as the reference's compiled fleet loop
    (fused multiply-adds, reciprocal multiply): bit for bit against the
    jitted reference, within 1e-5 of its eager op-by-op form."""
    rho = np.linspace(0.9, 2.7, 1001, dtype=np.float32)
    for name in ("rtok_from_rho", "dt_from_rho", "power_from_rho"):
        port = np_(getattr(td, name)(rho))
        np.testing.assert_array_equal(
            port, np.asarray(jax.jit(getattr(jd, name))(rho)), err_msg=name)
        np.testing.assert_allclose(port, np.asarray(getattr(jd, name)(rho)),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("n_tiles", [1, 2, 4, 7, 16, 33, 47, 64])
def test_coupling_matrix_bit_identical(n_tiles):
    """Raw Γ and the scheduler's row-normalised Γ match bit for bit."""
    np.testing.assert_array_equal(np_(tcp.coupling_matrix(n_tiles)),
                                  np.asarray(jcp.coupling_matrix(n_tiles)))
    js = JSched(JCfg(n_tiles=n_tiles))
    ts = TSched(TCfg(n_tiles=n_tiles), device="cpu")
    if js.gamma is None:
        assert ts.gamma is None
    else:
        np.testing.assert_array_equal(np_(ts.gamma), np.asarray(js.gamma))


def test_ponte_vecchio_sparsity_matches_reference():
    t, j = tcp.ponte_vecchio_gamma(), jcp.ponte_vecchio_gamma()
    np.testing.assert_array_equal(np_(t), np.asarray(j))
    assert tcp.sparsity_stats(t) == jcp.sparsity_stats(j)
    assert tcp.sparsity_stats(t, 0.1) == jcp.sparsity_stats(j, 0.1)
    # 47-tile Ponte Vecchio Γ is the same matrix SchedulerConfig(47) builds
    np.testing.assert_array_equal(np_(t), np_(tcp.coupling_matrix(47)))


def test_apply_coupling_matches_reference_in_a_fixed_order():
    """Γ·p within 1e-5 of the reference's GEMM, accumulated source tile by
    source tile with one f32 FMA each (the CUDA kernel's order)."""
    g = np.array(JSched(JCfg(n_tiles=47)).gamma)
    p = np.random.default_rng(0).uniform(20, 130, (5, 3, 47)).astype(
        np.float32)
    out = np_(tcp.apply_coupling(torch.from_numpy(g), torch.from_numpy(p)))
    np.testing.assert_allclose(out, np.asarray(jcp.apply_coupling(g, p)),
                               **TOL)
    acc = np.zeros(p.shape, np.float32)
    for j in range(47):
        acc = (g[:, j].astype(np.float64) * p[..., j:j + 1] + acc).astype(
            np.float32)
    np.testing.assert_array_equal(out, acc)


def _rn32(exact):
    """The f32 nearest the exact rational (ties to even)."""
    from fractions import Fraction

    f = np.float32(float(exact))
    lo, hi = ((np.nextafter(f, np.float32(-np.inf)), f)
              if Fraction(float(f)) > exact
              else (f, np.nextafter(f, np.float32(np.inf))))
    dl, dh = exact - Fraction(float(lo)), Fraction(float(hi)) - exact
    if dl != dh:
        return lo if dl < dh else hi
    return lo if int(np.float32(lo).view(np.int32)) % 2 == 0 else hi


@pytest.mark.parametrize("case", ["above_midpoint", "below_midpoint",
                                  "negative", "random"])
def test_fma_f32_rounds_once(case):
    """`fma_f32` is the single rounding of a·b + c, as fmaf on the card:
    where the f64 sum lands on an f32 halfway point while the exact sum
    lies off it, the two roundings of a plain f64 sum would go the wrong
    way (the first three cases are built so; a·b = 2^-24 ± a few 2^-70
    beside c ≈ 1)."""
    from fractions import Fraction

    from repro_torch import fma_f32

    f32 = lambda *v: torch.tensor(v, dtype=torch.float32)
    if case == "random":      # small products beside large sums, as Γ·P
        rng = np.random.default_rng(0)
        a = (rng.uniform(-1, 1, 4000) * 2.0 ** rng.integers(-20, 0, 4000)
             ).astype(np.float32)
        b = rng.uniform(-100, 100, 4000).astype(np.float32)
        c = rng.uniform(-100, 100, 4000).astype(np.float32)
    else:
        big, small = 2 ** 23 + 2896, 2 ** 23 - 2895     # product 2^46 + 4688
        if case == "below_midpoint":                     # product 2^46 − 1
            big, small = 2 ** 23 + 1, 2 ** 23 - 1
        a = np.array([big * 2.0 ** -35], np.float32)
        b = np.array([small * 2.0 ** -35], np.float32)
        c = np.array([1.0 if case != "below_midpoint" else 1 + 2 ** -23],
                     np.float32)
        if case == "negative":
            a, c = -a, -c
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    want = np.array([_rn32(Fraction(float(x)) * Fraction(float(y))
                           + Fraction(float(z))) for x, y, z in zip(a, b, c)],
                    np.float32)
    np.testing.assert_array_equal(got, want)
    if case != "random":
        twice = (torch.from_numpy(a).double() * torch.from_numpy(b).double()
                 + torch.from_numpy(c).double()).float().numpy()
        assert not np.array_equal(twice, want)     # the case bites
    assert fma_f32(2.0, f32(float("inf")), f32(1.0)).item() == float("inf")
    assert torch.isnan(fma_f32(0.0, f32(float("inf")), f32(1.0))).all()



@pytest.mark.parametrize("step_ms,lookahead,two_pole", [
    (10.0, 3, True), (5.0, 3, True), (1.0, 20, False), (2.0, 25, True)])
def test_pole_bank_and_eta_bit_identical(step_ms, lookahead, two_pole):
    for emib in (False, True):
        a, b = tth.two_pole(T_FP, step_ms, emib), jth.two_pole(J_FP, step_ms,
                                                              emib)
        np.testing.assert_array_equal(a.decay, b.decay)
        np.testing.assert_array_equal(a.gain, b.gain)
    a, b = tth.single_pole(T_FP, step_ms), jth.single_pole(J_FP, step_ms)
    np.testing.assert_array_equal(a.decay, b.decay)
    kw = dict(step_ms=step_ms, lookahead_steps=lookahead, two_pole=two_pole)
    tp = TSched(TCfg(**kw), device="cpu").plant
    jp = JSched(JCfg(**kw)).plant
    np.testing.assert_array_equal(tp.poles.decay, jp.poles.decay)
    np.testing.assert_array_equal(tp.poles.gain, jp.poles.gain)
    assert tp.eta == jp.eta
    assert tp.gain_sum == jp.gain_sum


def test_thermal_step_and_steady_state_match_reference():
    rng = np.random.default_rng(1)
    poles = jth.two_pole(J_FP, 10.0)
    state = rng.uniform(0, 30, (6, 4, 2)).astype(np.float32)
    p = rng.uniform(10, 120, (6, 4)).astype(np.float32)
    np.testing.assert_allclose(
        np_(tth.step(tth.two_pole(T_FP, 10.0), torch.from_numpy(state),
                     torch.from_numpy(p))),
        np.asarray(jth.step(poles, state, p)), **TOL)
    np.testing.assert_allclose(np_(tth.delta_t(torch.from_numpy(state))),
                               np.asarray(jth.delta_t(state)), **TOL)
    assert float(tth.steady_state_dt(tth.two_pole(T_FP), 50.0)) == \
        pytest.approx(float(jth.steady_state_dt(poles, 50.0)), rel=1e-6)
    bank = tth.pole_bank(np.float32([0.4, 0.5]), np.float32([70.0, 90.0]))
    ref = jth.pole_bank(np.float32([0.4, 0.5]), np.float32([70.0, 90.0]))
    np.testing.assert_allclose(np_(bank.decay), np.asarray(ref.decay),
                               rtol=1e-6)


@pytest.mark.parametrize("ptr", [0, 5, 15])
def test_exact_stats_matches_reference(ptr):
    buf = np.random.default_rng(ptr).uniform(0.9, 2.7, (32, 16, 4)).astype(
        np.float32)
    for a, b in zip(tpg.exact_stats(torch.from_numpy(buf), ptr),
                    jax.jit(jpg.exact_stats)(buf, ptr)):
        np.testing.assert_allclose(np_(a), np.asarray(b), **TOL)


def test_refresh_equals_exact_recompute_bit_for_bit():
    """The port's own claim (the reference's fails on this tree): right
    after each wraparound the O(1) stats ARE `exact_stats` of the ring."""
    w = 16
    ft = tpg.init_filtration_stats(w, 4, fill=0.9, batch_shape=(8,))
    tr = torch.from_numpy(trace(3 * w + 5, 8, 4, seed=3))
    for t in range(tr.shape[0]):
        ft = tpg.observe(ft, tr[t])
        if int(ft.ptr) == 0:
            for a, b in zip((ft.wsum, ft.csum, ft.rsum),
                            tpg.exact_stats(ft.buf, 0)):
                assert torch.equal(a, b)
    # and stays within 1e-5 of the recompute in between
    for a, b in zip((ft.wsum, ft.csum, ft.rsum),
                    tpg.exact_stats(ft.buf, ft.ptr)):
        np.testing.assert_allclose(np_(a), np_(b), **TOL)


@pytest.mark.parametrize("impl", ["incremental", "ring"])
def test_filtration_predict_and_hint_match_reference(impl):
    tr = trace(37, 6, 4, seed=4)
    w, la, dt = 16, 30.0, 10.0
    g = np.array(JSched(JCfg(n_tiles=4)).gamma)
    init = {"incremental": (tpg.init_filtration_stats,
                            jpg.init_filtration_stats),
            "ring": (tpg.init_filtration, jpg.init_filtration)}[impl]
    tf = init[0](w, 4, fill=0.9, batch_shape=(6,))
    jf = init[1](w, 4, fill=0.9, batch_shape=(6,))
    j_obs = jax.jit(jpg.observe)
    for t in range(tr.shape[0]):
        tf = tpg.observe(tf, torch.from_numpy(tr[t]))
        jf = j_obs(jf, tr[t])
    np.testing.assert_allclose(np_(tpg.predict_rho(tf, la, dt)),
                               np.asarray(jpg.predict_rho(jf, la, dt)),
                               **TOL)
    np.testing.assert_allclose(
        np_(tpg.hint(tf, torch.from_numpy(g), la, dt)),
        np.asarray(jax.jit(lambda f: jpg.hint(f, g, la, dt))(jf)), **TOL)


@pytest.mark.parametrize("mode", ["v24", "reactive", "reactive_poll", "off"])
@pytest.mark.parametrize("n_tiles,impl", [(4, "incremental"), (1, "ring")])
def test_scheduler_update_matches_reference(mode, n_tiles, impl):
    """Step-by-step `update` (the broadcast engine's body) against the
    reference's jitted update: outputs and state every step."""
    n, steps = 6, 40
    jcfg = JCfg(n_tiles=n_tiles, mode=mode, filtration_impl=impl)
    tcfg = TCfg(n_tiles=n_tiles, mode=mode, filtration_impl=impl)
    js, ts = JSched(jcfg), TSched(tcfg, device="cpu")
    jst, tst = js.init(batch_shape=(n,)), ts.init(batch_shape=(n,))
    upd = jax.jit(js.update)
    tr = trace(steps, n, n_tiles, seed=5)
    for t in range(steps):
        jst, jo = upd(jst, tr[t])
        tst, to = ts.update(tst, torch.from_numpy(tr[t]))
        for f in ("freq", "temp_c", "hint_w", "balance"):
            np.testing.assert_allclose(np_(getattr(to, f)),
                                       np.asarray(getattr(jo, f)),
                                       err_msg=f"step {t} {f}", **TOL)
        assert float(to.eta) == float(jo.eta)
    assert_state_close(jax.device_get(jst), tst, f"{mode}/{impl}")


@pytest.mark.parametrize("kw,step", [
    (dict(heterogeneous=True), 5), (dict(degraded_fallback=True), 5),
    (dict(mixed_mode=True), 5), (dict(plant="grid", heterogeneous=True), 5),
    (dict(plant="rom", heterogeneous=True), 5)])
def test_unported_scheduler_features_raise(kw, step):
    """The per-package planes that ROADMAP queue 1 step ``step`` ported:
    each builds the reference's state leaves and steps ten steps to the
    reference's numbers; heterogeneous draws on a grid-family plant are the
    reference's ValueError."""
    if kw.get("plant") in ("grid", "rom"):
        with pytest.raises(ValueError, match="heterogeneous=True requires"):
            JSched(JCfg(**kw))
        with pytest.raises(ValueError, match="heterogeneous=True requires"):
            TSched(TCfg(**kw), device="cpu")
        return
    from repro_torch.convert import state_from_numpy
    cfg = dict(kw, n_tiles=3)
    js, ts = JSched(JCfg(**cfg)), TSched(TCfg(**cfg), device="cpu")
    jst = js.init((5,))
    tst = ts.init((5,))
    for f in ("pkg", "rho_last", "stale", "degraded", "ctrl_mode",
              "throttled"):
        assert (getattr(jst, f) is None) == (getattr(tst, f) is None), f
    tst = state_from_numpy(jax.device_get(jst), device="cpu")
    tr = trace(10, 5, 3, seed=step)
    upd = jax.jit(js.update)
    for t in range(10):
        jst, jo = upd(jst, tr[t])
        tst, to = ts.update(tst, torch.from_numpy(tr[t]))
    np.testing.assert_allclose(np_(to.freq), np.asarray(jo.freq), **TOL)
    assert_state_close(jax.device_get(jst), tst, str(kw))


def test_scheduler_rejects_unknown_options():
    with pytest.raises(ValueError, match="mode"):
        TSched(TCfg(mode="bogus"), device="cpu")
    with pytest.raises(ValueError, match="filtration_impl"):
        TSched(TCfg(filtration_impl="bogus"), device="cpu")


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("needs a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSched(TCfg())
