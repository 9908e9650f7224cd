"""PyTorch port, whole-trace thermal kernels: the plain versions of
`thermal_conv` and `grid_conv` against the JAX references (`kernels.ref`)
and the Pallas kernels in interpret mode on the CPU, the wrappers' CPU
dispatch and contracts, and `core.thermal`'s trace functions.  The CUDA
kernels are held against the plain versions in tests/test_torch_cuda.py."""
import ctypes
import re

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np

from torch_parity import TOL, np_

from repro.core import thermal as jthermal
from repro.core.coupling import coupling_matrix as j_coupling_matrix
from repro.core.fingerprint import FINGERPRINT as JFP
from repro.core.plant import GridPlant as JGrid
from repro.core.scheduler import SchedulerConfig as JCfg
from repro.kernels import ref as jref
from repro.kernels import thermal_conv as jtc

from repro_torch.core import thermal as tthermal
from repro_torch.core.fingerprint import FINGERPRINT as TFP
from repro_torch.core.plant import GridPlant as TGrid
from repro_torch.core.scheduler import SchedulerConfig as TCfg
from repro_torch.kernels import _build, ops
from repro_torch.kernels import thermal_conv as ttc

jax.config.update("jax_platform_name", "cpu")


def _conv_case(t, n, n_poles, seed=0, with_state=True):
    """The same numpy inputs for both packages: 80 + 40·U(0,1) W power,
    a row-normalised distance-banded Γ, a pole bank and a warm state."""
    rng = np.random.default_rng(seed)
    power = (80.0 + 40.0 * rng.uniform(size=(t, n))).astype(np.float32)
    g = np.asarray(j_coupling_matrix(n), np.float32)
    gamma = (g / g.sum(1, keepdims=True)).astype(np.float32)
    decay = np.sort(rng.uniform(0.6, 0.999, n_poles)).astype(np.float32)
    gain = rng.uniform(0.05, 0.3, n_poles).astype(np.float32)
    state0 = (rng.uniform(0.0, 20.0, (n, n_poles)).astype(np.float32)
              if with_state else None)
    return power, gamma, decay, gain, state0


def _t(x):
    return None if x is None else torch.from_numpy(x)


# (T, N, n_poles): ragged T and N (no divisibility, no 128-lane padding)
CONV_SHAPES = [(64, 8, 2), (37, 5, 3), (100, 47, 2), (23, 70, 1)]


@pytest.mark.parametrize("t,n,n_poles", CONV_SHAPES)
def test_thermal_conv_plain_matches_reference_and_pallas(t, n, n_poles):
    power, gamma, decay, gain, state0 = _conv_case(t, n, n_poles, seed=t)
    want_d, want_s = jref.thermal_conv_ref(
        jnp.asarray(power), jnp.asarray(gamma), jnp.asarray(decay),
        jnp.asarray(gain), jnp.asarray(state0))
    pal_d, pal_s = jtc.thermal_conv(
        jnp.asarray(power), jnp.asarray(gamma), jnp.asarray(decay),
        jnp.asarray(gain), jnp.asarray(state0), chunk=16, interpret=True)
    got_d, got_s = ttc.thermal_conv_reference(
        _t(power), _t(gamma), decay, gain, _t(state0))
    for want, pal, got, what in ((want_d, pal_d, got_d, "dts"),
                                 (want_s, pal_s, got_s, "state")):
        np.testing.assert_allclose(np_(got), np.asarray(want), err_msg=what,
                                   **TOL)
        np.testing.assert_allclose(np_(got), np.asarray(pal), err_msg=what,
                                   **TOL)


def test_thermal_conv_state_carry_and_zero_start():
    """Two chained halves equal one run bit for bit; state0=None is a
    zero start (the reference's default)."""
    power, gamma, decay, gain, _ = _conv_case(90, 12, 2, seed=4,
                                              with_state=False)
    p, g = _t(power), _t(gamma)
    full_d, full_s = ttc.thermal_conv(p, g, decay, gain)
    a_d, a_s = ttc.thermal_conv(p[:41].contiguous(), g, decay, gain)
    b_d, b_s = ttc.thermal_conv(p[41:].contiguous(), g, decay, gain, a_s)
    assert torch.equal(torch.cat([a_d, b_d]), full_d)
    assert torch.equal(b_s, full_s)
    want_d, _ = jref.thermal_conv_ref(jnp.asarray(power), jnp.asarray(gamma),
                                      jnp.asarray(decay), jnp.asarray(gain))
    np.testing.assert_allclose(np_(full_d), np.asarray(want_d), **TOL)


def test_thermal_conv_on_cpu_is_the_plain_version_and_launches_nothing():
    power, gamma, decay, gain, state0 = _conv_case(30, 6, 2, seed=2)
    before = ttc.thermal_conv.launches
    got = ttc.thermal_conv(_t(power), _t(gamma), decay, gain, _t(state0))
    plain = ttc.thermal_conv_reference(_t(power), _t(gamma), decay, gain,
                                       _t(state0))
    via_ops = ops.thermal_conv(power, gamma, torch.from_numpy(decay),
                               torch.from_numpy(gain), _t(state0))
    assert ttc.thermal_conv.launches == before
    for a, b, c in zip(got, plain, via_ops):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_thermal_conv_matches_simulate_and_direct_convolution():
    """The kernel's plain version == `thermal.simulate` (same op order) ==
    the reference's simulate; the recurrence == the O(T²) convolution."""
    power, gamma, _, _, _ = _conv_case(120, 8, 2, seed=6, with_state=False)
    poles = tthermal.two_pole()
    dts, st = ttc.thermal_conv_reference(_t(power), _t(gamma), poles.decay,
                                         poles.gain)
    sim_d, sim_s = tthermal.simulate(poles, _t(power), gamma=_t(gamma))
    assert torch.equal(dts, sim_d) and torch.equal(st, sim_s)
    ref_d, ref_s = jthermal.simulate(jthermal.two_pole(), jnp.asarray(power),
                                     gamma=jnp.asarray(gamma))
    np.testing.assert_allclose(np_(sim_d), np.asarray(ref_d), **TOL)
    np.testing.assert_allclose(np_(sim_s), np.asarray(ref_s), **TOL)
    direct = tthermal.direct_convolution(poles, _t(power[:, :3]))
    scan, _ = tthermal.simulate(poles, _t(power[:, :3]))
    np.testing.assert_allclose(np_(direct), np_(scan), rtol=1e-4, atol=1e-3)
    jdirect = jthermal.direct_convolution(jthermal.two_pole(),
                                          jnp.asarray(power[:, :3]))
    np.testing.assert_allclose(np_(direct), np.asarray(jdirect), rtol=1e-5,
                               atol=1e-4)


def test_step_response_reaches_63_percent_at_tau():
    poles = tthermal.single_pole(TFP, 1.0)
    y = tthermal.step_response(poles, 400)
    want = jthermal.step_response(jthermal.single_pole(JFP, 1.0), 400)
    np.testing.assert_allclose(np_(y), np.asarray(want), **TOL)
    tau = int(TFP.tau_ms)
    assert abs(float(y[tau - 1]) / TFP.rth_c_per_w - (1 - np.exp(-1))) < 0.01


def test_thermal_conv_wrapper_validates_inputs():
    power, gamma, decay, gain, state0 = _conv_case(10, 4, 2)
    p, g, s = _t(power), _t(gamma), _t(state0)
    with pytest.raises(ValueError, match="gamma must be"):
        ttc.thermal_conv(p, g[:3], decay, gain)
    with pytest.raises(ValueError, match="state0 must be"):
        ttc.thermal_conv(p, g, decay, gain, s[:, :1])
    # other dtypes, layouts and numpy arrays are made contiguous f32 first
    want = ttc.thermal_conv(p, g, decay, gain, s)
    for got in (ttc.thermal_conv(p.double(), g, decay, gain, s),
                ttc.thermal_conv(p.T.contiguous().T, g.T.contiguous().T,
                                 decay, gain, s),
                ttc.thermal_conv(power, gamma, decay, gain, state0)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="empty"):
        ttc.thermal_conv(p[:0], g, decay, gain)
    with pytest.raises(ValueError, match="up to 2048 tiles"):
        ttc.thermal_conv(torch.ones((2, 2049)), torch.ones((2049, 2049)),
                         decay, gain)
    with pytest.raises(ValueError, match="poles"):
        ttc.thermal_conv(p, g, np.ones(9, np.float32),
                         np.ones(9, np.float32))
    with pytest.raises(ValueError, match="n_poles"):
        ttc.thermal_conv(p, g, decay, gain[:1])


def test_thermal_conv_cost_counts_dense_and_nonzero_gamma():
    power, gamma, _, _, _ = _conv_case(10, 47, 2)
    c = ttc.thermal_conv_cost(_t(power), _t(gamma), 2)
    nnz = int((gamma != 0).sum())
    assert c["bytes"] == 4 * (2 * 10 * 47 + 47 * 47 + 2 * 47 * 2)
    assert c["ops_dense"] - c["ops_nnz"] == 2 * (47 * 47 - nnz) * 10
    assert nnz < 47 * 47


# -------------------------------------------------------------- grid_conv
def _grid(nt, substeps=1, contrast=0.5, cells=8):
    kw = dict(n_tiles=nt, plant="grid", grid_substeps=substeps,
              grid_contrast=contrast, grid_cells=cells)
    return JGrid(JCfg(**kw), JFP), TGrid(TCfg(**kw), TFP, device="cpu")


def _ref_inject_readout(g):
    """The reference's fan-out and readout, as `GridPlant.simulate` builds
    them."""
    inject = np.zeros((g.n_tiles, g.W), np.float32)
    readout = np.zeros((g.W, g.n_tiles), np.float32)
    for t in range(g.n_tiles):
        inject[t, t * g.gx:(t + 1) * g.gx] = g.rth
        readout[t * g.gx:(t + 1) * g.gx, t] = 1.0 / (g.gy * g.gx)
    return inject, readout


@pytest.mark.parametrize("nt,substeps,contrast", [(1, 1, 0.5), (2, 2, 0.5),
                                                  (3, 1, 0.0)])
def test_grid_operators_reproduce_the_reference(nt, substeps, contrast):
    jg, tg = _grid(nt, substeps, contrast)
    inject, readout = _ref_inject_readout(jg)
    ops_ = ttc.grid_operators(tg.gy, tg.gx, nt, tg.rth)
    for name, want in (("adj_h", jg.adj_h), ("adj_v", jg.adj_v),
                       ("deg", jg.deg), ("inject", inject),
                       ("readout", readout)):
        assert ops_[name].dtype == np.float32, name
        np.testing.assert_array_equal(ops_[name], want, err_msg=name)


@pytest.mark.parametrize("nt,substeps,contrast", [(2, 1, 0.5), (3, 2, 0.5),
                                                  (1, 1, 0.0)])
def test_grid_conv_plain_matches_reference_pallas_and_scan(nt, substeps,
                                                           contrast):
    jg, tg = _grid(nt, substeps, contrast)
    rng = np.random.default_rng(nt + substeps)
    power = (80.0 + 40.0 * rng.uniform(size=(48, nt))).astype(np.float32)
    state0 = rng.uniform(0.0, 10.0, (tg.gy, tg.W)).astype(np.float32)
    inject, readout = _ref_inject_readout(jg)
    kw = dict(r=float(jg.r), kappa=float(jg.kappa), substeps=jg.substeps)
    want_d, want_s = jref.grid_conv_ref(
        jnp.asarray(power), jg.adj_h, jg.adj_v, jg.deg, jg.ghat, inject,
        readout, jnp.asarray(state0), **kw)
    pal_d, pal_s = jtc.grid_conv(
        jnp.asarray(power), jg.adj_h, jg.adj_v, jg.deg, jg.ghat, inject,
        readout, jnp.asarray(state0), chunk=16, interpret=True, **kw)
    got_d, got_s = ttc.grid_conv_reference(
        _t(power), jg.adj_h, jg.adj_v, jg.deg, jg.ghat, inject, readout,
        _t(state0), **kw)
    for want, pal, got, what in ((want_d, pal_d, got_d, "dts"),
                                 (want_s, pal_s, got_s, "state")):
        np.testing.assert_allclose(np_(got), np.asarray(want), err_msg=what,
                                   **TOL)
        np.testing.assert_allclose(np_(got), np.asarray(pal), err_msg=what,
                                   **TOL)
    # the wrapper (CPU → plain version over its own operators) and the
    # plant's whole-trace path agree with the plain version exactly
    via_plant = tg.simulate(_t(power), _t(state0))
    for a, b in zip(via_plant, (got_d, got_s)):
        assert torch.equal(a, b)
    # ... and with the scanned per-step plant
    st, dts = _t(state0), []
    for p in _t(power):
        st = tg.step(st, p)
        dts.append(tg.delta_t(st))
    np.testing.assert_allclose(np_(torch.stack(dts)), np_(got_d), **TOL)
    np.testing.assert_allclose(np_(st), np_(got_s), **TOL)


@pytest.mark.parametrize("cells", [2, 3, 6, 16])
def test_grid_conv_every_patch_edge_matches_reference(cells):
    """Patch edges other than the default 8 (the CUDA kernel compiles one
    variant per edge, 2..16): the port's plant trace on the CPU against the
    reference's `grid_conv_ref` on the reference plant's operators."""
    jg, tg = _grid(5, 1, 0.5, cells=cells)
    rng = np.random.default_rng(cells)
    power = (80.0 + 40.0 * rng.uniform(size=(40, 5))).astype(np.float32)
    state0 = rng.uniform(0.0, 10.0, (tg.gy, tg.W)).astype(np.float32)
    inject, readout = _ref_inject_readout(jg)
    want = jref.grid_conv_ref(
        jnp.asarray(power), jg.adj_h, jg.adj_v, jg.deg, jg.ghat, inject,
        readout, jnp.asarray(state0), r=float(jg.r), kappa=float(jg.kappa),
        substeps=jg.substeps)
    got = tg.simulate(_t(power), _t(state0))
    for a, b, what in zip(got, want, ("dts", "state")):
        np.testing.assert_allclose(np_(a), np.asarray(b), err_msg=what,
                                   **TOL)


def test_grid_conv_wrapper_validates_inputs():
    _, tg = _grid(2)
    p = torch.full((8, 2), 100.0)
    z = torch.zeros((tg.gy, tg.W))
    kw = dict(gy=tg.gy, gx=tg.gx, rth=0.45, r=0.1, kappa=0.35)
    before = ttc.grid_conv.launches
    ttc.grid_conv(p, tg._ghat, tg._deg, z, **kw)
    assert ttc.grid_conv.launches == before
    with pytest.raises(ValueError, match="ghat must be"):
        ttc.grid_conv(p, tg._ghat[:, :-1], tg._deg, z, **kw)
    with pytest.raises(ValueError, match="substeps"):
        ttc.grid_conv(p, tg._ghat, tg._deg, z, substeps=0, **kw)
    with pytest.raises(ValueError, match="square tile patches"):
        ttc.grid_conv(torch.full((8, 1), 1.0), torch.zeros((17, 17)),
                      torch.zeros((17, 17)), torch.zeros((17, 17)),
                      gy=17, gx=17, rth=0.45, r=0.1, kappa=0.35)
    with pytest.raises(ValueError, match="square tile patches"):
        ttc.grid_conv(torch.full((8, 1), 1.0), torch.zeros((4, 8)),
                      torch.zeros((4, 8)), torch.zeros((4, 8)),
                      gy=4, gx=8, rth=0.45, r=0.1, kappa=0.35)
    with pytest.raises(TypeError, match="float32"):
        ttc.grid_conv(p.double(), tg._ghat, tg._deg, z, **kw)


@pytest.mark.parametrize("src,struct,cls", [
    ("thermal_conv.cu", "ThermalConvConsts", ttc._ConvConsts),
    ("grid_conv.cu", "GridConvConsts", ttc._GridConsts)])
def test_consts_structs_mirror_cuda_sources(src, struct, cls):
    """Each ctypes struct lists the fields of its `struct` in the .cu file
    in the same order (all 4-byte, no padding)."""
    text = (_build.CSRC / src).read_text()
    body = re.search(rf"struct {struct} \{{(.*?)\}};", text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            names += [re.sub(r"\[.*\]", "", x).strip()
                      for x in decl.split(None, 1)[1].split(",")]
    assert names == [f for f, _ in cls._fields_]
    n_fields = sum(getattr(ty, "_length_", 1) for _, ty in cls._fields_)
    assert ctypes.sizeof(cls) == 4 * n_fields
