"""PyTorch port, the Γ walk of the `thermal_conv` CUDA kernel, restated in
PyTorch on the CPU and held to what it must equal.

``csrc/thermal_conv.cu`` gives each block a run of adjacent tiles
(`conv_tiles_per_block`), walks the union of their Γ rows' non-zero
columns in ascending order, one f32 FMA per column for every row of the
block (a NaN entry counts as non-zero), and leaves the rest of the dense
product to one rule: a row whose Γ is zero at a column holding a
non-finite power gets NaN from that step on — the kernel's last block
writes that NaN for every block with a non-finite power outside its union.
For finite power a skipped zero adds an exact 0, so the walk equals
`core.coupling.apply_coupling`'s dense j = 0 … N−1 order bit for bit; with
non-finite power the trace has NaN and ±inf where the plain version has
them.  Both are held here, and through the pole recurrence to the plain
`thermal_conv_reference` (bit for bit) and to the reference's
`kernels.ref.thermal_conv_ref` and Pallas kernel (interpret mode) within
TOL.  The kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py Phase D)."""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np

from torch_parity import TOL, np_

from repro.core.coupling import coupling_matrix as j_coupling_matrix
from repro.kernels import ref as jref
from repro.kernels import thermal_conv as jtc

from repro_torch import fma_f32
from repro_torch.core.coupling import apply_coupling
from repro_torch.kernels import thermal_conv as ttc

jax.config.update("jax_platform_name", "cpu")

INF, NAN = float("inf"), float("nan")


def _blocks(n, tb):
    return [(i0, min(i0 + tb, n)) for i0 in range(0, n, tb)]


def kernel_walk(gamma: torch.Tensor, power: torch.Tensor,
                tb: int) -> torch.Tensor:
    """p_eff [T, N] as the kernel's blocks of ``tb`` tiles walk Γ: for each
    block, fma over the union of its rows' non-zero columns, ascending,
    from +0 (no step is told about columns outside the union)."""
    out = torch.empty_like(power)
    for i0, i1 in _blocks(gamma.shape[0], tb):
        rows = gamma[i0:i1]
        union = torch.nonzero((rows != 0).any(0)).flatten().tolist()
        acc = torch.zeros((power.shape[0], i1 - i0))
        for j in union:
            acc = fma_f32(rows[:, j], power[:, j:j + 1], acc)
        out[:, i0:i1] = acc
    return out


def first_outside(gamma: torch.Tensor, power: torch.Tensor,
                  tb: int) -> list[int]:
    """Per block, the first step with a non-finite power in a column
    outside its union (T if none): the step the kernel's last block
    writes NaN from."""
    bad = ~torch.isfinite(power)
    hits = []
    for i0, i1 in _blocks(gamma.shape[0], tb):
        outside = ~(gamma[i0:i1] != 0).any(0)
        steps = torch.nonzero((bad & outside).any(1)).flatten()
        hits.append(int(steps[0]) if len(steps) else power.shape[0])
    return hits


def kernel_conv(power, gamma, decay, gain, state0, tb):
    """The kernel's whole trace, restated: the walk, the pole recurrence in
    the plain version's op order, then NaN from each block's first step
    with a non-finite power outside its union."""
    a, coef = ttc._pole_consts(decay, gain)
    a_t, coef_t = torch.from_numpy(a), torch.from_numpy(coef)
    p_eff = kernel_walk(gamma, power, tb)
    state = state0.clone()
    dts = torch.empty_like(power)
    for s in range(power.shape[0]):
        state = a_t * state + coef_t * p_eff[s][:, None]
        dt = state[:, 0]
        for k in range(1, a.shape[0]):
            dt = dt + state[:, k]
        dts[s] = dt
    for (i0, i1), h in zip(_blocks(gamma.shape[0], tb),
                           first_outside(gamma, power, tb)):
        dts[h:, i0:i1] = NAN
        if h < power.shape[0]:
            state[i0:i1] = NAN
    return dts, state


def _gamma(kind: str, rng) -> np.ndarray:
    """Γ cases: row-normalised distance bands at 512 tiles (the main path)
    and at the 47-tile Ponte-Vecchio grid, a dense random Γ at 100 tiles,
    and a banded Γ with one NaN entry."""
    if kind == "dense100":
        g = rng.uniform(0.0, 1.0, (100, 100))
    elif kind == "pv47":
        g = np.asarray(j_coupling_matrix(47, cols=7), np.float64)
    else:
        g = np.asarray(j_coupling_matrix(512 if kind == "banded512" else 64),
                       np.float64)
    g = (g / g.sum(1, keepdims=True)).astype(np.float32)
    if kind == "nan_entry":
        g[5, 40] = np.nan
    return g


def _power(t, n, rng, spans=()) -> np.ndarray:
    """80 + 40·U(0,1) W, with (t0, t1, column, value) spans written in."""
    p = (80.0 + 40.0 * rng.uniform(size=(t, n))).astype(np.float32)
    for t0, t1, j, v in spans:
        p[t0:t1, j] = v
    return p


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-equal, NaN equal to NaN."""
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a, nan=0.0),
                            torch.nan_to_num(b, nan=0.0)))


def _against_reference(got, want):
    """Equal NaN and ±inf positions, finite values within TOL."""
    got, want = np_(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)


GAMMAS = ["banded512", "pv47", "dense100", "nan_entry"]


@pytest.mark.parametrize("kind", GAMMAS)
def test_walk_equals_dense_fma_order_bit_for_bit(kind):
    rng = np.random.default_rng(len(kind))
    g = torch.from_numpy(_gamma(kind, rng))
    n = g.shape[0]
    p = torch.from_numpy(_power(24, n, rng))
    dense = apply_coupling(g, p)
    tb = ttc.conv_tiles_per_block(n)
    for blk in sorted({1, tb, 16}):
        assert _same(kernel_walk(g, p, blk), dense), blk
    if kind == "banded512":
        # the main path's sparsity: ~22.5 non-zeros a row, 4 tiles a block
        assert int((g != 0).sum()) == 11540 and tb == 4
    if kind == "nan_entry":
        assert bool(torch.isnan(dense[:, 5]).all())
        assert not bool(torch.isnan(dense[:, 6]).any())


SPANS = {
    "nan": [(9, 13, 40, NAN)],
    "+inf": [(5, 6, 3, INF), (17, 19, 30, INF)],
    "-inf": [(2, 4, 11, -INF)],
    "mixed": [(7, 8, 20, INF), (7, 9, 21, -INF), (15, 16, 0, NAN)],
}


@pytest.mark.parametrize("kind", ["pv47", "dense100", "banded64"])
@pytest.mark.parametrize("span", sorted(SPANS))
def test_walk_with_outside_rule_equals_dense_on_non_finite_power(kind, span):
    """Each step's p_eff: the walk, with NaN for the rows of a block whose
    union misses a column holding a non-finite power at that step — the
    dense product's 0·inf and 0·NaN, which the sparse walk alone skips."""
    rng = np.random.default_rng(7)
    g = torch.from_numpy(_gamma(kind, rng))
    n = g.shape[0]
    p = torch.from_numpy(_power(24, n, rng,
                                [(a, b, j % n, v) for a, b, j, v in SPANS[span]]))
    dense = apply_coupling(g, p)
    for tb in (1, 4, 16):
        walk = kernel_walk(g, p, tb)
        bad = ~torch.isfinite(p)
        for i0, i1 in _blocks(n, tb):
            outside = ~(g[i0:i1] != 0).any(0)
            hit = (bad & outside).any(1)
            walk[hit, i0:i1] = NAN
        assert _same(walk, dense), tb
    if kind == "banded64":    # some rows miss the bad column: the rule bites
        assert not _same(kernel_walk(g, p, 4), dense)


@pytest.mark.parametrize("kind,spans", [
    ("banded512", ()), ("pv47", ()), ("dense100", ()), ("nan_entry", ()),
    ("pv47", SPANS["nan"]), ("banded64", SPANS["+inf"]),
    ("banded64", SPANS["-inf"]), ("dense100", SPANS["mixed"]),
])
def test_kernel_trace_equals_plain_version_and_reference(kind, spans):
    """The restated kernel through the pole recurrence: bit-equal to the
    port's plain `thermal_conv_reference` (NaN for NaN), and to the
    reference's `thermal_conv_ref` and Pallas kernel in interpret mode with
    NaN / ±inf at the same places, finite values within TOL."""
    rng = np.random.default_rng(11)
    g = _gamma(kind, rng)
    n = g.shape[0]
    t = 32 if n == 512 else 40
    p = _power(t, n, rng, [(a, b, j % n, v) for a, b, j, v in spans])
    decay = np.array([0.9, 0.995], np.float32)
    gain = np.array([0.2, 0.1], np.float32)
    s0 = rng.uniform(0.0, 20.0, (n, 2)).astype(np.float32)
    tp, tg, ts = torch.from_numpy(p), torch.from_numpy(g), torch.from_numpy(s0)
    plain = ttc.thermal_conv_reference(tp, tg, decay, gain, ts)
    got = kernel_conv(tp, tg, decay, gain, ts, ttc.conv_tiles_per_block(n))
    for a, b in zip(got, plain):
        assert _same(a, b)
    want = jref.thermal_conv_ref(jnp.asarray(p), jnp.asarray(g),
                                 jnp.asarray(decay), jnp.asarray(gain),
                                 jnp.asarray(s0))
    pal = jtc.thermal_conv(jnp.asarray(p), jnp.asarray(g), jnp.asarray(decay),
                           jnp.asarray(gain), jnp.asarray(s0), chunk=8,
                           interpret=True)
    for a, w, q in zip(got, want, pal):
        _against_reference(a, w)
        _against_reference(a, q)


@pytest.mark.parametrize("span", sorted(SPANS))
def test_plain_version_has_the_reference_non_finite_positions(span):
    """The port's plain `thermal_conv_reference` — the card tests' target —
    against the reference's `thermal_conv_ref` on non-finite power: NaN
    and ±inf at the same positions of the trace and the final state."""
    rng = np.random.default_rng(3)
    g = _gamma("banded64", rng)
    p = _power(30, 64, rng, SPANS[span])
    decay = np.array([0.8, 0.99, 0.999], np.float32)
    gain = np.array([0.3, 0.2, 0.05], np.float32)
    got = ttc.thermal_conv_reference(torch.from_numpy(p), torch.from_numpy(g),
                                      decay, gain)
    want = jref.thermal_conv_ref(jnp.asarray(p), jnp.asarray(g),
                                 jnp.asarray(decay), jnp.asarray(gain))
    for a, w in zip(got, want):
        _against_reference(a, w)
    assert bool(torch.isnan(got[0]).any())


@pytest.mark.parametrize("n,want", [(1, 1), (47, 1), (132, 1), (133, 2),
                                    (512, 4), (1000, 8), (2048, 16)])
def test_tiles_per_block_fills_the_card_in_one_wave(n, want):
    tb = ttc.conv_tiles_per_block(n)
    assert tb == want
    assert -(-n // tb) <= 132
    assert tb == 1 or -(-n // (tb // 2)) > 132      # the fewest that fit
    assert ttc.conv_tiles_per_block(4096) == 16     # past one wave
