"""PyTorch port, the two shortcuts of the `fleet_step` CUDA kernel, restated
in PyTorch on the CPU and held to what they must equal.

  * The Γ walk: ``csrc/fleet_step.cu`` multiplies by Γ's non-zeros only, in
    ascending column order, one f32 FMA each (`repro_torch.fma_f32`), and a
    package whose exchange plane holds a non-finite value takes the dense
    walk for that step.  For finite powers a skipped zero entry adds an
    exact 0, so the walk equals `core.coupling.apply_coupling`'s dense
    j = 0 … n−1 order bit for bit; the reference's `apply_coupling` (an
    einsum) is matched within TOL.
  * One pow per (package, tile, step): clip(pow_f32(law_base(a, b))) for
    the plain version's min(clip(pow_f32(a)), clip(pow_f32(b))).

The kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py)."""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np

from torch_parity import TOL

from repro.core.coupling import apply_coupling as j_apply_coupling
from repro.core.scheduler import SchedulerConfig as JCfg
from repro.core.scheduler import ThermalScheduler as JSched

from repro_torch import fma_f32, pow_f32
from repro_torch.core.coupling import apply_coupling
from repro_torch.core.scheduler import SchedulerConfig, ThermalScheduler
from repro_torch.kernels.fleet_step import _consts
from repro_torch.fleet.backends.fused import FusedBackend

jax.config.update("jax_platform_name", "cpu")

INF = float("inf")


def _gamma(n_tiles):
    """(the port's Γ as the fused backend passes it, the reference's)."""
    t = ThermalScheduler(SchedulerConfig(n_tiles=n_tiles), device="cpu").gamma
    j = np.asarray(JSched(JCfg(n_tiles=n_tiles)).gamma, np.float32)
    return t, j


def kernel_walk(gamma: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Γ·x as the kernel walks it: x [packages, tiles] → [packages, tiles].

    Row i accumulates fma(Γ[i, j], x[:, j], ·) over the j with Γ[i, j] != 0
    in ascending order (a NaN entry counts as non-zero, as in the kernel's
    ballot); a package with a non-finite x takes the dense walk."""
    out = torch.empty_like(x)
    for i in range(gamma.shape[0]):
        acc = torch.zeros_like(x[:, 0])
        for j in torch.nonzero(gamma[i] != 0).flatten().tolist():
            acc = fma_f32(gamma[i, j], x[:, j], acc)
        out[:, i] = acc
    bad = ~torch.isfinite(x).all(dim=1)
    out[bad] = apply_coupling(gamma, x[bad])
    return out


def law_base(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's `law_base`: the lower of the law's two bases (NaN
    propagating), except that a −inf yields to the other base — pow(−inf,
    e) = +inf for the law's exponent, while a finite negative base gives
    NaN."""
    lo = torch.minimum(a, b)
    return torch.where(lo == -INF, torch.maximum(a, b), lo)


def _powers(n_pkgs, n_tiles, seed):
    """Package powers over six decades (W), as numpy f32."""
    rng = np.random.default_rng(seed)
    return (10.0 ** rng.uniform(-3.0, 3.0, (n_pkgs, n_tiles))
            ).astype(np.float32)


@pytest.mark.parametrize("n_tiles", [4, 47])
def test_sparse_walk_equals_dense_fma_order_bit_for_bit(n_tiles):
    gamma, j_gamma = _gamma(n_tiles)
    if n_tiles == 47:
        assert int((gamma != 0).sum()) == 811     # the paper's sparsity
    x = _powers(96, n_tiles, seed=n_tiles)
    walked = kernel_walk(gamma, torch.from_numpy(x))
    assert torch.equal(walked, apply_coupling(gamma, torch.from_numpy(x)))
    np.testing.assert_allclose(
        walked.numpy(), np.asarray(j_apply_coupling(jnp.asarray(j_gamma),
                                                    jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("bad", [float("nan"), INF, -INF])
def test_walk_with_dense_fallback_is_non_finite_where_dense_is(bad):
    """One tile's power non-finite in some packages: the dense product's
    0·inf / 0·NaN terms reach rows Γ does not couple to that tile; the
    walk's fallback gives the dense result exactly, NaN for NaN."""
    gamma, _ = _gamma(47)
    x = torch.from_numpy(_powers(64, 47, seed=5))
    x[3, 20] = bad
    x[17, 0] = bad
    x[40, 46] = -bad
    dense = apply_coupling(gamma, x)
    walked = kernel_walk(gamma, x)
    torch.testing.assert_close(walked, dense, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(torch.isnan(walked), torch.isnan(dense))
    # without the fallback the sparse walk would keep those rows finite
    assert bool(torch.isnan(dense[3]).any())
    assert (gamma[:, 20] == 0).any()


# the law's base pairs (a, b): b is always ≥ 0 or NaN in the kernel, a may
# be anything; each family is symmetric under a ↔ b below
_TINY = float(np.finfo(np.float32).tiny)
_LO = 0.05 ** 3                               # pow → the clip floor 0.05
_PAIRS = {
    "adjacent floats": [(x, float(np.nextafter(np.float32(x), np.float32(2))))
                        for x in (1e-4, _LO, 0.3, 0.999, 1.0, 7.5)],
    "equal bases": [(x, x) for x in (0.0, _LO, 0.2, 1.0, 3.0, INF)],
    "negatives": [(-1.0, 0.5), (-1e-30, 2.0), (-5.0, -2.0), (-0.0, 0.3),
                  (-1.0, float("nan"))],
    "NaN": [(float("nan"), 0.5), (float("nan"), float("nan")),
            (0.7, float("nan"))],
    "clip edges": [(_LO, 1.0), (float(np.nextafter(np.float32(_LO),
                                                   np.float32(0))), _LO),
                   (1.0, float(np.nextafter(np.float32(1.0),
                                            np.float32(2)))),
                   (0.0, 1.0), (_TINY, 8.0), (0.9, 1.1)],
    "infinities": [(-INF, 0.5), (-INF, 2.0), (-INF, float("nan")),
                   (-INF, -3.0), (-INF, -INF), (INF, 0.2), (INF, -INF)],
}


@pytest.mark.parametrize("family", sorted(_PAIRS))
def test_one_pow_of_the_law_base_equals_two_pows(family):
    e = _consts(FusedBackend(ThermalScheduler(
        SchedulerConfig(n_tiles=4), device="cpu")).params)["inv_exp"]
    pairs = _PAIRS[family] + [(b, a) for a, b in _PAIRS[family]]
    a = torch.tensor([p[0] for p in pairs], dtype=torch.float32)
    b = torch.tensor([p[1] for p in pairs], dtype=torch.float32)
    clip = lambda x: torch.clamp(x, 0.05, 1.0)
    two = torch.minimum(clip(pow_f32(a, e)), clip(pow_f32(b, e)))
    one = clip(pow_f32(law_base(a, b), e))
    torch.testing.assert_close(one, two, rtol=0, atol=0, equal_nan=True)


def test_law_base_is_needed_for_minus_infinity():
    """pow(−inf, e) = +inf for the law's exponent, above any finite base's
    pow: the plain lower base alone would turn min(1, f) into 1."""
    e = 1.0 / 3.0
    a, b = torch.tensor([-INF]), torch.tensor([0.001])
    clip = lambda x: torch.clamp(x, 0.05, 1.0)
    two = torch.minimum(clip(pow_f32(a, e)), clip(pow_f32(b, e)))
    assert float(clip(pow_f32(torch.minimum(a, b), e))) == 1.0 != float(two)
    assert float(clip(pow_f32(law_base(a, b), e))) == float(two)
