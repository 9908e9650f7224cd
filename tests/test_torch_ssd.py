"""PyTorch port: the plain chunked SSD (`repro_torch.kernels.ssm_scan`)
against the JAX package's Pallas kernel in interpret mode, on the reference
test's sweep (tests/test_kernels.py) with its bound (atol 3e-5), plus the
options the kernel's contract carries (``u``, ``include_current``, ``h0``),
the chunk rule, the sequential oracle and the decode step.  Inputs are
drawn with numpy from a seed and handed to both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.ssm_scan import ssd as pallas_ssd

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssm_scan import chunk_for, ssd, ssd_cost, ssd_reference

ATOL = 3e-5


def _inputs(B, T, H, N, P, dec_min, seed=0):
    rng = np.random.default_rng(seed)
    d = (dec_min + (0.999 - dec_min) * rng.uniform(size=(B, T, H, N))
         ).astype(np.float32)
    b = (0.2 * rng.standard_normal((B, T, H, N))).astype(np.float32)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    c = (0.2 * rng.standard_normal((B, T, H, N))).astype(np.float32)
    return d, b, x, c


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("B,T,H,N,P,dec_min,inc,use_u,use_h0", [
    (2, 128, 2, 64, 64, 0.90, True, False, False),    # mamba2 regime
    (1, 256, 4, 32, 64, 0.80, False, True, False),    # rwkv regime (u)
    (2, 128, 2, 16, 32, 0.95, False, True, True),
    (1, 64, 2, 64, 128, 0.70, True, False, True),     # strong decay corner
    (1, 96, 2, 16, 64, 0.90, True, False, False),     # chunk halves to 32
])
def test_plain_ssd_matches_pallas_kernel(B, T, H, N, P, dec_min, inc, use_u,
                                         use_h0):
    d, b, x, c = _inputs(B, T, H, N, P, dec_min)
    rng = np.random.default_rng(1)
    u = (0.1 * rng.standard_normal((H, N))).astype(np.float32) if use_u \
        else None
    h0 = rng.standard_normal((B, H, N, P)).astype(np.float32) if use_h0 \
        else None
    y1, h1 = pallas_ssd(*_j(d, b, x, c), u=_j(u)[0], h0=_j(h0)[0], chunk=64,
                        include_current=inc, interpret=True)
    before = ssd.launches
    y2, h2 = ssd(*_t(d, b, x, c), u=_t(u)[0], h0=_t(h0)[0], chunk=64,
                 include_current=inc)
    assert ssd.launches == before                 # no kernel on the CPU
    np.testing.assert_allclose(y2.numpy(), np.asarray(y1), atol=ATOL)
    np.testing.assert_allclose(h2.numpy(), np.asarray(h1), atol=ATOL)


def test_mixed_dtypes_as_mamba2_passes_them():
    """f32 d and b with bf16 c and x (Mamba2 at bf16): y in x's dtype, the
    state in f32, the same values as the reference's chunked form."""
    d, b, x, c = _inputs(1, 128, 3, 16, 32, 0.9, seed=4)
    jd, jb, jx, jc = _j(d, b, x, c)
    y1, h1 = jref.chunked_ssd(jd, jb, jx.astype(jnp.bfloat16),
                              jc.astype(jnp.bfloat16), chunk=64)
    td, tb, tx, tc = _t(d, b, x, c)
    y2, h2 = ssd(td, tb, tx.to(torch.bfloat16), tc.to(torch.bfloat16))
    assert y2.dtype == torch.bfloat16 and h2.dtype == torch.float32
    np.testing.assert_allclose(y2.float().numpy(),
                               np.asarray(y1, np.float32), atol=2e-2)
    np.testing.assert_allclose(h2.numpy(), np.asarray(h1), atol=ATOL)


def test_chained_halves_equal_one_run():
    d, b, x, c = _t(*_inputs(2, 256, 2, 32, 32, 0.85, seed=2))
    y, h = ssd(d, b, x, c)
    ya, ha = ssd(d[:, :128].contiguous(), b[:, :128].contiguous(),
                 x[:, :128].contiguous(), c[:, :128].contiguous())
    yb, hb = ssd(d[:, 128:].contiguous(), b[:, 128:].contiguous(),
                 x[:, 128:].contiguous(), c[:, 128:].contiguous(), h0=ha)
    np.testing.assert_allclose(torch.cat([ya, yb], 1).numpy(), y.numpy(),
                               atol=ATOL)
    np.testing.assert_allclose(hb.numpy(), h.numpy(), atol=ATOL)


def test_chunked_matches_sequential_scan():
    """The plain chunked form == the O(T) sequential recurrence (the
    reference's oracle of oracles, ported)."""
    d, b, x, c = _t(*_inputs(1, 64, 2, 16, 16, 0.85))
    y1, h1 = ssd_reference(d, b, x, c, chunk=16)
    hs, hT = tref.linear_scan_ref(d[..., None],
                                  b[..., :, None] * x[..., None, :])
    y_seq = torch.einsum("bthn,bthnp->bthp", c, hs)
    np.testing.assert_allclose(y1.numpy(), y_seq.numpy(), atol=1e-5)
    np.testing.assert_allclose(h1.numpy(), hT.numpy(), atol=1e-5)
    jd, jb = _j(*_inputs(1, 64, 2, 16, 16, 0.85)[:2])
    _, jhT = jref.linear_scan_ref(jd[..., None], jb[..., None])
    _, thT = tref.linear_scan_ref(d[..., None], b[..., None])
    np.testing.assert_allclose(thT.numpy(), np.asarray(jhT), atol=1e-6)


@pytest.mark.parametrize("inc,use_u", [(True, False), (False, True)])
def test_decode_step_matches_reference_and_chunked_form(inc, use_u):
    d, b, x, c = _inputs(1, 32, 2, 16, 16, 0.9, seed=6)
    u = (0.1 * np.random.default_rng(7).standard_normal((2, 16))
         ).astype(np.float32) if use_u else None
    td, tb, tx, tc = _t(d, b, x, c)
    tu = _t(u)[0]
    y_full, h_full = ssd(td, tb, tx, tc, u=tu, chunk=32, include_current=inc)
    h = jh = None
    ys = []
    for t in range(32):
        y, h = ops.ssd_decode_step(td[:, t], tb[:, t], tx[:, t], tc[:, t],
                                   u=tu, h=h, include_current=inc)
        jy, jh = jref.ssd_decode_step(*_j(d[:, t], b[:, t], x[:, t], c[:, t]),
                                      u=_j(u)[0], h=jh, include_current=inc)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
        ys.append(y)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y_full.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(h.numpy(), h_full.numpy(), atol=1e-5)


def test_chunk_rule_and_input_checks():
    assert [chunk_for(t, 64) for t in (1024, 96, 1000, 7, 32)] == \
        [64, 32, 8, 7, 32]
    d, b, x, c = _t(*_inputs(1, 8, 2, 4, 4, 0.9))
    with pytest.raises(AssertionError):
        ssd_reference(d, b, x, c, chunk=3)
    with pytest.raises(TypeError):
        ssd(d.double(), b, x, c)
    with pytest.raises(ValueError):
        ssd(d, b[:, :, :, :2].contiguous(), x, c)
    with pytest.raises(ValueError):
        ssd(d.transpose(1, 2), b, x, c)
    with pytest.raises(TypeError):
        ssd(d, b, x, c, u=torch.zeros(2, 4, dtype=torch.float64))


def test_cost_counts_bytes_once():
    d, b, x, c = _t(*_inputs(2, 128, 2, 16, 32, 0.9))
    cost = ssd_cost(d, b, x, c)
    assert cost["bytes"] == 4 * (3 * d.numel() + 2 * x.numel()
                                 + 2 * 2 * 16 * 32)
    per_chunk = (2 * 64 * 64 * 16 + 2 * 64 * 64 * 32 + 4 * 64 * 16 * 32
                 + 16 * 32 + 8 * 64 * 16)
    assert cost["ops"] == 2 * 2 * 2 * per_chunk


@pytest.mark.parametrize("case", ["N 65", "P 129", "half", "x double",
                                  "u shape", "h0 bf16", "not contiguous",
                                  "empty"])
def test_wrapper_rejects_inputs_the_kernel_does_not_take(case):
    """The kernel's limits (N <= 64, P <= 128; f32 or bf16 operands, f32
    u and h0) are the wrapper's: what it does not take raises, on the CPU
    as on a card, before any version runs."""
    d, b, x, c = _t(*_inputs(1, 16, 2, 8, 8, 0.9))
    kw = {}
    if case == "N 65":
        d, b, _, c = _t(*_inputs(1, 16, 2, 65, 8, 0.9))
    elif case == "P 129":
        x = torch.zeros(1, 16, 2, 129)
    elif case == "half":
        d = d.half()
    elif case == "x double":
        x = x.double()
    elif case == "u shape":
        kw = {"u": torch.zeros(2, 9)}
    elif case == "h0 bf16":
        kw = {"h0": torch.zeros(1, 2, 8, 8, dtype=torch.bfloat16)}
    elif case == "not contiguous":
        c = torch.zeros(1, 2, 16, 8).transpose(1, 2)
    elif case == "empty":
        d, b, x, c = (t[:, :0] for t in (d, b, x, c))
    before = ssd.launches
    with pytest.raises((TypeError, ValueError)):
        ssd(d, b, x, c, **kw)
    assert ssd.launches == before


def test_cpu_takes_the_plain_version_at_the_kernel_shapes():
    """On the CPU the wrapper is the plain version, bit for bit, at mixed
    operand types and at sizes the kernel stages element by element (N, P
    not multiples of 4; T = 7, a chunk of 7)."""
    d, b, x, c = _t(*_inputs(1, 7, 2, 6, 6, 0.9, seed=8))
    u = torch.full((2, 6), 0.05)
    h0 = torch.ones(1, 2, 6, 6)
    before = ssd.launches
    y, h = ssd(d, b, x.to(torch.bfloat16), c.to(torch.bfloat16), u=u, h0=h0,
               include_current=False)
    ry, rh = ssd_reference(d, b, x.to(torch.bfloat16), c.to(torch.bfloat16),
                           u=u, h0=h0, chunk=7, include_current=False)
    assert ssd.launches == before
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    torch.testing.assert_close(y, ry, rtol=0, atol=0)
    torch.testing.assert_close(h, rh, rtol=0, atol=0)
