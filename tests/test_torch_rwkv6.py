"""PyTorch port: RWKV6 (`repro_torch.models.ssm`'s time-mix, its one-token
decode and the channel-mix) against `repro.models.ssm` at reduced size in
f32.

The reference's own random layer weights cross over leaf for leaf
(`convert._tree`); inputs are drawn with numpy from a seed.  The JAX side
runs as its own tests run it on the CPU (`ops.ssd` → `ref.chunked_ssd`),
the port's on its plain `ssd_reference`.  Bound: every output within
rtol = atol = 1e-5 (torch_parity.TOL): the time-mix output reaches
|y| ≈ 40 over two chunks, where an absolute 1e-5 alone is under 3 ulp.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_arch as ref_arch
from repro.configs import reduced as ref_reduced
from repro.models import ssm as rssm

from torch_parity import TOL

from repro_torch.configs import get_arch, reduced
from repro_torch.convert import _tree as to_torch
from repro_torch.kernels import ssm_scan
from repro_torch.models import ssm as tssm

RCFG = ref_reduced(ref_arch("rwkv6-1.6b"))
CFG = reduced(get_arch("rwkv6-1.6b"))
D = CFG.d_model
NH, HD = D // CFG.rwkv_head_dim, CFG.rwkv_head_dim


@pytest.fixture(scope="module")
def layer():
    p = rssm.rwkv6_init(jax.random.PRNGKey(0), RCFG)
    return p, to_torch(jax.device_get(p), "cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("T", [64, 128, 24])
def test_time_mix_prefill(layer, T):
    """A whole prompt from zero state: y, the final state hT and the last
    token.  T = 128 runs two chunks of 64, T = 24 one chunk of 24."""
    p, tp = layer
    x = _x((2, T, D), 1)
    ry, (rh, rl) = rssm.rwkv6_time_mix(p, jnp.asarray(x), RCFG)
    ty, (th, tl) = tssm.rwkv6_time_mix(tp, torch.from_numpy(x), CFG)
    assert th.shape == (2, NH, HD, HD) and th.dtype == torch.float32
    for a, b in ((ty, ry), (th, rh), (tl, rl)):
        _close(a, b)


def test_time_mix_continues_from_state_and_previous_token(layer):
    """``h0`` and ``prev_x`` carried in: the second half of a prompt from
    the first half's state equals the reference doing the same."""
    p, tp = layer
    x = _x((2, 64, D), 2)
    h0 = 0.1 * _x((2, NH, HD, HD), 3)
    prev = _x((2, 1, D), 4)
    ry, (rh, rl) = rssm.rwkv6_time_mix(p, jnp.asarray(x), RCFG,
                                       prev_x=jnp.asarray(prev),
                                       h0=jnp.asarray(h0))
    ty, (th, tl) = tssm.rwkv6_time_mix(tp, torch.from_numpy(x), CFG,
                                       prev_x=torch.from_numpy(prev),
                                       h0=torch.from_numpy(h0))
    for a, b in ((ty, ry), (th, rh), (tl, rl)):
        _close(a, b)


def test_time_mix_feeds_ssd_the_bonus_path(layer, monkeypatch):
    """The port hands `ssd` contiguous [B, T, nh, hd] tensors with ``u`` and
    ``include_current=False`` (what the kernel requires and runs)."""
    _, tp = layer
    seen = {}

    def spy(d, b, x, c, **kw):
        seen.update(kw, contiguous=all(t.is_contiguous() for t in (d, b, x,
                                                                    c)),
                    shape=tuple(d.shape))
        return ssm_scan.ssd(d, b, x, c, **kw)

    monkeypatch.setattr(tssm.ops, "ssd", spy)
    tssm.rwkv6_time_mix(tp, torch.from_numpy(_x((2, 64, D), 5)), CFG)
    assert seen["contiguous"] and seen["shape"] == (2, 64, NH, HD)
    assert seen["include_current"] is False and seen["u"] is tp["u"]


def test_channel_mix(layer):
    p, tp = layer
    x, prev = _x((2, 32, D), 6), _x((2, 1, D), 7)
    for pv in (None, prev):
        ry, rl = rssm.rwkv6_channel_mix(
            p, jnp.asarray(x), None if pv is None else jnp.asarray(pv))
        ty, tl = tssm.rwkv6_channel_mix(
            tp, torch.from_numpy(x), None if pv is None
            else torch.from_numpy(pv))
        _close(ty, ry)
        _close(tl, rl)


def test_one_token_decode(layer):
    """One decode step from a carried state equals the reference's, and
    equals the prefill of the same token (the chunked form's weighting)."""
    p, tp = layer
    x = _x((2, 1, D), 8)
    h = 0.1 * _x((2, NH, HD, HD), 9)
    prev = _x((2, 1, D), 10)
    ry, rh, rx = rssm.rwkv6_time_mix_decode(p, jnp.asarray(x), RCFG,
                                            jnp.asarray(h), jnp.asarray(prev))
    ty, th, tx = tssm.rwkv6_time_mix_decode(tp, torch.from_numpy(x), CFG,
                                            torch.from_numpy(h),
                                            torch.from_numpy(prev))
    for a, b in ((ty, ry), (th, rh), (tx, rx)):
        _close(a, b)
    py, (ph, _) = tssm.rwkv6_time_mix(tp, torch.from_numpy(x), CFG,
                                      prev_x=torch.from_numpy(prev),
                                      h0=torch.from_numpy(h))
    _close(ty, py.numpy())
    _close(th, ph.numpy())
