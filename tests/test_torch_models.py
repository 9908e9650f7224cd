"""PyTorch port: the serving model stack (`repro_torch.models`) against the
JAX package's (`repro.models`) at reduced size in f32.

The reference's own random weights cross over leaf for leaf
(`convert.params_from_numpy`); inputs are drawn with numpy from a seed.
Bounds: layers ≤1e-5; whole-model logits atol 1e-4; cache leaves with the
parity harness's rtol = atol = 1e-5 (torch_parity.TOL: the hybrid's
residual stream grows through its layers, so its cached keys and values
reach magnitudes where an absolute 1e-5 alone is a few ulp); decode vs the
full forward inside the port 2e-4, the reference test's bound.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from torch_parity import TOL

from repro.configs import get_arch as ref_arch
from repro.configs import reduced as ref_reduced
from repro.models import attention as rattn
from repro.models import layers as rlayers
from repro.models import ssm as rssm
from repro.models import transformer as rtf

from repro_torch.configs import get_arch, reduced
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.convert import _tree as to_torch
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf

ALL = ["gemma-7b", "gemma-2b", "granite-34b", "granite-3-2b", "zamba2-7b",
       "mixtral-8x7b", "deepseek-v2-236b", "rwkv6-1.6b", "chameleon-34b",
       "musicgen-large"]
ARCHS = ["zamba2-7b", "gemma-2b"]
KV_ARCHS = [a for a in ALL if get_arch(a).family != "ssm"
            and not get_arch(a).mla_kv_lora]
KEY = jax.random.PRNGKey(0)


def _cfgs(arch):
    return ref_reduced(ref_arch(arch)), reduced(get_arch(arch))


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, atol=1e-5, **kw):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol, **kw)


def _close_cache(cfg, tc, rc):
    """Cache leaves at torch_parity.TOL.  RWKV6's state h is a
    decay-weighted sum of k⊗v over the prompt, so an element near zero is
    a cancellation of terms of the leaf's full size: its absolute bound is
    TOL's atol times the leaf's largest magnitude (XLA's and PyTorch's CPU
    tanh and exp differ in the last ulp, and the sum carries that ulp of
    its largest terms)."""
    assert set(tc) == set(rc)
    for k in rc:
        want = np.asarray(rc[k], np.float32)
        scale = (max(1.0, float(np.abs(want).max()))
                 if cfg.family == "ssm" and k == "h" else 1.0)
        _close(tc[k], want, rtol=TOL["rtol"], atol=TOL["atol"] * scale,
               err_msg=k)


# ----------------------------------------------------------------- layers --
def test_rms_norm_and_rope():
    x, w = _x((2, 16, 4, 32)), _x((32,), 1, 0.1)
    _close(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           rlayers.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    pos = np.arange(3, 19, dtype=np.int32)
    _close(tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos)),
           rlayers.rope(jnp.asarray(x), jnp.asarray(pos)))
    _close(tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos),
                        theta=500.0, rot_dims=16),
           rlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta=500.0,
                        rot_dims=16))


@pytest.mark.parametrize("kind", ["geglu", "swiglu", "gelu"])
def test_mlp_apply(kind):
    import dataclasses
    rcfg, _ = _cfgs("gemma-2b")
    rcfg = dataclasses.replace(rcfg, mlp=kind)
    p = rlayers.mlp_init(KEY, rcfg)
    x = _x((2, 8, rcfg.d_model))
    _close(tlayers.mlp_apply(to_torch(jax.device_get(p), "cpu"),
                             torch.from_numpy(x), kind),
           rlayers.mlp_apply(p, jnp.asarray(x), kind))


@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_forward_and_decode(arch):
    rcfg, cfg = _cfgs(arch)
    p = rattn.attn_init(KEY, rcfg)
    tp = to_torch(jax.device_get(p), "cpu")
    x = _x((2, 24, rcfg.d_model), 1)
    pos = np.arange(24, dtype=np.int32)
    ro, (rk, rv) = rattn.gqa_forward(p, jnp.asarray(x), rcfg, jnp.asarray(pos))
    to, (tk, tv) = tattn.gqa_forward(tp, torch.from_numpy(x), cfg,
                                     torch.from_numpy(pos))
    _close(to, ro)
    _close(tk, rk)
    _close(tv, rv)
    # one decode step at position 24 against a 32-slot cache holding the 24
    S = 32
    ck = np.zeros((2, S, cfg.n_kv_heads, cfg.head_dim), np.float32)
    cv = np.zeros_like(ck)
    ck[:, :24], cv[:, :24] = np.asarray(rk), np.asarray(rv)
    cpos = np.full((2, S), -1, np.int32)
    cpos[:, :24] = np.arange(24)
    xd = _x((2, 1, rcfg.d_model), 2)
    r = rattn.gqa_decode(p, jnp.asarray(xd), rcfg, jnp.asarray(ck),
                         jnp.asarray(cv), jnp.asarray(cpos), 24)
    t = tattn.gqa_decode(tp, torch.from_numpy(xd), cfg, torch.from_numpy(ck),
                         torch.from_numpy(cv), torch.from_numpy(cpos), 24)
    for a, b in zip(t, r):
        _close(a, b)


def test_mamba2_forward_and_decode():
    rcfg, cfg = _cfgs("zamba2-7b")
    p = rssm.mamba2_init(KEY, rcfg)
    tp = to_torch(jax.device_get(p), "cpu")
    x = _x((2, 64, rcfg.d_model), 3)
    ry, (rh, rtail) = rssm.mamba2_forward(p, jnp.asarray(x), rcfg)
    ty, (th, ttail) = tssm.mamba2_forward(tp, torch.from_numpy(x), cfg)
    _close(ty, ry)
    _close(th, rh)
    _close(ttail, rtail)
    xd = _x((2, 1, rcfg.d_model), 4)
    r = rssm.mamba2_decode(p, jnp.asarray(xd), rcfg, rh, rtail)
    t = tssm.mamba2_decode(tp, torch.from_numpy(xd), cfg, th, ttail)
    for a, b in zip(t, r):
        _close(a, b)


def test_softplus_has_no_identity_switch():
    x = torch.tensor([-30.0, -1.0, 0.0, 1.0, 19.0, 25.0, 60.0])
    _close(tssm.softplus(x), jax.nn.softplus(jnp.asarray(x.numpy())),
           atol=0, rtol=1e-6)


# ------------------------------------------------------------ whole model --
@functools.lru_cache(maxsize=None)
def _model(arch):
    rcfg, cfg = _cfgs(arch)
    rp = rtf.init_params(KEY, rcfg)
    return rcfg, cfg, rp, params_from_numpy(cfg, jax.device_get(rp), "cpu")


@pytest.fixture(scope="module", params=ALL)
def model(request):
    return _model(request.param)


def test_forward_prefill_decode_match_reference(model):
    rcfg, cfg, rp, tp = model
    toks = np.random.default_rng(0).integers(2, cfg.vocab_size, (2, 64)
                                             ).astype(np.int32)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks).long()
    rl, raux = rtf.forward(rp, rcfg, jt)
    tl, taux = ttf.forward(tp, cfg, tt)
    assert tl.dtype == torch.float32 and tl.shape == (2, 64, cfg.vocab_size)
    _close(tl, rl, atol=1e-4)
    _close(taux["moe_aux"], raux["moe_aux"])

    rlast, rc, rpos = rtf.prefill(rp, rcfg, jt, 96)
    tlast, tc, tpos = ttf.prefill(tp, cfg, tt, 96)
    assert tpos == int(rpos) == 64
    _close(tlast, rlast, atol=1e-4)
    _close_cache(cfg, tc, rc)

    # a decode step from the REFERENCE's cache, carried over leaf for leaf
    nxt = toks[:, 0]
    rlg, rc2 = rtf.decode_step(rp, rcfg, rc, jnp.asarray(nxt), rpos)
    tc_ref = cache_from_numpy(cfg, jax.device_get(rc), "cpu")
    tlg, tc2 = ttf.decode_step(tp, cfg, tc_ref, torch.from_numpy(nxt).long(),
                               64)
    _close(tlg, rlg, atol=1e-4)
    _close_cache(cfg, tc2, rc2)


@pytest.mark.parametrize("arch", KV_ARCHS)
def test_prefill_into_a_shorter_cache_keeps_the_trailing_window(arch):
    """A prompt longer than the cache: the last max_seq keys, ring-aligned
    (slot = position % max_seq), as the reference lays them out.  Run where
    the cache holds keys, values and positions (not RWKV6's state, nor
    MLA's latent cache)."""
    rcfg, cfg, rp, tp = _model(arch)
    toks = np.random.default_rng(2).integers(2, cfg.vocab_size, (1, 40)
                                             ).astype(np.int32)
    _, rc, _ = rtf.prefill(rp, rcfg, jnp.asarray(toks), 24)
    _, tc, _ = ttf.prefill(tp, cfg, torch.from_numpy(toks).long(), 24)
    for k in ("k", "v", "pos"):
        _close(tc[k], rc[k], **TOL)


def test_decode_matches_forward_inside_the_port(model):
    _, cfg, _, tp = model
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        2, cfg.vocab_size, (1, 33)))
    full, _ = ttf.forward(tp, cfg, toks)
    _, cache, pos = ttf.prefill(tp, cfg, toks[:, :32], 64)
    lg, _ = ttf.decode_step(tp, cfg, cache, toks[:, 32], pos)
    assert float((lg[0] - full[0, -1]).abs().max()) < 2e-4


def test_params_from_numpy_checks_keys():
    rcfg, cfg = _cfgs("gemma-2b")
    tree = jax.device_get(rtf.init_params(KEY, rcfg))
    tree.pop("final_norm")
    with pytest.raises(ValueError, match="parameter keys"):
        params_from_numpy(cfg, tree, "cpu")


def test_port_init_draws_the_reference_distributions():
    """The port draws its own weights (a torch generator): same shapes,
    dtypes and constants as the reference's, scales within sampling
    error — for every family (hybrid, RWKV6, MoE with the sliding window,
    MoE with MLA and shared experts, the two stub-frontend backbones).
    Constant leaves (norms, Mamba2's a_log / dt_bias / d_skip, RWKV6's mix,
    cmix and w0) are compared as constants, not by their spread."""
    flat = lambda t, pre="": (
        {k2: v2 for k, v in t.items() for k2, v2 in
         flat(v, pre + k + "/").items()} if isinstance(t, dict)
        else {pre[:-1]: t})
    for arch in ("zamba2-7b", "rwkv6-1.6b", "mixtral-8x7b",
                 "deepseek-v2-236b", "chameleon-34b", "musicgen-large"):
        rcfg, cfg = _cfgs(arch)
        fr = flat(jax.device_get(rtf.init_params(KEY, rcfg)))
        fp = flat(ttf.init_params(torch.Generator().manual_seed(0), cfg))
        assert fr.keys() == fp.keys(), arch
        for k in fr:
            where = f"{arch} {k}"
            assert tuple(fp[k].shape) == fr[k].shape, where
            assert str(fp[k].dtype) == f"torch.{fr[k].dtype}", where
            a, b = np.asarray(fr[k], np.float64), fp[k].double().numpy()
            if k.endswith(("a_log", "dt_bias", "d_skip", "norm", "mix",
                           "w0")):
                np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=where)
            else:
                assert abs(b.std() / a.std() - 1) < 0.1, where
