"""PyTorch port: the int8 KV cache and the sliding-window ring cache
(`repro_torch.models.attention.quantize_kv` / `gqa_decode`,
`transformer._fill_kv` / `decode_step`) against the JAX package at reduced
size in f32.

The reference's weights and caches cross over leaf for leaf
(`convert.params_from_numpy` / `cache_from_numpy`); inputs are drawn with
numpy from a seed.  Bounds: `quantize_kv` bit for bit (int8 values and f16
scales), and a reduced model's int8 cache after prefill and after a
decode step bit-equal too; positions exact; float cache leaves and outputs at
torch_parity.TOL; logits atol 1e-4 (tests/test_torch_models.py's bound).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from torch_parity import TOL

from repro.configs import get_arch as ref_arch
from repro.configs import reduced as ref_reduced
from repro.models import attention as rattn
from repro.models import transformer as rtf

from repro_torch.configs import get_arch, reduced
from repro_torch.convert import _tree as to_torch
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf

KEY = jax.random.PRNGKey(0)


def _cfgs(arch, **kw):
    return (ref_reduced(ref_arch(arch), **kw),
            reduced(get_arch(arch), **kw))


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _np(t):
    return t.detach().numpy() if hasattr(t, "detach") else np.asarray(t)


def _close(got, want, **kw):
    np.testing.assert_allclose(_np(got).astype(np.float32),
                               np.asarray(want, np.float32), **(kw or TOL))


def _same_bits(got, want, where=""):
    g, w = _np(got), np.asarray(want)
    assert g.dtype == w.dtype, where
    np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                  err_msg=where)


# ------------------------------------------------------------ quantize_kv --
def test_quantize_kv_bit_for_bit():
    """Random keys, rows with an exact .5 tie in every element (a row whose
    largest magnitude is 127 has scale 1 exactly; halves round to even, as
    `jnp.round` does), an all-zero row (the 1e-6 scale floor) and
    saturation at ±127."""
    x = _x((2, 16, 3, 32), 0, 3.0)
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -127.0],
                    np.float32)
    x[0, 0, 0] = np.resize(np.concatenate([ties, [127.0]]), 32)
    x[0, 0, 1] = 0.0
    x[0, 1, 2] = np.linspace(-1e-7, 1e-7, 32, dtype=np.float32)
    rq, rs = rattn.quantize_kv(jnp.asarray(x))
    tq, ts = tattn.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float16
    assert tuple(ts.shape) == (2, 16, 3, 1)
    _same_bits(tq, rq, "values")
    _same_bits(ts, rs, "scales")
    assert list(tq[0, 0, 0, :8]) == [0, 2, 2, 0, -2, -2, 126, -127]
    _same_bits(tattn.dequantize_kv(tq, ts, torch.float32),
               rattn.dequantize_kv(rq, rs, jnp.float32), "dequantised")


# ------------------------------------------------------------ int8 decode --
@pytest.mark.parametrize("arch", ["gemma-2b", "mixtral-8x7b"])
def test_int8_gqa_decode_step(arch):
    """One decode step against an int8 cache (full attention, and the SWA
    ring at slot pos % W): the new entry quantised into its slot in place,
    its scales beside it, attention over the dequantised cache."""
    rcfg, cfg = _cfgs(arch, kv_cache_dtype="int8")
    p = rattn.attn_init(KEY, rcfg)
    tp = to_torch(jax.device_get(p), "cpu")
    S, kv, dh = 32, cfg.n_kv_heads, cfg.head_dim
    k8, ks = rattn.quantize_kv(jnp.asarray(_x((2, S, kv, dh), 1)))
    v8, vs = rattn.quantize_kv(jnp.asarray(_x((2, S, kv, dh), 2)))
    cpos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    pos = 40 if cfg.attn_kind == "swa" else 24
    if cfg.attn_kind != "swa":
        cpos[:, pos:] = -1
    x = _x((2, 1, cfg.d_model), 3)
    r = rattn.gqa_decode(p, jnp.asarray(x), rcfg, k8, v8, jnp.asarray(cpos),
                         pos, kv_scales={"k": ks, "v": vs})
    t_in = [torch.from_numpy(np.array(a)) for a in (k8, v8, cpos, ks, vs)]
    t = tattn.gqa_decode(tp, torch.from_numpy(x), cfg, *t_in[:3], pos,
                         kv_scales={"k": t_in[3], "v": t_in[4]})
    assert t[1] is t_in[0] and t[1].dtype == torch.int8
    _close(t[0], r[0])
    for a, b, name in ((t[1], r[1], "k"), (t[2], r[2], "v"),
                       (t[3], r[3], "pos"), (t[4]["k"], r[4]["k"], "ks"),
                       (t[4]["v"], r[4]["v"], "vs")):
        _same_bits(a, b, name)


def test_int8_model_prefill_and_decode():
    """Gemma at reduced size with kv_cache_dtype="int8": prefill's cache
    (quantised keys and values, f16 scales, positions) and a decode step
    from the reference's cache, then decode vs the full forward inside the
    port within 0.05 relative (the bound of the reference's
    tests/test_perf_features.py::test_int8_kv_decode_close_to_bf16); the
    cache stays int8."""
    rcfg, cfg = _cfgs("gemma-2b", kv_cache_dtype="int8")
    rp = rtf.init_params(KEY, rcfg)
    tp = params_from_numpy(cfg, jax.device_get(rp), "cpu")
    toks = np.random.default_rng(1).integers(2, cfg.vocab_size, (1, 33)
                                             ).astype(np.int32)
    rl, rc, rpos = rtf.prefill(rp, rcfg, jnp.asarray(toks[:, :32]), 64)
    tl, tc, tpos = ttf.prefill(tp, cfg, torch.from_numpy(toks[:, :32]).long(),
                               64)
    assert tpos == int(rpos) == 32 and set(tc) == set(rc)
    _close(tl, rl, rtol=0, atol=1e-4)
    _int8_cache_close(tc, rc)
    tc_ref = cache_from_numpy(cfg, jax.device_get(rc), "cpu")
    rlg, rc2 = rtf.decode_step(rp, rcfg, rc, jnp.asarray(toks[:, 32]), rpos)
    tlg, tc2 = ttf.decode_step(tp, cfg, tc_ref,
                               torch.from_numpy(toks[:, 32]).long(), 32)
    _close(tlg, rlg, rtol=0, atol=1e-4)
    _int8_cache_close(tc2, rc2)
    assert tc2["k"].dtype == tc2["v"].dtype == torch.int8

    full, _ = ttf.forward(tp, dataclasses.replace(cfg, kv_cache_dtype=""),
                          torch.from_numpy(toks).long())
    lg, c3 = ttf.decode_step(tp, cfg, tc, torch.from_numpy(toks[:, 32]).long(),
                             32)
    rel = float((lg[0] - full[0, -1]).abs().max() / full[0, -1].abs().max())
    assert rel < 0.05 and c3["k"].dtype == torch.int8


def _int8_cache_close(tc, rc):
    """Every leaf bit-equal: int8 values, f16 scales, positions."""
    for name in rc:
        _same_bits(tc[name], rc[name], name)


# ---------------------------------------------------------------- SWA ring --
def test_sliding_window_ring_prefill_and_decode():
    """Reduced Mixtral (window 64): a prompt of 80 into max_seq 96 keeps
    the trailing 64 positions, rolled by 80 % 64 = 16 so position p sits in
    slot p % 64; then decode steps write slots 16, 17, … (overwriting
    positions 16, 17, … of the prompt), each from the reference's cache
    carried over and compared leaf for leaf."""
    rcfg, cfg = _cfgs("mixtral-8x7b")
    assert cfg.window == 64
    rp = rtf.init_params(KEY, rcfg)
    tp = params_from_numpy(cfg, jax.device_get(rp), "cpu")
    toks = np.random.default_rng(2).integers(2, cfg.vocab_size, (2, 84)
                                             ).astype(np.int32)
    rl, rc, _ = rtf.prefill(rp, rcfg, jnp.asarray(toks[:, :80]), 96)
    tl, tc, tpos = ttf.prefill(tp, cfg, torch.from_numpy(toks[:, :80]).long(),
                               96)
    assert tc["k"].shape[2] == 64 and tpos == 80
    want_pos = np.roll(np.arange(16, 80), 16)
    assert (tc["pos"].numpy() == want_pos).all()
    _close(tl, rl, rtol=0, atol=1e-4)
    for name in rc:
        _close(tc[name], rc[name])
    for pos in range(80, 84):
        tc = cache_from_numpy(cfg, jax.device_get(rc), "cpu")
        rlg, rc = rtf.decode_step(rp, rcfg, rc, jnp.asarray(toks[:, pos]),
                                  pos)
        tlg, tc = ttf.decode_step(tp, cfg, tc,
                                  torch.from_numpy(toks[:, pos]).long(), pos)
        _close(tlg, rlg, rtol=0, atol=1e-4)
        for name in rc:
            _close(tc[name], rc[name])
        assert int(tc["pos"][0, 0, pos % 64]) == pos


def test_sliding_window_decode_matches_forward_inside_the_port():
    """The ring's answer equals the windowed full forward: decode of token
    80 after a prompt of 80 (ring rolled by 16) against the forward's last
    logits over 81 tokens, within 2e-4 (the reference test's bound)."""
    _, cfg = _cfgs("mixtral-8x7b")
    tp = ttf.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        2, cfg.vocab_size, (1, 81)))
    full, _ = ttf.forward(tp, cfg, toks)
    _, cache, pos = ttf.prefill(tp, cfg, toks[:, :80], 96)
    lg, _ = ttf.decode_step(tp, cfg, cache, toks[:, 80], pos)
    assert float((lg[0] - full[0, -1]).abs().max()) < 2e-4
