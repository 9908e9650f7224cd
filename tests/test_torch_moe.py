"""PyTorch port: the routed mixture of experts (`repro_torch.models.layers.
moe_init` / `moe_apply`) against `repro.models.layers` at reduced size in
f32.

The reference's own random weights cross over leaf for leaf; inputs are
drawn with numpy from a seed.  Bounds: y and the aux loss within
atol 1e-5, and the dropped (token, slot) pairs identical — a pair dropped
on one side only moves its token's row by a whole expert output, far past
1e-5.  The router's probabilities are random f32, so no two of a token's
experts tie: `torch.topk` and `lax.top_k` (which puts the lower index
first on a tie) pick the same experts in the same order.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_arch as ref_arch
from repro.configs import reduced as ref_reduced
from repro.models import layers as rlayers

from repro_torch.configs import get_arch, reduced
from repro_torch.convert import _tree as to_torch
from repro_torch.models import layers as tlayers

KEY = jax.random.PRNGKey(0)


def _cfgs(arch, **kw):
    return (ref_reduced(ref_arch(arch), **kw),
            reduced(get_arch(arch), **kw))


def _run(arch, B, S, seed=0, opts=None, **kw):
    rcfg, cfg = _cfgs(arch, **kw)
    p = rlayers.moe_init(KEY, rcfg)
    x = np.random.default_rng(seed).standard_normal(
        (B, S, rcfg.d_model)).astype(np.float32)
    ry, raux = rlayers.moe_apply(p, jnp.asarray(x), rcfg,
                                 None if opts is None
                                 else rlayers.MoEOptions(**opts))
    ty, taux = tlayers.moe_apply(to_torch(jax.device_get(p), "cpu"),
                                 torch.from_numpy(x), cfg,
                                 None if opts is None
                                 else tlayers.MoEOptions(**opts))
    return (p, x, rcfg), (ty, taux), (ry, raux)


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=1e-5)


def _dropped(p, x, cfg, cf, group):
    """The reference's dispatch restated in numpy: [N, k] True where a
    (token, slot) arrives at or past its expert's capacity."""
    E, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(-1, cfg.d_model)
    probs = jax.nn.softmax(jnp.asarray(xf) @ p["router"], -1)
    _, topi = jax.lax.top_k(probs, k)
    topi = np.asarray(topi)
    cap = max(int(group * k / E * cf), 1)
    out = np.zeros(topi.shape, bool)
    for g0 in range(0, len(topi), group):
        seen = np.zeros(E, int)
        for t in range(g0, g0 + group):
            for s in range(k):
                out[t, s] = seen[topi[t, s]] >= cap
                seen[topi[t, s]] += 1
    return out


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-236b"])
def test_moe_init_shapes(arch):
    rcfg, cfg = _cfgs(arch)
    ref = jax.device_get(rlayers.moe_init(KEY, rcfg, stack=3))
    port = tlayers.moe_init(torch.Generator().manual_seed(0), cfg, stack=3)
    assert ref.keys() == port.keys()
    for k in ref:
        assert tuple(port[k].shape) == ref[k].shape, k
    assert port["router"].dtype == torch.float32


@pytest.mark.parametrize("arch,B,S", [
    ("mixtral-8x7b", 2, 32),          # routed experts only
    ("deepseek-v2-236b", 2, 32),      # plus a shared expert
    ("mixtral-8x7b", 1, 1),           # a decode step: one token
    ("deepseek-v2-236b", 3, 1),
])
def test_moe_apply_matches_reference(arch, B, S):
    _, (ty, taux), (ry, raux) = _run(arch, B, S)
    assert ty.shape == (B, S, 128) and ty.dtype == torch.float32
    _close(ty, ry)
    _close(taux, raux)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-236b"])
def test_capacity_drops_the_same_tokens(arch):
    """Capacity factor 1.0 over 64 tokens in one group: cap = g·k/E, so
    some experts overflow and drop the late arrivals.  The port drops the
    same pairs: y equal within 1e-5 (a pair dropped on one side only would
    differ by a whole expert output), and tokens whose every slot was
    dropped get exactly the shared experts' output (zero without)."""
    (p, x, rcfg), (ty, taux), (ry, raux) = _run(arch, 1, 64,
                                                moe_capacity_factor=1.0)
    drop = _dropped(p, x, rcfg, 1.0, 64)
    assert 0 < drop.sum() < drop.size
    _close(ty, ry)
    _close(taux, raux)
    gone = np.flatnonzero(drop.all(1))
    if not rcfg.n_shared_experts:
        assert np.all(ty.reshape(64, -1)[gone].numpy() == 0.0)


def test_group_halving_and_drops_per_group():
    """600 tokens: the group size halves from 512 until it divides (8), and
    capacity is per group — cap = int(8·2/4·1.0) = 4."""
    (p, x, rcfg), (ty, taux), (ry, raux) = _run(
        "mixtral-8x7b", 2, 300, seed=3, moe_capacity_factor=1.0)
    drop = _dropped(p, x, rcfg, 1.0, 8)
    assert drop.any()
    _close(ty, ry)
    _close(taux, raux)


def test_explicit_options_and_bf16():
    """MoEOptions overrides the config's factor; bf16 activations and
    weights come back in bf16 (dispatch, products and combine in f32)."""
    opts = {"capacity_factor": 0.5, "group_size": 16}
    _, (ty, _), (ry, _) = _run("deepseek-v2-236b", 2, 24, seed=4, opts=opts)
    _close(ty, ry)
    rcfg, cfg = _cfgs("mixtral-8x7b", dtype="bfloat16")
    p = rlayers.moe_init(KEY, rcfg)
    x = np.random.default_rng(5).standard_normal((2, 16, 128)).astype(
        np.float32)
    ry, _ = rlayers.moe_apply(p, jnp.asarray(x, jnp.bfloat16), rcfg)
    ty, _ = tlayers.moe_apply(to_torch(jax.device_get(p), "cpu"),
                              torch.from_numpy(x).to(torch.bfloat16), cfg)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(ry, np.float32), atol=2e-2,
                               rtol=2.0 ** -7)


@pytest.mark.parametrize("pass_tokens", [1, 16, 64, 200])
def test_passes_match_the_reference_scan(monkeypatch, pass_tokens):
    """The expert products run in passes of whole groups, at most
    `_PASS_TOKENS` tokens each (one group when a group is larger): 600
    tokens in groups of 8 at capacity factor 1.0, so every pass drops
    pairs, against the reference's scan over one group at a time."""
    monkeypatch.setattr(tlayers, "_PASS_TOKENS", pass_tokens)
    (p, x, rcfg), (ty, taux), (ry, raux) = _run(
        "deepseek-v2-236b", 2, 300, seed=6, moe_capacity_factor=1.0)
    assert _dropped(p, x, rcfg, 1.0, 8).any()
    _close(ty, ry)
    _close(taux, raux)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-236b"])
def test_unrouted_experts_are_never_read(arch):
    """One token routes to k of E experts; the others' weights are set to
    NaN on the port's side and y still matches the reference: only the
    routed experts' slices are cast and multiplied."""
    rcfg, cfg = _cfgs(arch)
    p = jax.device_get(rlayers.moe_init(KEY, rcfg))
    x = np.random.default_rng(7).standard_normal(
        (1, 1, rcfg.d_model)).astype(np.float32)
    ry, _ = rlayers.moe_apply(p, jnp.asarray(x), rcfg)
    _, topi = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x[0]) @ p["router"],
                                           -1), rcfg.top_k)
    idle = np.setdiff1d(np.arange(rcfg.n_experts), np.asarray(topi))
    assert idle.size
    tp = to_torch(p, "cpu")
    for name in ("we_gate", "we_up", "we_down"):
        tp[name][idle] = float("nan")
    ty, _ = tlayers.moe_apply(tp, torch.from_numpy(x), cfg)
    _close(ty, ry)
