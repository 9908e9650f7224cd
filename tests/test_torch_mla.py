"""PyTorch port: DeepSeek-V2's multi-head latent attention (`repro_torch.
models.attention.mla_forward` / `mla_decode`) and the plain flash version
at its q/k head dim 192 with v head dim 128, against the JAX package at
reduced size in f32.

The reference's weights cross over leaf for leaf; inputs are drawn with
numpy from a seed.  Bounds: the layer outputs and caches within atol 1e-5;
flash at d ≠ dv within the reference test's 2e-5 in f32 (2e-2 in bf16),
against both `repro.kernels.ops.attention`'s CPU path and the Pallas
kernel in interpret mode, which takes dv ≠ d (its V block is [bk, dv]).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_arch as ref_arch
from repro.configs import reduced as ref_reduced
from repro.kernels import ops as rops
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import attention as rattn

from repro_torch.configs import get_arch, reduced
from repro_torch.convert import _tree as to_torch
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_route)
from repro_torch.models import attention as tattn

RCFG = ref_reduced(ref_arch("deepseek-v2-236b"))
CFG = reduced(get_arch("deepseek-v2-236b"))
DH, RD, R = CFG.head_dim, CFG.mla_rope_dim, CFG.mla_kv_lora


@pytest.fixture(scope="module")
def layer():
    p = rattn.attn_init(jax.random.PRNGKey(0), RCFG)
    return p, to_torch(jax.device_get(p), "cpu")


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol)


def test_mla_init_keys_and_shapes(layer):
    p, _ = layer
    port = tattn.attn_init(torch.Generator().manual_seed(0), CFG)
    assert port.keys() == p.keys()
    for k in p:
        assert tuple(port[k].shape) == p[k].shape, k
    assert not port["kv_norm"].any()


def test_mla_forward(layer):
    p, tp = layer
    x = _x((2, 40, CFG.d_model), 1)
    pos = np.arange(40, dtype=np.int32)
    ro, (rc, rkr) = rattn.mla_forward(p, jnp.asarray(x), RCFG,
                                      jnp.asarray(pos))
    to, (tc, tkr) = tattn.mla_forward(tp, torch.from_numpy(x), CFG,
                                      torch.from_numpy(pos))
    assert tc.shape == (2, 40, R) and tkr.shape == (2, 40, RD)
    for a, b in ((to, ro), (tc, rc), (tkr, rkr)):
        _close(a, b)


@pytest.mark.parametrize("pos,S", [(24, 32), (31, 32), (40, 32)])
def test_mla_decode(layer, pos, S):
    """The absorbed latent decode at ``pos`` against a cache of S slots
    (pos ≥ S: the write clamps to the last slot, as
    ``dynamic_update_index_in_dim`` does, and the mask keeps every slot);
    the port writes the cache in place and returns it."""
    p, tp = layer
    cc = _x((2, S, R), 2)
    ck = _x((2, S, RD), 3)
    x = _x((2, 1, CFG.d_model), 4)
    ro, rc, rk = rattn.mla_decode(p, jnp.asarray(x), RCFG, jnp.asarray(cc),
                                  jnp.asarray(ck), pos)
    tc, tk = torch.from_numpy(cc.copy()), torch.from_numpy(ck.copy())
    to, tc2, tk2 = tattn.mla_decode(tp, torch.from_numpy(x), CFG, tc, tk,
                                    pos)
    assert tc2 is tc and tk2 is tk
    for a, b in ((to, ro), (tc, rc), (tk, rk)):
        _close(a, b)


def test_mla_decode_equals_the_expanded_forward(layer):
    """Absorbed decode of token 24 against the first 24 tokens' latent
    cache equals row 24 of the expanded forward over 25 tokens."""
    _, tp = layer
    x = torch.from_numpy(_x((2, 25, CFG.d_model), 5))
    full, (c, kr) = tattn.mla_forward(tp, x, CFG, torch.arange(25))
    cc = torch.zeros((2, 32, R))
    ck = torch.zeros((2, 32, RD))
    cc[:, :24], ck[:, :24] = c[:, :24], kr[:, :24]
    out, _, _ = tattn.mla_decode(tp, x[:, 24:], CFG, cc, ck, 24)
    _close(out, full[:, 24:].numpy(), atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_at_mla_head_dims(causal, dtype):
    """q/k head dim 192, v head dim 128, MLA's explicit scale (dh + rd) ** −0.5
    = 192 ** −0.5 (not q's default d ** −0.5, which is the same number
    here: the scale is passed through, not re-derived)."""
    B, T, H, d, dv = 2, 256, 4, 192, 128
    q, k = _x((B, T, H, d), 6), _x((B, T, H, d), 7)
    v = _x((B, T, H, dv), 8)
    scale = (128 + 64) ** -0.5
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    atol = 2e-2 if dtype == "bfloat16" else 2e-5
    got = flash_attention(tq, tk, tv, causal=causal, scale=scale)
    assert got.shape == (B, T, H, dv) and got.dtype == tdt
    for want in (rops.attention(jq, jk, jv, causal=causal, scale=scale),
                 pallas_flash(jq, jk, jv, causal=causal, scale=scale,
                              block_q=128, block_k=128, interpret=True)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=atol)
    # the same call through the models' entry (`ops.attention`)
    torch.testing.assert_close(tops.attention(tq, tk, tv, causal=causal,
                                              scale=scale), got,
                               rtol=0, atol=0)
    # another scale moves the result: the explicit one is the one used
    other = flash_attention(tq, tk, tv, causal=causal, scale=0.5 * scale)
    assert float((other.float() - got.float()).abs().max()) > 1e-3


def test_mla_shapes_route_to_the_cuda_core_kernel():
    """On a card MLA's d 192 / dv 128 in f32 (or mixed types) takes the
    CUDA-core kernel, forward and backward."""
    assert flash_route("cuda", torch.float32, torch.float32, 192,
                       128) == "cuda_core"
    assert flash_route("cuda", torch.bfloat16, torch.float32, 192,
                       128) == "cuda_core"


def test_mla_shapes_route_bf16_to_the_tensor_cores():
    """On a card bf16 at MLA's d 192 / dv 128 takes the tensor-core kernels
    (forward and backward), as bf16 at d = dv = 128 does; other d ≠ dv
    pairs do not."""
    bf16 = torch.bfloat16
    assert flash_route("cuda", bf16, bf16, 192, 128) == "tensor_core"
    assert flash_route("cuda", bf16, bf16, 128, 128) == "tensor_core"
    assert flash_route("cuda", bf16, bf16, 128, 192) == "cuda_core"
    assert flash_route("cuda", bf16, bf16, 192, 192) == "cuda_core"
    assert flash_route("cpu", bf16, bf16, 192, 128) == "plain"
