"""PyTorch port: the plain flash attention (`repro_torch.kernels.
flash_attention`) against the JAX package's Pallas kernel in interpret mode
and its naive oracle, on the reference test's sweep (tests/test_kernels.py)
with its bounds: atol 2e-5 in f32, 2e-2 in bf16.  Inputs are drawn with
numpy from a seed and handed to both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_cost,
                                                 flash_attention_reference)

TOL = {np.float32: 2e-5, "bfloat16": 2e-2}


def _qkv(B, Tq, Tk, H, KV, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Tq, H, d)).astype(np.float32),
            rng.standard_normal((B, Tk, KV, d)).astype(np.float32),
            rng.standard_normal((B, Tk, KV, d)).astype(np.float32))


def _both(arrays, dtype):
    """The same values as JAX and torch arrays of ``dtype``."""
    if dtype == "bfloat16":
        return ([jnp.asarray(a, jnp.bfloat16) for a in arrays],
                [torch.from_numpy(a).to(torch.bfloat16) for a in arrays])
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("B,T,H,KV,d,window", [
    (2, 256, 4, 2, 64, 0),
    (1, 256, 8, 1, 128, 0),        # MQA, gemma head_dim class
    (2, 512, 4, 4, 64, 128),       # sliding window
    (1, 128, 2, 2, 256, 0),        # head_dim 256 (gemma)
])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_plain_flash_matches_pallas_kernel(B, T, H, KV, d, window, dtype):
    (jq, jk, jv), (q, k, v) = _both(_qkv(B, T, T, H, KV, d), dtype)
    want = pallas_flash(jq, jk, jv, causal=True, window=window, block_q=128,
                        block_k=128, interpret=True)
    got = flash_attention(q, k, v, causal=True, window=window)
    assert got.dtype == q.dtype and got.shape == (B, T, H, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype])


@pytest.mark.parametrize("Tq,Tk,window,q_offset,causal", [
    (100, 100, 0, 0, True),         # ragged: no block divides T
    (130, 200, 16, 70, True),       # offset queries, window
    (64, 200, 8, 300, True),        # the window empties every row
    (70, 90, 0, 0, False),          # not causal
])
def test_plain_flash_ragged_offset_window_vs_oracle(Tq, Tk, window, q_offset,
                                                    causal):
    """Beyond the Pallas sweep (its wrapper halves blocks to divide T): the
    ragged edge, q_offset and a window that leaves rows without keys, held
    to the reference's naive oracle (empty rows: the mean of V there)."""
    a = _qkv(1, Tq, Tk, 4, 2, 112, seed=3)
    (jq, jk, jv), (q, k, v) = _both(a, np.float32)
    want = jref.attention_ref(jq, jk, jv, causal=causal, window=window,
                              q_offset=q_offset)
    got = flash_attention_reference(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, block_q=64,
                                    block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(
        tref.attention_ref(q, k, v, causal=causal, window=window,
                           q_offset=q_offset).numpy(),
        np.asarray(want), atol=2e-5)


def test_decode_routes_to_the_naive_oracle_with_kv_positions():
    """ops.attention: one query against a cache with unfilled slots (−1)
    equals the reference's decode path."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 1, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 48, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 48, 2, 32)).astype(np.float32)
    pos = np.where(np.arange(48) < 40, np.arange(48), -1).astype(np.int32)
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              q_offset=39, kv_positions=jnp.asarray(pos))
    before = flash_attention.launches
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), q_offset=39,
                        kv_positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert flash_attention.launches == before


def test_wrapper_takes_the_plain_version_on_cpu_and_checks_inputs():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, 64, 2, 1, 32))
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    assert flash_attention.launches == before       # no kernel on the CPU
    torch.testing.assert_close(out, flash_attention_reference(q, k, v),
                               rtol=0, atol=0)
    with pytest.raises(TypeError):
        flash_attention(q.double(), k, v)
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :, :16].contiguous(), v)
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2), k, v)
    kv2 = torch.zeros(1, 64, 2, 32)
    with pytest.raises(ValueError):                 # 3 heads on 2 KV heads
        flash_attention(torch.zeros(1, 8, 3, 32), kv2, kv2)


def test_cost_counts_the_kept_pairs():
    q, k, v = (torch.zeros(2, 8, 4, 16), torch.zeros(2, 8, 2, 16),
               torch.zeros(2, 8, 2, 16))
    c = flash_attention_cost(q, k, v)
    assert c["pairs"] == 36                        # causal 8 × 9 / 2
    assert c["ops"] == 2 * 4 * 36 * (2 * 16 + 2 * 16 + 4)
    assert c["bytes"] == 4 * (q.numel() + k.numel() + v.numel() + q.numel())
    assert flash_attention_cost(q, k, v, window=2)["pairs"] == 15


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("d", [32, 64, 96, 112, 128, 192, 256])
@pytest.mark.parametrize("q_dtype,kv_dtype", [(BF16, BF16), (F32, F32),
                                              (F32, BF16), (BF16, F32)])
def test_route_rule_sends_only_all_bf16_to_the_tensor_cores(q_dtype,
                                                           kv_dtype, d):
    """The written rule: on a card, bf16 q, k and v with d = dv in
    {64, 112, 128, 256} take the tensor-core kernel, everything else the
    CUDA-core kernel; on the CPU the plain version."""
    from repro_torch.kernels.flash_attention import TC_HEAD_DIMS, flash_route

    tc = q_dtype == kv_dtype == BF16 and d in (64, 112, 128, 256)
    assert (d in TC_HEAD_DIMS) == (d in (64, 112, 128, 256))
    assert flash_route("cuda", q_dtype, kv_dtype, d, d) == (
        "tensor_core" if tc else "cuda_core")
    assert flash_route("cuda", q_dtype, kv_dtype, d, d // 2) == "cuda_core"
    assert flash_route("cpu", q_dtype, kv_dtype, d, d) == "plain"


def test_cpu_bf16_at_a_tensor_core_shape_runs_the_plain_version():
    """A CPU tensor never reaches a kernel, whatever its route on a card;
    `reset_launches` zeroes both routes' counts."""
    from repro_torch.kernels import flash_attention as fa

    fa.flash_attention.launches_by_route["tensor_core"] += 3
    fa.reset_launches()
    assert fa.flash_attention.launches == 0
    assert fa.flash_attention.launches_by_route == {"tensor_core": 0,
                                                    "cuda_core": 0}
    q, k, v = (torch.from_numpy(a).to(BF16)
               for a in _qkv(1, 70, 70, 4, 2, 112, seed=9))
    out = flash_attention(q, k, v, window=16)
    assert out.dtype == BF16
    assert fa.flash_attention.launches == 0
    torch.testing.assert_close(out, flash_attention_reference(q, k, v,
                                                              window=16),
                               rtol=0, atol=0)


@pytest.mark.parametrize("case", ["half", "double", "d 320", "dv 288",
                                  "heads 6 on 4", "kv types", "empty",
                                  "not contiguous", "q_offset float"])
def test_wrapper_rejects_inputs_neither_kernel_takes(case):
    """What neither kernel (nor the plain version) takes raises before any
    route is chosen: other dtypes, head dims past 256, H not a multiple of
    KV, k and v of different types, empty or strided inputs."""
    z = lambda *s, dt=F32: torch.zeros(s, dtype=dt)
    q, k, v = z(1, 8, 4, 64), z(1, 8, 2, 64), z(1, 8, 2, 64)
    kw = {}
    if case == "half":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "double":
        q = q.double()
    elif case == "d 320":
        q, k, v = z(1, 8, 4, 320), z(1, 8, 2, 320), z(1, 8, 2, 320)
    elif case == "dv 288":
        v = z(1, 8, 2, 288)
    elif case == "heads 6 on 4":
        q, k, v = z(1, 8, 6, 64), z(1, 8, 4, 64), z(1, 8, 4, 64)
    elif case == "kv types":
        k = k.to(BF16)
    elif case == "empty":
        q = z(1, 0, 4, 64)
    elif case == "not contiguous":
        q = z(1, 4, 8, 64).transpose(1, 2)
    elif case == "q_offset float":
        kw = {"q_offset": 1.0}
    with pytest.raises((TypeError, ValueError)):
        flash_attention(q, k, v, **kw)
