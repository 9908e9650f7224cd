"""PyTorch port: flash attention's training path on the CPU.

  * the plain forward's statistics (`flash_attention_stats_reference`)
    against the reference's `ref._flash_fwd_blocks`;
  * the plain backward (`flash_attention_backward_reference`) against
    ``jax.vjp`` of `ref.make_flash` — the reference's custom VJP — for
    causal and windowed masks, ``q_offset``, GQA / MQA, d ≠ dv and rows a
    window leaves without keys, within 1e-5 in f32;
  * `FlashAttention`'s gradients (what `flash_attention` and
    `ops.attention` route through when an input requires grad) against
    torch autograd of `ref.attention_ref`, within 5e-4 as the reference's
    ``test_flash_vjp_matches_autodiff``, ragged lengths included.

Inputs are drawn with numpy from a seed and handed to both packages.  The
backward kernel itself runs only on a card (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels import ref as jref

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref


def _arrays(B, Tq, Tk, H, KV, d, dv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Tq, H, d)).astype(np.float32),
            rng.standard_normal((B, Tk, KV, d)).astype(np.float32),
            rng.standard_normal((B, Tk, KV, dv)).astype(np.float32),
            rng.standard_normal((B, Tq, H, dv)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# (B, Tq, Tk, H, KV, d, dv, causal, window, q_offset, q_block, kv_block)
CASES = [
    (2, 64, 64, 4, 2, 16, 16, True, 0, 0, 16, 32),        # GQA, causal
    (1, 64, 64, 4, 1, 32, 32, True, 0, 0, 64, 64),        # MQA, one block
    (2, 64, 64, 4, 4, 16, 16, True, 20, 0, 16, 16),       # window
    (1, 32, 96, 2, 2, 16, 16, False, 24, 40, 16, 32),     # window, offset
    (2, 48, 48, 4, 2, 24, 16, True, 0, 0, 16, 16),        # d != dv
    (1, 32, 64, 4, 2, 16, 8, True, 8, 100, 16, 32),       # rows left empty
    (1, 64, 64, 2, 1, 16, 16, False, 0, 0, 32, 16),       # full, no mask
]
IDS = ["gqa", "mqa", "window", "offset", "d_ne_dv", "empty_rows", "full"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_stats_match_reference_fwd_blocks(case):
    B, Tq, Tk, H, KV, d, dv, causal, w, off, qb, kb = case
    q, k, v, _ = _arrays(B, Tq, Tk, H, KV, d, dv)
    o, ms, ls = jref._flash_fwd_blocks(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, w, off,
        d ** -0.5, qb, kb)
    # the reference's statistics: [nq, B, KV, g, qb] → [B, H, Tq]
    stat = lambda x: np.asarray(x).transpose(1, 2, 3, 0, 4).reshape(B, H, Tq)
    got_o, got_m, got_l = fa.flash_attention_stats_reference(
        *_t(q, k, v), causal=causal, window=w, q_offset=off, block_q=qb,
        block_k=kb)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(o), atol=1e-6)
    np.testing.assert_allclose(got_m.numpy(), stat(ms), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got_l.numpy(), stat(ls), rtol=1e-6)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_make_flash_vjp(case):
    B, Tq, Tk, H, KV, d, dv, causal, w, off, qb, kb = case
    q, k, v, do = _arrays(B, Tq, Tk, H, KV, d, dv, seed=1)
    flash = jref.make_flash(causal=causal, window=w, q_offset=off,
                            q_block=qb, kv_block=kb)
    out, vjp = jax.vjp(flash, jnp.asarray(q), jnp.asarray(k),
                       jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = _t(q, k, v, do)
    o, m, l = fa.flash_attention_stats_reference(
        tq, tk, tv, causal=causal, window=w, q_offset=off)
    got = fa.flash_attention_backward(tq, tk, tv, o, m, l, tdo,
                                      causal=causal, window=w, q_offset=off)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), atol=1e-5)
    for name, g, ref in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == ref.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), atol=1e-5,
                                   err_msg=name)


def test_plain_backward_blocks_do_not_change_the_gradient():
    """Ragged blocks (no size divides T) give make_flash's gradient."""
    q, k, v, do = _t(*_arrays(1, 100, 100, 4, 2, 16, 16, seed=2))
    o, m, l = fa.flash_attention_stats_reference(q, k, v)
    whole = fa.flash_attention_backward_reference(q, k, v, o, m, l, do,
                                                  block_q=100, block_k=100)
    ragged = fa.flash_attention_backward_reference(q, k, v, o, m, l, do,
                                                   block_q=32, block_k=24)
    for a, b in zip(whole, ragged):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


@pytest.mark.parametrize("Tq,Tk,H,KV,d,dv,causal,w,off", [
    (64, 64, 4, 2, 16, 16, True, 0, 0),
    (100, 100, 4, 1, 16, 16, True, 0, 0),      # ragged: no block divides T
    (70, 130, 2, 2, 8, 12, True, 32, 60),      # offset, window, d != dv
    (50, 50, 4, 4, 16, 16, False, 0, 0),
])
def test_flash_attention_gradients_match_autodiff(Tq, Tk, H, KV, d, dv,
                                                  causal, w, off):
    """The reference's test_flash_vjp_matches_autodiff bound (5e-4)."""
    q, k, v, do = _t(*_arrays(2, Tq, Tk, H, KV, d, dv, seed=3))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    kw = dict(causal=causal, window=w, q_offset=off)
    got = torch.autograd.grad(ops.attention(q, k, v, **kw), (q, k, v), do)
    want = torch.autograd.grad(tref.attention_ref(q, k, v, **kw),
                               (q, k, v), do)
    for name, g, ref in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), ref.numpy(), atol=5e-4,
                                   err_msg=name)


def test_flash_attention_routes_through_the_autograd_function():
    """With grad on, the output carries FlashAttention's graph; without,
    it is the serving path's output, equal to the statistics forward's."""
    q, k, v, _ = _t(*_arrays(1, 40, 40, 2, 1, 16, 16, seed=4))
    plain = fa.flash_attention(q, k, v)
    assert plain.grad_fn is None
    qg = q.clone().requires_grad_()
    out = fa.flash_attention(qg, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.equal(out.detach(), plain)
    with torch.no_grad():
        assert fa.flash_attention(qg, k, v).grad_fn is None


def test_bf16_gradients_keep_their_dtypes():
    q, k, v, do = (t.to(torch.bfloat16) for t in
                   _t(*_arrays(1, 32, 32, 4, 2, 16, 16, seed=5)))
    o, m, l = fa.flash_attention_stats_reference(q, k, v)
    assert o.dtype == m.dtype == l.dtype == torch.float32
    dq, dk, dv = fa.flash_attention_backward(q, k, v, o, m, l, do)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    ref = fa.flash_attention_backward_reference(q, k, v, o, m, l, do)
    for a, b in zip((dq, dk, dv), ref):
        assert torch.equal(a, b)


def test_backward_takes_a_strided_output_gradient():
    """Autograd may hand the output's gradient over non-contiguous."""
    q, k, v, do = _t(*_arrays(1, 32, 32, 2, 2, 16, 16, seed=6))
    o, m, l = fa.flash_attention_stats_reference(q, k, v)
    strided = do.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous()
    for a, b in zip(fa.flash_attention_backward(q, k, v, o, m, l, strided),
                    fa.flash_attention_backward(q, k, v, o, m, l, do)):
        assert torch.equal(a, b)


def test_backward_checks_its_residuals():
    q, k, v, do = _t(*_arrays(1, 16, 16, 2, 1, 8, 8, seed=7))
    o, m, l = fa.flash_attention_stats_reference(q, k, v)
    with pytest.raises(ValueError, match="m must be"):
        fa.flash_attention_backward(q, k, v, o, m[:, :1], l, do)
    with pytest.raises(ValueError, match="do must be"):
        fa.flash_attention_backward(q, k, v, o, m, l, do.double())
