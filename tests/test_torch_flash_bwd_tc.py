"""PyTorch port: the tensor-core flash backward's route and numerics, on the
CPU.

The kernel (``csrc/flash_attention_bwd_tc.cu``) runs only on a card
(tests/test_torch_cuda.py, chip_smoke.py Phase L).  Here:

  * the route rule: bf16 q, k, v at the tensor-core pairs — d = dv ∈ {64,
    112, 128, 256} and MLA's (192, 128) — take the tensor-core kernels
    forward and backward; f32, mixed types and other dims the CUDA-core
    ones; the backward counts its calls by route;
  * the kernel's roundings restated in plain PyTorch (`kernel_model`): p in
    log2 units times 1 / max(l, 1e-20), and p and ds entering their
    products as three bf16 parts (each the rounding of what the earlier
    leave), everything else f32.  At Gemma-2B's
    row length [1, 1,024, 8 on 1, 256] and at MLA's dims, causal, the
    model is held to the f32 plain version within the bf16 gate (5e-3 of
    each gradient's largest magnitude) — the plain version is held to
    ``jax.vjp`` of `ref.make_flash` in tests/test_torch_flash_backward.py,
    so this chains the design's roundings to the reference — and, rounded
    to bf16 as the kernel writes it, to the plain version's bf16 output,
    which is what the gate on the card compares.  A single bf16 rounding
    of p and ds would break that gate: the reason for the parts.

Inputs are drawn with numpy from a seed.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import NEG_INF, keep_mask

BF16, F32 = torch.bfloat16, torch.float32
GATE = 5e-3            # chip_smoke.FLASH_BWD_TOL["bfloat16"]
GEMMA = (1, 1024, 8, 1, 256, 256)
MLA = (1, 512, 8, 8, 192, 128)


def _inputs(B, T, H, KV, d, dv, seed):
    rng = np.random.default_rng(seed)
    r = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(BF16)
    return r(B, T, H, d), r(B, T, KV, d), r(B, T, KV, dv), r(B, T, H, dv)


def _operand(x, parts: int):
    """x as the kernel feeds it to the tensor cores: the sum of ``parts``
    bf16 values, each the bf16 rounding of what the earlier leave."""
    out = torch.zeros_like(x)
    for _ in range(parts):
        out = out + (x - out).to(BF16).float()
    return out


def kernel_model(q, k, v, o, m, l, do, *, causal=True, parts=3):
    """The tensor-core backward's arithmetic in f32 on the CPU: scores on
    the bf16 inputs, p = 2^(s·scale·log2 e − m·log2 e) · (1 / max(l,
    1e-20)) (a masked score NEG_INF·log2 e), ds = p·(do·vᵀ − D)·scale, and
    the three accumulating products on p and ds as `_operand` rounds them.
    Returns f32 (dq, dk, dv)."""
    B, T, H, d = q.shape
    KV, dv = k.shape[2], v.shape[-1]
    g = H // KV
    scale = float(d ** -0.5)
    log2e = math.log2(math.e)
    qf = q.float().reshape(B, T, KV, g, d)
    dof = do.float().reshape(B, T, KV, g, dv)
    kf, vf = k.float(), v.float()
    D = torch.einsum("bqkgc,bqkgc->bkgq", dof, o.reshape(B, T, KV, g, dv))
    s2 = torch.einsum("bqkgc,bskc->bkgqs", qf, kf) * torch.tensor(
        scale * log2e, dtype=F32)
    keep = keep_mask(torch.arange(T), torch.arange(T), causal, 0)
    s2 = torch.where(keep, s2, torch.tensor(NEG_INF * log2e, dtype=F32))
    m2 = torch.where(m == NEG_INF, torch.tensor(NEG_INF * log2e, dtype=F32),
                     m * torch.tensor(log2e, dtype=F32))
    il = 1.0 / torch.clamp(l, min=1e-20)
    p = torch.exp2(s2 - m2.reshape(B, KV, g, T, 1)) * il.reshape(
        B, KV, g, T, 1)
    dp = torch.einsum("bqkgc,bskc->bkgqs", dof, vf)
    ds = p * (dp - D[..., None]) * scale
    pu, dsu = _operand(p, parts), _operand(ds, parts)
    dq = torch.einsum("bkgqs,bskc->bqkgc", dsu, kf).reshape(B, T, H, d)
    dk = torch.einsum("bkgqs,bqkgc->bskc", dsu, qf)
    dvv = torch.einsum("bkgqs,bqkgc->bskc", pu, dof)
    return dq, dk, dvv


def _rel(got, want):
    """Each gradient's largest |Δ| as a share of its largest magnitude."""
    return [float((a.float() - b.float()).abs().max())
            / float(b.float().abs().max()) for a, b in zip(got, want)]


def _case(shape, seed, parts):
    q, k, v, do = _inputs(*shape, seed)
    o, m, l = fa.flash_attention_stats_reference(q, k, v)
    got = kernel_model(q, k, v, o, m, l, do, parts=parts)
    f32 = fa.flash_attention_backward_reference(
        q.float(), k.float(), v.float(), o, m, l, do.float())
    bf16 = fa.flash_attention_backward_reference(q, k, v, o, m, l, do)
    return _rel(got, f32), _rel([x.to(BF16) for x in got], bf16)


@pytest.mark.parametrize("shape", [GEMMA, MLA], ids=["gemma-2b", "mla"])
def test_kernel_roundings_hold_the_bf16_gate(shape):
    """p and ds in three bf16 parts: within the gate of the f32 plain
    version (in fact ~1e-6), and after the bf16 output rounding of the
    plain version's bf16 output."""
    rel32, rel16 = _case(shape, seed=1, parts=3)
    assert max(rel32) <= 1e-5, rel32
    assert max(rel16) <= GATE, rel16


def test_one_bf16_rounding_of_p_and_ds_would_break_the_gate():
    """With p and ds rounded once to bf16 the f32 result still sits within
    the gate of the f32 plain version, but its bf16 output leaves the
    plain version's bf16 output by more than the gate allows."""
    rel32, rel16 = _case(GEMMA, seed=1, parts=1)
    assert max(rel32) <= GATE, rel32
    assert max(rel16) > GATE, rel16


@pytest.mark.parametrize("d,dv", sorted(fa.TC_DIMS))
def test_bf16_at_the_tensor_core_pairs_takes_the_tensor_cores(d, dv):
    """Forward and backward share `flash_route`: bf16 at a pair of
    `TC_DIMS` goes to the tensor-core kernels on a card, f32 or mixed
    types to the CUDA-core ones, and the CPU to the plain versions."""
    assert fa.flash_route("cuda", BF16, BF16, d, dv) == "tensor_core"
    assert fa.flash_route("cuda", F32, F32, d, dv) == "cuda_core"
    assert fa.flash_route("cuda", BF16, F32, d, dv) == "cuda_core"
    assert fa.flash_route("cpu", BF16, BF16, d, dv) == "plain"


@pytest.mark.parametrize("d,dv", [(32, 32), (96, 96), (48, 40), (128, 64),
                                  (256, 128), (192, 192), (128, 192)])
def test_other_head_dims_take_the_cuda_cores(d, dv):
    assert (d, dv) not in fa.TC_DIMS
    assert fa.flash_route("cuda", BF16, BF16, d, dv) == "cuda_core"


def test_backward_counts_launches_by_route_and_resets_them():
    """The backward's per-route counts exist beside the forward's, and
    `reset_launches` zeroes them; a CPU call is the plain version and
    counts nothing."""
    fa.flash_attention_backward.launches_by_route["tensor_core"] += 2
    fa.reset_launches()
    assert fa.flash_attention_backward.launches_by_route == {
        "tensor_core": 0, "cuda_core": 0}
    q, k, v, do = _inputs(1, 70, 4, 1, 192, 128, seed=3)
    o, m, l = fa.flash_attention_stats_reference(q, k, v)
    got = fa.flash_attention_backward(q, k, v, o, m, l, do)
    want = fa.flash_attention_backward_reference(q, k, v, o, m, l, do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fa.flash_attention_backward.launches == 0
    assert fa.flash_attention_backward.launches_by_route == {
        "tensor_core": 0, "cuda_core": 0}


def test_tensor_core_backward_raises_when_its_library_does_not_load(
        monkeypatch):
    """No fallback in the launch path: a library that does not build or
    load is an error, not a reason to run another version."""
    from repro_torch.kernels import _build

    def refuse(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(_build, "load", refuse)
    q, k, v, do = _inputs(1, 64, 2, 1, 128, 128, seed=4)
    o, m, l = fa.flash_attention_stats_reference(q, k, v)
    with pytest.raises(RuntimeError, match="flash_attention_bwd_tc"):
        fa._launch_bwd_tc(q, k, v, o, m, l, do, True, 0, 0, 128 ** -0.5)
