"""Blocked online-softmax (flash) attention, forward and backward.

Port of the TPU kernel `repro.kernels.flash_attention.flash_attention`
(Pallas body `_kernel`), with its plain version.

  * `flash_attention` — the wrapper.  On CUDA tensors it launches one of
    two hand-written Hopper kernels, as `flash_route` says, or raises; on
    CPU tensors it runs `flash_attention_reference`.
      - ``tensor_core`` (``csrc/flash_attention_tc.cu``): bf16 q, k and v
        with (d, dv) in `TC_DIMS` — d = dv ∈ {64, 112, 128, 256} and MLA's
        (192, 128): the serving path.  wgmma on the tensor cores, TMA
        loads into a K/V ring, a producer warp and two consumer
        warpgroups.
      - ``cuda_core`` (``csrc/flash_attention.cu``): every other input
        (f32 or mixed types, other head dims).  f32 FMAs on the CUDA
        cores, no TF32: the f32 bounds rest on it.
    The route depends on dtypes and shapes only, never on a failure.
    ``flash_attention.launches`` counts launches of both kernels,
    ``flash_attention.launches_by_route`` each route's.
  * `flash_attention_reference` — the plain PyTorch version: the blocked
    online softmax of `repro.kernels.ref._flash_fwd_blocks`, every KV block
    of every Q block in order.

The training path (the gradient of `ref.make_flash`, the reference's
``jax.custom_vjp``; the TPU kernel itself has no VJP):

  * `FlashAttention` — the ``torch.autograd.Function`` that
    `flash_attention` routes through when grad mode is on and q, k or v
    requires grad.  It saves (q, k, v, o_f32, m, l), as the reference's
    ``fwd`` does, and its backward is `flash_attention_backward`.
  * `flash_attention_stats` — the forward with its softmax statistics:
    (out, o_f32, m, l).  On a card the route's kernel with its optional
    statistics output (``launches_by_route`` counts it as a forward
    launch); on the CPU `flash_attention_stats_reference`.
  * `flash_attention_backward` — dq, dk, dv.  On a card one of two
    hand-written kernels by the same rule as the forward (`flash_route`):
    ``tensor_core`` (``csrc/flash_attention_bwd_tc.cu``: wgmma, TMA, p and
    ds in three bf16 parts) or ``cuda_core``
    (``csrc/flash_attention_bwd.cu``: f32 FMAs).  Each call is three kernel
    launches (four where the tensor-core dK/dV pass splits the query
    heads); ``flash_attention_backward.launches`` counts calls,
    ``flash_attention_backward.launches_by_route`` each route's.  On the
    CPU `flash_attention_backward_reference`, `make_flash`'s ``bwd`` step
    by step.

Each entry has a `torch.library.custom_op` (``repro_torch::
flash_attention``, ``::flash_attention_stats``, ``::flash_attention_backward``)
whose implementation is the device rule above.  Its fake rule (its shape
rule) gives the outputs' shapes, dtypes and strides with no arithmetic, so
the entries run under ``FakeTensorMode`` (the dry run, `launch.dryrun`), and
its flop formula — the ``ops`` of `flash_attention_cost` /
`flash_attention_backward_cost` — lets ``FlopCounterMode`` count the
kernels as the card runs them.  Real tensors with no dispatch mode active
call the implementation directly (`kernels.call_op`), off the dispatcher.
A real tensor never reaches a shape rule; the launch counts and
`flash_route` live in the implementations only.

Semantics kept from the reference: GQA/MQA through kv_head = h // (H/KV);
causal and sliding-window masks from global positions, queries shifted by
``q_offset``; masked scores are NEG_INF = −1e30 (not −inf) and the output
is normalised by max(l, 1e-20), so a row that a window leaves without keys
gets the reference's result (the mean of V); ``scale`` defaults to
d ** −0.5 computed in Python double and applied in f32; f32 inside, the
output in q's dtype.  Unlike the Pallas wrapper, nothing here needs Tq or
Tk to divide a block size: the ragged last tile is masked.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import call_op
from repro_torch.kernels.ref import NEG_INF, keep_mask

_MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head dims d = dv the tensor-core kernels take, and every (d, dv) pair
# they take: those and MLA's q/k 192 with v 128 (every pair in configs/)
TC_HEAD_DIMS = (64, 112, 128, 256)
TC_DIMS = frozenset({(d, d) for d in TC_HEAD_DIMS} | {(192, 128)})
ROUTES = ("tensor_core", "cuda_core")


def flash_route(device_type: str, q_dtype, kv_dtype, d: int, dv: int) -> str:
    """Which version `flash_attention` and `flash_attention_backward`
    run for these inputs: ``"plain"`` on the CPU; on a card
    ``"tensor_core"`` when q, k and v are all bf16 and (d, dv) is one of
    `TC_DIMS`, else ``"cuda_core"``."""
    if device_type == "cpu":
        return "plain"
    if q_dtype == kv_dtype == torch.bfloat16 and (d, dv) in TC_DIMS:
        return "tensor_core"
    return "cuda_core"


def _check(q, k, v, q_offset) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q, k, v must be [B, T, heads, d]")
    B, _, H, d = q.shape
    _, Tk, KV, dk = k.shape
    if (k.shape[0] != B or tuple(v.shape[:3]) != (B, Tk, KV) or dk != d
            or KV == 0 or H % KV):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         f"match (H must be a multiple of KV)")
    if 0 in q.shape or Tk == 0:
        raise ValueError("flash_attention: empty input")
    if max(d, v.shape[-1]) > _MAX_HEAD_DIM:
        raise ValueError(f"flash_attention supports head dims up to "
                         f"{_MAX_HEAD_DIM}, got {d} and {v.shape[-1]}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype not in _DTYPES:
            raise TypeError(f"flash_attention: {name} must be float32 or "
                            f"bfloat16, got {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {x.device}, q "
                             f"on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    if k.dtype != v.dtype:
        raise TypeError(f"flash_attention: k is {k.dtype}, v {v.dtype}")
    if not isinstance(q_offset, int):
        raise TypeError("flash_attention: q_offset must be a Python int")


def _scale(d: int, scale) -> float:
    return float(d ** -0.5) if scale is None else float(scale)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, scale=None) -> torch.Tensor:
    """q: [B, Tq, H, d]; k, v: [B, Tk, KV, d(v)].  Returns [B, Tq, H, dv]
    in q's dtype (see the module docstring)."""
    _check(q, k, v, q_offset)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, q_offset,
                                    scale)
    return call_op(_flash_op, _flash_impl, q, k, v, bool(causal),
                   int(window), q_offset, _scale(q.shape[-1], scale))


def _flash_impl(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int,
                q_offset: int, scale: float) -> Tensor:
    """`flash_attention` without grad: the kernel `flash_route` names, or
    the plain version on the CPU."""
    route = flash_route(q.device.type, q.dtype, k.dtype, q.shape[-1],
                        v.shape[-1])
    if route == "plain":
        return flash_attention_reference(q, k, v, causal=causal,
                                         window=window, q_offset=q_offset,
                                         scale=scale)
    launch = _launch_tc if route == "tensor_core" else _launch
    out = launch(q, k, v, causal, window, q_offset, scale)
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    return out


_flash_op = torch.library.custom_op("repro_torch::flash_attention",
                                    _flash_impl, mutates_args=())


@_flash_op.register_fake
def _flash_shape(q, k, v, causal, window, q_offset, scale):
    return q.new_empty((*q.shape[:3], v.shape[-1]))


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)


def reset_launches() -> None:
    """Set the launch counts of both forward routes and of the backward
    to 0."""
    flash_attention.launches = 0
    flash_attention.launches_by_route.update(dict.fromkeys(ROUTES, 0))
    flash_attention_backward.launches = 0
    flash_attention_backward.launches_by_route.update(
        dict.fromkeys(ROUTES, 0))


class _FlashArgs(ctypes.Structure):
    """Mirrors ``struct FlashArgs`` in csrc/flash_attention.cu."""

    _fields_ = ([(f, ctypes.c_int) for f in (
        "B", "Tq", "Tk", "H", "KV", "d", "dv", "causal", "window",
        "q_offset", "q_bf16", "kv_bf16")] + [("scale", ctypes.c_float)])


def _stats_outputs(q, v):
    """The statistics outputs a forward launch fills: o_f32 [B, Tq, H, dv]
    and m, l [B, H, Tq], all f32."""
    B, Tq, H, _ = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.empty((B, Tq, H, v.shape[-1]), **f32),
            torch.empty((B, H, Tq), **f32), torch.empty((B, H, Tq), **f32))


def _launch(q, k, v, causal, window, q_offset, scale, stats=False):
    """The CUDA-core kernel: out, or (out, o_f32, m, l) with ``stats``."""
    from repro_torch.kernels import _build

    lib = _build.load("flash_attention")
    fn = lib.flash_attention_stats_launch if stats else \
        lib.flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.POINTER(_FlashArgs)]
                   + [ctypes.c_void_p] * (8 if stats else 5))
    B, Tq, H, d = q.shape
    Tk, KV, dv = k.shape[1], k.shape[2], v.shape[-1]
    a = _FlashArgs(B=B, Tq=Tq, Tk=Tk, H=H, KV=KV, d=d, dv=dv,
                   causal=int(bool(causal)), window=int(window),
                   q_offset=q_offset, q_bf16=_DTYPES[q.dtype],
                   kv_bf16=_DTYPES[k.dtype], scale=scale)
    extra = _stats_outputs(q, v) if stats else ()
    # an f32 output is its own f32 copy: one buffer for both
    out = (extra[0] if stats and q.dtype == torch.float32 else
           torch.empty((B, Tq, H, dv), dtype=q.dtype, device=q.device))
    err = fn(ctypes.byref(a), q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), *(t.data_ptr() for t in extra),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {err}")
    return (out, *extra) if stats else out


class _FlashTcArgs(ctypes.Structure):
    """Mirrors ``struct FlashTcArgs`` in csrc/flash_attention_tc.cu."""

    _fields_ = ([(f, ctypes.c_int) for f in (
        "B", "Tq", "Tk", "H", "KV", "d", "dv", "causal", "window",
        "q_offset")] + [("scale", ctypes.c_float)])


def _aligned(x):
    """``x``, copied if its address is not 16-byte aligned (TMA's rule; a
    contiguous slice can start anywhere)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch_tc(q, k, v, causal, window, q_offset, scale, stats=False):
    """The tensor-core kernel: out, or (out, o_f32, m, l) with ``stats``."""
    from repro_torch.kernels import _build

    lib = _build.load("flash_attention_tc")
    fn = lib.flash_attention_tc_stats_launch if stats else \
        lib.flash_attention_tc_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.POINTER(_FlashTcArgs)]
                   + [ctypes.c_void_p] * (8 if stats else 5))
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    B, Tq, H, d = q.shape
    Tk, KV, dv = k.shape[1], k.shape[2], v.shape[-1]
    a = _FlashTcArgs(B=B, Tq=Tq, Tk=Tk, H=H, KV=KV, d=d, dv=dv,
                     causal=int(bool(causal)), window=int(window),
                     q_offset=q_offset, scale=scale)
    out = torch.empty((B, Tq, H, dv), dtype=q.dtype, device=q.device)
    extra = _stats_outputs(q, v) if stats else ()
    err = fn(ctypes.byref(a), q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), *(t.data_ptr() for t in extra),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention tensor-core kernel launch "
                           f"failed: cudaError_t {err}")
    return (out, *extra) if stats else out


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              window: int = 0, q_offset: int = 0, scale=None,
                              block_q: int = 128, block_k: int = 128
                              ) -> torch.Tensor:
    """Plain PyTorch version of `flash_attention`: same arguments and
    output.  Q and KV in blocks (the last ones ragged), every KV block in
    order, running (m, l, acc) in f32 as `ref._flash_fwd_blocks`.  Runs on
    any device; nothing on the main path calls it when a card is present.
    """
    o, _, _ = flash_attention_stats_reference(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        scale=scale, block_q=block_q, block_k=block_k)
    return o.to(q.dtype)


def flash_attention_stats_reference(q, k, v, *, causal: bool = True,
                                    window: int = 0, q_offset: int = 0,
                                    scale=None, block_q: int = 128,
                                    block_k: int = 128):
    """The plain forward with its softmax statistics, as
    `ref._flash_fwd_blocks` returns them: (o_f32 [B, Tq, H, dv], m, l),
    m and l f32 [B, H, Tq] — each row's running max and sum after the last
    KV block (a row with no kept key: m = NEG_INF and l = Tk)."""
    B, Tq, H, d = q.shape
    Tk, KV, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = H // KV
    scale = _scale(d, scale)
    dev = q.device
    kf, vf = k.float(), v.float()
    out = torch.empty((B, Tq, H, dv), dtype=torch.float32, device=dev)
    m_out = torch.empty((B, H, Tq), dtype=torch.float32, device=dev)
    l_out = torch.empty((B, H, Tq), dtype=torch.float32, device=dev)
    for q0 in range(0, Tq, block_q):
        qb = min(block_q, Tq - q0)
        qpos = q_offset + q0 + torch.arange(qb, device=dev)
        qf = q[:, q0:q0 + qb].reshape(B, qb, KV, g, d).float()
        m = torch.full((B, KV, g, qb), NEG_INF, device=dev)
        l = torch.zeros((B, KV, g, qb), device=dev)
        acc = torch.zeros((B, KV, g, qb, dv), device=dev)
        for k0 in range(0, Tk, block_k):
            kb = min(block_k, Tk - k0)
            kpos = k0 + torch.arange(kb, device=dev)
            s = torch.einsum("bqkgd,bskd->bkgqs", qf,
                             kf[:, k0:k0 + kb]) * scale
            s = torch.where(keep_mask(qpos, kpos, causal, window)
                            [None, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, vf[:, k0:k0 + kb])
            m = m_new
        o = acc / torch.clamp(l, min=1e-20)[..., None]
        out[:, q0:q0 + qb] = o.permute(0, 3, 1, 2, 4).reshape(B, qb, H, dv)
        m_out[:, :, q0:q0 + qb] = m.reshape(B, H, qb)
        l_out[:, :, q0:q0 + qb] = l.reshape(B, H, qb)
    return out, m_out, l_out


def flash_attention_backward_reference(q, k, v, o, m, l, do, *,
                                       causal: bool = True, window: int = 0,
                                       q_offset: int = 0, scale=None,
                                       block_q: int = 128,
                                       block_k: int = 128):
    """Plain PyTorch version of `flash_attention_backward`: the backward of
    `ref.make_flash` (its ``bwd``) step by step, over ragged blocks.

    ``o`` is the forward's f32 output and (m, l) its statistics, as
    `flash_attention_stats_reference` returns them; ``do`` the output's
    gradient.  Per Q block D = Σ do·o; per (Q block, KV block) the scores
    are recomputed (masked ones NEG_INF), p = exp(s − m) / max(l, 1e-20),
    dp = do·vᵀ and ds = p·(dp − D)·scale; dq += ds·k, dk += dsᵀ·q and
    dv += pᵀ·do, dk and dv summed over the g query heads of each KV head.
    Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    B, Tq, H, d = q.shape
    Tk, KV, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = H // KV
    sc = _scale(d, scale)
    dev = q.device
    kf, vf = k.float(), v.float()
    dq = torch.empty((B, Tq, H, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, Tk, KV, d), dtype=torch.float32, device=dev)
    dvv = torch.zeros((B, Tk, KV, dv), dtype=torch.float32, device=dev)
    for q0 in range(0, Tq, block_q):
        qb = min(block_q, Tq - q0)
        qpos = q_offset + q0 + torch.arange(qb, device=dev)
        rows = slice(q0, q0 + qb)
        qf = q[:, rows].reshape(B, qb, KV, g, d).float()
        dof = do[:, rows].reshape(B, qb, KV, g, dv).float()
        of = o[:, rows].reshape(B, qb, KV, g, dv).float()
        mb = m[:, :, rows].reshape(B, KV, g, qb)
        lb = l[:, :, rows].reshape(B, KV, g, qb)
        Drow = torch.einsum("bqkgd,bqkgd->bkgq", dof, of)
        dq_blk = torch.zeros((B, qb, KV, g, d), device=dev)
        for k0 in range(0, Tk, block_k):
            kb = min(block_k, Tk - k0)
            cols = slice(k0, k0 + kb)
            kpos = k0 + torch.arange(kb, device=dev)
            s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf[:, cols]) * sc
            s = torch.where(keep_mask(qpos, kpos, causal, window)
                            [None, None, None], s, NEG_INF)
            p = torch.exp(s - mb[..., None]) / torch.clamp(
                lb, min=1e-20)[..., None]
            dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf[:, cols])
            ds = p * (dp - Drow[..., None]) * sc
            dq_blk = dq_blk + torch.einsum("bkgqs,bskd->bqkgd", ds,
                                           kf[:, cols])
            dk[:, cols] += torch.einsum("bkgqs,bqkgd->bskd", ds, qf)
            dvv[:, cols] += torch.einsum("bkgqs,bqkgd->bskd", p, dof)
        dq[:, rows] = dq_blk.reshape(B, qb, H, d)
    return dq.to(q.dtype), dk.to(k.dtype), dvv.to(v.dtype)


def flash_attention_stats(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: int = 0, scale=None):
    """The forward with its statistics: (out in q's dtype, o_f32, m, l).
    On a card the route's kernel with its statistics output (one forward
    launch, counted by route); on the CPU the plain version, out being
    o_f32 cast to q's dtype, as the reference's ``fwd`` returns it."""
    _check(q, k, v, q_offset)
    o, m, l, out = call_op(_flash_stats_op, _flash_stats_impl, q, k, v,
                           bool(causal), int(window), q_offset,
                           _scale(q.shape[-1], scale))
    return (o if q.dtype == torch.float32 else out), o, m, l


def _flash_stats_impl(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                      window: int, q_offset: int, scale: float
                      ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """(o_f32, m, l, out): ``out`` in q's dtype, empty for f32 q, whose
    output is o_f32 itself (an op's outputs may not alias)."""
    route = flash_route(q.device.type, q.dtype, k.dtype, q.shape[-1],
                        v.shape[-1])
    if route == "plain":
        o, m, l = flash_attention_stats_reference(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            scale=scale)
    else:
        launch = _launch_tc if route == "tensor_core" else _launch
        out, o, m, l = launch(q, k, v, causal, window, q_offset, scale,
                              stats=True)
        flash_attention.launches += 1
        flash_attention.launches_by_route[route] += 1
    if q.dtype == torch.float32:
        return o, m, l, q.new_empty((0,))
    return o, m, l, (o.to(q.dtype) if route == "plain" else out)


_flash_stats_op = torch.library.custom_op(
    "repro_torch::flash_attention_stats", _flash_stats_impl, mutates_args=())


@_flash_stats_op.register_fake
def _flash_stats_shape(q, k, v, causal, window, q_offset, scale):
    o, m, l = _stats_outputs(q, v)
    out = (q.new_empty((0,)) if q.dtype == torch.float32
           else q.new_empty(o.shape))
    return o, m, l, out


class _FlashBwdArgs(ctypes.Structure):
    """Mirrors ``struct FlashBwdArgs`` in csrc/flash_attention_bwd.cu."""

    _fields_ = ([(f, ctypes.c_int) for f in (
        "B", "Tq", "Tk", "H", "KV", "d", "dv", "causal", "window",
        "q_offset", "q_bf16", "kv_bf16")] + [("scale", ctypes.c_float)])


def flash_attention_backward(q, k, v, o, m, l, do, *, causal: bool = True,
                             window: int = 0, q_offset: int = 0,
                             scale=None):
    """(dq, dk, dv) of `flash_attention` from the forward's saved
    (q, k, v, o_f32, m, l) and the output's gradient ``do`` (made
    contiguous here: autograd may hand it over strided).  On a card the
    kernel `flash_route` names — ``csrc/flash_attention_bwd_tc.cu`` or
    ``csrc/flash_attention_bwd.cu``, three launches each (the row pass,
    the dK/dV pass, the dQ pass; a fourth adds the tensor-core dK/dV
    pass's partial sums where it splits the query heads), counted once in
    ``flash_attention_backward.launches`` and in its route's
    ``launches_by_route`` — or raises; on the CPU the plain version."""
    do = do.contiguous()
    _check(q, k, v, q_offset)
    B, Tq, H, d = q.shape
    dv = v.shape[-1]
    for name, t, shape in (("o", o, (B, Tq, H, dv)), ("m", m, (B, H, Tq)),
                           ("l", l, (B, H, Tq))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"flash_attention_backward: {name} must be "
                             f"contiguous f32 {shape} on {q.device}")
    if tuple(do.shape) != (B, Tq, H, dv) or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_backward: do must be {q.dtype} "
                         f"{(B, Tq, H, dv)}, got {do.dtype} "
                         f"{tuple(do.shape)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention_backward runs on cuda or cpu, "
                         f"got {q.device}")
    return call_op(_flash_bwd_op, _flash_bwd_impl, q, k, v, o, m, l, do,
                   bool(causal), int(window), q_offset, _scale(d, scale))


def _flash_bwd_impl(q: Tensor, k: Tensor, v: Tensor, o: Tensor, m: Tensor,
                    l: Tensor, do: Tensor, causal: bool, window: int,
                    q_offset: int, scale: float
                    ) -> tuple[Tensor, Tensor, Tensor]:
    if q.device.type == "cpu":
        return flash_attention_backward_reference(
            q, k, v, o, m, l, do, causal=causal, window=window,
            q_offset=q_offset, scale=scale)
    route = flash_route("cuda", q.dtype, k.dtype, q.shape[-1], v.shape[-1])
    launch = _launch_bwd_tc if route == "tensor_core" else _launch_bwd
    grads = launch(q, k, v, o, m, l, do, causal, window, q_offset, scale)
    flash_attention_backward.launches += 1
    flash_attention_backward.launches_by_route[route] += 1
    return grads


_flash_bwd_op = torch.library.custom_op(
    "repro_torch::flash_attention_backward", _flash_bwd_impl,
    mutates_args=())


@_flash_bwd_op.register_fake
def _flash_bwd_shape(q, k, v, o, m, l, do, causal, window, q_offset, scale):
    return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))


flash_attention_backward.launches = 0
flash_attention_backward.launches_by_route = dict.fromkeys(ROUTES, 0)


def _launch_bwd(q, k, v, o, m, l, do, causal, window, q_offset, scale):
    """The CUDA-core backward: (dq, dk, dv)."""
    from repro_torch.kernels import _build

    fn = _build.load("flash_attention_bwd").flash_attention_bwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_FlashBwdArgs)] + [ctypes.c_void_p] * 12
    B, Tq, H, d = q.shape
    Tk, KV, dv = k.shape[1], k.shape[2], v.shape[-1]
    a = _FlashBwdArgs(B=B, Tq=Tq, Tk=Tk, H=H, KV=KV, d=d, dv=dv,
                      causal=int(bool(causal)), window=int(window),
                      q_offset=q_offset, q_bf16=_DTYPES[q.dtype],
                      kv_bf16=_DTYPES[k.dtype], scale=scale)
    dq, dk, dvv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    err = fn(ctypes.byref(a), *(t.data_ptr() for t in (
        q, k, v, o, m, l, do, delta, dq, dk, dvv)),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch "
                           f"failed: cudaError_t {err}")
    return dq, dk, dvv


class _FlashBwdTcArgs(ctypes.Structure):
    """Mirrors ``struct FlashBwdTcArgs`` in csrc/flash_attention_bwd_tc.cu."""

    _fields_ = ([(f, ctypes.c_int) for f in (
        "B", "Tq", "Tk", "H", "KV", "d", "dv", "causal", "window",
        "q_offset")] + [("scale", ctypes.c_float)])


def _launch_bwd_tc(q, k, v, o, m, l, do, causal, window, q_offset, scale):
    """The tensor-core backward: (dq, dk, dv), with a row-record scratch
    of the library's size."""
    from repro_torch.kernels import _build

    lib = _build.load("flash_attention_bwd_tc")
    fn = lib.flash_attention_bwd_tc_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_FlashBwdTcArgs)] + [ctypes.c_void_p] * 12
    size = lib.flash_attention_bwd_tc_scratch_floats
    size.restype = ctypes.c_longlong
    size.argtypes = [ctypes.POINTER(_FlashBwdTcArgs)]
    q, k, v, do = _aligned(q), _aligned(k), _aligned(v), _aligned(do)
    B, Tq, H, d = q.shape
    Tk, KV, dv = k.shape[1], k.shape[2], v.shape[-1]
    a = _FlashBwdTcArgs(B=B, Tq=Tq, Tk=Tk, H=H, KV=KV, d=d, dv=dv,
                        causal=int(bool(causal)), window=int(window),
                        q_offset=q_offset, scale=scale)
    dq, dk, dvv = (torch.empty_like(t) for t in (q, k, v))
    rec = torch.empty(size(ctypes.byref(a)), dtype=torch.float32,
                      device=q.device)
    err = fn(ctypes.byref(a), *(t.data_ptr() for t in (
        q, k, v, o, m, l, do, rec, dq, dk, dvv)),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention tensor-core backward kernel "
                           f"launch failed: cudaError_t {err}")
    return dq, dk, dvv


class FlashAttention(torch.autograd.Function):
    """`flash_attention` with its gradient: the reference's
    ``make_flash`` custom VJP.  Forward: `flash_attention_stats`; saved:
    (q, k, v, o_f32, m, l); backward: `flash_attention_backward`.  Both
    are looked up in this module when called, so a caller may point them
    at the plain versions on a card."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale):
        out, o, m, l = flash_attention_stats(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            scale=scale)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.args = dict(causal=causal, window=window, q_offset=q_offset,
                        scale=scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, m, l, do,
                                              **ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention_cost(q, k, v, *, causal: bool = True, window: int = 0,
                         q_offset: int = 0) -> dict:
    """Bytes and operations `flash_attention` must spend on these inputs.

    Bytes: q, k, v read once and the output written once.  Operations:
    for each kept (query, key) pair of each head — the pairs this mask
    keeps, not the full square — 2·d for the score and 2·dv for the
    weighted value, plus four for scale, max, exp and sum.
    """
    B, Tq, H, d = q.shape
    Tk, dv = k.shape[1], v.shape[-1]
    kept = kept_pairs(Tq, Tk, causal=causal, window=window,
                      q_offset=q_offset)
    nbytes = (q.numel() * q.element_size() + k.numel() * k.element_size()
              + v.numel() * v.element_size() + B * Tq * H * dv
              * q.element_size())
    return {"bytes": nbytes, "ops": B * H * kept * (2 * d + 2 * dv + 4),
            "pairs": kept}


def flash_attention_backward_cost(q, k, v, *, causal: bool = True,
                                  window: int = 0, q_offset: int = 0) -> dict:
    """Bytes and operations `flash_attention_backward` must spend on these
    inputs.

    Bytes: q, k, v, the output's gradient (q's dtype), the f32 output and
    m, l read once; dq, dk, dv written once.  Operations: for each kept
    (query, key) pair of each head — the pairs this mask keeps — the five
    products (scores and do·vᵀ: 2·d + 2·dv; dv, dk, dq: 2·dv + 4·d) and
    six for the scale, exp, normalisation and ds; plus 2·dv a row for D.
    """
    B, Tq, H, d = q.shape
    dv = v.shape[-1]
    fwd = flash_attention_cost(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    rows = B * Tq * H
    nbytes = (2 * (q.numel() * q.element_size() + k.numel() * k.element_size()
                   + v.numel() * v.element_size())
              + rows * dv * (q.element_size() + 4) + 2 * rows * 4)
    return {"bytes": nbytes,
            "ops": B * H * fwd["pairs"] * (6 * d + 4 * dv + 6) + rows * 2 * dv,
            "pairs": fwd["pairs"]}


def kept_pairs(Tq: int, Tk: int, *, causal: bool = True, window: int = 0,
               q_offset: int = 0) -> int:
    """The (query, key) pairs `keep_mask` keeps, counted on the host from
    the bounds of each row's kept span (no tensor: a shape rule's flop
    formula runs under ``FakeTensorMode``)."""
    p = q_offset + np.arange(Tq, dtype=np.int64)
    hi = np.minimum(p, Tk - 1) if causal else np.full(Tq, Tk - 1)
    lo = np.maximum(p - window + 1, 0) if window else np.zeros(Tq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _flops(cost, *names):
    """A flop formula for ``FlopCounterMode`` from a cost function: the
    op's positional ``names`` bound to their values, ``cost(...)["ops"]``."""
    def formula(*args, out_val=None, **kwargs):
        kw = dict(zip(names, args), **kwargs)
        return cost(**kw)["ops"]
    return formula


register_flop_formula(torch.ops.repro_torch.flash_attention, get_raw=True)(
    _flops(lambda q, k, v, causal, window, q_offset, scale:
           flash_attention_cost(q, k, v, causal=causal, window=window,
                                q_offset=q_offset),
           "q", "k", "v", "causal", "window", "q_offset", "scale"))
register_flop_formula(torch.ops.repro_torch.flash_attention_stats,
                      get_raw=True)(
    _flops(lambda q, k, v, causal, window, q_offset, scale:
           flash_attention_cost(q, k, v, causal=causal, window=window,
                                q_offset=q_offset),
           "q", "k", "v", "causal", "window", "q_offset", "scale"))
register_flop_formula(torch.ops.repro_torch.flash_attention_backward,
                      get_raw=True)(
    _flops(lambda q, k, v, o, m, l, do, causal, window, q_offset, scale:
           flash_attention_backward_cost(q, k, v, causal=causal,
                                         window=window, q_offset=q_offset),
           "q", "k", "v", "o", "m", "l", "do", "causal", "window",
           "q_offset", "scale"))
