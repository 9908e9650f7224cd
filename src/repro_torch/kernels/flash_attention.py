"""Blocked online-softmax (flash) attention forward.

Port of the TPU kernel `repro.kernels.flash_attention.flash_attention`
(Pallas body `_kernel`), with its plain version.

  * `flash_attention` — the wrapper.  On CUDA tensors it launches one of
    two hand-written Hopper kernels, as `flash_route` says, or raises; on
    CPU tensors it runs `flash_attention_reference`.
      - ``tensor_core`` (``csrc/flash_attention_tc.cu``): bf16 q, k and v
        with d = dv ∈ {64, 112, 128, 256} — the serving path.  wgmma on
        the tensor cores, TMA loads into a K/V ring, a producer warp and
        two consumer warpgroups.
      - ``cuda_core`` (``csrc/flash_attention.cu``): every other input
        (f32 or mixed types, other head dims).  f32 FMAs on the CUDA
        cores, no TF32: the f32 bounds rest on it.
    The route depends on dtypes and shapes only, never on a failure.
    ``flash_attention.launches`` counts launches of both kernels,
    ``flash_attention.launches_by_route`` each route's.
  * `flash_attention_reference` — the plain PyTorch version: the blocked
    online softmax of `repro.kernels.ref._flash_fwd_blocks`, every KV block
    of every Q block in order.

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

import torch

from repro_torch.kernels.ref import NEG_INF, keep_mask

_MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head dims the tensor-core kernel takes (every one in configs/)
TC_HEAD_DIMS = (64, 112, 128, 256)
ROUTES = ("tensor_core", "cuda_core")


def flash_route(device_type: str, q_dtype, kv_dtype, d: int, dv: int) -> str:
    """Which version `flash_attention` runs for these inputs: ``"plain"``
    on the CPU; on a card ``"tensor_core"`` when q, k and v are all bf16
    and d = dv is one of `TC_HEAD_DIMS`, else ``"cuda_core"``."""
    if device_type == "cpu":
        return "plain"
    if (q_dtype == kv_dtype == torch.bfloat16 and d == dv
            and d in TC_HEAD_DIMS):
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
    route = flash_route(q.device.type, q.dtype, k.dtype, q.shape[-1],
                        v.shape[-1])
    if route == "plain":
        return flash_attention_reference(q, k, v, causal=causal,
                                         window=window, q_offset=q_offset,
                                         scale=scale)
    launch = _launch_tc if route == "tensor_core" else _launch
    out = launch(q, k, v, causal, window, q_offset,
                 _scale(q.shape[-1], scale))
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)


def reset_launches() -> None:
    """Set the launch counts of both routes to 0."""
    flash_attention.launches = 0
    flash_attention.launches_by_route.update(dict.fromkeys(ROUTES, 0))


class _FlashArgs(ctypes.Structure):
    """Mirrors ``struct FlashArgs`` in csrc/flash_attention.cu."""

    _fields_ = ([(f, ctypes.c_int) for f in (
        "B", "Tq", "Tk", "H", "KV", "d", "dv", "causal", "window",
        "q_offset", "q_bf16", "kv_bf16")] + [("scale", ctypes.c_float)])


def _launch(q, k, v, causal, window, q_offset, scale):
    from repro_torch.kernels import _build

    fn = _build.load("flash_attention").flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_FlashArgs)] + [ctypes.c_void_p] * 5
    B, Tq, H, d = q.shape
    Tk, KV, dv = k.shape[1], k.shape[2], v.shape[-1]
    a = _FlashArgs(B=B, Tq=Tq, Tk=Tk, H=H, KV=KV, d=d, dv=dv,
                   causal=int(bool(causal)), window=int(window),
                   q_offset=q_offset, q_bf16=_DTYPES[q.dtype],
                   kv_bf16=_DTYPES[k.dtype], scale=scale)
    out = torch.empty((B, Tq, H, dv), dtype=q.dtype, device=q.device)
    err = fn(ctypes.byref(a), q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {err}")
    return out


class _FlashTcArgs(ctypes.Structure):
    """Mirrors ``struct FlashTcArgs`` in csrc/flash_attention_tc.cu."""

    _fields_ = ([(f, ctypes.c_int) for f in (
        "B", "Tq", "Tk", "H", "KV", "d", "causal", "window", "q_offset")]
        + [("scale", ctypes.c_float)])


def _aligned(x):
    """``x``, copied if its address is not 16-byte aligned (TMA's rule; a
    contiguous slice can start anywhere)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch_tc(q, k, v, causal, window, q_offset, scale):
    from repro_torch.kernels import _build

    fn = _build.load("flash_attention_tc").flash_attention_tc_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_FlashTcArgs)] + [ctypes.c_void_p] * 5
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    B, Tq, H, d = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    a = _FlashTcArgs(B=B, Tq=Tq, Tk=Tk, H=H, KV=KV, d=d,
                     causal=int(bool(causal)), window=int(window),
                     q_offset=q_offset, scale=scale)
    out = torch.empty((B, Tq, H, d), dtype=q.dtype, device=q.device)
    err = fn(ctypes.byref(a), q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention tensor-core kernel launch "
                           f"failed: cudaError_t {err}")
    return out


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              window: int = 0, q_offset: int = 0, scale=None,
                              block_q: int = 128, block_k: int = 128
                              ) -> torch.Tensor:
    """Plain PyTorch version of `flash_attention`: same arguments and
    output.  Q and KV in blocks (the last ones ragged), every KV block in
    order, running (m, l, acc) in f32 as `ref._flash_fwd_blocks`.  Runs on
    any device; nothing on the main path calls it when a card is present.
    """
    B, Tq, H, d = q.shape
    Tk, KV, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = H // KV
    scale = _scale(d, scale)
    dev = q.device
    kf, vf = k.float(), v.float()
    out = torch.empty((B, Tq, H, dv), dtype=torch.float32, device=dev)
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
    return out.to(q.dtype)


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
    qpos = q_offset + torch.arange(Tq)
    kept = int(keep_mask(qpos, torch.arange(Tk), causal, window).sum())
    nbytes = (q.numel() * q.element_size() + k.numel() * k.element_size()
              + v.numel() * v.element_size() + B * Tq * H * dv
              * q.element_size())
    return {"bytes": nbytes, "ops": B * H * kept * (2 * d + 2 * dv + 4),
            "pairs": kept}
