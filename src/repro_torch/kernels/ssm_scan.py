"""Chunked linear-recurrence "SSD" (the Mamba2 / RWKV6 core).

    h_t = d_t ⊙ h_{t−1} + b_t ⊗ x_t,      y_t = c_t · h_t

Port of the TPU kernel `repro.kernels.ssm_scan.ssd` (Pallas body
`_kernel`), with its plain version.

  * `ssd` — the wrapper.  On CUDA tensors it launches the hand-written
    Hopper kernel (``csrc/ssd.cu``: one block per (head, batch) walking
    the chunks in order with the [N, P] state in shared memory) or raises;
    on CPU tensors it runs `ssd_reference`.  ``ssd.launches`` counts kernel
    launches.  Like the Pallas wrapper it halves ``chunk`` until it divides
    T, and hands that chunk to either version.
  * `ssd_reference` — the plain PyTorch version: `repro.kernels.ref.
    chunked_ssd` op for op (it keeps that function's assert that the chunk
    divides T).

Per chunk both compute, in f32: the inclusive log-decay cumsum L; ĉ = c·e^L,
b̂ = b·e^{−L}, b̃ = b·e^{L_C − L}; the masked [C, C] scores ĉ·b̂ᵀ (s ≤ t with
``include_current``, s < t without) times x; the optional per-head bonus
(c·u·b)·x; the inter-chunk read ĉ·h; then h ← e^{L_C}·h + b̃ᵀx.  The
factorisation is stable for per-step decay ≳ 0.55 at chunk 64, as in the
reference.  y comes back in x's dtype, the final state in f32.  d, b, c
and x may each be f32 or bf16 (Mamba2 at bf16 passes f32 d and b, bf16 c
and x).
"""
from __future__ import annotations

import ctypes

import torch

_MAX_CHUNK = 64
_MAX_N = 64
_MAX_P = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def chunk_for(T: int, chunk: int) -> int:
    """The Pallas wrapper's chunk: min(chunk, T), halved until it divides
    T."""
    ck = min(chunk, T)
    while T % ck:
        ck //= 2
    return ck


def _check(d, b, x, c, u, h0) -> None:
    if d.ndim != 4 or x.ndim != 4:
        raise ValueError("ssd: d, b, c must be [B, T, H, N], x [B, T, H, P]")
    B, T, H, N = d.shape
    P = x.shape[-1]
    if 0 in d.shape or P == 0:
        raise ValueError(f"ssd: empty input {tuple(d.shape)}")
    for name, t in (("b", b), ("c", c)):
        if tuple(t.shape) != (B, T, H, N):
            raise ValueError(f"ssd: {name} must be {(B, T, H, N)}, got "
                             f"{tuple(t.shape)}")
    if tuple(x.shape[:3]) != (B, T, H):
        raise ValueError(f"ssd: x must be [{B}, {T}, {H}, P], got "
                         f"{tuple(x.shape)}")
    if N > _MAX_N or P > _MAX_P:
        raise ValueError(f"ssd supports N <= {_MAX_N} and P <= {_MAX_P}, "
                         f"got N={N}, P={P}")
    for name, t, shape, dtypes in (
            ("d", d, None, _DTYPES), ("b", b, None, _DTYPES),
            ("x", x, None, _DTYPES), ("c", c, None, _DTYPES),
            ("u", u, (H, N), (torch.float32,)),
            ("h0", h0, (B, H, N, P), (torch.float32,))):
        if t is None:
            continue
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"ssd: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype not in dtypes:
            raise TypeError(f"ssd: {name} has dtype {t.dtype}, want one of "
                            f"{list(dtypes)}")
        if t.device != d.device:
            raise ValueError(f"ssd: {name} is on {t.device}, d on "
                             f"{d.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd: {name} must be contiguous")


def ssd(d, b, x, c, *, u=None, h0=None, chunk: int = 64,
        include_current: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """d, b, c: [B, T, H, N]; x: [B, T, H, P]; u: [H, N] f32; h0:
    [B, H, N, P] f32.  Returns (y [B, T, H, P] in x's dtype, hT
    [B, H, N, P] f32).  See the module docstring."""
    _check(d, b, x, c, u, h0)
    ck = chunk_for(d.shape[1], chunk)
    if d.device.type == "cpu":
        return ssd_reference(d, b, x, c, u=u, h0=h0, chunk=ck,
                             include_current=include_current)
    if d.device.type != "cuda":
        raise ValueError(f"ssd runs on cuda or cpu, got {d.device}")
    if ck > _MAX_CHUNK:
        raise ValueError(f"ssd: chunk {ck} > {_MAX_CHUNK}")
    return _launch(d, b, x, c, u, h0, ck, include_current)


ssd.launches = 0


class _SsdArgs(ctypes.Structure):
    """Mirrors ``struct SsdArgs`` in csrc/ssd.cu."""

    _fields_ = [(f, ctypes.c_int) for f in (
        "B", "T", "H", "N", "P", "chunk", "include_current", "has_u",
        "has_h0", "d_bf16", "b_bf16", "x_bf16", "c_bf16")]


def _launch(d, b, x, c, u, h0, ck, include_current):
    from repro_torch.kernels import _build

    fn = _build.load("ssd").ssd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_SsdArgs)] + [ctypes.c_void_p] * 9
    B, T, H, N = d.shape
    P = x.shape[-1]
    a = _SsdArgs(B=B, T=T, H=H, N=N, P=P, chunk=ck,
                 include_current=int(bool(include_current)),
                 has_u=int(u is not None), has_h0=int(h0 is not None),
                 d_bf16=_DTYPES[d.dtype], b_bf16=_DTYPES[b.dtype],
                 x_bf16=_DTYPES[x.dtype], c_bf16=_DTYPES[c.dtype])
    y = torch.empty_like(x)
    hT = torch.empty((B, H, N, P), dtype=torch.float32, device=d.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = fn(ctypes.byref(a), d.data_ptr(), b.data_ptr(), x.data_ptr(),
             c.data_ptr(), ptr(u), ptr(h0), y.data_ptr(), hT.data_ptr(),
             torch.cuda.current_stream(d.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed: cudaError_t {err}")
    ssd.launches += 1
    return y, hT


def ssd_reference(d, b, x, c, *, u=None, h0=None, chunk: int = 64,
                  include_current: bool = True
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `ssd`: `repro.kernels.ref.chunked_ssd` op
    for op, on any device.  Nothing on the main path calls it when a card
    is present."""
    B, T, H, N = d.shape
    P = x.shape[-1]
    nc = T // chunk
    assert nc * chunk == T, f"T={T} not divisible by chunk={chunk}"
    f32 = torch.float32
    dr = d.reshape(B, nc, chunk, H, N).to(f32)
    br = b.reshape(B, nc, chunk, H, N).to(f32)
    xr = x.reshape(B, nc, chunk, H, P).to(f32)
    cr = c.reshape(B, nc, chunk, H, N).to(f32)

    L = torch.cumsum(torch.log(torch.clamp(dr, min=1e-20)), dim=2)
    Lc = L[:, :, -1]                                  # [B, nc, H, N]
    c_hat = cr * torch.exp(L)
    b_hat = br * torch.exp(-L)
    b_tld = br * torch.exp(Lc[:, :, None] - L)

    scores = torch.einsum("bgthn,bgshn->bghts", c_hat, b_hat)
    t_idx = torch.arange(chunk, device=d.device)[:, None]
    s_idx = torch.arange(chunk, device=d.device)[None, :]
    keep = (s_idx <= t_idx) if include_current else (s_idx < t_idx)
    scores = torch.where(keep[None, None, None], scores, 0.0)
    y = torch.einsum("bghts,bgshp->bgthp", scores, xr)
    if u is not None:
        su = torch.einsum("bgthn,hn,bgthn->bgth", cr, u.to(f32), br)
        y = y + su[..., None] * xr

    h = (torch.zeros((B, H, N, P), dtype=f32, device=d.device)
         if h0 is None else h0.to(f32))
    y_inter = []
    for g in range(nc):
        y_inter.append(torch.einsum("bthn,bhnp->bthp", c_hat[:, g], h))
        h = (torch.exp(Lc[:, g])[..., None] * h
             + torch.einsum("bshn,bshp->bhnp", b_tld[:, g], xr[:, g]))
    y = y + torch.stack(y_inter, 1)
    return y.reshape(B, T, H, P).to(x.dtype), h


def ssd_cost(d, b, x, c, u=None, h0=None) -> dict:
    """Bytes and operations `ssd` must spend on these inputs.

    Bytes: d, b, c, x (and u, h0) read once, y and the final state written
    once.  Operations per (batch, head) chunk of C steps: the four
    products 2·C·C·N (scores, of which the masked half is needed but
    counted whole as the algorithm forms it), 2·C·C·P (scores·x), 2·C·N·P
    (ĉ·h) and 2·C·N·P (b̃ᵀx), the state decay N·P, and ~8·C·N for the
    log, cumsum and three exponentials.
    """
    B, T, H, N = d.shape
    P = x.shape[-1]
    ck = chunk_for(T, 64)
    per_chunk = (2 * ck * ck * N + 2 * ck * ck * P + 4 * ck * N * P
                 + N * P + 8 * ck * N)
    size = lambda t: 0 if t is None else t.numel() * t.element_size()
    nbytes = (size(d) + size(b) + size(c) + size(x) + size(u) + size(h0)
              + size(x) + B * H * N * P * 4)
    return {"bytes": nbytes, "ops": B * H * (T // ck) * per_chunk}
