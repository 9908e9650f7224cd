"""Chunked linear-recurrence "SSD" (the Mamba2 / RWKV6 core).

    h_t = d_t ⊙ h_{t−1} + b_t ⊗ x_t,      y_t = c_t · h_t

Port of the TPU kernel `repro.kernels.ssm_scan.ssd` (Pallas body
`_kernel`), with its plain version and its gradient.

  * `ssd` — the wrapper.  On CUDA tensors it launches the hand-written
    Hopper kernel (``csrc/ssd.cu``: one block per (head, batch) walking
    the chunks in order with the [N, P] state in shared memory) or raises;
    on CPU tensors it runs `ssd_reference`.  ``ssd.launches`` counts kernel
    launches.  Like the Pallas wrapper it halves ``chunk`` until it divides
    T, and hands that chunk to either version.  With grad mode on and an
    input that requires grad it goes through `SsdFunction` on either
    device, so its output always carries a graph.
  * `ssd_reference` — the plain PyTorch version: `repro.kernels.ref.
    chunked_ssd` op for op (it keeps that function's assert that the chunk
    divides T); with ``states=True`` it also returns the state entering
    each chunk.
  * `SsdFunction` — the gradient, as the reference gets it from XLA's
    differentiation of ``chunked_ssd``: forward `ssd_states` (the kernel's
    variant that also writes the chunk states hs [B, nc, H, N, P] f32, or
    the plain version on the CPU), backward `ssd_backward` (``csrc/
    ssd_bwd.cu``: a reverse walk over the chunks for the state gradient,
    then every other gradient chunk-parallel, the chunk products on the
    tensor cores in 3×TF32; `ssd_backward_reference` on the CPU).

Each entry has a `torch.library.custom_op` (``repro_torch::ssd``,
``::ssd_states``, ``::ssd_backward``) whose implementation is the device
rule above; its fake rule (its shape rule) gives the outputs' shapes,
dtypes and strides with no arithmetic, for ``FakeTensorMode`` (the dry run,
`launch.dryrun`), and its flop formula — `ssd_cost` / `ssd_backward_cost`
— lets ``FlopCounterMode`` count the kernel as the card runs it.  Real
tensors with no dispatch mode active call the implementation directly
(`kernels.call_op`), off the dispatcher.  A real tensor never reaches a
shape rule.

Per chunk both compute, in f32: the inclusive log-decay cumsum L; ĉ = c·e^L,
b̂ = b·e^{−L}, b̃ = b·e^{L_C − L}; the masked [C, C] scores ĉ·b̂ᵀ (s ≤ t with
``include_current``, s < t without) times x; the optional per-head bonus
(c·u·b)·x; the inter-chunk read ĉ·h; then h ← e^{L_C}·h + b̃ᵀx.  The
factorisation is stable for per-step decay ≳ 0.55 at chunk 64, as in the
reference.  y comes back in x's dtype, the final state in f32.  d, b, c
and x may each be f32 or bf16 (Mamba2 at bf16 passes f32 d and b, bf16 c
and x); each gradient comes back in its input's dtype.
"""
from __future__ import annotations

import ctypes

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import call_op

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
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (d, b, x, c, u, h0)):
        return SsdFunction.apply(d, b, x, c, u, h0, ck, include_current)
    _check_device(d, ck)
    return call_op(_ssd_op, _ssd_impl, d, b, x, c, u, h0, ck,
                   bool(include_current))


def _ssd_impl(d: Tensor, b: Tensor, x: Tensor, c: Tensor, u: Tensor | None,
              h0: Tensor | None, chunk: int, include_current: bool
              ) -> tuple[Tensor, Tensor]:
    if d.device.type == "cpu":
        return ssd_reference(d, b, x, c, u=u, h0=h0, chunk=chunk,
                             include_current=include_current)
    return _launch(d, b, x, c, u, h0, chunk, include_current)


_ssd_op = torch.library.custom_op("repro_torch::ssd", _ssd_impl,
                                  mutates_args=())


@_ssd_op.register_fake
def _ssd_shape(d, b, x, c, u, h0, chunk, include_current):
    return _forward_shapes(d, x, chunk)[:2]


def _forward_shapes(d, x, chunk):
    """The forward's outputs as a launch allocates them: y like x, hT
    [B, H, N, P] f32 and the chunk states hs [B, nc, H, N, P] f32."""
    B, T, H, N = d.shape
    P = x.shape[-1]
    f32 = dict(dtype=torch.float32, device=d.device)
    return (torch.empty_like(x), torch.empty((B, H, N, P), **f32),
            torch.empty((B, T // chunk, H, N, P), **f32))


ssd.launches = 0


def _check_device(d, ck) -> None:
    if d.device.type == "cpu":
        return
    if d.device.type != "cuda":
        raise ValueError(f"ssd runs on cuda or cpu, got {d.device}")
    if ck > _MAX_CHUNK:
        raise ValueError(f"ssd: chunk {ck} > {_MAX_CHUNK}")


def ssd_states(d, b, x, c, *, u=None, h0=None, chunk: int = 64,
               include_current: bool = True):
    """The forward that keeps the chunk states: (y, hT, hs), hs [B, nc, H,
    N, P] f32 the state entering each chunk (hs[:, 0] is h0, or zeros).
    On a card the kernel's states variant (one launch, counted in
    ``ssd.launches``; its y and hT are the serving launch's bit for bit),
    on the CPU `ssd_reference` with ``states=True``."""
    _check(d, b, x, c, u, h0)
    ck = chunk_for(d.shape[1], chunk)
    _check_device(d, ck)
    return call_op(_ssd_states_op, _ssd_states_impl, d, b, x, c, u, h0, ck,
                   bool(include_current))


def _ssd_states_impl(d: Tensor, b: Tensor, x: Tensor, c: Tensor,
                     u: Tensor | None, h0: Tensor | None, chunk: int,
                     include_current: bool
                     ) -> tuple[Tensor, Tensor, Tensor]:
    if d.device.type == "cpu":
        return ssd_reference(d, b, x, c, u=u, h0=h0, chunk=chunk,
                             include_current=include_current, states=True)
    return _launch(d, b, x, c, u, h0, chunk, include_current, states=True)


_ssd_states_op = torch.library.custom_op("repro_torch::ssd_states",
                                         _ssd_states_impl, mutates_args=())


@_ssd_states_op.register_fake
def _ssd_states_shape(d, b, x, c, u, h0, chunk, include_current):
    return _forward_shapes(d, x, chunk)


class _SsdArgs(ctypes.Structure):
    """Mirrors ``struct SsdArgs`` in csrc/ssd.cu."""

    _fields_ = [(f, ctypes.c_int) for f in (
        "B", "T", "H", "N", "P", "chunk", "include_current", "has_u",
        "has_h0", "d_bf16", "b_bf16", "x_bf16", "c_bf16")]


class _SsdBwdArgs(ctypes.Structure):
    """Mirrors ``struct SsdBwdArgs`` in csrc/ssd_bwd.cu."""

    _fields_ = [(f, ctypes.c_int) for f in (
        "B", "T", "H", "N", "P", "chunk", "include_current", "has_u",
        "has_dhT", "d_bf16", "b_bf16", "x_bf16", "c_bf16")]


def _args(cls, d, b, x, c, u, ck, include_current, **flags):
    B, T, H, N = d.shape
    return cls(B=B, T=T, H=H, N=N, P=x.shape[-1], chunk=ck,
               include_current=int(bool(include_current)),
               has_u=int(u is not None),
               **{k: int(v) for k, v in flags.items()},
               **{f"{k}_bf16": _DTYPES[t.dtype]
                  for k, t in (("d", d), ("b", b), ("x", x), ("c", c))})


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(d, b, x, c, u, h0, ck, include_current, states=False):
    """The forward kernel: (y, hT), or with ``states`` (y, hT, hs) from
    the states variant (``ssd_states_launch``, the same code with the
    chunk states written out)."""
    from repro_torch.kernels import _build

    lib = _build.load("ssd")
    fn = lib.ssd_states_launch if states else lib.ssd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.POINTER(_SsdArgs)]
                   + [ctypes.c_void_p] * (10 if states else 9))
    B, T, H, N = d.shape
    P = x.shape[-1]
    a = _args(_SsdArgs, d, b, x, c, u, ck, include_current,
              has_h0=h0 is not None)
    y = torch.empty_like(x)
    hT = torch.empty((B, H, N, P), dtype=torch.float32, device=d.device)
    hs = (torch.empty((B, T // ck, H, N, P), dtype=torch.float32,
                      device=d.device) if states else None)
    err = fn(ctypes.byref(a), d.data_ptr(), b.data_ptr(), x.data_ptr(),
             c.data_ptr(), _ptr(u), _ptr(h0), y.data_ptr(), hT.data_ptr(),
             *((hs.data_ptr(),) if states else ()),
             torch.cuda.current_stream(d.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed: cudaError_t {err}")
    ssd.launches += 1
    return (y, hT, hs) if states else (y, hT)


def ssd_reference(d, b, x, c, *, u=None, h0=None, chunk: int = 64,
                  include_current: bool = True, states: bool = False):
    """Plain PyTorch version of `ssd`: `repro.kernels.ref.chunked_ssd` op
    for op, on any device.  Returns (y, hT), with ``states`` (y, hT, hs):
    hs [B, nc, H, N, P] f32 the state entering each chunk.  Nothing on the
    main path calls it when a card is present."""
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
    y_inter, hs = [], []
    for g in range(nc):
        hs.append(h)
        y_inter.append(torch.einsum("bthn,bhnp->bthp", c_hat[:, g], h))
        h = (torch.exp(Lc[:, g])[..., None] * h
             + torch.einsum("bshn,bshp->bhnp", b_tld[:, g], xr[:, g]))
    y = (y + torch.stack(y_inter, 1)).reshape(B, T, H, P).to(x.dtype)
    return (y, h, torch.stack(hs, 1)) if states else (y, h)


def _check_backward(d, x, hs, dy, dhT, ck) -> None:
    B, T, H, N = d.shape
    P = x.shape[-1]
    for name, t, shape, dtype in (
            ("hs", hs, (B, T // ck, H, N, P), torch.float32),
            ("dy", dy, (B, T, H, P), x.dtype),
            ("dhT", dhT, (B, H, N, P), torch.float32)):
        if t is None:
            continue
        if (tuple(t.shape) != shape or t.dtype != dtype
                or not t.is_contiguous() or t.device != d.device):
            raise ValueError(f"ssd_backward: {name} must be contiguous "
                             f"{dtype} {shape} on {d.device}, got "
                             f"{t.dtype} {tuple(t.shape)}")


def ssd_backward(d, b, x, c, u, h0, hs, dy, dhT, *, chunk: int = 64,
                 include_current: bool = True):
    """(dd, db, dx, dc, du, dh0) of `ssd` from its inputs, the forward's
    chunk states ``hs`` (`ssd_states`), the output's gradient ``dy`` (made
    contiguous here: autograd may hand it over strided) and the final
    state's ``dhT`` (None for zero).  dd, db, dx, dc in their inputs'
    dtypes; du [H, N] f32 (None without ``u``); dh0 [B, H, N, P] f32.  On a
    card ``csrc/ssd_bwd.cu`` (counted once a call in
    ``ssd_backward.launches``) or raises; on the CPU the plain version."""
    dy = dy.contiguous()
    _check(d, b, x, c, u, h0)
    ck = chunk_for(d.shape[1], chunk)
    _check_backward(d, x, hs, dy, dhT, ck)
    _check_device(d, ck)
    *grads, du, dh0 = call_op(_ssd_bwd_op, _ssd_bwd_impl, d, b, x, c, u,
                              h0, hs, dy, dhT, ck, bool(include_current))
    return (*grads, du if u is not None else None, dh0)


def _ssd_bwd_impl(d: Tensor, b: Tensor, x: Tensor, c: Tensor,
                  u: Tensor | None, h0: Tensor | None, hs: Tensor,
                  dy: Tensor, dhT: Tensor | None, chunk: int,
                  include_current: bool
                  ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """(dd, db, dx, dc, du, dh0), du empty without ``u`` (an op returns
    no None)."""
    if d.device.type == "cpu":
        grads = ssd_backward_reference(d, b, x, c, u, h0, hs, dy, dhT,
                                       chunk=chunk,
                                       include_current=include_current)
    else:
        grads = _launch_bwd(d, b, x, c, u, hs, dy, dhT, chunk,
                            include_current)
        ssd_backward.launches += 1
    *g, du, dh0 = grads
    return (*g, d.new_empty((0,), dtype=torch.float32) if du is None
            else du, dh0)


_ssd_bwd_op = torch.library.custom_op("repro_torch::ssd_backward",
                                      _ssd_bwd_impl, mutates_args=())


@_ssd_bwd_op.register_fake
def _ssd_bwd_shape(d, b, x, c, u, h0, hs, dy, dhT, chunk, include_current):
    B, T, H, N = d.shape
    f32 = dict(dtype=torch.float32, device=d.device)
    du = (torch.empty((0,), **f32) if u is None
          else torch.empty((H, N), **f32))
    return (*(torch.empty_like(t) for t in (d, b, x, c)), du,
            torch.empty((B, H, N, x.shape[-1]), **f32))


ssd_backward.launches = 0


def _launch_bwd(d, b, x, c, u, hs, dy, dhT, ck, include_current):
    """The backward kernels (``ssd_bwd_launch``: the reverse state walk,
    the chunk-parallel gradients, the fixed-order du sum), with the state
    gradient entering each chunk from the right and du's per-(batch,
    chunk) partials as scratch."""
    from repro_torch.kernels import _build

    fn = _build.load("ssd_bwd").ssd_bwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_SsdBwdArgs)] + [ctypes.c_void_p] * 17
    B, T, H, N = d.shape
    P = x.shape[-1]
    nc = T // ck
    a = _args(_SsdBwdArgs, d, b, x, c, u, ck, include_current,
              has_dhT=dhT is not None)
    f32 = dict(dtype=torch.float32, device=d.device)
    dd, db, dx, dc = (torch.empty_like(t) for t in (d, b, x, c))
    du = None if u is None else torch.empty((H, N), **f32)
    dh0 = torch.empty((B, H, N, P), **f32)
    dhs = torch.empty((B, nc, H, N, P), **f32)
    du_part = torch.empty((B, nc, H, N) if u is not None else (1,), **f32)
    err = fn(ctypes.byref(a), *(_ptr(t) for t in (
        d, b, x, c, u, hs, dy, dhT, dhs, du_part, dd, db, dx, dc, du, dh0)),
        torch.cuda.current_stream(d.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd backward kernel launch failed: "
                           f"cudaError_t {err}")
    return dd, db, dx, dc, du, dh0


def ssd_backward_resources(P: int, d_dtype, c_dtype, x_dtype) -> dict:
    """Shared bytes a block and resident blocks an SM of the backward's
    state-gradient walk ("A") and chunk-gradient pass ("B") for value
    width ``P`` and these input dtypes, as the card reports them
    (``ssd_bwd_resources``: cudaOccupancyMaxActiveBlocksPerMultiprocessor).
    Needs the card."""
    from repro_torch.kernels import _build

    fn = _build.load("ssd_bwd").ssd_bwd_resources
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    out = {}
    for name, k in (("A", 0), ("B", 1)):
        smem, blocks = ctypes.c_int(), ctypes.c_int()
        err = fn(k, P, _DTYPES[d_dtype], _DTYPES[c_dtype], _DTYPES[x_dtype],
                 ctypes.addressof(smem), ctypes.addressof(blocks))
        if err != 0:
            raise RuntimeError(f"ssd_bwd_resources: cudaError_t {err}")
        out[name] = {"smem_bytes": smem.value,
                     "blocks_per_sm": blocks.value}
    return out


def ssd_backward_reference(d, b, x, c, u, h0, hs, dy, dhT, *,
                           chunk: int = 64, include_current: bool = True):
    """Plain PyTorch version of `ssd_backward`: the chunk formulas written
    out (not autograd of `ssd_reference`), on any device.

    Per chunk g, from the forward's intermediates (L, ĉ, b̂, b̃, the masked
    scores S, the bonus sums su) and the state h_g entering it, with dh the
    state gradient leaving it (a reverse walk from dhT):
    dS = mask(dy xᵀ); dx = Sᵀdy + su·dy + b̃·dh; dĉ = dS·b̂ + dy·h_gᵀ;
    db̂ = dSᵀĉ; db̃ = x·dhᵀ; dLc = Σ_p h_g⊙dh·e^{Lc} + Σ_t db̃⊙b̃;
    dL = dĉ⊙ĉ − db̂⊙b̂ − db̃⊙b̃; dlog d_s = Σ_{t≥s} dL_t + dLc (a reverse
    running sum); dd = dlog d / d where d > 1e-20, else 0; dc = dĉ⊙e^L,
    db = db̂⊙e^{−L} + db̃⊙e^{Lc−L}; with u, dsu = Σ_p dy⊙x adds dsu·u·b to
    dc, dsu·u·c to db and Σ dsu·c·b to du.  The walk: dh ← e^{Lc}⊙dh +
    ĉᵀdy, and dh0 is its last value.  Returns (dd, db, dx, dc, du, dh0) as
    `ssd_backward` does; ``h0`` is unused (hs[:, 0] holds it)."""
    del h0
    B, T, H, N = d.shape
    P = x.shape[-1]
    nc = T // chunk
    assert nc * chunk == T, f"T={T} not divisible by chunk={chunk}"
    f32 = torch.float32
    dr = d.reshape(B, nc, chunk, H, N).to(f32)
    br = b.reshape(B, nc, chunk, H, N).to(f32)
    xr = x.reshape(B, nc, chunk, H, P).to(f32)
    cr = c.reshape(B, nc, chunk, H, N).to(f32)
    dyr = dy.reshape(B, nc, chunk, H, P).to(f32)

    L = torch.cumsum(torch.log(torch.clamp(dr, min=1e-20)), dim=2)
    Lc = L[:, :, -1]                                  # [B, nc, H, N]
    eL, einv = torch.exp(L), torch.exp(-L)
    elcl = torch.exp(Lc[:, :, None] - L)
    c_hat, b_hat, b_tld = cr * eL, br * einv, br * elcl
    t_idx = torch.arange(chunk, device=d.device)[:, None]
    s_idx = torch.arange(chunk, device=d.device)[None, :]
    keep = ((s_idx <= t_idx) if include_current else (s_idx < t_idx)
            )[None, None, None]
    S = torch.where(keep, torch.einsum("bgthn,bgshn->bghts", c_hat, b_hat),
                    0.0)
    dS = torch.where(keep, torch.einsum("bgthp,bgshp->bghts", dyr, xr), 0.0)

    # the state gradient leaving each chunk: a walk from the last chunk
    dh = (torch.zeros((B, H, N, P), dtype=f32, device=d.device)
          if dhT is None else dhT.to(f32))
    dhs = [None] * nc
    for g in reversed(range(nc)):
        dhs[g] = dh
        dh = (torch.exp(Lc[:, g])[..., None] * dh
              + torch.einsum("bthn,bthp->bhnp", c_hat[:, g], dyr[:, g]))
    DH = torch.stack(dhs, 1)                          # [B, nc, H, N, P]

    dx = (torch.einsum("bghts,bgthp->bgshp", S, dyr)
          + torch.einsum("bgshn,bghnp->bgshp", b_tld, DH))
    dc_hat = (torch.einsum("bghts,bgshn->bgthn", dS, b_hat)
              + torch.einsum("bgthp,bghnp->bgthn", dyr, hs))
    db_hat = torch.einsum("bghts,bgthn->bgshn", dS, c_hat)
    db_tld = torch.einsum("bgshp,bghnp->bgshn", xr, DH)
    dLc = ((hs * DH).sum(-1) * torch.exp(Lc)
           + (db_tld * b_tld).sum(2))
    dL = dc_hat * c_hat - db_hat * b_hat - db_tld * b_tld
    dc = dc_hat * eL
    db = db_hat * einv + db_tld * elcl
    du = None
    if u is not None:
        uf = u.to(f32)
        su = torch.einsum("bgthn,hn,bgthn->bgth", cr, uf, br)
        dsu = (dyr * xr).sum(-1)                      # [B, nc, C, H]
        dx = dx + su[..., None] * dyr
        dc = dc + dsu[..., None] * uf * br
        db = db + dsu[..., None] * uf * cr
        du = torch.einsum("bgth,bgthn,bgthn->hn", dsu, cr, br)
    # Σ_{t ≥ s} dL_t, summed from the chunk's last step down
    dlogd = torch.flip(torch.cumsum(torch.flip(dL, (2,)), 2), (2,)) \
        + dLc[:, :, None]
    dd = torch.where(dr > 1e-20, dlogd / dr, 0.0)
    back = lambda t, like: t.reshape(like.shape).to(like.dtype)
    return (back(dd, d), back(db, b), back(dx, x), back(dc, c), du, dh)


class SsdFunction(torch.autograd.Function):
    """`ssd` with its gradient.  Forward: `ssd_states`; saved: (d, b, x, c,
    u, h0, hs); backward: `ssd_backward`.  Both are looked up in this
    module when called, so a caller may point them at the plain versions
    on a card.  Gradients that autograd does not materialise (an unused
    y or hT) arrive as None: dy then counts as zeros, dhT as absent."""

    @staticmethod
    def forward(ctx, d, b, x, c, u, h0, chunk, include_current):
        y, hT, hs = ssd_states(d, b, x, c, u=u, h0=h0, chunk=chunk,
                               include_current=include_current)
        ctx.save_for_backward(d, b, x, c, u, h0, hs)
        ctx.set_materialize_grads(False)
        ctx.args = dict(chunk=chunk, include_current=include_current)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        d, b, x, c, u, h0, hs = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = ssd_backward(d, b, x, c, u, h0, hs, dy, dhT, **ctx.args)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)),
                None, None)


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


def ssd_backward_cost(d, b, x, c, u=None, dhT=None, *,
                      include_current: bool = True) -> dict:
    """Bytes and operations `ssd_backward` must spend on these inputs.

    Bytes: d, b, c, x, the output's gradient (x's dtype), the chunk states
    hs (f32), u and dhT read once; dd, db, dc, dx (each in its input's
    dtype), du and dh0 written once.  Operations per (batch, head) chunk
    of C steps: the five products with a masked C × C operand — scores
    2·N, dS 2·P, Sᵀdy 2·P, dS·b̂ and dSᵀĉ 4·N an entry, over only the K
    entries the mask keeps (C(C+1)/2 with ``include_current``, C(C−1)/2
    without) —, dy·hᵀ, b̃·dh, x·dhᵀ and the state walk's ĉᵀdy 8·C·N·P,
    the walk's decay and Σ_p h⊙dh 2·N·P, and ~30·C·N for the logs,
    exponentials, cumsums and elementwise gradients.
    """
    B, T, H, N = d.shape
    P = x.shape[-1]
    ck = chunk_for(T, 64)
    nc = T // ck
    kept = ck * (ck + 1) // 2 if include_current else ck * (ck - 1) // 2
    per_chunk = (2 * kept * (3 * N + 2 * P) + 8 * ck * N * P
                 + 2 * N * P + 30 * ck * N)
    size = lambda t: 0 if t is None else t.numel() * t.element_size()
    state = B * H * N * P * 4
    nbytes = (2 * (size(d) + size(b) + size(c) + size(x)) + size(x)
              + nc * state + 2 * size(u) + size(dhT) + state)
    return {"bytes": nbytes, "ops": B * H * nc * per_chunk}


def _ssd_flops(*args, out_val=None, **kwargs):
    d, b, x, c, u, h0 = args[:6]
    return ssd_cost(d, b, x, c, u, h0)["ops"]


def _ssd_bwd_flops(*args, out_val=None, **kwargs):
    d, b, x, c, u, _, _, _, dhT, _, include_current = args
    return ssd_backward_cost(d, b, x, c, u, dhT,
                             include_current=include_current)["ops"]


register_flop_formula([torch.ops.repro_torch.ssd,
                       torch.ops.repro_torch.ssd_states],
                      get_raw=True)(_ssd_flops)
register_flop_formula(torch.ops.repro_torch.ssd_backward,
                      get_raw=True)(_ssd_bwd_flops)
