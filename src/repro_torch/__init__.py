"""PyTorch / CUDA port of `repro`'s fleet firmware loop, for NVIDIA Hopper.

Laid out like `repro` (``core/``, ``kernels/``, ``fleet/backends/``,
``launch/``) with the same module names, so each module's counterpart is
one path away.  The port imports ``torch`` and numpy, never ``jax`` and
never ``repro``: constants and configs it needs are its own copies.

Conventions every module follows:

  * f32 throughout; state pytrees are ``NamedTuple``s of tensors with the
    reference's field names;
  * an explicit ``device``: entry points default to CUDA and raise when it
    is absent (`resolve_device`) — the CPU runs only when the caller asks
    for it, as the tests do;
  * Γ products are f32 fused multiply-adds in one fixed order
    (`core.coupling.apply_coupling`), never a TF32-capable GEMM;
  * the multiply-adds whose results cancel are fused (`fma_f32`) and the
    control law's fractional power is correctly rounded (`pow_f32`).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's, else CUDA.

    There is no silent CPU fallback: with no card, a default-device call
    raises, and the caller has to ask for ``device="cpu"`` explicitly.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the host")
    return device


def fma_f32(a, b: torch.Tensor, c, *, exact: bool = False) -> torch.Tensor:
    """a·b + c rounded ONCE to f32: a fused multiply-add.

    The reference's fleet loop runs as a compiled XLA program, which
    contracts a multiply followed by an add into one FMA.  Three results of
    the loop cancel heavily — ΔT = α·R_tok + β (α·R_tok ≈ 1,290 against
    β = −1,256.6), the filtration's centered moment ``csum`` (terms ~10²,
    value near 0) and the v24 budget t_allow − (1 − η)·ΔT near the thermal
    limit — so there that single rounding shows at 1e-5, and every port
    version computes exactly those multiply-adds as FMAs (the CUDA kernels
    with fmaf).  The Γ products accumulate with it too (`apply_coupling`).
    ``a`` (a constant or tensor), ``b`` and ``c`` are f32, so a·b is exact
    in f64.  Its sum with c, rounded to f64 and then to f32, is rounded
    twice, which differs from one rounding only where the f64 sum lands
    exactly halfway between two f32 values while the exact sum lies off it
    (a small a·b beside a large c: a dense Γ's terms meet it about once in
    10⁸ products).  There the sum moves one f64 step toward the exact value
    (its TwoSum error) before the cast, so the result is the FMA's for
    results in f32's normal range.  On the CPU that correction runs where
    such a sum occurred (finding out is free there).  On a card finding
    out would be a host sync, so the correction runs on every element, and
    only with ``exact=True`` — as the plain versions that a kernel is held
    to bit for bit ask for it; the per-step engines, bound by launches,
    keep the two roundings.
    """
    x = a * b.double()
    c = c.double() if torch.is_tensor(c) else c
    s = x + c
    if x.device.type != "cpu" and not exact:
        return s.float()
    mid = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    if x.device.type == "cpu" and not bool(mid.any()):
        return s.float()
    t = s - x
    err = (x - (s - t)) + (c - t)
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    return torch.where(mid & (err != 0), torch.nextafter(s, toward),
                       s).float()


def pow_f32(x: torch.Tensor, y: float) -> torch.Tensor:
    """x ** y correctly rounded to f32 (pow in f64, one rounding).

    The reference's compiled f32 pow returns the correctly rounded result
    for 99.9 % of inputs, PyTorch's f32 pow for ~97 %; a 1-ulp miss in the
    control law's frequency shows ×20 in the MTPS telemetry sums.  ``y`` is
    the law's f32 exponent (1/3 rounded to f32).  Never a cube root
    special form: the reference computes pow.
    """
    return (x.double() ** y).float()
