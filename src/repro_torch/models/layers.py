"""Shared building blocks: RMS norm, RoPE, the dense MLPs (GeGLU, SwiGLU,
GELU).

Port of `repro.models.layers` (MoE and the training-only ``recompute_vjp``
wait for their ROADMAP steps).  Parameters are plain dicts of tensors with
the reference's key names; ``stack`` > 0 prepends a layer axis, as the
reference's stacked [L, …] layout does.  Weights are drawn from an explicit
`torch.Generator` on the device they live on (``gen.device``), with the
reference's distributions; the numbers differ from `jax.random`'s, so
parity tests carry the reference's weights across (`convert`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig


def param_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal(gen: torch.Generator, shape, dtype: torch.dtype,
           scale: float) -> torch.Tensor:
    """N(0, 1) · scale drawn in ``dtype`` on ``gen``'s device (the
    reference draws in the parameter dtype, then scales)."""
    x = torch.randn(tuple(shape), generator=gen, dtype=dtype,
                    device=gen.device)
    return x.mul_(scale)


# ------------------------------------------------------------------ norms --
def rms_norm(x, w, eps: float = 1e-6):
    """x · rsqrt(mean(x²) + eps) · (1 + w), in f32, cast back to x's
    dtype."""
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return ((x32 * inv) * (1.0 + w.float())).to(x.dtype)


# ------------------------------------------------------------------- rope --
def rope(x, positions, *, theta: float = 10_000.0,
         rot_dims: int | None = None):
    """Rotary embedding on the last dim.  x: [..., T, H, d]; positions:
    [T].  Angles in f32 from theta ** (−arange(half) / half)."""
    d = x.shape[-1] if rot_dims is None else rot_dims
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[:, None].float() * freqs[None, :]          # [T, half]
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    xr, rest = x[..., :d], x[..., d:]
    x1, x2 = xr[..., :half], xr[..., half:]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return torch.cat([rot.to(x.dtype), rest], -1)


# -------------------------------------------------------------------- mlp --
def mlp_init(gen: torch.Generator, cfg: ArchConfig, d_ff: int | None = None,
             stack: int = 0) -> dict:
    """Dense MLP params; ``stack`` > 0 prepends a layer axis."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = param_dtype(cfg)
    pre = (stack,) if stack else ()
    p = {"w_up": normal(gen, (*pre, d, f), dt, d ** -0.5),
         "w_down": normal(gen, (*pre, f, d), dt, f ** -0.5)}
    if cfg.mlp in ("geglu", "swiglu"):
        p["w_gate"] = normal(gen, (*pre, d, f), dt, d ** -0.5)
    return p


def mlp_apply(p: dict, x, kind: str):
    """GeGLU / SwiGLU / GELU MLP.  GELU is the tanh approximation, as
    `jax.nn.gelu`'s default (PyTorch's default is the exact erf form)."""
    up = x @ p["w_up"]
    if kind == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * up
    elif kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return h @ p["w_down"]
