"""Shared building blocks: RMS norm, RoPE, the dense MLPs (GeGLU, SwiGLU,
GELU) and the routed mixture of experts.

Port of `repro.models.layers`.  Parameters are plain dicts of tensors with
the reference's key names; ``stack`` > 0 prepends a layer axis, as the
reference's stacked [L, …] layout does.  Weights are drawn from an explicit
`torch.Generator` on the device they live on (``gen.device``), with the
reference's distributions; the numbers differ from `jax.random`'s, so
parity tests carry the reference's weights across (`convert`).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

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


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward: the
    reference's ``jax.checkpoint`` of each block plus ``recompute_vjp``.

    Only ``args`` are kept for the backward.  ``recompute_vjp`` exists in
    the reference because ``jax.checkpoint`` saves a custom VJP's residuals
    (the flash attention's (q, k, v, o, m, l)); PyTorch's non-reentrant
    checkpoint saves nothing of the block, so the flash residuals exist
    only while one block's backward runs.  The forward of a checkpointed
    block runs twice a step (forward and recompute), its backward once."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


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


# -------------------------------------------------------------------- moe --
def moe_init(gen: torch.Generator, cfg: ArchConfig, stack: int = 0) -> dict:
    """Routed experts (stacked [E, D, Fe]), the optional shared experts and
    the f32 router."""
    d, e = cfg.d_model, cfg.n_experts
    fe = cfg.moe_d_ff or cfg.d_ff
    dt = param_dtype(cfg)
    pre = (stack,) if stack else ()
    p = {"router": normal(gen, (*pre, d, e), torch.float32, d ** -0.5),
         "we_gate": normal(gen, (*pre, e, d, fe), dt, d ** -0.5),
         "we_up": normal(gen, (*pre, e, d, fe), dt, d ** -0.5),
         "we_down": normal(gen, (*pre, e, fe, d), dt, fe ** -0.5)}
    if cfg.n_shared_experts:
        fs = fe * cfg.n_shared_experts
        p["ws_gate"] = normal(gen, (*pre, d, fs), dt, d ** -0.5)
        p["ws_up"] = normal(gen, (*pre, d, fs), dt, d ** -0.5)
        p["ws_down"] = normal(gen, (*pre, fs, d), dt, fs ** -0.5)
    return p


@dataclasses.dataclass(frozen=True)
class MoEOptions:
    capacity_factor: float = 1.3
    group_size: int = 512           # tokens per dispatch group


# most tokens dispatched per pass of the expert products: the f32 buffers
# of a pass (~_PASS_TOKENS·k·cf rows of D and of Fe) stay bounded whatever
# the prompt, as the reference's scan over one group at a time keeps them
_PASS_TOKENS = 8192


def _experts_f32(w, used, E: int) -> torch.Tensor:
    """The stacked expert weight ``w`` [E, …] in f32, only the experts
    ``used``: one cast of the stack when every expert is used, else each
    used expert's slice cast into its row (no copy in ``w``'s dtype
    first)."""
    if used.numel() == E:
        return w.float()
    out = torch.empty((used.numel(), *w.shape[1:]), dtype=torch.float32,
                      device=w.device)
    for j, e in enumerate(used.tolist()):
        out[j].copy_(w[e])
    return out


def moe_apply(p: dict, x, cfg: ArchConfig, opts: MoEOptions | None = None):
    """Top-k routed MoE with the reference's capacity-bounded dispatch
    (T5X-style).  Returns (y, aux_loss).

    Tokens go in groups of ``group_size`` (halved while it does not divide
    the token count); each expert takes at most cap = max(int(g·k/E·cf), 1)
    of a group's (token, slot) pairs, in arrival order — token-major, then
    slot — and drops the rest.  The router runs in f32: softmax, top-k,
    weights renormalised by max(Σ, 1e-9); the switch load-balance loss is
    E·Σ mean(prob)·share(top-k).

    The reference builds one-hot [g, E, C] dispatch and combine tensors per
    group; here the same (expert, group, slot) buffer is filled by index.
    Moving a row by index is the exact value the one-hot product gives, and
    a buffer row's expert product does not depend on its group, so whole
    groups go through the products together: f32 batched matmuls, in the
    fewest even passes of at most ``_PASS_TOKENS`` tokens.  Only the
    experts some token routes to (each keeps its first arrival, cap ≥ 1)
    take part, their weights cast to f32 once per call — in a decode step
    that is a few of E.  The combine sums each token's k weighted rows in
    slot order (the one-hot product sums the same k terms), then casts to
    x's dtype; the shared experts run in x's dtype, as in the reference.
    """
    if opts is None:
        opts = MoEOptions(capacity_factor=cfg.moe_capacity_factor)
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    N = B * S
    xf = x.reshape(N, D)
    g = min(opts.group_size, N)
    while N % g:
        g //= 2
    ng = N // g
    cap = max(int(g * k / E * opts.capacity_factor), 1)
    dev = x.device

    probs = torch.softmax(xf.float() @ p["router"].float(), -1)     # [N, E]
    topw, topi = torch.topk(probs, k, dim=-1)                      # [N, k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    ce = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, topi.reshape(-1), torch.ones(N * k, device=dev)) / (N * k)
    aux = E * torch.sum(probs.mean(0) * ce)

    used = torch.unique(topi)                      # ascending expert ids
    U = used.numel()
    slot = torch.zeros(E, dtype=torch.long, device=dev)
    slot[used] = torch.arange(U, device=dev)
    wg, wu, wd = (_experts_f32(p[n], used, E)
                  for n in ("we_gate", "we_up", "we_down"))

    y = torch.empty((N, D), dtype=x.dtype, device=dev)
    passes = -(-ng // max(_PASS_TOKENS // g, 1))
    per = -(-ng // passes)                         # groups per pass, even
    for g0 in range(0, ng, per):
        c = min(per, ng - g0)
        t0, t1 = g0 * g, (g0 + c) * g
        # arrival index of each (token, slot) in its expert's buffer
        ig = topi[t0:t1].reshape(c, g * k)
        arrive = (F.one_hot(ig, E).cumsum(1) - 1).gather(
            -1, ig[..., None])[..., 0]
        keep = (arrive < cap).reshape(c * g, k)
        group = torch.arange(c, device=dev)[:, None].expand(c, g * k)
        row = ((slot[ig] * c + group) * cap + arrive).reshape(c * g, k)
        row = torch.where(keep, row, 0)            # [U, c, cap] flattened
        tok = torch.arange(c * g, device=dev)[:, None].expand(c * g, k)
        xe = torch.zeros((U * c * cap, D), dtype=torch.float32, device=dev)
        xe[row[keep]] = xf[t0:t1][tok[keep]].float()
        xe = xe.reshape(U, c * cap, D)
        h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
        ye = torch.bmm(h, wd).reshape(U * c * cap, D)
        w = torch.where(keep, topw[t0:t1], 0.0)
        y[t0:t1] = (ye[row] * w[..., None]).sum(1)

    if cfg.n_shared_experts:
        hs = F.silu(xf @ p["ws_gate"]) * (xf @ p["ws_up"])
        y = y + (hs @ p["ws_down"]).to(x.dtype)
    return y.reshape(B, S, D), aux
