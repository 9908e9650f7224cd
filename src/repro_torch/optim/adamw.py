"""AdamW with decoupled weight decay, global-norm clipping and a cosine
learning-rate schedule.

Port of `repro.optim.adamw`, with its defaults and its math (`adamw.py`
there, lines 42–89): the moments are f32 trees congruent with the
parameters, the gradient is cast to f32 and scaled by
min(1, clip / max(‖g‖, 1e-9)), m and v are the usual exponential averages,
the step is (m / (1 − b1ᶜ)) / (√(v / (1 − b2ᶜ)) + eps) + wd·p and the new
parameter (p − lr·step) in p's dtype, with ``c`` the update count after
this step.

Unlike the reference, `adamw_update` updates the parameters and the
moments in place (one leaf at a time, under ``torch.no_grad``): at
Gemma-2B's 2.51 B parameters a second copy of the f32 moments would cost
20 GB.  The values are the reference's.  The step count and the learning
rate are 0-dim f32 tensors on the host (the reference keeps them on the
device): reading them costs no device synchronisation, and a 0-dim host
tensor enters a device op as a scalar.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.checkpoint.manager import tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor          # 0-dim int32, on the host


def adamw_init(params) -> AdamWState:
    """Zero f32 moments beside each parameter leaf, count 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    leaves = tree_leaves(params)
    return AdamWState(m=tree_unflatten(params, [zeros(p) for p in leaves]),
                      v=tree_unflatten(params, [zeros(p) for p in leaves]),
                      count=torch.zeros((), dtype=torch.int32))


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, then a cosine decay to
    ``min_lr_frac``·lr at ``total_steps``; f32, as the reference."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(_f32(math.pi) * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """√(Σ over leaves of Σ x²), in f32 (0-dim, on the leaves' device)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def adamw_update(grads, state: AdamWState, params,
                 cfg: AdamWConfig | None = None):
    """One AdamW step, in place: ``params`` and ``state``'s moments are
    updated and returned.  Returns (params, new state, {"grad_norm",
    "lr"}); ``grads`` may be in the parameters' dtype or f32."""
    cfg = AdamWConfig() if cfg is None else cfg
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    count = state.count + 1
    lr = cosine_schedule(cfg, count)
    c = count.to(torch.float32)
    b1c = 1 - cfg.b1 ** c
    b2c = 1 - cfg.b2 ** c
    with torch.no_grad():
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state.m), tree_leaves(state.v)):
            g = g.float() * scale
            m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
            v.mul_(cfg.b2).add_(g.square_() * (1 - cfg.b2))
            step = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
            step.add_(p.float() * cfg.weight_decay)
            p.copy_(p.float() - step.mul_(lr))
    return params, AdamWState(state.m, state.v, count), {
        "grad_norm": gnorm, "lr": lr}
