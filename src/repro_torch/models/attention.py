"""Grouped-query attention (MHA / GQA / MQA): init, prefill, decode.

Port of the non-MLA half of `repro.models.attention` with the model-dtype
cache (MLA and the int8 cache wait for ROADMAP queue 1 step 10).  Cache
layout per attention application: k, v [B, S_max, KV, dh] and positions
[B, S_max] (−1 marks an unfilled slot).

Prefill runs full-sequence attention through `ops.attention`, which sends
it to the hand-written flash kernel on a card; decode (one query against
the cache) takes the exact naive `ref.attention_ref`, as the reference.
Unlike the reference, `gqa_decode` writes the new key, value and position
into the cache tensors in place (JAX returns new arrays): at serving width
a copy of the cache per token would cost more than the step itself.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import normal, param_dtype, rope


def attn_init(gen: torch.Generator, cfg: ArchConfig, stack: int = 0) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = param_dtype(cfg)
    pre = (stack,) if stack else ()
    return {
        "wq": normal(gen, (*pre, d, h * dh), dt, d ** -0.5),
        "wk": normal(gen, (*pre, d, kv * dh), dt, d ** -0.5),
        "wv": normal(gen, (*pre, d, kv * dh), dt, d ** -0.5),
        "wo": normal(gen, (*pre, h * dh, d), dt, (h * dh) ** -0.5),
    }


def _window(cfg: ArchConfig) -> int:
    return cfg.window if cfg.attn_kind == "swa" else 0


def gqa_forward(p: dict, x, cfg: ArchConfig, positions):
    """Prefill full-sequence attention.  Returns (out, (k, v))."""
    B, S, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, h, dh)
    k = (x @ p["wk"]).reshape(B, S, kv, dh)
    v = (x @ p["wv"]).reshape(B, S, kv, dh)
    q = rope(q, positions, theta=cfg.rope_theta)
    k = rope(k, positions, theta=cfg.rope_theta)
    o = ops.attention(q, k, v, causal=True, window=_window(cfg))
    return o.reshape(B, S, h * dh) @ p["wo"], (k, v)


def gqa_decode(p: dict, x, cfg: ArchConfig, cache_k, cache_v, cache_pos,
               pos: int):
    """One-token decode at absolute position ``pos`` (a Python int).

    cache_k/v: [B, S_cache, KV, dh]; cache_pos: [B, S_cache].  The new
    entries are written in place; returns (out, cache_k, cache_v,
    cache_pos).
    """
    if cfg.attn_kind == "swa":
        raise NotImplementedError("the sliding-window ring cache is not "
                                  "ported yet: ROADMAP queue 1 step 10")
    B = x.shape[0]
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, 1, h, dh)
    k = (x @ p["wk"]).reshape(B, 1, kv, dh)
    v = (x @ p["wv"]).reshape(B, 1, kv, dh)
    posv = torch.full((1,), pos, device=x.device)
    q = rope(q, posv, theta=cfg.rope_theta)
    k = rope(k, posv, theta=cfg.rope_theta)
    slot = min(pos, cache_k.shape[1] - 1)
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    cache_pos[:, slot] = pos
    o = ops.attention(q, cache_k, cache_v, causal=True, q_offset=pos,
                      kv_positions=cache_pos[0])
    return o.reshape(B, 1, h * dh) @ p["wo"], cache_k, cache_v, cache_pos
