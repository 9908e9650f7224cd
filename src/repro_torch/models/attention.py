"""Attention variants: MHA / GQA / MQA, MLA (DeepSeek-V2's latent KV), the
sliding-window ring and the int8 KV cache.

Port of `repro.models.attention`.  Cache layouts per attention
application:

  * GQA / full: k, v [B, S_max, KV, dh] and positions [B, S_max] (−1 marks
    an unfilled slot);
  * SWA ring: k, v [B, W, KV, dh] and positions [B, W], W = min(S_max,
    window), position p in slot p % W;
  * int8: k, v int8 with f16 scales ks, vs [B, S, KV, 1] beside them;
  * MLA: c [B, S_max, r] and k_rope [B, S_max, rope_dim].

Prefill runs full-sequence attention through `ops.attention`, which sends
it to the hand-written flash kernel on a card (MLA's q/k head dim 192 with
v head dim 128 takes its CUDA-core route); decode (one query against the
cache) takes the exact naive `ref.attention_ref`, and MLA decodes in the
absorbed latent form, as the reference does.  Unlike the reference,
`gqa_decode` and `mla_decode` write the new entries into the cache tensors
in place (JAX returns new arrays): at serving width a copy of the cache per
token would cost more than the step itself.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (constrain_heads, first_row,
                                              is_distributed, merge_heads,
                                              split_heads)
from repro_torch.kernels import ops
from repro_torch.models.layers import normal, param_dtype, rms_norm, rope


def attn_init(gen: torch.Generator, cfg: ArchConfig, stack: int = 0) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = param_dtype(cfg)
    pre = (stack,) if stack else ()
    if cfg.mla_kv_lora:
        r, rd = cfg.mla_kv_lora, cfg.mla_rope_dim
        return {"wq": normal(gen, (*pre, d, h * (dh + rd)), dt, d ** -0.5),
                "w_dkv": normal(gen, (*pre, d, r + rd), dt, d ** -0.5),
                "kv_norm": torch.zeros((*pre, r), dtype=dt,
                                       device=gen.device),
                "w_uk": normal(gen, (*pre, r, h * dh), dt, r ** -0.5),
                "w_uv": normal(gen, (*pre, r, h * dh), dt, r ** -0.5),
                "wo": normal(gen, (*pre, h * dh, d), dt, (h * dh) ** -0.5)}
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
    q = constrain_heads(split_heads(x @ p["wq"], (B, S, h, dh)))
    k = constrain_heads(split_heads(x @ p["wk"], (B, S, kv, dh)))
    v = constrain_heads(split_heads(x @ p["wv"], (B, S, kv, dh)))
    q = rope(q, positions, theta=cfg.rope_theta)
    k = rope(k, positions, theta=cfg.rope_theta)
    o = constrain_heads(ops.attention(q, k, v, causal=True,
                                      window=_window(cfg)))
    return merge_heads(o) @ p["wo"], (k, v)


# int8 KV cache: per-(position, head) symmetric scales in f16
KV_QUANT_SCALE = 127.0


def quantize_kv(x):
    """[..., KV, dh] → (int8 values, f16 scales [..., KV, 1]).  Rounds half
    to even, as `jnp.round`."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(-1, keepdim=True),
                        min=1e-6) / KV_QUANT_SCALE
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def dequantize_kv(q, scale, dtype):
    return (q.float() * scale.float()).to(dtype)


def gqa_decode(p: dict, x, cfg: ArchConfig, cache_k, cache_v, cache_pos,
               pos: int, kv_scales=None):
    """One-token decode at absolute position ``pos`` (a Python int).

    cache_k/v: [B, S_cache, KV, dh]; cache_pos: [B, S_cache]; the new entry
    goes to slot pos % S_cache in the SWA ring, else min(pos, S_cache − 1).
    With ``cfg.kv_cache_dtype == "int8"`` the caches are int8 and
    ``kv_scales`` is {"k": [B, S, KV, 1], "v": …} in f16; attention reads
    the dequantised cache.  The new entries are written in place; returns
    (out, cache_k, cache_v, cache_pos[, kv_scales]).
    """
    B = x.shape[0]
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = split_heads(x @ p["wq"], (B, 1, h, dh))
    k = split_heads(x @ p["wk"], (B, 1, kv, dh))
    v = split_heads(x @ p["wv"], (B, 1, kv, dh))
    posv = torch.full((1,), pos, device=x.device)
    q = rope(q, posv, theta=cfg.rope_theta)
    k = rope(k, posv, theta=cfg.rope_theta)
    S = cache_k.shape[1]
    slot = pos % S if cfg.attn_kind == "swa" else min(pos, S - 1)
    quant = cfg.kv_cache_dtype == "int8"
    if quant:
        cache_k[:, slot], kv_scales["k"][:, slot] = quantize_kv(k[:, 0])
        cache_v[:, slot], kv_scales["v"][:, slot] = quantize_kv(v[:, 0])
        k_full = dequantize_kv(cache_k, kv_scales["k"], x.dtype)
        v_full = dequantize_kv(cache_v, kv_scales["v"], x.dtype)
    else:
        cache_k[:, slot] = k[:, 0]
        cache_v[:, slot] = v[:, 0]
        k_full, v_full = cache_k, cache_v
    # on a mesh a tensor, not a number: DTensor has no rule for filling
    # a slice of a placed tensor with a scalar
    cache_pos[:, slot] = (torch.full_like(cache_pos[:, slot], pos)
                          if is_distributed(cache_pos) else pos)
    o = ops.attention(q, k_full, v_full, causal=True, window=_window(cfg),
                      q_offset=pos, kv_positions=first_row(cache_pos))
    out = merge_heads(o) @ p["wo"]
    if quant:
        return out, cache_k, cache_v, cache_pos, kv_scales
    return out, cache_k, cache_v, cache_pos


# ------------------------------------------------------------- MLA paths --
def mla_forward(p: dict, x, cfg: ArchConfig, positions):
    """Expanded MLA for prefill: per-head keys [nope ‖ rope] of dim
    dh + rd against values of dim dh, scale (dh + rd) ** −0.5.  Returns
    (out, (c [B, S, r], k_rope [B, S, rd]))."""
    B, S, _ = x.shape
    h, dh, r, rd = cfg.n_heads, cfg.head_dim, cfg.mla_kv_lora, \
        cfg.mla_rope_dim
    q = constrain_heads(split_heads(x @ p["wq"], (B, S, h, dh + rd)))
    q_nope, q_rope = q[..., :dh], q[..., dh:]
    q_rope = rope(q_rope, positions, theta=cfg.rope_theta)
    ckr = x @ p["w_dkv"]                                   # [B, S, r+rd]
    c = rms_norm(ckr[..., :r], p["kv_norm"], cfg.norm_eps)
    k_rope = rope(ckr[..., None, r:], positions, theta=cfg.rope_theta)
    k_nope = constrain_heads(split_heads(c @ p["w_uk"], (B, S, h, dh)))
    v = constrain_heads(split_heads(c @ p["w_uv"], (B, S, h, dh)))
    k = torch.cat([k_nope, k_rope.expand(B, S, h, rd)], -1)
    qf = torch.cat([q_nope, q_rope], -1)
    o = constrain_heads(ops.attention(qf, k, v,
                                      scale=(dh + rd) ** -0.5))
    return merge_heads(o) @ p["wo"], (c, k_rope[:, :, 0])


def mla_decode(p: dict, x, cfg: ArchConfig, cache_c, cache_kr, pos: int):
    """Absorbed-matmul MLA decode against the latent cache, in f32.

    cache_c: [B, S, r]; cache_kr: [B, S, rd].  Scores in latent space,
    s = q_nopeᵀ·W_uk·c + q_ropeᵀ·k_rope, over slots ≤ pos (−1e30 elsewhere);
    values re-expanded through W_uv after the weighted sum over c.  The new
    entries go to slot min(pos, S − 1), in place.  Returns (out, cache_c,
    cache_kr).
    """
    B = x.shape[0]
    h, dh, r, rd = cfg.n_heads, cfg.head_dim, cfg.mla_kv_lora, \
        cfg.mla_rope_dim
    S = cache_c.shape[1]
    q = split_heads(x @ p["wq"], (B, 1, h, dh + rd))
    q_nope, q_rope = q[..., :dh], q[..., dh:]
    posv = torch.full((1,), pos, device=x.device)
    q_rope = rope(q_rope, posv, theta=cfg.rope_theta)
    ckr = x @ p["w_dkv"]
    c_new = rms_norm(ckr[..., :r], p["kv_norm"], cfg.norm_eps)   # [B, 1, r]
    kr_new = rope(ckr[..., None, r:], posv, theta=cfg.rope_theta)[:, :, 0]
    slot = min(pos, S - 1)
    cache_c[:, slot] = c_new[:, 0]
    cache_kr[:, slot] = kr_new[:, 0]

    cc, ck = cache_c.float(), cache_kr.float()
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(),
                         p["w_uk"].reshape(r, h, dh).float())
    s = (torch.einsum("bhr,bsr->bhs", q_lat, cc)
         + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(), ck)
         ) * ((dh + rd) ** -0.5)
    mask = torch.arange(S, device=x.device)[None, None, :] <= pos
    pr = torch.softmax(torch.where(mask, s, -1e30), -1)
    o_lat = torch.einsum("bhs,bsr->bhr", pr, cc)
    o = torch.einsum("bhr,rhd->bhd", o_lat,
                     p["w_uv"].reshape(r, h, dh).float())
    o = o.reshape(B, 1, h * dh).to(x.dtype)
    return o @ p["wo"], cache_c, cache_kr
