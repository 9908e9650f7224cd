"""Config-driven model assembly for the dense and hybrid (Zamba2) families.

Port of `repro.models.transformer` for serving: `init_params`, `forward`,
`init_cache`, `prefill` and `decode_step`.  Parameters keep the reference's
dict key names and its stacked [L, …] per-layer layout, so weights cross
over leaf for leaf (`repro_torch.convert.params_from_numpy`); the layer
stack runs as a Python loop over the stacked tensors (PyTorch runs eagerly:
no scan is needed).

  * dense: L blocks of RMS norm → GQA attention → RMS norm → MLP;
  * hybrid: Mamba2 layers with ONE shared attention + MLP block applied
    after every full group of ``attn_every`` layers (`_hybrid_group_ids`).

Prefill runs each attention through the flash kernel and each Mamba2 layer
through the ssd kernel (on a card); decode runs neither (`ops`).  The
decode cache is updated in place: `decode_step` returns the dict it was
given.  The other families (RWKV6, MoE, MLA, the sliding-window ring, the
int8 cache, the stub frontends) raise `NotImplementedError` naming their
ROADMAP step.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.layers import (mlp_apply, mlp_init, normal,
                                       param_dtype, rms_norm)

Params = dict[str, Any]
Cache = dict[str, Any]

_WAITS = "is not ported yet: ROADMAP queue 1 step 10"


def check_supported(cfg: ArchConfig) -> None:
    """Raise `NotImplementedError` for what this port does not serve yet."""
    if cfg.family == "ssm":
        raise NotImplementedError(f"RWKV6 ({cfg.name}) {_WAITS}")
    if cfg.is_moe or cfg.mla_kv_lora:
        raise NotImplementedError(f"MoE / MLA ({cfg.name}) {_WAITS}")
    if cfg.frontend != "token" or cfg.family not in ("dense", "hybrid"):
        raise NotImplementedError(f"the {cfg.family} stub frontend "
                                  f"({cfg.name}) {_WAITS}")
    if cfg.attn_kind == "swa":
        raise NotImplementedError(f"the sliding-window ring cache "
                                  f"({cfg.name}) {_WAITS}")
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(f"the int8 KV cache ({cfg.name}) {_WAITS}")


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter (sub)tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ================================================================== init ==
def init_params(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Random parameters with the reference's distributions, drawn on
    ``gen.device`` in the config's dtype."""
    check_supported(cfg)
    dt = param_dtype(cfg)
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    zeros = lambda *s: torch.zeros(s, dtype=dt, device=gen.device)
    p: Params = {"embed": normal(gen, (V, D), dt, D ** -0.5),
                 "final_norm": zeros(D)}
    if not cfg.tie_embeddings:
        p["lm_head"] = normal(gen, (D, V), dt, D ** -0.5)
    if cfg.family == "hybrid":
        p["blocks"] = {"mamba_norm": zeros(L, D),
                       "mamba": ssm.mamba2_init(gen, cfg, stack=L)}
        p["shared_attn_norm"] = zeros(D)
        p["shared_attn"] = attn.attn_init(gen, cfg)
        p["shared_mlp_norm"] = zeros(D)
        p["shared_mlp"] = mlp_init(gen, cfg)
    else:
        p["blocks"] = {"attn_norm": zeros(L, D),
                       "attn": attn.attn_init(gen, cfg, stack=L),
                       "mlp_norm": zeros(L, D),
                       "mlp": mlp_init(gen, cfg, stack=L)}
    return p


def _embed_in(p: Params, cfg: ArchConfig, tokens):
    x = p["embed"][tokens]
    if cfg.mlp == "geglu":                        # gemma-style √d scaling
        # √d rounded to the activations' dtype first, as the reference
        # does, on the host: a device scalar would cost a copy and a sync
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))
    return x


def _logits(p: Params, cfg: ArchConfig, x):
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    head = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return (x @ head).float()


# ============================================================== forward ==
def _hybrid_group_ids(cfg: ArchConfig) -> list[int]:
    """Mamba-layer counts per stage; the shared attention block runs after
    each full group of ``attn_every`` layers (a remainder closes the
    stack)."""
    n_full = cfg.n_layers // cfg.attn_every
    rem = cfg.n_layers - n_full * cfg.attn_every
    return [cfg.attn_every] * n_full + ([rem] if rem else [])


def _shared_block(p: Params, cfg: ArchConfig, x, positions):
    h = rms_norm(x, p["shared_attn_norm"], cfg.norm_eps)
    a, kv = attn.gqa_forward(p["shared_attn"], h, cfg, positions)
    x = x + a
    h = rms_norm(x, p["shared_mlp_norm"], cfg.norm_eps)
    return x + mlp_apply(p["shared_mlp"], h, cfg.mlp), kv


def _trunk(p: Params, cfg: ArchConfig, tokens, collect_cache: bool):
    """Embedding and layer stack: (final hidden [B, S, D], cache or None).

    The cache has the reference's layout: dense (k, v) stacked [L, …];
    hybrid {"mamba": (h [L, …], conv tails [L, …]), "attn": (k, v)
    stacked over the shared block's applications}.
    """
    check_supported(cfg)
    x = _embed_in(p, cfg, tokens)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    blocks = p["blocks"]
    kvs, hs, tails = [], [], []
    if cfg.family == "hybrid":
        off = 0
        for gs in _hybrid_group_ids(cfg):
            for i in range(off, off + gs):
                h = rms_norm(x, blocks["mamba_norm"][i], cfg.norm_eps)
                y, (hT, tail) = ssm.mamba2_forward(
                    _layer(blocks["mamba"], i), h, cfg)
                x = x + y
                if collect_cache:
                    hs.append(hT)
                    tails.append(tail)
            off += gs
            if gs == cfg.attn_every:
                x, kv = _shared_block(p, cfg, x, positions)
                if collect_cache:
                    kvs.append(kv)
        if not collect_cache:
            return x, None
        return x, {"mamba": (torch.stack(hs), torch.stack(tails)),
                   "attn": (torch.stack([k for k, _ in kvs]),
                            torch.stack([v for _, v in kvs]))}
    for i in range(cfg.n_layers):
        bp = _layer(blocks, i)
        h = rms_norm(x, bp["attn_norm"], cfg.norm_eps)
        a, kv = attn.gqa_forward(bp["attn"], h, cfg, positions)
        x = x + a
        h = rms_norm(x, bp["mlp_norm"], cfg.norm_eps)
        x = x + mlp_apply(bp["mlp"], h, cfg.mlp)
        if collect_cache:
            kvs.append(kv)
    if not collect_cache:
        return x, None
    return x, (torch.stack([k for k, _ in kvs]),
               torch.stack([v for _, v in kvs]))


def forward(p: Params, cfg: ArchConfig, tokens, *, collect_cache=False):
    """Full-sequence forward.  tokens: [B, S] ints.

    Returns (logits [B, S, V] f32, {"cache": …}) as the reference.
    """
    x, cache = _trunk(p, cfg, tokens, collect_cache)
    return _logits(p, cfg, x), {"cache": cache}


# ================================================================ cache ==
def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device=None) -> Cache:
    check_supported(cfg)
    dt = param_dtype(cfg)
    L, D = cfg.n_layers, cfg.d_model
    z = lambda *s, dtype=dt: torch.zeros(s, dtype=dtype, device=device)
    if cfg.family == "hybrid":
        di = 2 * D
        n_apps = sum(1 for g in _hybrid_group_ids(cfg)
                     if g == cfg.attn_every)
        kv = (n_apps, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        return {"h": z(L, batch, cfg.ssm_heads, cfg.ssm_state,
                       di // cfg.ssm_heads, dtype=torch.float32),
                "conv": z(L, batch, 3, di), "k": z(*kv), "v": z(*kv),
                "pos": torch.full((n_apps, batch, max_seq), -1,
                                  dtype=torch.int32, device=device)}
    kv = (L, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": z(*kv), "v": z(*kv),
            "pos": torch.full((L, batch, max_seq), -1, dtype=torch.int32,
                              device=device)}


def _fill_kv(cache: Cache, k, v, S: int) -> Cache:
    """Write the prompt's keys and values into the cache (the trailing
    window, ring-aligned, when the prompt fills it)."""
    w = cache["k"].shape[2]
    if S >= w:
        shift = S % w
        pos = torch.arange(S - w, S, dtype=torch.int32, device=k.device)
        cache["k"] = torch.roll(k[:, :, S - w:], shift, 2).contiguous()
        cache["v"] = torch.roll(v[:, :, S - w:], shift, 2).contiguous()
        cache["pos"] = torch.roll(pos, shift, 0).expand_as(
            cache["pos"]).contiguous()
    else:
        cache["k"][:, :, :S] = k
        cache["v"][:, :, :S] = v
        cache["pos"][:, :, :S] = torch.arange(S, dtype=torch.int32,
                                              device=k.device)
    return cache


# =============================================================== prefill ==
def prefill(p: Params, cfg: ArchConfig, tokens, max_seq: int):
    """Full-sequence prefill.  Returns (last-token logits [B, V], cache,
    S), the cache laid out for `decode_step` at position S.

    The LM head is applied to the last position only: the rows are
    independent and only the last is returned, and at Gemma's 256,000-word
    vocabulary the whole [B, S, V] f32 tensor would take gigabytes.
    """
    B, S = tokens.shape[:2]
    x, fc = _trunk(p, cfg, tokens, collect_cache=True)
    last = _logits(p, cfg, x[:, -1:])[:, 0]
    cache = init_cache(cfg, B, max_seq, device=x.device)
    if cfg.family == "hybrid":
        cache["h"], cache["conv"] = fc["mamba"]
        k, v = fc["attn"]
    else:
        k, v = fc
    return last, _fill_kv(cache, k, v, S), S


# ================================================================ decode ==
def decode_step(p: Params, cfg: ArchConfig, cache: Cache, token, pos: int):
    """One decode step.  token: [B] ints; pos: the absolute position (a
    Python int).  Returns (logits [B, V] f32, cache), the cache updated in
    place."""
    check_supported(cfg)
    x = _embed_in(p, cfg, token[:, None])           # [B, 1, D]
    blocks = p["blocks"]
    if cfg.family == "hybrid":
        return _hybrid_decode(p, cfg, cache, x, pos)
    for i in range(cfg.n_layers):
        bp = _layer(blocks, i)
        h = rms_norm(x, bp["attn_norm"], cfg.norm_eps)
        a, *_ = attn.gqa_decode(bp["attn"], h, cfg, cache["k"][i],
                                cache["v"][i], cache["pos"][i], pos)
        x = x + a
        h = rms_norm(x, bp["mlp_norm"], cfg.norm_eps)
        x = x + mlp_apply(bp["mlp"], h, cfg.mlp)
    return _logits(p, cfg, x)[:, 0], cache


def _hybrid_decode(p: Params, cfg: ArchConfig, cache: Cache, x, pos: int):
    blocks = p["blocks"]
    off = app = 0
    for gs in _hybrid_group_ids(cfg):
        for i in range(off, off + gs):
            hh = rms_norm(x, blocks["mamba_norm"][i], cfg.norm_eps)
            y, h2, c2 = ssm.mamba2_decode(_layer(blocks["mamba"], i), hh,
                                          cfg, cache["h"][i],
                                          cache["conv"][i])
            cache["h"][i] = h2
            cache["conv"][i] = c2
            x = x + y
        off += gs
        if gs == cfg.attn_every:
            hh = rms_norm(x, p["shared_attn_norm"], cfg.norm_eps)
            a, *_ = attn.gqa_decode(p["shared_attn"], hh, cfg,
                                    cache["k"][app], cache["v"][app],
                                    cache["pos"][app], pos)
            x = x + a
            hh = rms_norm(x, p["shared_mlp_norm"], cfg.norm_eps)
            x = x + mlp_apply(p["shared_mlp"], hh, cfg.mlp)
            app += 1
    return _logits(p, cfg, x)[:, 0], cache
