"""Config-driven model assembly for every architecture in `configs`.

Port of `repro.models.transformer`: `init_params`, `forward`, `loss_fn`
(with `_hidden`), `init_cache`, `prefill` and `decode_step`.  Parameters
keep the reference's dict key names and its stacked [L, …] per-layer
layout, so weights cross over leaf for leaf
(`repro_torch.convert.params_from_numpy`); the layer stack runs as a Python
loop over the stacked tensors (PyTorch runs eagerly: no scan is needed),
each stacked leaf split once per call with ``torch.unbind`` (`_unstack`),
whose backward is one ``stack``.  One code path per family:

  * attention families (dense, moe, vlm, audio): L blocks of RMS norm →
    GQA or MLA attention (full or sliding-window) → RMS norm → MLP or MoE;
  * ssm (RWKV6): L blocks of RMS norm → time-mix → RMS norm → channel-mix;
  * hybrid (Zamba2): Mamba2 layers with ONE shared attention + MLP block
    applied after every full group of ``attn_every`` layers
    (`_hybrid_group_ids`).

On a mesh (`repro_torch.distributed.sharding`) the same code runs on
DTensors: the reference's activation hints (`constrain`,
`constrain_heads`) pin the embeddings, heads, MLP width and logits; each
block gathers its FSDP weights and settles the residual stream; the
lookup and the LM head's cross entropy run vocab-parallel.

The vlm / audio frontends are stubs, as in the reference: the entry points
take integer tokens [B, S] or precomputed embeddings [B, S, D] (decode:
[B] or [B, D]).  Prefill runs each attention through the flash kernel and
each Mamba2 / RWKV6 layer through the ssd kernel (on a card); decode runs
neither (`ops`).  The decode cache is updated in place: `decode_step`
returns the dict it was given.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import constrain, settle
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.layers import (mlp_apply, mlp_init, moe_apply,
                                       moe_init, normal, param_dtype,
                                       rms_norm)
from repro_torch.models.layers import remat as _remat

Params = dict[str, Any]
Cache = dict[str, Any]

def _unstack(tree, L: int) -> list:
    """The L per-layer (sub)trees of a stacked parameter tree: one
    ``torch.unbind`` per leaf.  Under autograd its backward is one
    ``stack`` per leaf; indexing ``leaf[i]`` instead would write a
    zero-filled [L, …] gradient per layer (SelectBackward)."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, L) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(L)]
    return list(torch.unbind(tree))


# ================================================================== init ==
def init_params(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Random parameters with the reference's distributions, drawn on
    ``gen.device`` in the config's dtype."""
    dt = param_dtype(cfg)
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    zeros = lambda *s: torch.zeros(s, dtype=dt, device=gen.device)
    p: Params = {"embed": normal(gen, (V, D), dt, D ** -0.5),
                 "final_norm": zeros(D)}
    if not cfg.tie_embeddings:
        p["lm_head"] = normal(gen, (D, V), dt, D ** -0.5)
    if cfg.family == "ssm":                       # RWKV6: the channel-mix
        p["blocks"] = {"tm_norm": zeros(L, D),   # lives in "tm" too
                       "tm": ssm.rwkv6_init(gen, cfg, stack=L),
                       "cm_norm": zeros(L, D)}
    elif cfg.family == "hybrid":
        p["blocks"] = {"mamba_norm": zeros(L, D),
                       "mamba": ssm.mamba2_init(gen, cfg, stack=L)}
        p["shared_attn_norm"] = zeros(D)
        p["shared_attn"] = attn.attn_init(gen, cfg)
        p["shared_mlp_norm"] = zeros(D)
        p["shared_mlp"] = mlp_init(gen, cfg)
    else:
        p["blocks"] = {"attn_norm": zeros(L, D),
                       "attn": attn.attn_init(gen, cfg, stack=L),
                       "mlp_norm": zeros(L, D)}
        if cfg.is_moe:
            p["blocks"]["moe"] = moe_init(gen, cfg, stack=L)
        else:
            p["blocks"]["mlp"] = mlp_init(gen, cfg, stack=L)
    return p


def _embed_in(p: Params, cfg: ArchConfig, tokens_or_embeds):
    """Integer tokens through the embedding table; float inputs are a stub
    frontend's embeddings, cast to the parameter dtype."""
    if tokens_or_embeds.is_floating_point():
        x = tokens_or_embeds.to(param_dtype(cfg))
    elif sharding.is_distributed(p["embed"]):
        x = sharding.vocab_parallel_embedding(
            sharding.gather_dp(p["embed"]), tokens_or_embeds)
    else:
        x = p["embed"][tokens_or_embeds]
    if cfg.mlp == "geglu":                        # gemma-style √d scaling
        # √d rounded to the activations' dtype first, as the reference
        # does, on the host: a device scalar would cost a copy and a sync
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))
    return constrain(x, ("dp", None, None))


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
    p = sharding.gather_dp({k: p[k] for k in (
        "shared_attn_norm", "shared_attn", "shared_mlp_norm", "shared_mlp")})
    h = rms_norm(x, p["shared_attn_norm"], cfg.norm_eps)
    a, kv = attn.gqa_forward(p["shared_attn"], h, cfg, positions)
    x = settle(x + a)
    h = rms_norm(x, p["shared_mlp_norm"], cfg.norm_eps)
    return settle(x + mlp_apply(p["shared_mlp"], h, cfg.mlp)), kv


def _attn_block(bp: Params, cfg: ArchConfig, x, positions):
    """Norm → GQA / MLA attention → norm → MLP / MoE.  Returns (x, the
    layer's cache entries, MoE aux or None).  On a mesh the block's
    weights are gathered over the DP axes first (FSDP), inside the block,
    so a rematerialised block gathers them again in its backward, and the
    residual stream is settled after each add (`sharding.settle`)."""
    bp = sharding.gather_dp(bp)
    h = rms_norm(x, bp["attn_norm"], cfg.norm_eps)
    fwd = attn.mla_forward if cfg.mla_kv_lora else attn.gqa_forward
    a, kv = fwd(bp["attn"], h, cfg, positions)
    x = settle(x + a)
    h = rms_norm(x, bp["mlp_norm"], cfg.norm_eps)
    if "moe" in bp:
        m, aux = moe_apply(bp["moe"], h, cfg)
    else:
        m, aux = mlp_apply(bp["mlp"], h, cfg.mlp), None
    return settle(x + m), kv, aux


def _rwkv_block(bp: Params, cfg: ArchConfig, x):
    bp = sharding.gather_dp(bp)
    h = rms_norm(x, bp["tm_norm"], cfg.norm_eps)
    y, (hT, x_last_t) = ssm.rwkv6_time_mix(bp["tm"], h, cfg)
    x = settle(x + y)
    h = rms_norm(x, bp["cm_norm"], cfg.norm_eps)
    y, x_last_c = ssm.rwkv6_channel_mix(bp["tm"], h)
    return settle(x + y), (hT, x_last_t, x_last_c)


def _stack(states: list) -> tuple:
    """Per-layer tuples of tensors → a tuple of [L, …] stacks."""
    return tuple(torch.stack(leaf) for leaf in zip(*states))


def _mamba_layer(bp: Params, cfg: ArchConfig, x):
    bp = sharding.gather_dp(bp)
    h = rms_norm(x, bp["mamba_norm"], cfg.norm_eps)
    y, st = ssm.mamba2_forward(bp["mamba"], h, cfg)
    return settle(x + y), st


def _trunk(p: Params, cfg: ArchConfig, tokens, collect_cache: bool,
           remat_blocks: bool = False):
    """Embedding and layer stack: (final hidden [B, S, D], cache or None,
    summed MoE aux loss).

    The cache has the reference's layout: attention families (k, v) or
    MLA's (c, k_rope), stacked [L, …]; ssm (h, prev_t, prev_c) stacked;
    hybrid {"mamba": (h [L, …], conv tails [L, …]), "attn": (k, v) stacked
    over the shared block's applications}.  With ``remat_blocks`` each
    block (each Mamba2 layer of the hybrid; its shared block is not, as in
    the reference) runs under `layers.remat`.
    """
    x = _embed_in(p, cfg, tokens)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    layers = _unstack(p["blocks"], cfg.n_layers)
    run = _remat if remat_blocks else (lambda fn, *a: fn(*a))
    states, mamba = [], []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        off = 0
        for gs in _hybrid_group_ids(cfg):
            for i in range(off, off + gs):
                x, st = run(_mamba_layer, layers[i], cfg, x)
                if collect_cache:
                    mamba.append(st)
            off += gs
            if gs == cfg.attn_every:
                x, kv = _shared_block(p, cfg, x, positions)
                if collect_cache:
                    states.append(kv)
        if not collect_cache:
            return x, None, aux
        return x, {"mamba": _stack(mamba), "attn": _stack(states)}, aux
    for bp in layers:
        if cfg.family == "ssm":
            x, st = run(_rwkv_block, bp, cfg, x)
        else:
            x, st, a = run(_attn_block, bp, cfg, x, positions)
            if a is not None:
                aux = aux + a
        if collect_cache:
            states.append(st)
    return x, _stack(states) if collect_cache else None, aux


def forward(p: Params, cfg: ArchConfig, tokens, *, collect_cache=False):
    """Full-sequence forward.  tokens: [B, S] ints or [B, S, D] stub
    embeddings.

    Returns (logits [B, S, V] f32, {"moe_aux", "cache"}) as the reference.
    """
    x, cache, aux = _trunk(p, cfg, tokens, collect_cache)
    return _logits(p, cfg, x), {"moe_aux": aux, "cache": cache}


# ================================================================= loss ==
def _hidden(p: Params, cfg: ArchConfig, tokens, *, remat: bool = False):
    """Forward up to the final hidden states (no LM head): (x, summed MoE
    aux loss)."""
    x, _, aux = _trunk(p, cfg, tokens, collect_cache=False,
                       remat_blocks=remat)
    return x, aux


def _chunk_nll(x, labels, head):
    """Σ (logsumexp − gold logit) over one slice of positions, logits in
    f32.  On a mesh the logits keep the vocabulary split over "tp" and the
    sum runs vocab-parallel (`sharding.vocab_parallel_nll`): no rank
    gathers a logits slice."""
    logits = constrain((x @ head).float(), ("dp", None, "tp"))
    if sharding.is_distributed(logits):
        return sharding.vocab_parallel_nll(logits, labels)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (torch.logsumexp(logits, -1) - gold).sum()


def loss_fn(p: Params, cfg: ArchConfig, tokens, labels, *,
            remat: bool = False, moe_aux_weight: float = 0.01,
            seq_chunk: int = 512):
    """Causal-LM cross entropy (f32) plus the MoE load-balance aux loss,
    as the reference's: (nll + moe_aux_weight·aux, {"nll", "moe_aux"}).

    The LM head and softmax run over slices of ``ck`` positions (``ck`` =
    min(seq_chunk, S), halved until it divides S), each slice under
    `layers.remat`, so the f32 [B, S, V] logits never exist whole: at
    Gemma-2B's 256,000-word vocabulary one [8, 512] slice is already
    4.2 GB.
    """
    x, aux = _hidden(p, cfg, tokens, remat=remat)
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    head = sharding.gather_dp(
        p["embed"].T if cfg.tie_embeddings else p["lm_head"])
    B, S, _ = x.shape
    ck = min(seq_chunk, S)
    while S % ck:
        ck //= 2
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, ck):
        total = total + _remat(_chunk_nll, x[:, c0:c0 + ck],
                               labels[:, c0:c0 + ck], head)
    nll = sharding.replicate(total / (B * S))
    aux = sharding.replicate(aux)
    return nll + moe_aux_weight * aux, {"nll": nll, "moe_aux": aux}


# ================================================================ cache ==
def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device=None, like=None) -> Cache:
    """The empty decode cache, laid out as the reference's.  With a
    DTensor ``like`` (an activation on a mesh) each leaf is a DTensor on
    its mesh placed by `sharding.cache_specs`, each rank making only its
    shard."""
    if like is not None and sharding.is_distributed(like):
        mesh, local = like.device_mesh, like.to_local()
        meta = init_cache(cfg, batch, max_seq, device="meta")
        specs = sharding.cache_specs(cfg, meta, mesh)
        return sharding.map_with_path(
            lambda path, x: sharding.new_placed(
                local, x.shape, x.dtype, mesh, _at(specs, path),
                -1 if path[-1] == "pos" else 0), meta)
    dt = param_dtype(cfg)
    L, D = cfg.n_layers, cfg.d_model
    z = lambda *s, dtype=dt: torch.zeros(s, dtype=dtype, device=device)
    unfilled = lambda *s: torch.full(s, -1, dtype=torch.int32, device=device)
    if cfg.family == "ssm":
        hd = cfg.rwkv_head_dim
        return {"h": z(L, batch, D // hd, hd, hd, dtype=torch.float32),
                "prev_t": z(L, batch, 1, D), "prev_c": z(L, batch, 1, D)}
    if cfg.family == "hybrid":
        di = 2 * D
        n_apps = sum(1 for g in _hybrid_group_ids(cfg)
                     if g == cfg.attn_every)
        kv = (n_apps, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        return {"h": z(L, batch, cfg.ssm_heads, cfg.ssm_state,
                       di // cfg.ssm_heads, dtype=torch.float32),
                "conv": z(L, batch, 3, di), "k": z(*kv), "v": z(*kv),
                "pos": unfilled(n_apps, batch, max_seq)}
    if cfg.mla_kv_lora:
        return {"c": z(L, batch, max_seq, cfg.mla_kv_lora),
                "kr": z(L, batch, max_seq, cfg.mla_rope_dim)}
    w = min(max_seq, cfg.window) if cfg.attn_kind == "swa" else max_seq
    kv = (L, batch, w, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        sc = (L, batch, w, cfg.n_kv_heads, 1)
        return {"k": z(*kv, dtype=torch.int8), "v": z(*kv, dtype=torch.int8),
                "ks": z(*sc, dtype=torch.float16),
                "vs": z(*sc, dtype=torch.float16),
                "pos": unfilled(L, batch, w)}
    return {"k": z(*kv), "v": z(*kv), "pos": unfilled(L, batch, w)}


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _placed_as_specs(cfg: ArchConfig, cache: Cache, mesh) -> Cache:
    """Every leaf of a prefill's cache on ``mesh`` as `sharding.
    cache_specs` places it (a leaf computed on the mesh may come out
    placed otherwise; a plain one, the same on every rank, keeps its
    slice)."""
    specs = sharding.cache_specs(cfg, cache, mesh)
    return sharding.map_with_path(
        lambda path, x: sharding.distribute_leaf(
            x, mesh, sharding.placements(mesh, _at(specs, path))), cache)


def _fill_kv(cache: Cache, k, v, S: int) -> Cache:
    """Write the prompt's keys and values into the cache (the trailing
    window, ring-aligned so position p sits in slot p % w, when the prompt
    fills it); an int8 cache takes them quantised, its scales laid out
    alongside."""
    w = cache["k"].shape[2]
    leaves = {"k": k, "v": v}
    if "ks" in cache:
        leaves["k"], leaves["ks"] = attn.quantize_kv(k)
        leaves["v"], leaves["vs"] = attn.quantize_kv(v)
    if S >= w:
        shift = S % w
        for name, t in leaves.items():
            cache[name] = torch.roll(t[:, :, S - w:], shift, 2).contiguous()
        pos = torch.arange(S - w, S, dtype=torch.int32, device=k.device)
        cache["pos"].copy_(torch.roll(pos, shift, 0).expand_as(cache["pos"]))
    else:
        for name, t in leaves.items():
            cache[name][:, :, :S] = t
        cache["pos"][:, :, :S] = torch.arange(S, dtype=torch.int32,
                                              device=k.device)
    return cache


# =============================================================== prefill ==
def prefill(p: Params, cfg: ArchConfig, tokens, max_seq: int):
    """Full-sequence prefill.  Returns (last-token logits [B, V], cache,
    S), the cache laid out for `decode_step` at position S.

    The LM head is applied to the last position only: the rows are
    independent and only the last is returned, and at Gemma's 256,000-word
    vocabulary the whole [B, S, V] f32 tensor would take gigabytes.  On a
    mesh the cache comes back placed by `sharding.cache_specs`, as
    `decode_step` takes it.
    """
    B, S = tokens.shape[:2]
    x, fc, _ = _trunk(p, cfg, tokens, collect_cache=True)
    last = _logits(p, cfg, x[:, -1:])[:, 0]
    if cfg.family == "ssm":
        cache = dict(zip(("h", "prev_t", "prev_c"), fc))
    else:
        cache = init_cache(cfg, B, max_seq, device=x.device, like=x)
        if cfg.mla_kv_lora:
            cache["c"][:, :, :S], cache["kr"][:, :, :S] = fc
        else:
            if cfg.family == "hybrid":
                cache["h"], cache["conv"] = fc["mamba"]
                fc = fc["attn"]
            if fc:                  # a hybrid cut below one group has none
                cache = _fill_kv(cache, *fc, S)
    if sharding.is_distributed(x):
        cache = _placed_as_specs(cfg, cache, x.device_mesh)
    return last, cache, S


# ================================================================ decode ==
def decode_step(p: Params, cfg: ArchConfig, cache: Cache, token, pos: int):
    """One decode step.  token: [B] ints or [B, D] stub embeddings; pos:
    the absolute position (a Python int).  Returns (logits [B, V] f32,
    cache), the cache updated in place.  On a mesh each layer gathers its
    FSDP weights first, as a training block does (`sharding.gather_dp`):
    a weight split over "data" would otherwise gather the batch, and with
    it every rank's cache."""
    x = _embed_in(p, cfg, token[:, None])           # [B, 1, D]
    if cfg.family == "hybrid":
        return _hybrid_decode(p, cfg, cache, x, pos)
    for i, bp in enumerate(_unstack(p["blocks"], cfg.n_layers)):
        bp = sharding.gather_dp(bp)
        if cfg.family == "ssm":
            h = rms_norm(x, bp["tm_norm"], cfg.norm_eps)
            y, h2, pt = ssm.rwkv6_time_mix_decode(
                bp["tm"], h, cfg, cache["h"][i], cache["prev_t"][i])
            x = x + y
            h = rms_norm(x, bp["cm_norm"], cfg.norm_eps)
            # the channel-mix reads the "tm" subtree, as the reference
            y, pc = ssm.rwkv6_channel_mix(bp["tm"], h, cache["prev_c"][i])
            cache["h"][i], cache["prev_t"][i], cache["prev_c"][i] = h2, pt, pc
            x = x + y
            continue
        h = rms_norm(x, bp["attn_norm"], cfg.norm_eps)
        if cfg.mla_kv_lora:
            a, *_ = attn.mla_decode(bp["attn"], h, cfg, cache["c"][i],
                                    cache["kr"][i], pos)
        else:
            scales = ({"k": cache["ks"][i], "v": cache["vs"][i]}
                      if cfg.kv_cache_dtype == "int8" else None)
            a, *_ = attn.gqa_decode(bp["attn"], h, cfg, cache["k"][i],
                                    cache["v"][i], cache["pos"][i], pos,
                                    kv_scales=scales)
        x = x + a
        h = rms_norm(x, bp["mlp_norm"], cfg.norm_eps)
        if "moe" in bp:
            m, _ = moe_apply(bp["moe"], h, cfg)
        else:
            m = mlp_apply(bp["mlp"], h, cfg.mlp)
        x = x + m
    return _logits(p, cfg, x)[:, 0], cache


def _hybrid_decode(p: Params, cfg: ArchConfig, cache: Cache, x, pos: int):
    layers = _unstack(p["blocks"], cfg.n_layers)
    p = dict(p, **sharding.gather_dp({k: p[k] for k in (
        "shared_attn_norm", "shared_attn", "shared_mlp_norm",
        "shared_mlp")}))
    off = app = 0
    for gs in _hybrid_group_ids(cfg):
        for i in range(off, off + gs):
            lp = sharding.gather_dp(layers[i])
            hh = rms_norm(x, lp["mamba_norm"], cfg.norm_eps)
            y, h2, c2 = ssm.mamba2_decode(lp["mamba"], hh, cfg,
                                          cache["h"][i], cache["conv"][i])
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
