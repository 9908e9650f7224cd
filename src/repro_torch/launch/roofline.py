"""Analytic roofline model (NVIDIA H100 SXM targets) for the dry run.

Port of `repro.launch.roofline`: the same `Roofline` terms, `analytic`,
`_attn_flops`, `_cache_bytes` and `DEFAULT_OPTS`, every formula unchanged;
only the hardware constants are the H100's.  The analytic model stands in
for a compiler's cost analysis, which the port does not have: the dry run
(`launch.dryrun`) records it beside the flops its shape rules count and
the collectives its census sees.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed.sharding import use_fsdp

# NVIDIA H100 SXM5 data sheet (the rates assume the full 700 W power limit)
PEAK_FLOPS = 989e12          # dense bf16 on the tensor cores, per GPU
HBM_BW = 3.35e12             # HBM3 bytes/s per GPU
PEAK_F32_FLOPS = 67e12       # f32 on the CUDA cores (no tensor cores)
PEAK_TF32_FLOPS = 495e12     # dense TF32 on the tensor cores
# one 400 Gb/s NDR InfiniBand port a GPU (ConnectX-7): a 16×16 mesh spans
# 32 eight-GPU nodes; NVLink 4's 450e9 B/s a direction holds only for a
# mesh of at most 8 ranks, all in one node
LINK_BW = 50e9               # bytes/s per GPU


@dataclasses.dataclass
class Roofline:
    flops: float                 # total useful FLOPs for the step (all chips)
    hbm_bytes: float             # total HBM traffic (all chips)
    collective_bytes: float      # total link payload bytes (all chips)
    model_flops: float           # 6·N·D (train) / 2·N·D (decode) reference
    chips: int

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.chips * LINK_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU bound: compute term / dominant term."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        return self.t_compute / t if t else 0.0

    per_chip_hbm_bytes: float = 0.0   # analytic resident estimate

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops, "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "roofline_fraction": self.roofline_fraction,
            "useful_ratio": (self.model_flops / self.flops
                             if self.flops else 0.0),
            "per_chip_hbm_gb": self.per_chip_hbm_bytes / 1e9,
        }


def _attn_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Score+value FLOPs (fwd).  Causal halves the full square."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "ssm":
        # chunked SSD: per token 2·(H·N·P) state update + readout ×2
        H = cfg.d_model // cfg.rwkv_head_dim
        n, p = cfg.rwkv_head_dim, cfg.rwkv_head_dim
        per_tok = 4 * H * n * p
        toks = B * (1 if shape.is_decode else S)
        return cfg.n_layers * toks * per_tok
    d_attn = cfg.n_heads * cfg.head_dim
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every
        H, n, p = cfg.ssm_heads, cfg.ssm_state, 2 * cfg.d_model // cfg.ssm_heads
        ssm_per_tok = 4 * H * n * p
        toks = B * (1 if shape.is_decode else S)
        ssm = cfg.n_layers * toks * ssm_per_tok
    else:
        n_attn = cfg.n_layers
        ssm = 0.0
    eff = min(S, cfg.window) if cfg.attn_kind == "swa" and cfg.window else S
    if shape.is_decode:
        attn = n_attn * B * 4 * d_attn * eff          # 1 token vs eff cache
    else:
        attn = n_attn * B * 4 * d_attn * S * eff / (1 if cfg.attn_kind ==
                                                    "swa" else 2)
    return attn + ssm


DEFAULT_OPTS = {"kv_int8": False, "n_microbatches": 1, "tp_attention": True,
                "grad_compress": False}


def analytic(cfg: ArchConfig, shape: ShapeConfig, mesh_shape: dict,
             remat: bool = True, opts: dict | None = None) -> Roofline:
    """Roofline terms for one (arch × shape × mesh) cell (the reference's
    formulas; the port reads them per GPU).

    FLOPs:  matmul work = 2·N_active per token forward; train = 3× forward
            (activation-grad + weight-grad each cost a forward); +1 forward
            if remat recomputes the scan body.  Attention/SSD added per
            `_attn_flops`.
    HBM:    train: params read fwd+bwd + opt state rw + grads + activations;
            decode: active params + full KV/state cache read per token;
            prefill: params + activations.
    Links:  TP: 2 activation all-reduces per layer (fwd), ×3 train, ring cost
            2·(n−1)/n per chip ⇒ ≈ 2 payload;  DP: gradient all-reduce
            2·params·(r−1)/r across data(+pod);  FSDP: per-layer weight
            all-gather fwd+bwd + grad reduce-scatter (≈ 3·params·(f−1)/f);
            EP: token dispatch/return all-to-alls ≈ 4·tokens·D·(e−1)/e.
    """
    opts = {**DEFAULT_OPTS, **(opts or {})}
    if opts.get("kv_int8"):
        cfg = __import__("dataclasses").replace(cfg, kv_cache_dtype="int8")
    chips = 1
    for v in mesh_shape.values():
        chips *= v
    tp = mesh_shape.get("model", 1)
    dp = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    tp_attn = opts["tp_attention"]
    n_mb = max(opts["n_microbatches"], 1)

    B, S = shape.global_batch, shape.seq_len
    toks = B * (1 if shape.is_decode else S)
    n_active = cfg.active_param_count()
    n_total = cfg.param_count()
    bpe = 2 if cfg.dtype == "bfloat16" else 4

    mm_fwd = 2 * n_active * toks
    attn_fwd = _attn_flops(cfg, shape)
    fwd = mm_fwd + attn_fwd

    if shape.kind == "train":
        flops = fwd * (4 if remat else 3)
        model_flops = 6 * n_active * toks
    else:
        flops = fwd
        model_flops = 2 * n_active * toks

    # ---- HBM bytes ---------------------------------------------------------
    act_bytes_layer = toks * cfg.d_model * bpe
    if shape.kind == "train":
        hbm = (n_total * bpe * 3          # params fwd + bwd(×2 passes)
               + n_total * 4 * 3          # opt m/v read+write + f32 grads
               + cfg.n_layers * act_bytes_layer * (2 if remat else 6))
    elif shape.kind == "prefill":
        hbm = n_total * bpe + cfg.n_layers * act_bytes_layer * 4
    else:  # decode: weights + cache traffic dominate
        cache_bytes = _cache_bytes(cfg, shape, bpe)
        hbm = n_active * bpe + cache_bytes + cfg.n_layers * act_bytes_layer * 4
    # ---- collective bytes (TOTAL link-payload across all chips) -------------
    # Ring all-reduce of M bytes over n chips moves 2·M·(n−1)/n per chip ⇒
    # 2·M·(n−1) per group.  TP groups each all-reduce the FULL group
    # activation (M = toks_global/dp_groups · D · bpe), dp_groups of them ⇒
    # total = n_AR · L · 2 · act_all · (tp−1)  with act_all = toks·D·bpe.
    # n_AR = 2/layer fwd; ×3 for train (fwd + remat-recompute + bwd dgrad).
    coll = 0.0
    act_all = toks * cfg.d_model * bpe
    layers_tp = cfg.n_layers
    if tp > 1 and tp_attn:
        n_ar = 6 if shape.kind == "train" else 2
        coll += n_ar * layers_tp * act_all * (tp - 1)
    if shape.kind == "train" and dp > 1:
        # DP grad all-reduce: each of the tp·dp chips rings its N/tp shard
        # over dp replicas ⇒ total = 2·N·bpe·(dp−1); int8 error-feedback
        # compression halves the payload vs bf16
        gbpe = 1 if opts.get("grad_compress") else bpe
        coll += 2 * n_total * gbpe * (dp - 1)
    if (use_fsdp(cfg) or not tp_attn) and mesh_shape.get("data", 1) > 1 \
            and shape.kind == "train":
        # ZeRO-3: all-gather weights (fwd + remat + bwd) + reduce-scatter
        # grads ⇒ ≈ 4 passes of N·bpe over the data axis
        f = mesh_shape["data"]
        coll += 4 * n_total * bpe * (f - 1)
    if cfg.is_moe and cfg.n_experts % tp == 0 and tp > 1:
        # EP all-to-all: dispatch + return, each token crosses once ⇒
        # 2 · toks·D·bpe · (tp−1)/tp per pass (point-to-point, no ring factor)
        mult = 3 if shape.kind == "train" else 1
        coll += 2 * toks * cfg.d_model * bpe * (tp - 1) / tp * mult

    # ---- per-chip resident memory (bf16 weights and cache, f32 moments) --
    fsdp_div = mesh_shape.get("data", 1) if (use_fsdp(cfg) or not tp_attn) \
        else 1
    tp_div = tp if tp_attn else (tp if cfg.is_moe else 1)
    param_res = n_total * bpe / (tp_div * fsdp_div)
    if shape.kind == "train":
        opt_res = n_total * 8 / (tp_div * fsdp_div)          # m, v f32
        b_loc = max(B // dp, 1)
        # scan-saved carries scale with the MICRObatch; the f32 grad
        # accumulator (param-sharded) appears when n_mb > 1
        act_res = cfg.n_layers * (b_loc / n_mb) * S * cfg.d_model * bpe
        acc_res = (n_total * 4 / (tp_div * fsdp_div)) if n_mb > 1 else 0.0
        per_chip = param_res + opt_res + act_res + acc_res
    elif shape.kind == "prefill":
        b_loc = max(B // dp, 1)
        per_chip = param_res + _cache_bytes(cfg, shape, bpe) / chips \
            + 4 * b_loc * S * cfg.d_model * bpe
    else:
        per_chip = param_res + _cache_bytes(cfg, shape, bpe) / chips

    return Roofline(flops=float(flops), hbm_bytes=float(hbm),
                    collective_bytes=float(coll),
                    model_flops=float(model_flops), chips=chips,
                    per_chip_hbm_bytes=float(per_chip))


def _cache_bytes(cfg: ArchConfig, shape: ShapeConfig, bpe: int) -> float:
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "ssm":
        H = cfg.d_model // cfg.rwkv_head_dim
        return cfg.n_layers * B * H * cfg.rwkv_head_dim ** 2 * 4 * 2
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every
        ssm = cfg.n_layers * B * cfg.ssm_heads * cfg.ssm_state \
            * (2 * cfg.d_model // cfg.ssm_heads) * 4 * 2
        kv = n_attn * B * S * 2 * cfg.n_kv_heads * cfg.head_dim * bpe
        return ssm + kv
    if cfg.mla_kv_lora:
        return cfg.n_layers * B * S * (cfg.mla_kv_lora + cfg.mla_rope_dim) \
            * bpe
    eff = min(S, cfg.window) if cfg.attn_kind == "swa" and cfg.window else S
    if cfg.kv_cache_dtype == "int8":
        # 1 byte/elem + f16 scale per (pos, head): dh elems share one scale
        kv_bpe = 1.0 + 2.0 / cfg.head_dim
        return cfg.n_layers * B * eff * 2 * cfg.n_kv_heads * cfg.head_dim \
            * kv_bpe
    return cfg.n_layers * B * eff * 2 * cfg.n_kv_heads * cfg.head_dim * bpe
