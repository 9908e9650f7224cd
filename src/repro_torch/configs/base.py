"""Architecture config schema (data-only copy of `repro.configs.base`): read by
the density calibration and the serving launcher's ``--arch`` resolution."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One LM-family architecture (see ARCHITECTURES table in DESIGN.md)."""

    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                # 0 for attention-free archs (rwkv6 uses d_model/64 internally)
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- MLP ------------------------------------------------------------
    mlp: str = "swiglu"         # geglu | swiglu | gelu

    # --- attention extras -------------------------------------------------
    attn_kind: str = "full"     # full | swa | none
    window: int = 0             # sliding-window size (swa)
    mla_kv_lora: int = 0        # >0 ⇒ DeepSeek-V2 MLA latent KV rank
    mla_rope_dim: int = 64      # decoupled RoPE head dim for MLA

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0           # per-expert hidden dim (0 ⇒ use d_ff)
    # capacity-factor semantics: overflow beyond cap is dropped (std MoE);
    # reduced/smoke configs use a generous factor so train/decode logits
    # match exactly in the cache-consistency tests
    moe_capacity_factor: float = 1.3

    # --- SSM / linear attention ----------------------------------------------
    ssm_state: int = 0          # Mamba2 state dim per head
    ssm_heads: int = 0
    rwkv_head_dim: int = 64

    # --- hybrid (zamba2): shared attention block every `attn_every` ssm layers -
    attn_every: int = 0

    # --- modality frontends (stub) ---------------------------------------------
    frontend: str = "token"     # token | patch (vlm) | frame (audio)

    # --- serving ---------------------------------------------------------------
    kv_cache_dtype: str = ""    # "" ⇒ model dtype; "int8" ⇒ quantised cache

    # --- misc ---------------------------------------------------------------
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    source: str = ""            # provenance tag [arXiv/hf; tier]

    # ------------------------------------------------------------------ helpers
    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.attn_kind == "none"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / linear-attn / sliding window)."""
        return self.family in ("ssm", "hybrid") or self.attn_kind == "swa"

    @property
    def expert_activation(self) -> float:
        """ω — active-parameter activation rate (paper §4.2 density metric).

        MoE: (shared + top-k) / (shared + routed).  Dense: 1.0.
        """
        if not self.is_moe:
            return 1.0
        return (self.n_shared_experts + self.top_k) / (
            self.n_shared_experts + self.n_experts)

    def kv_bytes_per_token_layer(self) -> float:
        """Per-layer, per-token decode-cache footprint in bf16 bytes.

        Full/SWA attention: 2·n_kv·head_dim.  MLA: latent rank + decoupled RoPE key.
        SSM: recurrent state amortised (heads·state·head_dim per *sequence*, not per
        token) — returned as 0 here; density handles SSM state separately.
        """
        if self.mla_kv_lora > 0:
            return 2.0 * (self.mla_kv_lora + self.mla_rope_dim)
        if self.attn_kind == "none":
            return 0.0
        return 2.0 * (2 * self.n_kv_heads * self.head_dim)

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6·N·D roofline row)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":          # RWKV6: 5 d×d time-mix + channel-mix
            per_layer = 5 * d * d + d * d + 2 * d * self.d_ff
            return emb + L * per_layer
        if self.attn_every:               # hybrid: mamba per layer; the
            mamba = 6 * d * d             # SHARED attn+MLP counted once
            shared = (2 * d * self.n_heads * self.head_dim
                      + 2 * d * self.n_kv_heads * self.head_dim
                      + 3 * d * self.d_ff)
            return emb + L * mamba + shared
        per_layer = 0
        q = d * self.n_heads * self.head_dim
        kv = 2 * d * self.n_kv_heads * self.head_dim
        o = self.n_heads * self.head_dim * d
        if self.mla_kv_lora:
            kv = d * self.mla_kv_lora + self.mla_kv_lora * (
                self.n_heads * self.head_dim) * 2
        per_layer += q + kv + o
        if self.is_moe:
            dff = self.moe_d_ff or self.d_ff
            n_ff = self.n_experts + self.n_shared_experts
            per_layer += 3 * d * dff * n_ff + d * self.n_experts  # + router
        else:
            mult = 3 if self.mlp in ("swiglu", "geglu") else 2
            per_layer += mult * d * self.d_ff
        return emb + L * per_layer

    def active_param_count(self) -> int:
        """N_active for MoE (6·N_active·D roofline row)."""
        if not self.is_moe:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        q = d * self.n_heads * self.head_dim
        kv = 2 * d * self.n_kv_heads * self.head_dim
        if self.mla_kv_lora:
            kv = d * self.mla_kv_lora + self.mla_kv_lora * (
                self.n_heads * self.head_dim) * 2
        o = self.n_heads * self.head_dim * d
        dff = self.moe_d_ff or self.d_ff
        active_ff = 3 * d * dff * (self.top_k + self.n_shared_experts)
        return emb + L * (q + kv + o + active_ff + d * self.n_experts)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (seq_len × global_batch × step kind)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Smoke-test variant: same family/topology, tiny dims."""
    small = dict(
        n_layers=min(cfg.n_layers, 4) if not cfg.attn_every
        else max(cfg.attn_every + 1, 4),
        d_model=128,
        n_heads=min(cfg.n_heads, 4) if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=32 if cfg.head_dim else 0,
        d_ff=256,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 4),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        top_k=min(cfg.top_k, 2),
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        mla_kv_lora=32 if cfg.mla_kv_lora else 0,
        moe_capacity_factor=4.0,
        mla_rope_dim=16 if cfg.mla_kv_lora else 64,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_heads=min(cfg.ssm_heads, 4) if cfg.ssm_heads else 0,
        window=min(cfg.window, 64) if cfg.window else 0,
        attn_every=min(cfg.attn_every, 2) if cfg.attn_every else 0,
        dtype="float32",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
