"""deepseek-v2-236b [moe] — 60L d_model=5120 128H (MLA) d_ff=1536 vocab=102400,
MoE 160 routed top-6 + 2 shared experts, MLA kv_lora=512.  [arXiv:2405.04434; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=1536,
    vocab_size=102_400,
    mlp="swiglu",
    attn_kind="full",
    mla_kv_lora=512,
    mla_rope_dim=64,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1536,
    tie_embeddings=False,
    source="arXiv:2405.04434; hf",
)
