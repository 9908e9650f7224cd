"""zamba2-7b [hybrid] — 81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000,
ssm_state=64.  Mamba2 trunk + shared attention blocks.  [arXiv:2411.15242; unverified]

Hybrid layout: Mamba2 layers with one *shared-weight* attention block applied
every `attn_every` SSM layers (Zamba2's shared-attention design).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32_000,
    mlp="swiglu",
    attn_kind="full",
    ssm_state=64,
    ssm_heads=112,          # d_inner = 2·d_model = 7168, ssm head_dim 64
    attn_every=6,
    tie_embeddings=True,
    source="arXiv:2411.15242; unverified",
)
