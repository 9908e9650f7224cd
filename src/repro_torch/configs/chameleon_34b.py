"""chameleon-34b [vlm] — 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.
Early-fusion, VQ image tokens.  Backbone only; the VQ-VAE image tokenizer is a
STUB — `input_specs()` supplies precomputed patch-token embeddings.
[arXiv:2405.09818; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65_536,
    mlp="swiglu",
    attn_kind="full",
    frontend="patch",
    tie_embeddings=False,
    source="arXiv:2405.09818; unverified",
)
