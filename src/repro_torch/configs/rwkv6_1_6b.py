"""rwkv6-1.6b [ssm] — 24L d_model=2048 (attention-free) d_ff=7168 vocab=65536.
Finch — data-dependent decay linear attention.  [arXiv:2404.05892; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=7168,
    vocab_size=65_536,
    mlp="gelu",           # RWKV channel-mix (squared-relu-ish; gelu proxy kept simple)
    attn_kind="none",
    rwkv_head_dim=64,
    tie_embeddings=False,
    source="arXiv:2404.05892; unverified",
)
