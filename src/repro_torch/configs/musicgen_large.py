"""musicgen-large [audio] — 48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048.
Decoder-only over EnCodec tokens.  Backbone only; the EnCodec frontend is a
STUB — `input_specs()` supplies precomputed frame-token embeddings.
[arXiv:2306.05284; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2_048,
    mlp="gelu",
    attn_kind="full",
    frontend="frame",
    tie_embeddings=False,
    source="arXiv:2306.05284; hf",
)
