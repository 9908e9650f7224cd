"""granite-34b [dense] — 88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
Code model.  [arXiv:2405.04324; hf]

MLP note: the published 34B total is only consistent with a 2-matrix GELU
MLP (GPT-BigCode lineage: 2·d·ff·88 = 26.6B); a SwiGLU reading gives 47B.
We follow the parameter count (hf checkpoint concurs: gpt_bigcode arch).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49_152,
    mlp="gelu",
    attn_kind="full",
    tie_embeddings=False,
    source="arXiv:2405.04324; hf",
)
