"""granite-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.

Llama-architecture code model: RoPE + SwiGLU + GQA [arXiv:2405.04324].
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=49152,
    activation="swiglu",
    tie_embeddings=False,
)
