"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.

GeGLU, head_dim=256, tied embeddings with sqrt(d) input scaling
[arXiv:2403.08295].
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=256000,
    activation="geglu",
    tie_embeddings=True,
    embed_scale=True,
)
