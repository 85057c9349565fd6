"""h2o-danube-1.8b [dense]: 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000 — llama + mistral mix with sliding-window attention
[arXiv:2401.16818].  The 4096-token window makes decode memory O(window),
so the long_500k cell runs for this arch.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab=32000,
    activation="swiglu",
    sliding_window=4096,
    tie_embeddings=False,
)
