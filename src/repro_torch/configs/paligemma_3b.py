"""paligemma-3b [vlm]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216.

SigLIP vision tower + gemma LM [arXiv:2407.07726].  The SigLIP frontend is a
STUB: inputs are precomputed patch embeddings (frontend_dim=1152, 256 patches
per image) projected into d_model; text attends with a bidirectional prefix
over image tokens (prefix-LM mask).
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=257216,
    activation="geglu",
    tie_embeddings=True,
    embed_scale=True,
    frontend_dim=1152,
    num_patches=256,
)
