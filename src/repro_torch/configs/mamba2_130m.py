"""mamba2-130m [ssm]: 24L d_model=768 (attention-free) vocab=50280,
ssm_state=128 — SSD / state-space duality [arXiv:2405.21060].

d_inner = 2 * d_model = 1536, 24 SSD heads of head_dim 64, shared B/C
(one group), conv width 4, SSD chunk 256.  State-size decode means the
long_500k cell runs at O(1) memory in sequence length.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=24,          # SSD heads (d_inner / ssm_head_dim)
    n_kv_heads=24,
    head_dim=64,
    d_ff=0,              # attention-free, no FFN sublayer
    vocab=50280,
    tie_embeddings=True,
    ssm_state=128,
    ssm_expand=2,
    ssm_conv=4,
    ssm_head_dim=64,
    ssm_chunk=256,
)
