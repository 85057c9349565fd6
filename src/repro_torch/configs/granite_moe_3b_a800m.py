"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8 [hf:ibm-granite granite-3.0 family].

d_ff is the per-expert FFN width; 8 of 40 experts are active per token.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    activation="swiglu",
    tie_embeddings=True,
    n_experts=40,
    top_k=8,
    # 40 % 16 != 0: expert weights/buffers are padded to 48 so 16-way
    # expert parallelism applies (~17% padded capacity, 16x sharding; §Perf)
    n_experts_padded=48,
)
