"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

d_ff is the per-expert FFN width (moe_intermediate_size); head_dim=128.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab=151936,
    activation="swiglu",
    tie_embeddings=False,
    n_experts=128,
    top_k=8,
)
