"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000 — RG-LRU recurrent blocks + local attention, 1 attn : 2 rec
[arXiv:2402.19427].

38 layers = 12 x (rec, rec, attn) superblocks + 2 trailing rec layers.
Local attention window 2048, RG-LRU width 4096, temporal conv width 4.
Bounded decode state means the long_500k cell runs for this arch.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    activation="geglu",
    tie_embeddings=True,
    embed_scale=True,
    pattern=("rec", "rec", "attn"),
    local_window=2048,
    rnn_width=4096,
    ssm_conv=4,
)
