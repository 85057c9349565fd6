"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.

Encoder-only (bidirectional), same backbone as wav2vec2 [arXiv:2106.07447].
The conv waveform frontend is a STUB: inputs are precomputed frame embeddings
(frontend_dim=512); the vocab is the HuBERT pseudo-label codebook (504 units),
which examples/hubert_units.py regenerates with DPC instead of k-means.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    activation="geglu",
    is_causal=False,
    tie_embeddings=False,
    frontend_dim=512,
)
