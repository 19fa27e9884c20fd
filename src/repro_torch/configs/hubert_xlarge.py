"""hubert-xlarge — encoder-only audio transformer (w2v2-style backbone).

[arXiv:2106.07447; unverified] 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.
The convolutional waveform frontend is a STUB: input_specs() provides
precomputed frame embeddings (B, T, frontend_dim).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    encoder_only=True,
    tie_embeddings=False,
    act="gelu",
    frontend="audio",
    frontend_dim=512,  # conv feature extractor output dim (stubbed)
    source="[arXiv:2106.07447; unverified]",
))
