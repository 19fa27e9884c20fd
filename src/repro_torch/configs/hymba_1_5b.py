"""hymba-1.5b — hybrid: parallel attention + mamba heads in each block.

[arXiv:2411.13676; hf] 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001
ssm_state=16. Sliding-window attention except 3 global (full-attention)
layers (first/middle/last), per the Hymba paper.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, conv_width=4, n_groups=1,
                  chunk=256),
    sliding_window=2048,
    n_global_layers=3,
    tie_embeddings=True,
    act="silu",
    source="[arXiv:2411.13676; hf]",
))
