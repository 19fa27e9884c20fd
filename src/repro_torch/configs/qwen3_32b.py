"""qwen3-32b — dense GQA with qk_norm.

[hf:Qwen/Qwen3-8B; hf] 64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    qkv_bias=False,
    rope_theta=1e6,
    tie_embeddings=False,
    act="silu",
    source="[hf:Qwen/Qwen3-8B; hf]",
))
