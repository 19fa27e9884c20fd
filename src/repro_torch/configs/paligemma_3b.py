"""paligemma-3b — VLM: SigLIP vision tower (STUB) + gemma decoder backbone.

[arXiv:2407.07726; hf] 18L d_model=2048 8H (GQA kv=1, MQA) d_ff=16384
vocab=257216. The SigLIP patch frontend is a STUB: input_specs() provides
precomputed patch embeddings (B, 256 patches, frontend_dim) that are
projected and prepended to the text sequence.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    tie_embeddings=True,
    act="gelu_glu",
    frontend="vision",
    frontend_dim=1152,  # SigLIP-So400m embedding width (stubbed)
    frontend_seq=256,   # 224x224 / 14x14 patches
    source="[arXiv:2407.07726; hf]",
))
