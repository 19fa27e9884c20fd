"""granite-moe-1b-a400m — fine-grained MoE, 32 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf] 24L d_model=1024 16H (GQA kv=8)
d_ff=512 per expert, vocab=49155.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512, n_shared_experts=0,
                  capacity_factor=2.0, group_size=1024),
    tie_embeddings=True,
    act="silu",
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]",
))
