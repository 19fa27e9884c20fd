"""deepseek-v2-236b — MLA + fine-grained MoE (2 shared + 160 routed, top-6).

[arXiv:2405.04434; hf] 60L d_model=5120 128H, MLA kv_lora=512 (rope_dim=64,
nope_dim=128, v_dim=128, q_lora=1536), d_ff=1536 per routed expert,
vocab=102400. First layer uses a dense MLP (d_ff=12288), per the paper.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=12288,  # dense-MLP width for the leading dense layer
    vocab_size=102400,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536, n_shared_experts=2,
                  first_dense_layers=1, capacity_factor=2.0, group_size=1024),
    tie_embeddings=False,
    act="silu",
    source="[arXiv:2405.04434; hf]",
))
