"""mamba2-780m — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified] 48L d_model=1536 d_ff=0 vocab=50280 ssm_state=128.
Mamba-2 block: expand=2 (d_inner=3072), headdim=64 -> 48 SSD heads, ngroups=1.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    head_dim=0,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4, n_groups=1,
                  chunk=256),
    tie_embeddings=True,
    act="silu",
    source="[arXiv:2405.21060; unverified]",
))
