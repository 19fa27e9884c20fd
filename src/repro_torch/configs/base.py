"""Architecture & shape configuration dataclasses.

An architecture is a frozen ``ArchConfig``; an input-shape cell is a
``ShapeConfig``. ``opgen.arch_workload`` lowers an (arch, shape) pair to
an operator trace for the power plane. Pure dataclasses: the per-model
config modules and the parameter counter are not part of this package
yet, so ``arch_workload`` takes the parameter count of a training shape
as an argument.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (seq_len x global_batch)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0  # leading layers that use a dense MLP instead
    capacity_factor: float = 2.0
    group_size: int = 1024  # GShard dispatch group size (tokens)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    n_groups: int = 1
    chunk: int = 256  # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # attention features
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # block families
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    # hybrid (hymba): sliding-window attention everywhere except global layers
    sliding_window: int = 0  # 0 => full attention
    n_global_layers: int = 0  # leading/middle/trailing full-attention layers
    # structure
    encoder_only: bool = False
    tie_embeddings: bool = True
    act: str = "silu"  # mlp activation: silu(SwiGLU) | gelu (plain 2-layer)
    norm_eps: float = 1e-6
    # modality frontend stub: input_specs() provides precomputed embeddings
    frontend: Optional[str] = None  # None | "audio" | "vision"
    frontend_dim: int = 0  # embedding dim produced by the stub frontend
    frontend_seq: int = 0  # frontend tokens prepended (vlm patches)
    source: str = ""  # provenance note [source; verified-tier]

    # ---- derived ----
    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up for 16-way TP divisibility (loss masks padding)."""
        return _round_up(self.vocab_size, 256)
