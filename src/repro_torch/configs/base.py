"""Architecture & shape configuration system.

An architecture is a frozen ``ArchConfig``; an input-shape cell is a
``ShapeConfig``. The exact published dimensions live in one place each,
``repro_torch/configs/<id>.py`` (copies of the JAX package's), and
``get_arch`` resolves every name; ``SHAPES`` holds the four input-shape
cells. ``opgen.arch_workload`` lowers an (arch, shape) pair to an
operator trace for the power plane.
"""
from __future__ import annotations

import dataclasses
import importlib
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

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# The four assigned LM shapes. ``decode_*``/``long_*`` lower ``serve_step``
# (one new token against a KV cache of ``seq_len``), not ``train_step``.
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


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

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def uses_full_attention_only(self) -> bool:
        """True if the arch has quadratic attention with no sub-quadratic path."""
        return (not self.is_attention_free) and self.sliding_window == 0

    @property
    def q_dim(self) -> int:
        if self.mla:
            return self.n_heads * (self.mla.nope_head_dim + self.mla.rope_head_dim)
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        if self.mla:
            return self.mla.kv_lora_rank + self.mla.rope_head_dim
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (exact for the port's models)."""
        from repro_torch.models.registry import count_params

        return count_params(self)

    def active_param_count(self) -> int:
        """Parameters a token passes through (MoE: top_k and shared
        experts only)."""
        from repro_torch.models.registry import count_params

        return count_params(self, active_only=True)

    def supported_shapes(self) -> dict[str, str]:
        """shape name -> "ok" or "SKIP(<reason>)" for the 4-cell row."""
        out = {}
        for s in SHAPES.values():
            if s.is_decode and self.encoder_only:
                out[s.name] = "SKIP(encoder-only: no decode step)"
            elif s.name == "long_500k" and self.uses_full_attention_only:
                out[s.name] = "SKIP(full-attention arch: 500k needs sub-quadratic)"
            else:
                out[s.name] = "ok"
        return out

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw: dict = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            frontend_dim=32 if self.frontend else 0,
            frontend_seq=4 if self.frontend == "vision" else 0,
        )
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2, d_ff_expert=32,
                group_size=32, first_dense_layers=min(1, self.moe.first_dense_layers),
            )
        if self.ssm:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk=8)
        if self.mla:
            kw["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                                  rope_head_dim=8, nope_head_dim=16, v_head_dim=16)
        if self.sliding_window:
            kw["sliding_window"] = 16
        return dataclasses.replace(self, **kw)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


ALL_ARCH_MODULES = [
    "mamba2_780m", "qwen3_32b", "qwen2_5_14b", "qwen2_5_3b", "qwen1_5_4b",
    "hymba_1_5b", "hubert_xlarge", "granite_moe_1b", "deepseek_v2_236b",
    "paligemma_3b",
]


def _load_all() -> None:
    for mod in ALL_ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")
