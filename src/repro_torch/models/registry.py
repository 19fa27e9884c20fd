"""Per-architecture parameter trees + layer metadata.

``param_specs(cfg)`` returns the full abstract parameter tree (ParamSpec
leaves) of every arch, as the JAX package's; ``count_params`` sums it
analytically (``active_only=True`` counts only the parameters touched
per token: MoE's top_k and shared experts).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks
from repro_torch.models.param import spec, stack_specs, tree_num_params


def layer_specs(cfg: ArchConfig) -> dict:
    """ParamSpec tree for one (stacked) layer."""
    fam = cfg.family
    if fam == "ssm":
        return {"ssd": blocks.ssd_specs(cfg)}
    if fam == "hybrid":
        return {"mix": blocks.hybrid_specs(cfg),
                "mlp": blocks.mlp_specs(cfg)}
    if fam == "moe":
        attn = (blocks.mla_specs(cfg) if cfg.mla else blocks.attn_specs(cfg))
        return {"attn": attn, "moe": blocks.moe_specs(cfg)}
    # dense / audio / vlm
    return {"attn": blocks.attn_specs(cfg), "mlp": blocks.mlp_specs(cfg)}


def dense0_specs(cfg: ArchConfig) -> dict:
    """DeepSeek-style leading dense layer(s) (MLA attn + wide dense MLP)."""
    return {"attn": blocks.mla_specs(cfg),
            "mlp": blocks.mlp_specs(cfg, d_ff=cfg.d_ff)}


def n_scanned_layers(cfg: ArchConfig) -> int:
    lead = cfg.moe.first_dense_layers if cfg.moe else 0
    return cfg.n_layers - lead


def param_specs(cfg: ArchConfig) -> dict:
    D, Vp = cfg.d_model, cfg.vocab_padded
    tree: dict[str, Any] = {
        "embed": spec((Vp, D), ("vocab", "embed"), init_scale=1.0),
        "final_norm": spec((D,), ("embed",), init="ones"),
    }
    if cfg.frontend:
        tree["frontend_proj"] = spec((cfg.frontend_dim, D),
                                     ("frontend", "embed"))
    if not cfg.tie_embeddings:
        tree["lm_head"] = spec((D, Vp), ("embed", "vocab"))
    if cfg.moe and cfg.moe.first_dense_layers:
        tree["dense0"] = dense0_specs(cfg)
    tree["layers"] = stack_specs(n_scanned_layers(cfg), layer_specs(cfg))
    return tree


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """Analytic parameter count from the spec tree (exact for the impl);
    ``active_only`` replaces the whole expert bank by the top_k experts
    a token passes through."""
    total = tree_num_params(param_specs(cfg))
    if active_only and cfg.moe:
        mo = cfg.moe
        L = n_scanned_layers(cfg)
        per_expert = 3 * cfg.d_model * mo.d_ff_expert
        total -= L * mo.n_experts * per_expert
        total += L * mo.top_k * per_expert
    return total


def global_layer_indices(cfg: ArchConfig) -> list[int]:
    """hymba: full-attention layers are first / middle / last."""
    if cfg.n_global_layers <= 0:
        return []
    L = cfg.n_layers
    if cfg.n_global_layers >= L:
        return list(range(L))
    if cfg.n_global_layers == 1:
        return [0]
    step = (L - 1) / (cfg.n_global_layers - 1)
    return sorted({int(round(i * step)) for i in range(cfg.n_global_layers)})


def window_list(cfg: ArchConfig, seq_hint: int) -> Optional[list[int]]:
    """Each layer's attention window as Python ints (>= seq =>
    effectively global); None if the arch has no sliding-window mixing
    (static full attention)."""
    if cfg.sliding_window <= 0:
        return None
    glob = set(global_layer_indices(cfg))
    big = seq_hint + cfg.sliding_window + 1
    return [big if i in glob else cfg.sliding_window
            for i in range(cfg.n_layers)]


def window_array(cfg: ArchConfig, seq_hint: int,
                 device=None) -> Optional[torch.Tensor]:
    """(L,) int32 per-layer attention window (``window_list``'s values);
    None if the arch has no sliding-window mixing."""
    vals = window_list(cfg, seq_hint)
    return None if vals is None else torch.tensor(
        vals, dtype=torch.int32, device=device)
