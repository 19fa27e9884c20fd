"""Per-architecture parameter trees + layer metadata.

``param_specs(cfg)`` returns the full abstract parameter tree (ParamSpec
leaves) and ``count_params`` sums it analytically. The port holds the
dense text family (dense GQA / MHA, QKV bias, qk-norm, tied or untied
embeddings) and the attention-free SSD family (mamba2); every other
family raises ``NotImplementedError`` naming the ROADMAP item that ports
it, here, before any block is reached.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks
from repro_torch.models.param import spec, stack_specs, tree_num_params


def check_ported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for an arch outside this slice."""
    why = None
    if cfg.family == "ssm":
        return
    if cfg.family == "hybrid":
        why = ("the hybrid block and sliding-window attention on the card "
               "(ROADMAP A7)")
    elif cfg.moe is not None:
        why = "MoE dispatch (ROADMAP A7)"
    elif cfg.mla is not None:
        why = "multi-head latent attention (ROADMAP A7)"
    elif cfg.frontend is not None:
        why = f"the {cfg.frontend} frontend (ROADMAP A7)"
    elif cfg.encoder_only:
        why = "encoder-only attention (ROADMAP A7)"
    elif cfg.sliding_window:
        why = "sliding-window attention (ROADMAP A7)"
    elif cfg.family != "dense":
        why = f"the {cfg.family!r} family (ROADMAP A7)"
    if why is not None:
        raise NotImplementedError(
            f"{cfg.name}: {why} is not ported yet; the port runs the dense "
            f"text family and the SSD family")


def layer_specs(cfg: ArchConfig) -> dict:
    """ParamSpec tree for one (stacked) layer."""
    check_ported(cfg)
    if cfg.family == "ssm":
        return {"ssd": blocks.ssd_specs(cfg)}
    return {"attn": blocks.attn_specs(cfg), "mlp": blocks.mlp_specs(cfg)}


def n_scanned_layers(cfg: ArchConfig) -> int:
    lead = cfg.moe.first_dense_layers if cfg.moe else 0
    return cfg.n_layers - lead


def param_specs(cfg: ArchConfig) -> dict:
    check_ported(cfg)
    D, Vp = cfg.d_model, cfg.vocab_padded
    tree: dict[str, Any] = {
        "embed": spec((Vp, D), ("vocab", "embed"), init_scale=1.0),
        "final_norm": spec((D,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = spec((D, Vp), ("embed", "vocab"))
    tree["layers"] = stack_specs(n_scanned_layers(cfg), layer_specs(cfg))
    return tree


def count_params(cfg: ArchConfig) -> int:
    """Analytic parameter count from the spec tree (exact for the impl)."""
    return tree_num_params(param_specs(cfg))


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


def window_array(cfg: ArchConfig, seq_hint: int,
                 device=None) -> Optional[torch.Tensor]:
    """(L,) int32 per-layer attention window (>=seq => effectively global).

    None if the arch has no sliding-window mixing (static full attention).
    """
    if cfg.sliding_window <= 0:
        return None
    glob = set(global_layer_indices(cfg))
    big = seq_hint + cfg.sliding_window + 1
    vals = [big if i in glob else cfg.sliding_window
            for i in range(cfg.n_layers)]
    return torch.tensor(vals, dtype=torch.int32, device=device)
