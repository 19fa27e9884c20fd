"""Roofline terms of a step from its counted costs.

Per (arch x shape x mesh) cell:

  compute_s    = FLOPs / peak_FLOP/s
  memory_s     = bytes / HBM_bw
  collective_s = collective_bytes / (link_bw x links)

The FLOPs, bytes and collective bytes are the per-device counts of
``core.costs.CostCounter`` over one step as the port runs it (the JAX
package reads them off XLA's per-partition HLO, ``report_from_hlo``), so
the terms use one device's peaks. The peaks are the report's target's
(``core.hw.RooflineTarget``; ``H100_SXM`` unless another is given), never
a module global.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any

from repro_torch.core.costs import HloCosts
from repro_torch.core.hw import TARGET, RooflineTarget


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    # per-device quantities counted over the step
    flops: float
    memory_bytes: float
    collective_bytes: dict[str, float]
    # the three terms, seconds
    compute_s: float
    memory_s: float
    collective_s: float
    # analytic model FLOPs (6ND etc.), whole-job, for the usefulness ratio
    model_flops: float = 0.0
    bytes_per_device: float = 0.0      # peak live bytes a device
    kernel_flops: float = 0.0          # the hand kernels' share of flops
    notes: str = ""
    target: Any = field(default=TARGET, repr=False)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Perfect-overlap lower bound on step time."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the modeled step time: the score.
        (model_flops / chips / peak) / max-term."""
        if self.step_time_s <= 0 or self.model_flops <= 0:
            return 0.0
        ideal = self.model_flops / self.n_chips / self.target.peak_flops
        return ideal / self.step_time_s

    @property
    def flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs (per-device-normalized): remat
        waste."""
        if self.flops <= 0:
            return 0.0
        return (self.model_flops / self.n_chips) / self.flops

    def to_json(self) -> dict:
        d = asdict(self)
        d["target"] = getattr(self.target, "name", str(self.target))
        d.update(dominant=self.dominant, step_time_s=self.step_time_s,
                 roofline_fraction=self.roofline_fraction,
                 flops_ratio=self.flops_ratio)
        return d


def report_from_costs(costs: HloCosts, *, arch: str, shape: str, mesh: str,
                      n_chips: int, model_flops: float = 0.0,
                      bytes_per_device: float = 0.0,
                      target: RooflineTarget = TARGET,
                      notes: str = "") -> RooflineReport:
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh, n_chips=n_chips,
        flops=costs.flops, memory_bytes=costs.memory_bytes,
        collective_bytes=dict(costs.collective_bytes),
        compute_s=costs.flops / target.peak_flops,
        memory_s=costs.memory_bytes / target.hbm_bw,
        collective_s=costs.total_collective_bytes
        / (target.ici_bw_link * target.ici_links),
        model_flops=model_flops, bytes_per_device=bytes_per_device,
        kernel_flops=getattr(costs, "kernel_flops", 0.0), notes=notes,
        target=target)


def model_flops_estimate(cfg, shape) -> float:
    """Whole-job useful FLOPs: 6ND train, 2ND decode/prefill (MoE: active).
    Attention flops added explicitly (they are not in the 6ND rule)."""
    from repro_torch.models.registry import count_params
    n_active = count_params(cfg, active_only=True)
    n_embed = cfg.vocab_padded * cfg.d_model
    n_body = n_active - n_embed * (1 if cfg.tie_embeddings else 2)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        tokens = B  # one step
        mult = 2.0
        attn = 2.0 * B * S * cfg.n_layers * (
            0 if cfg.family == "ssm" else
            max(1, cfg.n_heads) * max(1, cfg.head_dim)) * 2
    else:
        tokens = B * S
        mult = 6.0 if shape.kind == "train" else 2.0
        # causal attention: S/2 average context
        attn_per_layer = 2.0 * tokens * (S / 2) * max(1, cfg.n_heads) \
            * max(1, cfg.head_dim) * 2
        if cfg.family == "ssm":
            attn_per_layer = 0.0
        attn = attn_per_layer * cfg.n_layers * (3 if shape.kind == "train"
                                                else 1)
    # lm_head + embed
    head = 2.0 * tokens * n_embed * (3 if shape.kind == "train" else 1)
    return mult * tokens * n_body + attn + head
