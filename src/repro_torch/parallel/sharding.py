"""Logical-axis sharding rules (MaxText-style), over DTensor meshes.

Model code names tensor dimensions with *logical* axes ("vocab", "mlp",
"batch", ...). A ``ShardingRules`` object maps logical axes to mesh axes;
the mapping degrades gracefully (an axis whose size does not divide the
mesh axis is left unsharded), which is what makes one model
implementation serve qwen3-32b (64 heads) and hymba (25 heads) on the
same 16-way model axis. The tables, ``_resolve`` and the hill-climb
variants (``RULE_VARIANTS``) are the JAX package's, copied.

A resolved spec is a tuple with one entry per tensor dim (trailing
``None``s dropped): ``None``, a mesh axis name, or a tuple of names.
``spec_placements`` turns it into DTensor placements, one per mesh dim:
a tensor dim over ``("pod", "data")`` is ``Shard(d)`` on both mesh dims,
pod-major, as the JAX package's ``PartitionSpec`` lays it out.
``constrain`` redistributes a DTensor to the rules' placements -- the
port's ``with_sharding_constraint``: DTensor runs the collective that
GSPMD would insert there.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch

from repro_torch.parallel.dist import current_mesh, mesh_axis_sizes

AxisTarget = Union[None, str, tuple[str, ...]]


@dataclass(frozen=True)
class ShardingRules:
    """logical axis -> mesh axis (or axis tuple)."""

    name: str
    param_rules: dict[str, AxisTarget]
    act_rules: dict[str, AxisTarget]

    def with_updates(self, name: str, param_updates=None, act_updates=None):
        pr = dict(self.param_rules)
        pr.update(param_updates or {})
        ar = dict(self.act_rules)
        ar.update(act_updates or {})
        return ShardingRules(name, pr, ar)


def _mesh_axis_sizes(mesh_shape: dict[str, int], target: AxisTarget) -> int:
    if target is None:
        return 1
    if isinstance(target, str):
        return mesh_shape.get(target, 1)
    n = 1
    for t in target:
        n *= mesh_shape.get(t, 1)
    return n


def _resolve(rules: dict[str, AxisTarget], axes: Sequence[Optional[str]],
             shape: Sequence[int], mesh_shape: dict[str, int]) -> tuple:
    """Map logical axes to a spec tuple with divisibility + dedup checks."""
    used: set[str] = set()
    out = []
    for dim, ax in zip(shape, axes):
        tgt = rules.get(ax) if ax is not None else None
        if tgt is None:
            out.append(None)
            continue
        names = (tgt,) if isinstance(tgt, str) else tuple(tgt)
        names = tuple(n for n in names if n in mesh_shape and n not in used)
        size = _mesh_axis_sizes(mesh_shape, names)
        if not names or size <= 1 or dim % size != 0:
            out.append(None)
            continue
        used.update(names)
        out.append(names[0] if len(names) == 1 else names)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def param_pspec(rules: ShardingRules, axes, shape, mesh_shape) -> tuple:
    return _resolve(rules.param_rules, axes, shape, mesh_shape)


def act_pspec(rules: ShardingRules, axes, shape, mesh_shape) -> tuple:
    return _resolve(rules.act_rules, axes, shape, mesh_shape)


def spec_placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of a resolved spec on ``mesh``: ``Shard(d)`` on
    every mesh dim that tensor dim ``d`` names, ``Replicate()`` on the
    others."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for n in ((entry,) if isinstance(entry, str) else entry):
            out[names.index(n)] = Shard(d)
    return tuple(out)


def local_shape(spec: tuple, shape: Sequence[int],
                mesh_shape: dict[str, int]) -> tuple[int, ...]:
    """The shape of one device's shard of a tensor of ``shape`` under a
    resolved ``spec`` (every sharded dim divides evenly)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            out[d] //= _mesh_axis_sizes(mesh_shape, entry)
    return tuple(out)


def param_placements(rules: ShardingRules, s, mesh) -> tuple:
    """Placements of a ``ParamSpec`` leaf ``s`` on ``mesh``."""
    return spec_placements(
        param_pspec(rules, s.axes, s.shape, mesh_axis_sizes(mesh)), mesh)


def act_placements(rules: ShardingRules, axes, shape, mesh) -> tuple:
    """Placements of an activation with logical ``axes`` on ``mesh``."""
    return spec_placements(
        act_pspec(rules, axes, shape, mesh_axis_sizes(mesh)), mesh)


# --------------------------------------------------------------------------
# Rule tables. "baseline" is the paper-faithful starting point used for every
# cell; the others are the JAX package's hill-climb variants.
# --------------------------------------------------------------------------

_FSDP = ("data",)           # parameter sharding over the data axis (FSDP)
_FSDP_POD = ("pod", "data")  # multi-pod FSDP
_BATCH = ("pod", "data")     # activation batch sharding

BASELINE = ShardingRules(
    name="baseline",
    param_rules={
        "vocab": "model",
        "embed": _FSDP_POD,
        "q_heads": "model",      # combined H*head_dim dim
        "kv_heads": "model",     # combined Hkv*head_dim dim
        "mlp": "model",
        "experts": "model",      # expert-parallelism
        "expert_mlp": None,
        "ssm_inner": "model",
        "state": None,
        "conv": None,
        "kv_lora": None,
        "q_lora": None,
        "heads": "model",        # per-head param dims (qk_norm scales)
        "frontend": None,
        "layers": None,
    },
    act_rules={
        "batch": _BATCH,
        "seq": None,
        "kv_seq": None,
        "embed": None,
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "experts": "model",
        "ssm_inner": "model",
        "state": None,
        "kv_lora": None,
    },
)

# Sequence-parallel variant: shards the sequence dim of activations over the
# model axis in the norm/residual region (Megatron-SP analogue).
SEQ_PARALLEL = BASELINE.with_updates(
    "seq_parallel", act_updates={"seq": "model"})

# Long-context decode variant: shard the KV cache over its sequence dim.
KV_SEQ = BASELINE.with_updates(
    "kv_seq", act_updates={"kv_seq": "model"},
    param_updates={})

# MoE variant: replicate the expert bank instead of expert parallelism
# (FSDP-sharded storage); dispatch becomes local to each data shard.
MOE_REPLICATED = BASELINE.with_updates(
    "moe_replicated",
    param_updates={"experts": ("data",)},
    act_updates={"experts": None})

RULE_VARIANTS: dict[str, ShardingRules] = {
    r.name: r for r in [BASELINE, SEQ_PARALLEL, KV_SEQ, MOE_REPLICATED]
}


# --------------------------------------------------------------------------
# Context: model code calls constrain(x, axes...) without threading rules.
# --------------------------------------------------------------------------

_CURRENT: contextvars.ContextVar[Optional[ShardingRules]] = \
    contextvars.ContextVar("repro_torch_sharding_rules", default=None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    tok = _CURRENT.set(rules)
    try:
        yield
    finally:
        _CURRENT.reset(tok)


def current_rules() -> Optional[ShardingRules]:
    return _CURRENT.get()


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Redistribute ``x`` to the placements its logical activation
    ``axes`` resolve to (a no-op when no rules are active, no mesh is set
    or ``x`` is a plain tensor -- keeps single-device runs as they are).
    Under autograd the redistribution is made even when ``x`` is placed
    so already: its backward then brings the gradient back to those
    placements, whatever layout the ops after it left the gradient in (a
    slice's or a pad's backward can shard the sequence, which a
    flattening matmul backward cannot take)."""
    rules = _CURRENT.get()
    mesh = current_mesh()
    if rules is None or mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    pl = act_placements(rules, axes, x.shape, mesh)
    if tuple(x.placements) == pl and not (
            x.requires_grad and torch.is_grad_enabled()):
        return x
    return x.redistribute(mesh, pl)


def gather_params(tree):
    """``tree`` (nested dicts) with every DTensor leaf gathered over the
    mesh axes the rules shard ``"batch"`` over (``pod``, ``data``): the
    FSDP all-gather before a layer computes, whose backward is the
    gradient's reduce-scatter. Model-axis sharding stays. A no-op with no
    rules or no mesh."""
    rules, mesh = _CURRENT.get(), current_mesh()
    if rules is None or mesh is None:
        return tree
    from torch.distributed.tensor import DTensor, Replicate
    target = rules.act_rules.get("batch")
    fsdp = {target} if isinstance(target, str) else set(target or ())
    dims = [i for i, n in enumerate(mesh.mesh_dim_names) if n in fsdp]

    def one(t):
        if not isinstance(t, DTensor) or not any(
                t.placements[i].is_shard() for i in dims):
            return t
        pl = list(t.placements)
        for i in dims:
            pl[i] = Replicate()
        return t.redistribute(mesh, tuple(pl))

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return one(x)
    return walk(tree)
