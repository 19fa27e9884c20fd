"""AdamW with global-norm clipping and a cosine schedule.

The JAX package's ``repro.optim.adamw`` in PyTorch's idiom: the same
config, schedule, norm and update formula, in the same order of
operations, over parameter trees (nested dicts of tensors). The moment
dtype is configurable; float32 params remain the source of truth.

Unlike the reference, which returns new trees, ``adamw_update`` updates
the parameters and the moments **in place**: at qwen2.5-3b's full width
the state is ~37 GB of float32 (params, m, v) and one stacked MLP leaf is
3.25 GB, so an out-of-place update (six temporaries a leaf) would not fit
one 80 GB card beside the gradients. Leaves are updated in chunks along
their leading (stacked-layer) axis of at most ``max_chunk_elems``
elements, each chunk by the reference's operations in the reference's
order; elementwise float operations give the same bits chunked or whole.
On the CPU a contiguous leaf is chunked over its flat elements, in
chunks of at most ``CPU_CHUNK_ELEMS``.

On a mesh the parameters, gradients and moments are DTensors: the global
norm sums each leaf's shards (DTensor's reduction), and every leaf is
updated in place on this device's local shard, its gradient first
redistributed to the parameter's placements.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Iterator, Optional

import torch

from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.parallel.dist import is_dtensor

#: the default chunk of an in-place update: 64 M elements (256 MB of
#: float32 a temporary)
CHUNK_ELEMS = 1 << 26
#: the chunk on the CPU, over a contiguous leaf's flat elements: 1 M
#: elements (4 MB a temporary), so that the temporaries stay in the cache
#: and the allocator's heap (one of 256 MB is fresh pages each time)
CPU_CHUNK_ELEMS = 1 << 20


@dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: Any = torch.float32


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(1.0, cfg.warmup_steps)
    frac = (step - cfg.warmup_steps) / max(
        1.0, cfg.total_steps - cfg.warmup_steps)
    frac = frac.clamp(0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    lr = torch.where(step < cfg.warmup_steps, warm, 0.1 + 0.9 * cos)
    return cfg.lr_peak * lr


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """``{"m", "v"}`` zero trees of ``cfg.moment_dtype`` beside
    ``params`` (on their devices, placed as they are on a mesh) and
    ``"step"``, an int32 0-d tensor."""
    zeros = lambda p: torch.zeros_like(  # noqa: E731
        p, dtype=cfg.moment_dtype, memory_format=torch.contiguous_format)
    dev = next(leaf for _, leaf in tree_leaves(params)).device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def chunks(t: torch.Tensor, max_elems: Optional[int]) -> Iterator:
    """Views of ``t`` that tile it along its leading axis, each at most
    ``max_elems`` elements (at least one row); ``t`` whole when
    ``max_elems`` is None or ``t`` has fewer than two dims."""
    if max_elems is None or t.dim() < 2 or t.numel() <= max_elems:
        yield t
        return
    rows = max(1, max_elems // max(1, t[0].numel()))
    yield from t.split(rows, dim=0)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of
    squares (one leaf-sized temporary at a time)."""
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for _, x in tree_leaves(tree)]
    sums = [s.full_tensor() if is_dtensor(s) else s for s in sums]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _update_leaf(p, g, m, v, *, cfg: AdamWConfig, scale, lr, c1, c2,
                 decay: bool) -> None:
    """One chunk, in place: the reference's ``upd`` in its order."""
    b1, b2 = cfg.b1, cfg.b2
    g = g.to(torch.float32) * scale
    m32 = m.to(torch.float32)
    v32 = v.to(torch.float32)
    m32.mul_(b1).add_(g * (1 - b1))
    gg = g * (1 - b2)
    v32.mul_(b2).add_(gg.mul_(g))
    delta = m32 / c1
    den = torch.sqrt(v32 / c2).add_(cfg.eps)
    delta.div_(den)
    if decay:  # decoupled weight decay on matrices only
        delta.add_(cfg.weight_decay * p.to(torch.float32))
    if p.dtype == torch.float32:
        p.sub_(delta.mul_(lr))
    else:
        p.copy_(p.to(torch.float32) - lr * delta)
    if m32 is not m:
        m.copy_(m32)
    if v32 is not v:
        v.copy_(v32)


@torch.no_grad()
def adamw_update(grads, opt_state: dict, params, cfg: AdamWConfig, *,
                 max_chunk_elems: Optional[int] = CHUNK_ELEMS):
    """One AdamW step. ``grads``, ``params`` and ``opt_state["m"]`` /
    ``["v"]`` are trees of one structure; params, m and v are updated in
    place and ``opt_state["step"]`` is replaced by ``step + 1``. Returns
    ``(params, opt_state, {"lr", "grad_norm"})``, the same objects.
    ``max_chunk_elems=None`` updates every leaf whole."""
    step = opt_state["step"] + 1
    lr = cosine_lr(cfg, step)

    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)

    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(cfg.b1, stepf)
    c2 = 1.0 - torch.pow(cfg.b2, stepf)

    flat_g = dict(tree_leaves(grads))
    flat_m = dict(tree_leaves(opt_state["m"]))
    flat_v = dict(tree_leaves(opt_state["v"]))
    for path, p in tree_leaves(params):
        g, m, v = flat_g[path], flat_m[path], flat_v[path]
        if is_dtensor(p):  # this device's shards, g placed as p
            if tuple(g.placements) != tuple(p.placements):
                g = g.redistribute(p.device_mesh, p.placements)
            p, g, m, v = (t.to_local() for t in (p, g, m, v))
        parts = (p, g, m, v)
        if p.device.type == "cpu" and max_chunk_elems is not None \
                and all(t.is_contiguous() for t in parts):
            n = min(max_chunk_elems, CPU_CHUNK_ELEMS)
            parts = [t.view(-1).split(n) for t in parts]
        else:
            parts = [chunks(t, max_chunk_elems) for t in parts]
        for pc, gc, mc, vc in zip(*parts):
            _update_leaf(pc, gc, mc, vc, cfg=cfg, scale=scale, lr=lr, c1=c1,
                         c2=c2, decay=p.dim() >= 2)
    opt_state["step"] = step
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
