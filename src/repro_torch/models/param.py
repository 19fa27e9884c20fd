"""Parameter specification machinery.

Models declare an *abstract* parameter tree of ``ParamSpec`` (shape,
dtype, logical axes, initializer): nested dicts with ``ParamSpec``
leaves. From it the port counts parameters without allocating them and
materializes parameter trees (nested dicts of tensors) on a chosen
device. The logical axes are kept for the sharding rules of a later
multi-device slice; on one device nothing reads them.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional

import torch


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]  # logical axis names, len == len(shape)
    dtype: Any = torch.float32
    init: str = "normal"  # normal | zeros | ones | small_normal
    init_scale: float = 1.0
    #: ``custom_init(gen, shape, dtype, device)`` draws the leaf itself
    custom_init: Optional[Callable[[torch.Generator, tuple, Any,
                                    torch.device], torch.Tensor]] = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


def spec(shape, axes, init="normal", init_scale=1.0, dtype=torch.float32,
         custom_init=None) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), dtype, init, init_scale,
                     custom_init)


def tree_leaves(tree) -> Iterator[tuple[tuple[str, ...], Any]]:
    """``(path, leaf)`` of a nested dict, keys sorted at every level —
    the leaf order of ``jax.tree.flatten`` on the same dicts."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            for path, leaf in tree_leaves(tree[key]):
                yield (key, *path), leaf
    else:
        yield (), tree


def tree_map(fn: Callable, tree):
    """``fn`` applied to every leaf of a nested dict; same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_num_params(specs) -> int:
    return sum(math.prod(s.shape) for _, s in tree_leaves(specs))


def _init_one(gen: torch.Generator, s: ParamSpec,
              device: torch.device) -> torch.Tensor:
    if s.custom_init is not None:
        return s.custom_init(gen, s.shape, s.dtype, device)
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=s.dtype, device=device)
    # fan-in-scaled normal; last axis is fan-out by convention. As in the
    # JAX package, "small_normal" has no branch of its own: it is this one,
    # with the spec's init_scale
    fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
    std = s.init_scale / math.sqrt(max(1, fan_in))
    x = torch.empty(s.shape, dtype=torch.float32, device=device)
    x.normal_(generator=gen)
    return (x * std).to(s.dtype)


def init_params(specs, gen: torch.Generator, device, *,
                dtype=None) -> Any:
    """Materialize a parameter tree from specs on ``device``, drawing
    every normal leaf from ``gen`` (a ``torch.Generator`` on that
    device) in sorted-key order. The numbers are not ``jax.random``'s:
    to compute from the JAX package's weights, convert them with
    ``repro_torch.convert.params_from_numpy(tree, device=device)``.

    ``dtype``: each floating leaf is cast to it as soon as it is drawn --
    the numbers of ``cast_tree(init_params(...), dtype)`` without the
    whole float32 tree beside the cast one (a server's bf16 weights)."""
    device = torch.device(device)
    vals = {}
    for path, s in tree_leaves(specs):
        x = _init_one(gen, s, device)
        vals[path] = x.to(dtype) if dtype is not None \
            and x.is_floating_point() else x
    return _with_leaves(specs, vals, ())


def tree_with_leaves(tree, vals: dict) -> Any:
    """``tree``'s structure with the leaf at each path (a key tuple, as
    ``tree_leaves`` gives it) replaced by ``vals[path]``."""
    return _with_leaves(tree, vals, ())


def _with_leaves(tree, vals: dict, prefix: tuple):
    """``tree``'s structure with leaf ``path`` replaced by ``vals[path]``."""
    if isinstance(tree, dict):
        return {k: _with_leaves(v, vals, (*prefix, k))
                for k, v in tree.items()}
    return vals[prefix]


def train_params(tree) -> Any:
    """Training parameters from a parameter tree: float32 leaves that
    require grad (the float32 master weights; a float32 leaf is used as
    it is, others are copied)."""
    return tree_map(lambda x: x.detach().to(torch.float32).requires_grad_()
                    if x.is_floating_point() else x, tree)


def cast_tree(tree, dtype) -> Any:
    """Cast floating leaves (mixed-precision compute cast). A leaf that
    already has ``dtype`` is returned as it is, without a copy."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def stacked(n: int, s: ParamSpec) -> ParamSpec:
    """Stack a per-layer spec along a leading 'layers' axis."""
    return dataclasses.replace(s, shape=(n, *s.shape),
                               axes=("layers", *s.axes))


def stack_specs(n: int, tree) -> Any:
    return tree_map(lambda s: stacked(n, s), tree)
