"""Gradient compression for the data-parallel reduction path.

The JAX package's ``repro.optim.compression`` in PyTorch's idiom. Two
codecs (``make_train_step(grad_compression=...)``):

* ``"bf16"`` — stateless cast (2 bytes a gradient on the wire);
* ``"int8"`` — per-tensor symmetric int8 quantization WITH error
  feedback: the quantization residual is carried beside the optimizer
  state and added back before the next step's quantization, so the
  compression error telescopes instead of accumulating.

Both round half to even (``torch.round``, as ``jnp.round``), so the int8
codes equal the reference's. The decompressed gradients feed the normal
float32 AdamW math. On one device nothing is reduced; the codec's
rounding is what a run on one card keeps of it.

Unlike the reference, which returns new trees, ``compress_grads``
overwrites the gradient and error-feedback leaves in place and returns
them: at full width a second gradient tree does not fit one card beside
the first. The arithmetic is the reference's, in its order.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models.param import tree_leaves, tree_map


def _int8_scale(g: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, float32 0-d scale) of one tensor."""
    scale = _int8_scale(g)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_feedback(params) -> Any:
    """A float32 zero tree beside ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


@torch.no_grad()
def compress_grads(grads, codec: Optional[str], ef_state=None):
    """Decompressed gradients and the new error feedback, written over
    ``grads`` (float32 leaves) and ``ef_state`` in place; returns them."""
    if codec is None:
        return grads, ef_state
    if codec == "bf16":
        for _, g in tree_leaves(grads):
            g.copy_(g.to(torch.bfloat16))
        return grads, ef_state
    if codec == "int8":
        if ef_state is None:
            raise ValueError("int8 codec needs error feedback")
        flat_e = dict(tree_leaves(ef_state))
        for path, g in tree_leaves(grads):
            # corrected = g + e; g <- dequantize(quantize(corrected));
            # e <- corrected - g (the codes are integers in float32)
            e = flat_e[path].add_(g)
            scale = _int8_scale(e)
            g.copy_(e).div_(scale).round_().clamp_(-127, 127).mul_(scale)
            e.sub_(g)
        return grads, ef_state
    raise ValueError(f"unknown codec {codec!r}")
