"""Public wrappers around the hand-written kernels, under the JAX
package's names (``repro/kernels/ops.py``).

``flash_attention`` (B3), ``decode_attention`` (B4) and ``ssd_scan`` (B5)
launch their CUDA kernels for CUDA tensors and take their plain versions
for CPU tensors. ``decode_attention`` is the wrapper the JAX package never
exported (its tests call ``decode_attention_p`` directly). The attention
wrappers keep the model's ``(B, S, H, D)`` layout with GQA by head
grouping, where the JAX wrapper folds ``(B*H, S, D)`` with equal head
counts; ``ssd_scan`` keeps the JAX wrapper's ``(BH, S, ·)`` layout. The
last Pallas kernel's wrapper (``gated_matmul``) comes with its kernel
(ROADMAP B2).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd_scan

__all__ = ["decode_attention", "flash_attention", "ssd_scan"]


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. x: (BH, S, P); dt: (BH, S); A: (BH,); B/C: (BH, S, N).
    Returns (y (BH, S, P) in x's dtype, final state (BH, P, N) float32).

    The inputs are viewed as batch BH with one head and one group (no
    copy) and handed to kernel B5's wrapper. ``chunk`` is the JAX
    signature's: B5 and its plain version chunk by their own
    ``ssd_scan.CHUNK`` rows, and the result depends on the chunk only by
    rounding.
    """
    if int(chunk) <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    BH, S, P = x.shape
    N = B.shape[-1]
    y, h = _ssd_scan(x.view(BH, S, 1, P), dt.view(BH, S, 1),
                     A.view(BH, 1), B.view(BH, S, 1, N),
                     C.view(BH, S, 1, N))
    return y.view(BH, S, P).to(x.dtype), h.view(BH, P, N)
