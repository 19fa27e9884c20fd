"""Public wrappers around the hand-written kernels, under the JAX
package's names (``repro/kernels/ops.py``).

``gated_matmul`` (B2), ``flash_attention`` (B3), ``decode_attention``
(B4) and ``ssd_scan`` (B5) launch their CUDA kernels for CUDA tensors and
take their plain versions for CPU tensors. ``decode_attention`` is the wrapper the JAX package never
exported (its tests call ``decode_attention_p`` directly). The attention
wrappers keep the model's ``(B, S, H, D)`` layout with GQA by head
grouping, where the JAX wrapper folds ``(B*H, S, D)`` with equal head
counts; ``ssd_scan`` keeps the JAX wrapper's ``(BH, S, ·)`` layout.
``gated_matmul`` and ``tile_nonzero_bitmap`` keep the JAX names and
signatures, without ``interpret``; the bitmap is plain tensor code on
either device, as it is plain ``jnp`` in the reference.
``flash_attention`` keeps the JAX signature (``causal``, ``bq``, ``bk``)
over B3's wrapper.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import \
    flash_attention as _flash_attention
from repro_torch.kernels.gated_matmul import gated_matmul_p
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd_scan

__all__ = ["decode_attention", "flash_attention", "gated_matmul",
           "ssd_scan", "tile_nonzero_bitmap"]


def tile_nonzero_bitmap(w: torch.Tensor, bk: int, bn: int) -> torch.Tensor:
    """Per-(K-tile, N-tile) any-nonzero map, int32 ``(K/bk, N/bn)`` — the
    tile-level analogue of the paper's col_nz/row_nz PE bitmaps (Fig 12).
    As in the reference, a tile of ``-0.0`` is zero, and a tile that
    holds a NaN has a NaN maximum, which is not ``> 0``: its bit is 0."""
    K, N = w.shape
    if bk <= 0 or bn <= 0 or K % bk or N % bn:
        raise ValueError(f"w {(K, N)} must tile by bk, bn = {(bk, bn)}")
    t = w.reshape(K // bk, bk, N // bn, bn)
    return (t.abs().amax(dim=(1, 3)) > 0).to(torch.int32)


def gated_matmul(x: torch.Tensor, w: torch.Tensor, *, bm: int = 128,
                 bn: int = 128, bk: int = 128) -> torch.Tensor:
    """[M,K] x [K,N] matmul that skips all-zero weight tiles (kernel B2
    on a CUDA tensor); the output in x's dtype."""
    bitmap = tile_nonzero_bitmap(w, bk, bn)
    return gated_matmul_p(x, w, bitmap, bm=bm, bn=bn, bk=bk)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """The reference's ``ops.flash_attention``: q/k/v ``(B, S, H, D)``,
    returns ``(B, S, H, D)`` -- kernel B3 on a CUDA tensor, its plain
    version on a CPU tensor. The reference wants equal head counts (it
    folds ``(B*H, S, D)``); B3 also takes k / v with fewer heads (GQA by
    head grouping). ``bq`` / ``bk`` are the Pallas kernel's block sizes,
    kept for the signature and checked positive; B3 tiles by its own 64
    rows, so they change nothing here."""
    if int(bq) <= 0 or int(bk) <= 0:
        raise ValueError(f"block sizes must be positive, got bq={bq}, "
                         f"bk={bk}")
    return _flash_attention(q, k, v, causal=causal)


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
