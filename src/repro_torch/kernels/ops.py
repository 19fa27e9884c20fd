"""Public wrappers around the hand-written kernels, under the JAX
package's names (``repro/kernels/ops.py``).

``flash_attention`` (B3) and ``decode_attention`` (B4) launch their CUDA
kernels for CUDA tensors and take their plain versions for CPU tensors.
``decode_attention`` is the wrapper the JAX package never exported (its
tests call ``decode_attention_p`` directly). Both keep the model's
``(B, S, H, D)`` layout with GQA by head grouping, where the JAX
wrapper folds ``(B*H, S, D)`` with equal head counts. The other two
Pallas kernels' wrappers (``gated_matmul``, ``ssd_scan``) come with
their kernels (ROADMAP B2, B5).
"""
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention

__all__ = ["decode_attention", "flash_attention"]
