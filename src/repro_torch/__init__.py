"""PyTorch / CUDA port of the ReGate NPU power-gating simulator.

A second package beside the JAX package ``repro`` (the reference), with
the same sub-package and module names. It imports ``torch`` and
``numpy`` and nothing of ``repro`` or ``jax``. What is here so far is
the batched power-plane sweep: ``repro_torch.core.sweep.sweep`` /
``sweep_grid`` → ``policies.evaluate_batch`` → ``_sweep_kernel``, with
its two device passes written by hand for Hopper
(``repro_torch.kernels``).
"""
