"""PyTorch / CUDA port of the ReGate NPU power-gating simulator.

A second package beside the JAX package ``repro`` (the reference), with
the same sub-package and module names. It imports ``torch`` and
``numpy`` and nothing of ``repro`` or ``jax``. What is here so far:

* the batched power-plane sweep, ``repro_torch.core.sweep.sweep`` /
  ``sweep_grid`` → ``policies.evaluate_batch`` → ``_sweep_kernel``;
* serving the dense text archs (qwen2.5-3b and kin),
  ``repro_torch.launch.serve.Server`` → ``models.model.prefill_step`` /
  ``decode_step``;

each with its device passes written by hand for Hopper
(``repro_torch.kernels``).
"""
