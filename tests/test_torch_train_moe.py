"""The port's training path against the JAX package's for the MoE
families, on the CPU: granite-moe-1b-a400m (GQA attention, 4 routed
experts top-2 at ``reduced()``) and deepseek-v2-236b (multi-head latent
attention at q/k head dim 24 and v 16, 2 shared and 4 routed experts top-2,
the leading dense layer) reduced, float32 on both sides from one state,
with ``tests/_torch_train_common.py``'s checks and limits:

* ``loss_fn`` and every gradient leaf (the MoE dispatch's backward:
  the buffer write's gather, the expert ``bmm``s, the combine's
  accumulating ``index_put_``, the router's softmax and top-k gates);
* ``make_train_step`` at microbatches 1 and 2 with codecs None, bf16 and
  int8, after one and after three steps;
* the three remat policies give the same loss and gradients, bit for bit;
* a run failed at step 5 and resumed from its step-4 checkpoint
  reproduces the uninterrupted run's last 3 losses bit for bit.

A file of its own, so that ``--dist loadfile`` gives its ~90 s to a
worker of its own.
"""
import pytest

torch = pytest.importorskip("torch")

import _torch_train_common as common  # noqa: E402

ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-236b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_equal_the_reference(arch):
    common.check_loss_and_gradients(arch)


@pytest.mark.parametrize("codec", [None, "bf16", "int8"])
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_equal_the_reference(arch, microbatches, codec):
    common.check_train_steps(arch, microbatches, codec)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_the_same_loss_and_gradients(arch):
    common.check_remat_policies(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_failure_injection_and_bitexact_resume(tmp_path, arch):
    common.check_failure_injection_and_bitexact_resume(tmp_path, arch)
