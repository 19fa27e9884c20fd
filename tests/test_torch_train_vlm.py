"""The port's training path against the JAX package's, on the CPU, for the
vision family (paligemma-3b reduced, 4 patch embeddings before the
text): ``tests/_torch_train_common.py``'s checks and limits -- loss and
every gradient leaf, three train steps at microbatches 1 and 2 under
each codec, the remat policies bit for bit, a failed run resumed bit for
bit. A file a family, so that ``--dist loadfile`` spreads the families
over workers.
"""
import pytest

torch = pytest.importorskip("torch")

import _torch_train_common as common  # noqa: E402

ARCHS = ["paligemma-3b"]


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
