"""The port's training path against the JAX package's, on the CPU, for the
dense family (qwen2.5-3b reduced), and the tests that are no family's:
AdamW's eps and the zero-initialized biases, the layers' views, the
loop, a failed run's checkpoint, compression, the rule variants, the
default device and the quickstart twin:
``tests/_torch_train_common.py``'s checks and limits -- loss and every
gradient leaf, three train steps at microbatches 1 and 2 under each
codec, the remat policies bit for bit, a failed run resumed bit for bit.
A file a family, so that ``--dist loadfile`` spreads the families over
workers.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_train_common as common  # noqa: E402
from _torch_train_common import (LEAF_TOL, _example, _leaf_rels,  # noqa
                                 _loop, _setup)
from repro.train.steps import make_train_step as ref_make_step  # noqa: E402
from repro_torch.launch.train import TrainLoopConfig, run  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402

ARCHS = ["qwen2.5-3b"]


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


def test_zero_init_gap_is_adamws_eps():
    """With AdamW's eps at 1e-5 the zero-initialized biases agree like
    every leaf: their gap at 1e-8 is the sign-like first steps on ~1e-7
    gradients."""
    (rcfg, ropt, rst, rdata), (cfg, opt, st, data) = _setup(
        "qwen2.5-3b", eps=1e-5)
    rstep = jax.jit(ref_make_step(rcfg, ropt, dtype=jnp.float32))
    step = make_train_step(cfg, opt, dtype=torch.float32)
    for i in range(3):
        rst, _ = rstep(rst, rdata.batch(i))
        st, _ = step(st, data.batch(i))
    rels = _leaf_rels(rst.params, st.params)
    assert max(rels.values()) <= LEAF_TOL, rels

def test_layer_views_share_the_stacked_storage():
    _, (cfg, _, st, _) = _setup("qwen2.5-3b")
    layers = TM._layers(st.params["layers"], cfg.n_layers)
    wq = st.params["layers"]["attn"]["wq"]
    assert [lay["attn"]["wq"].data_ptr() for lay in layers] == \
        [wq[i].data_ptr() for i in range(cfg.n_layers)]

def test_train_loop_runs_and_improves(tmp_path):
    out = run(TrainLoopConfig(arch="qwen2.5-3b", steps=6, seq_len=32,
                              global_batch=4, ckpt_dir=str(tmp_path),
                              checkpoint_every=3, log_every=100,
                              device="cpu"))
    assert len(out["losses"]) == 6 == len(out["step_s"])
    assert all(np.isfinite(v) for v in out["losses"])

def test_a_failed_run_publishes_the_checkpoint_it_started(tmp_path,
                                                          monkeypatch):
    """The step-4 save is still being written when the injected failure
    at step 5 raises: ``run`` publishes it before it lets the error out,
    so the next run resumes from step 4 however slow the writer is (and
    no writer of the failed run is left beside the next one's)."""
    from repro_torch.checkpoint import manager
    real_save = manager.np.save

    def slow_save(*args, **kwargs):
        time.sleep(0.01)
        return real_save(*args, **kwargs)

    monkeypatch.setattr(manager.np, "save", slow_save)
    cfg = _loop("qwen2.5-3b", tmp_path)
    with pytest.raises(RuntimeError, match="injected failure"):
        run(TrainLoopConfig(**{**vars(cfg), "fail_at_step": 5}))
    assert manager.CheckpointManager(cfg.ckpt_dir).latest_step() == 4


def test_grad_compression_changes_nothing_structural():
    out = run(TrainLoopConfig(arch="qwen2.5-3b", steps=3, seq_len=32,
                              global_batch=4, grad_compression="bf16",
                              log_every=100, device="cpu"))
    assert all(np.isfinite(v) for v in out["losses"])


def test_rules_other_than_baseline_wait_for_a9():
    """Since the parallel slice (A9a) ``run`` takes every rule variant of
    the JAX package; without a mesh a variant changes nothing, as in the
    reference: the losses equal baseline's bit for bit. A name that is no
    variant raises."""
    kw = dict(device="cpu", steps=3, log_every=100)
    base = run(TrainLoopConfig(**kw))["losses"]
    for rules in ("seq_parallel", "kv_seq", "moe_replicated"):
        assert run(TrainLoopConfig(rules=rules, **kw))["losses"] == base
    with pytest.raises(ValueError, match="fsdp"):
        run(TrainLoopConfig(rules="fsdp", device="cpu"))


def test_train_defaults_to_the_card():
    assert TrainLoopConfig().device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(TrainLoopConfig(steps=1))

def test_quickstart_twin_runs_on_the_cpu(capsys):
    _example("quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "ReGate-Full" in out and "train step: loss=" in out
