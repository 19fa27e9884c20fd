"""Shared set-up, limits and checks of the port's training tests against
the JAX package's, on the CPU. The test files ``tests/test_torch_train_
{dense,ssm,hybrid,vlm,audio,moe}.py`` hold one family each, so that
``--dist loadfile`` can put them on different workers; the checks and
their limits are here (the first three are the families' tests: each
file runs its archs through ``check_loss_and_gradients``,
``check_train_steps``, ``check_remat_policies`` and
``check_failure_injection_and_bitexact_resume``).

Both packages start from the same state: the JAX package's
``TrainState`` (its ``init_params`` from a PRNG key) carried across as
numpy by ``convert.train_state_from_numpy``; batches from
``SyntheticDataset``, whose numbers are the reference's bit for bit. All
in float32 (``dtype=float32`` on both sides), qwen2.5-3b, mamba2-780m,
paligemma-3b (4 patch embeddings before the text) and hubert-xlarge
(frame embeddings) reduced, and hymba-1.5b reduced and cut to 5 layers
(``reduced()`` has 2, both global; at 5, layers 1 and 3 slide over a
window of 16) at 24 positions, past the window:

* ``loss_fn`` and every gradient leaf (``jax.value_and_grad`` against
  ``backward``): loss, ce and z within 1e-5 relative, each gradient leaf
  within 1e-4 relative L2 (measured at most 2.4e-7 and 7.8e-6);
* ``make_train_step`` at microbatches 1 and 2 with codecs None, bf16 and
  int8, after one and after three steps: loss within 1e-5 relative, every
  parameter leaf within 1e-4 relative L2 (measured at most 2.4e-7 and
  3.4e-5; the zero-initialized leaves below), the steps' lr within 1e-6
  and grad_norm within ``NORM_RTOL``;
* the three remat policies give the same loss and gradients, bit for bit;
* ``tests/test_system.py``'s train tests on the port: the loop runs and
  its losses are finite; a run failed at step 5 and resumed from its step-4
  checkpoint reproduces the uninterrupted run's last 3 losses bit for bit
  (mamba2, as the reference's test, and qwen); bf16 compression trains;
* the launcher's edges: ``--rules`` other than ``baseline`` raises naming
  A9; the default device is the card; the twins of the examples run.

One deviation is held to its own limit (ROADMAP Queue C). A leaf that
starts at zero (qwen's q, k, v biases) has no value but its updates, so
its relative L2 is the updates' own. The k bias's components on RoPE's
lowest frequencies get gradients ~1e-7 (five orders below the leaf's
largest), where the two packages' float32 summation orders differ by
~1e-9; AdamW's first steps are sign-like at that size (eps 1e-8), so
those components move by different fractions of the learning rate: the
k bias reads up to 5.1e-3 relative L2 (its gradient agrees to 1.8e-6).
The zero-initialized leaves are held to ``ZERO_INIT_TOL``; with eps
1e-5, where no component is that close to eps, every leaf is within
1e-4 (``test_torch_train_dense.py::test_zero_init_gap_is_adamws_eps``).
"""
import dataclasses
import functools
import importlib.util
import pathlib
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.data.pipeline import SyntheticDataset as RefDataset  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models.param import init_params as ref_init_params  # noqa: E402
from repro.optim.adamw import AdamWConfig as RefAdamW  # noqa: E402
from repro.train.steps import TrainState as RefState  # noqa: E402
from repro.train.steps import make_train_step as ref_make_step  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.data.pipeline import SyntheticDataset  # noqa: E402
from repro_torch.launch.train import TrainLoopConfig, run  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.param import tree_leaves  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: per arch, the reduced config's cut (both packages alike) and sequence
CUT = {"hymba-1.5b": dict(n_layers=5)}
ARCH_SEQ = {"hymba-1.5b": 24}
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4       # relative L2, gradient and parameter leaves
ZERO_INIT_TOL = 1e-2  # measured 5.1e-3 (module docstring)
# the norm of the compressed gradients: the bf16 codec rounds elements
# that the two packages' float32 sums put on either side of a rounding
# boundary to neighbouring values (measured 1.3e-5; 6.5e-6 without it)
NORM_RTOL = 1e-4
SEQ, BATCH = 16, 4


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's reduced config (cut by ``CUT``) and its initial
    parameters from PRNG key 0 -- immutable, so shared by the tests."""
    ref_cfg = dataclasses.replace(ref_get_arch(arch).reduced(),
                                  **CUT.get(arch, {}))
    return ref_cfg, ref_init_params(jreg.param_specs(ref_cfg),
                                    jax.random.PRNGKey(0))


def _setup(arch, codec=None, eps=1e-8):
    ref_cfg, params = _ref_params(arch)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **CUT.get(arch, {}))
    seq = ARCH_SEQ.get(arch, SEQ)
    kw = dict(total_steps=10, warmup_steps=2, eps=eps)
    ref_state = RefState.create(params, RefAdamW(**kw),
                                grad_compression=codec)
    dump = jax.tree.map(np.asarray, {"params": ref_state.params,
                                     "opt_state": ref_state.opt_state,
                                     "step": ref_state.step})
    state = train_state_from_numpy(dump, device="cpu")
    ref_data = RefDataset(ref_cfg, RefShape("t", seq, BATCH, "train"),
                          seed=1)
    data = SyntheticDataset(cfg, ShapeConfig("t", seq, BATCH, "train"),
                            seed=1, device="cpu")
    return (ref_cfg, RefAdamW(**kw), ref_state, ref_data), \
        (cfg, AdamWConfig(**kw), state, data)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _leaf_rels(ref_tree, tree) -> dict:
    ref = dict(tree_leaves(jax.tree.map(np.asarray, ref_tree)))
    return {path: _rel(ref[path], t.detach().numpy())
            for path, t in tree_leaves(tree)}


def _zero_init(ref_params) -> set:
    return {path for path, a in tree_leaves(jax.tree.map(np.asarray,
                                                         ref_params))
            if not a.any()}


def _check_leaves(rels: dict, what: str, zero_init: set):
    for path, r in rels.items():
        tol = ZERO_INIT_TOL if path in zero_init else LEAF_TOL
        assert r <= tol, (what, path, r)


def check_loss_and_gradients(arch):
    """``loss_fn`` and every gradient leaf against ``jax.value_and_grad``
    of the reference's."""
    (rcfg, _, rst, rdata), (cfg, _, st, data) = _setup(arch)
    rb = rdata.batch(0)
    (_, rm), rg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, rb, rcfg, dtype=jnp.float32),
        has_aux=True))(rst.params)
    loss, m = TM.loss_fn(st.params, data.batch(0), cfg, dtype=torch.float32)
    loss.backward()
    for k in ("loss", "ce", "z"):
        assert float(m[k]) == pytest.approx(float(rm[k]), rel=LOSS_RTOL)
    # a leaf the loss never reaches (hubert's token embedding) has no
    # .grad; the reference's gradient there is zeros
    grads = {path: torch.zeros_like(p) if p.grad is None else p.grad
             for path, p in tree_leaves(st.params)}
    ref = dict(tree_leaves(jax.tree.map(np.asarray, rg)))
    for path, g in grads.items():
        assert _rel(ref[path], g.numpy()) <= LEAF_TOL, path


def check_train_steps(arch, microbatches, codec):
    """Three ``make_train_step`` steps against the reference's: loss, lr,
    grad_norm, and every parameter leaf after one and after three."""
    (rcfg, ropt, rst, rdata), (cfg, opt, st, data) = _setup(arch, codec)
    rstep = jax.jit(ref_make_step(rcfg, ropt, microbatches=microbatches,
                                  grad_compression=codec,
                                  dtype=jnp.float32))
    step = make_train_step(cfg, opt, microbatches=microbatches,
                           grad_compression=codec, dtype=torch.float32)
    zero_init = _zero_init(rst.params)
    for i in range(3):
        rst, rm = rstep(rst, rdata.batch(i))
        st, m = step(st, data.batch(i))
        for k in ("loss", "ce", "z"):
            assert float(m[k]) == pytest.approx(float(rm[k]), rel=LOSS_RTOL)
        assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
        assert float(m["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=NORM_RTOL)
        if i in (0, 2):  # after one step and after three
            _check_leaves(_leaf_rels(rst.params, st.params),
                          f"params after {i + 1} steps", zero_init)
    assert int(st.step) == int(rst.step) == 3
    assert ("ef" in st.opt_state) == (codec == "int8")


def check_remat_policies(arch):
    """The three remat policies give the same loss and gradients, bit for
    bit."""
    _, (cfg, _, st, data) = _setup(arch)
    batch = data.batch(0)
    out = {}
    for remat in ("none", "full", "dots"):
        for _, p in tree_leaves(st.params):
            p.grad = None
        loss, _ = TM.loss_fn(st.params, batch, cfg, remat=remat,
                             dtype=torch.float32)
        loss.backward()
        # None: a leaf the loss never reaches (hubert's token embedding)
        out[remat] = (loss.detach(), [None if p.grad is None
                                      else p.grad.clone() for _, p in
                                      tree_leaves(st.params)])
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][1], out["none"][1]):
            assert (a is None and b is None) or torch.equal(a, b)
    with pytest.raises(ValueError, match="remat"):
        TM.loss_fn(st.params, batch, cfg, remat="some",
                   dtype=torch.float32)


# ------------------------------------------------- tests/test_system.py's
def _loop(arch, tmp_path, **kw):
    return TrainLoopConfig(arch=arch, steps=8, seq_len=ARCH_SEQ.get(arch, SEQ),
                           global_batch=BATCH, ckpt_dir=str(tmp_path),
                           checkpoint_every=2, log_every=100, device="cpu",
                           **kw)


def check_failure_injection_and_bitexact_resume(tmp_path, arch):
    """A run failed at step 5 and resumed from its step-4 checkpoint
    reproduces the uninterrupted run's last 3 losses bit for bit."""
    cfg = _loop(arch, tmp_path)
    full = run(TrainLoopConfig(**{**vars(cfg), "ckpt_dir": ""}))
    with pytest.raises(RuntimeError, match="injected failure"):
        run(TrainLoopConfig(**{**vars(cfg), "fail_at_step": 5}))
    resumed = run(cfg)  # resumes from the step-4 checkpoint
    assert len(resumed["losses"]) == 4
    np.testing.assert_allclose(resumed["losses"][-3:], full["losses"][-3:],
                               rtol=0, atol=0)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
