"""The port's gradient codecs against the JAX package's, on the CPU.

* ``tests/test_compression_slo.py``'s codec checks, on the port: the
  int8 round trip within half a step, the error feedback telescoping,
  a train step with each codec;
* ``quantize_int8`` gives the reference's int8 codes exactly (both round
  half to even) and a scale within 1 float32 ulp; ``compress_grads``
  (bf16, and int8 over 5 steps of error feedback) within 2 float32
  ulps of each leaf's largest value (measured: 0 for bf16, at most 1
  ulp for int8);
* ``compress_grads`` writes over the given trees and returns them (the
  reference returns new ones).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import compression as ref  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data.specs import make_batch  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.param import init_params, train_params  # noqa
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.optim.compression import (  # noqa: E402
    compress_grads, dequantize_int8, init_error_feedback, quantize_int8)
from repro_torch.train.steps import TrainState, make_train_step  # noqa

ULPS = 2.4e-7


def test_int8_roundtrip_bounded_error():
    g = torch.tensor(np.random.default_rng(0).standard_normal(256)
                     .astype(np.float32)) * 3.0
    q, s = quantize_int8(g)
    deq = dequantize_int8(q, s)
    assert q.dtype == torch.int8
    np.testing.assert_allclose(deq.numpy(), g.numpy(), atol=float(s) * 0.51)


def test_error_feedback_telescopes():
    """Sum of decompressed grads converges to the sum of true grads —
    the EF residual never grows."""
    rng = np.random.default_rng(1)
    p = {"w": torch.zeros((64,))}
    ef = init_error_feedback(p)
    true_sum = torch.zeros((64,))
    deq_sum = torch.zeros((64,))
    for _ in range(20):
        g = {"w": torch.tensor(rng.standard_normal(64).astype(np.float32))}
        true_sum = true_sum + g["w"]
        out, ef = compress_grads(g, "int8", ef)
        deq_sum = deq_sum + out["w"]
    resid = float((true_sum - deq_sum).abs().max())
    assert resid < 0.2, resid
    np.testing.assert_allclose(ef["w"].numpy(),
                               (true_sum - deq_sum).numpy(), atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_codes_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(4099) * 10 ** rng.uniform(-6, 2)).astype(
        np.float32)
    g[:50] = np.round(g[:50])  # exact halves after scaling are likely
    q, s = quantize_int8(torch.tensor(g))
    rq, rs = ref.quantize_int8(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == pytest.approx(float(rs), rel=1.2e-7)


def _grad_tree(rng):
    return {"embed": rng.standard_normal((16, 8)).astype(np.float32),
            "layers": {"w": rng.standard_normal((3, 8, 5)).astype(
                np.float32) * 1e-3,
                "b": rng.standard_normal((3, 5)).astype(np.float32)}}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], (*prefix, k))
    else:
        yield prefix, np.asarray(tree, dtype=np.float32)


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_compress_grads_equals_the_reference(codec):
    rng = np.random.default_rng(7)
    shapes = _grad_tree(rng)
    jef = ref.init_error_feedback(jax.tree.map(jnp.asarray, shapes)) \
        if codec == "int8" else None
    tef = init_error_feedback(jax.tree.map(torch.tensor, shapes)) \
        if codec == "int8" else None
    for _ in range(5):
        g = _grad_tree(rng)
        jout, jef = ref.compress_grads(jax.tree.map(jnp.asarray, g), codec,
                                       jef)
        tout, tef = compress_grads(jax.tree.map(torch.tensor, g), codec, tef)
        trees = [(jout, tout)] + ([(jef, tef)] if codec == "int8" else [])
        for jt, tt in trees:
            for (ka, a), (kb, b) in zip(_leaves(jt), _leaves(
                    jax.tree.map(lambda t: t.numpy(), tt))):
                assert ka == kb
                np.testing.assert_allclose(b, a, rtol=0,
                                           atol=ULPS * np.abs(a).max())


@pytest.mark.parametrize("codec", [None, "bf16", "int8"])
def test_compress_grads_writes_in_place(codec):
    g = jax.tree.map(torch.tensor, _grad_tree(np.random.default_rng(3)))
    ef = init_error_feedback(g) if codec == "int8" else None
    leaves = [t for _, t in _leaves_t(g)]
    out, ef2 = compress_grads(g, codec, ef)
    assert out is g and ef2 is ef
    assert [t for _, t in _leaves_t(out)] == leaves


def _leaves_t(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_t(tree[k], (*prefix, k))
    else:
        yield prefix, tree


def test_unknown_codec_and_missing_feedback_raise():
    g = {"w": torch.ones(3)}
    with pytest.raises(ValueError, match="unknown codec"):
        compress_grads(g, "fp8")
    with pytest.raises(ValueError, match="error feedback"):
        compress_grads(g, "int8", None)


@pytest.mark.parametrize("codec", [None, "bf16", "int8"])
def test_train_step_with_compression(codec):
    cfg = get_arch("qwen2.5-3b").reduced()
    opt = AdamWConfig(total_steps=10, warmup_steps=2)
    params = train_params(init_params(registry.param_specs(cfg),
                                      torch.Generator().manual_seed(0),
                                      "cpu"))
    st = TrainState.create(params, opt, grad_compression=codec)
    step = make_train_step(cfg, opt, grad_compression=codec)
    b = make_batch(cfg, ShapeConfig("t", 32, 4, "train"), seed=1,
                   device="cpu")
    st, m = step(st, b)
    st, m = step(st, b)
    assert bool(torch.isfinite(m["loss"]))
    assert int(st.step) == 2 and int(st.opt_state["step"]) == 2
    if codec == "int8":
        assert "ef" in st.opt_state
